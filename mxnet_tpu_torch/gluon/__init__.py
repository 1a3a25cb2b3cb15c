"""``mx.gluon``: Block, HybridBlock (with ``CachedOp``), SymbolBlock,
Parameter, the ``nn`` layers, the losses, the Trainer, the model zoo
(ResNet V1), ``data`` (datasets, samplers, DataLoader) and ``rnn`` (the
recurrent cells and the fused RNN/LSTM/GRU layers)."""
from . import data, loss, model_zoo, nn, rnn
from .block import (Block, CachedOp, HookHandle, HybridBlock, SymbolBlock,
                    cached_op_stats, reset_cached_op_stats)
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "model_zoo", "data", "rnn", "Block", "HybridBlock",
           "SymbolBlock", "CachedOp", "HookHandle", "cached_op_stats",
           "reset_cached_op_stats", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer"]
