"""``mx.gluon``: Block, HybridBlock (with ``CachedOp``), SymbolBlock,
Parameter and Constant, the ``nn`` layers, the losses, the Trainer,
``utils``, the vision model zoo, ``data`` (datasets, samplers,
DataLoader), ``rnn`` (the recurrent cells and the fused RNN/LSTM/GRU
layers) and ``contrib.nn``."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import (Block, CachedOp, HookHandle, HybridBlock, SymbolBlock,
                    cached_op_stats, reset_cached_op_stats)
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer

__all__ = ["nn", "loss", "model_zoo", "data", "rnn", "utils", "contrib",
           "Block", "HybridBlock", "SymbolBlock", "CachedOp", "HookHandle",
           "cached_op_stats", "reset_cached_op_stats", "Parameter",
           "Constant", "ParameterDict", "DeferredInitializationError",
           "Trainer"]
