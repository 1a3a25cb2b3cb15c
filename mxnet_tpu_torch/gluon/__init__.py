"""``mx.gluon``: Block, HybridBlock (with ``CachedOp``), SymbolBlock,
Parameter, the ``nn`` layers, the losses, the Trainer, the model zoo
(ResNet V1) and ``data`` (datasets, samplers, DataLoader)."""
from . import data, loss, model_zoo, nn
from .block import (Block, CachedOp, HookHandle, HybridBlock, SymbolBlock,
                    cached_op_stats, reset_cached_op_stats)
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "model_zoo", "data", "Block", "HybridBlock",
           "SymbolBlock", "CachedOp", "HookHandle", "cached_op_stats",
           "reset_cached_op_stats", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer"]
