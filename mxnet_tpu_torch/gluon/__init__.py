"""``mx.gluon``: Block, HybridBlock, SymbolBlock, Parameter, the ``nn``
layers, the losses and the Trainer."""
from . import loss, nn
from .block import Block, HybridBlock, SymbolBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterDict", "DeferredInitializationError", "Trainer"]
