"""``mx.gluon``: Block, HybridBlock, Parameter, the ``nn`` layers, the
losses and the Trainer."""
from . import loss, nn
from .block import Block, HybridBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer"]
