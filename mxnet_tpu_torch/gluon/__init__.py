"""``mx.gluon``: Block, HybridBlock, Parameter and the ``nn`` layers."""
from . import nn
from .block import Block, HybridBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["nn", "Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError"]
