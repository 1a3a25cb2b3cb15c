"""``mx.gluon``: Block, HybridBlock, SymbolBlock, Parameter, the ``nn``
layers, the losses, the Trainer and the model zoo (ResNet V1)."""
from . import loss, model_zoo, nn
from .block import Block, HybridBlock, SymbolBlock
from .parameter import DeferredInitializationError, Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "loss", "model_zoo", "Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterDict", "DeferredInitializationError", "Trainer"]
