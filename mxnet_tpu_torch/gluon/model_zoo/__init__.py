"""Model zoo (reference: python/mxnet/gluon/model_zoo/): the ResNet V1
family so far."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
