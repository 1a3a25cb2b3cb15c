"""Model zoo (reference: python/mxnet/gluon/model_zoo/): the vision
families of the JAX package's zoo."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
