"""Model zoo (reference: python/mxnet/gluon/model_zoo/): the vision
families of the JAX package's zoo and the pretrained-weight store."""
from . import model_store, vision
from .vision import get_model

__all__ = ["vision", "get_model", "model_store"]
