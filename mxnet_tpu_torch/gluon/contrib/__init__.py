"""``gluon.contrib`` (reference: python/mxnet/gluon/contrib/): the
``nn`` layers the vision zoo builds on."""
from . import nn

__all__ = ["nn"]
