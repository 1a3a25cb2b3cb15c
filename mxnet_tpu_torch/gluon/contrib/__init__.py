"""``gluon.contrib`` (reference: python/mxnet/gluon/contrib/): the
``nn`` layers the vision zoo builds on, and ``cnn``'s deformable
convolution."""
from . import cnn, nn

__all__ = ["cnn", "nn"]
