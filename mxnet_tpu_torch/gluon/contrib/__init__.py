"""``gluon.contrib`` (reference: python/mxnet/gluon/contrib/): the
``nn`` layers the vision zoo builds on, ``cnn``'s deformable
convolution and ``estimator``, the Fit API."""
from . import cnn, estimator, nn

__all__ = ["cnn", "estimator", "nn"]
