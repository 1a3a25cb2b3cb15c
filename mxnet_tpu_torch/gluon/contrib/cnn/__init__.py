"""``gluon.contrib.cnn`` (reference: python/mxnet/gluon/contrib/cnn):
``DeformableConvolution``."""
from .conv_layers import DeformableConvolution

__all__ = ["DeformableConvolution"]
