"""``mx.contrib`` (reference: python/mxnet/contrib/__init__.py): AMP and
int8 quantization, the part of the JAX package's ``contrib`` that is
ported."""
from . import amp  # noqa: F401
from . import quantization  # noqa: F401

__all__ = ["amp", "quantization"]
