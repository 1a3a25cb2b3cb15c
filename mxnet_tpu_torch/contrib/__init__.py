"""``mx.contrib`` (reference: python/mxnet/contrib/__init__.py): AMP,
the part of the JAX package's ``contrib`` that is ported."""
from . import amp  # noqa: F401

__all__ = ["amp"]
