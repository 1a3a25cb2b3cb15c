"""``mx.contrib`` (reference: python/mxnet/contrib/__init__.py): AMP,
int8 quantization, ONNX interchange and the legacy shims (``autograd``,
``io``, ``ndarray``, ``symbol``), the part of the JAX package's
``contrib`` that is ported."""
from . import amp  # noqa: F401
from . import autograd  # noqa: F401  (the legacy experimental API)
from . import io  # noqa: F401
from . import ndarray  # noqa: F401  (namespace shim)
from . import symbol  # noqa: F401  (namespace shim)
from . import quantization  # noqa: F401
from . import onnx  # noqa: F401

__all__ = ["amp", "autograd", "io", "ndarray", "symbol", "quantization",
           "onnx"]
