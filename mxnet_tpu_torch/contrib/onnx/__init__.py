"""ONNX interchange (``mx.contrib.onnx``; reference:
python/mxnet/contrib/onnx/__init__.py): the exporter ``mx2onnx`` and the
importer ``onnx2mx``, the PyTorch counterpart of
``mxnet_tpu/contrib/onnx/``. The ONNX messages are read and written by
the package's own wire codec (:mod:`._wire`), so neither ``onnx`` nor
``protobuf`` is needed."""
from .mx2onnx import export_model  # noqa: F401
from .onnx2mx import (get_model_metadata, import_model,  # noqa: F401
                      import_to_gluon)

# the reference's module aliases (mx.contrib.onnx.mx2onnx / onnx2mx)
from . import mx2onnx, onnx2mx  # noqa: F401

__all__ = ["export_model", "import_model", "get_model_metadata",
           "import_to_gluon", "mx2onnx", "onnx2mx"]
