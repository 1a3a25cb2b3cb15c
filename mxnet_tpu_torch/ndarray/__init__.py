"""``mx.nd``: NDArray, creation functions and the registered ops.

The PyTorch counterpart of ``mxnet_tpu/ndarray/__init__.py``. Every op
registered with the ``"nd"`` namespace is exposed here as a function of
NDArrays, so a block's ``hybrid_forward(F, ...)`` runs with ``F`` = this
module.
"""
from __future__ import annotations

from . import registry
from . import ops_nn  # noqa: F401 — registers the ops
from .ndarray import NDArray, arange, array, expand_dims, zeros

__all__ = ["NDArray", "array", "zeros", "arange", "expand_dims",
           "registry"]


def _make_op_function(opdef):
    def op(*args, **kwargs):
        return registry.invoke(opdef, args, kwargs)

    op.__name__ = opdef.name
    op.__doc__ = opdef.doc
    return op


for _name in registry.list_ops():
    _opdef = registry.get_op(_name)
    if "nd" in _opdef.namespaces:
        globals()[_name] = _make_op_function(_opdef)
        __all__.append(_name)
