"""Op registry.

The PyTorch counterpart of ``mxnet_tpu/ndarray/registry.py:32-65,599``.
Each op is a plain function on ``torch.Tensor`` arguments plus
metadata; :func:`invoke` unwraps NDArray arguments, runs the op and
wraps tensor results. Ops registered with the ``"nd"`` namespace also
appear as ``mx.nd.<name>``. The tape is torch's autograd graph: an op
runs with grad mode on only inside ``autograd.record()`` and only if it
is differentiable, so ops outside the graph (``differentiable=False``:
the optimizer updates, the decode-cache writes) record nothing. The AMP
cast hook of the reference's dispatch comes with a later slice.
"""
from __future__ import annotations

import torch

from .. import autograd

__all__ = ["OpDef", "register", "get_op", "list_ops", "invoke"]

_OPS = {}


class OpDef:
    __slots__ = ("name", "fn", "differentiable", "doc", "namespaces")

    def __init__(self, name, fn, differentiable=True, doc=None,
                 namespaces=("nd",)):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.doc = doc or fn.__doc__
        self.namespaces = namespaces


def register(name=None, differentiable=True, namespaces=("nd",)):
    """Decorator registering a tensor function as op ``name`` (default:
    the function's own name)."""

    def deco(fn):
        opname = name or fn.__name__
        if opname in _OPS:
            raise ValueError(f"op '{opname}' already registered")
        _OPS[opname] = OpDef(opname, fn, differentiable, fn.__doc__,
                             namespaces)
        return fn

    return deco


def get_op(name):
    return _OPS.get(name)


def list_ops():
    return sorted(_OPS)


def invoke(opdef, args, kwargs):
    """Run ``opdef`` on NDArray (or plain) arguments; tensor results
    come back as NDArrays, a tuple result as a list of them."""
    from .ndarray import NDArray

    def unwrap(x):
        return x._data if isinstance(x, NDArray) else x

    with autograd._grad_mode(opdef.differentiable):
        result = opdef.fn(*[unwrap(a) for a in args],
                          **{k: unwrap(v) for k, v in kwargs.items()})
    if isinstance(result, tuple):
        return [NDArray(r) if isinstance(r, torch.Tensor) else r
                for r in result]
    return NDArray(result) if isinstance(result, torch.Tensor) else result
