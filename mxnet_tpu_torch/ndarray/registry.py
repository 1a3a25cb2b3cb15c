"""Op registry.

The PyTorch counterpart of ``mxnet_tpu/ndarray/registry.py:32-65,599``.
Each op is a plain function on ``torch.Tensor`` arguments plus
metadata; :func:`invoke` unwraps NDArray arguments, runs the op and
wraps tensor results. Ops registered with the ``"nd"`` namespace also
appear as ``mx.nd.<name>``. The tape is torch's autograd graph: an op
runs with grad mode on only inside ``autograd.record()`` and only if it
is differentiable, so ops outside the graph (``differentiable=False``:
the optimizer updates, the decode-cache writes) record nothing.

The AMP cast hook (``mxnet_tpu/ndarray/registry.py:81-169,656-660``):
while ``contrib.amp.init`` has set a policy (:func:`set_amp`),
:func:`invoke` casts an op's floating array arguments by the op lists
before the op runs, inside the op's grad mode, so the casts sit on
torch's autograd graph and gradients land in each parameter's own dtype.
"""
from __future__ import annotations

import torch

from .. import autograd

__all__ = ["OpDef", "register", "get_op", "list_ops", "invoke", "set_amp",
           "amp_version"]

_OPS = {}


class OpDef:
    __slots__ = ("name", "fn", "differentiable", "doc", "namespaces", "_sig")

    def __init__(self, name, fn, differentiable=True, doc=None,
                 namespaces=("nd",)):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.doc = doc or fn.__doc__
        self.namespaces = namespaces
        self._sig = None

    def signature(self):
        if self._sig is None:
            import inspect

            self._sig = inspect.signature(self.fn)
        return self._sig


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


# the AMP policy contrib.amp.init installs; while it is on, invoke casts
# each op's floating array arguments by the op lists
_AMP = {"on": False, "target": None, "target_ops": frozenset(),
        "fp32_ops": frozenset(), "widest_ops": frozenset(),
        "conditional_ops": {}, "version": 0}

# widest last: the order the widest-type rule ranks float dtypes by
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def set_amp(target_dtype=None, target_ops=(), fp32_ops=(), widest_ops=(),
            conditional_ops=()):
    """Install the AMP policy (``target_dtype`` None turns it off):
    target ops take ``target_dtype``, fp32 ops float32, widest ops the
    widest float dtype among their inputs, and a conditional op
    ``(op, attr, values)`` float32 when ``attr`` takes one of
    ``values``."""
    from .ndarray import torch_dtype

    _AMP["on"] = target_dtype is not None
    _AMP["target"] = None if target_dtype is None else \
        torch_dtype(target_dtype)
    _AMP["target_ops"] = frozenset(target_ops)
    _AMP["fp32_ops"] = frozenset(fp32_ops)
    _AMP["widest_ops"] = frozenset(widest_ops)
    _AMP["conditional_ops"] = {op: (attr, frozenset(vals))
                               for op, attr, vals in conditional_ops}
    # a signature cache keyed by it (the fused step's) rebuilds on a change
    _AMP["version"] += 1


def amp_version():
    return _AMP["version"]


def _cond_attr(opdef, args, kwargs, attr):
    """Value of ``attr`` whether passed by keyword or positionally."""
    if kwargs and attr in kwargs:
        return kwargs[attr]
    if args:
        try:
            bound = opdef.signature().bind_partial(*args, **(kwargs or {}))
        except TypeError:
            return None
        return bound.arguments.get(attr)
    return None


def _is_float(x):
    return isinstance(x, torch.Tensor) and x.dtype in _FLOATS


def _amp_cast_fn(opdef, args=None, kwargs=None):
    """``f(list of tensors) -> list of tensors`` applying the AMP policy
    to ``opdef``'s array arguments, or None when the policy leaves the
    op alone. Only floating tensors are cast."""
    if not _AMP["on"]:
        return None
    opname = opdef.name
    cond = _AMP["conditional_ops"].get(opname)
    if cond is not None and \
            str(_cond_attr(opdef, args, kwargs, cond[0])) in cond[1]:
        to = torch.float32
    elif opname in _AMP["target_ops"]:
        to = _AMP["target"]
    elif opname in _AMP["fp32_ops"]:
        to = torch.float32
    elif opname in _AMP["widest_ops"]:
        def widest(xs):
            fl = [x.dtype for x in xs if _is_float(x)]
            if not fl:
                return xs
            w = max(fl, key=_FLOATS.index)
            return [x.to(w) if _is_float(x) else x for x in xs]
        return widest
    else:
        return None

    def cast(xs):
        return [x.to(to) if _is_float(x) else x for x in xs]
    return cast


def invoke(opdef, args, kwargs):
    """Run ``opdef`` on NDArray (or plain) arguments; tensor results
    come back as NDArrays, a tuple result as a list of them."""
    from .ndarray import NDArray

    def unwrap(x):
        return x._data if isinstance(x, NDArray) else x

    with autograd._grad_mode(opdef.differentiable):
        args = [unwrap(a) for a in args]
        kwargs = {k: unwrap(v) for k, v in kwargs.items()}
        cast = _amp_cast_fn(opdef, args, kwargs) if _AMP["on"] else None
        if cast is not None:
            # positional and keyword arrays in one list, as the JAX
            # dispatch gathers them (its ``arr_args``)
            keys = [k for k, v in kwargs.items()
                    if isinstance(v, torch.Tensor)]
            pos = [i for i, a in enumerate(args)
                   if isinstance(a, torch.Tensor)]
            casted = cast([args[i] for i in pos] + [kwargs[k] for k in keys])
            for i, c in zip(pos, casted):
                args[i] = c
            for k, c in zip(keys, casted[len(pos):]):
                kwargs[k] = c
        result = opdef.fn(*args, **kwargs)
    if isinstance(result, tuple):
        return [NDArray(r) if isinstance(r, torch.Tensor) else r
                for r in result]
    return NDArray(result) if isinstance(result, torch.Tensor) else result
