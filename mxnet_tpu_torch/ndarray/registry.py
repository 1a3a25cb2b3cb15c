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

Shape bucketing (``mxnet_tpu/ndarray/registry.py:421-440``): under
``MXNET_SHAPE_BUCKETS``, outside ``autograd.record()``, an op of
``utils.compile_cache._BATCH_SAFE`` runs with its batch rows zero-padded
up to the bucket and its outputs sliced back, row-bitwise equal to the
unbucketed op (``compile_cache.plan_bucketing``).
"""
from __future__ import annotations

import time as _time

import torch

from .. import autograd
from .. import profiler as _prof
from ..base import MXNetError
from ..telemetry import tracer as _telem
from ..utils import compile_cache as _cc

__all__ = ["OpDef", "register", "get_op", "list_ops", "invoke", "set_amp",
           "amp_version", "amp_policy"]

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


def amp_policy():
    """The AMP policy in force as a process-stable value (what
    persisted fingerprints key on; :func:`amp_version` counts changes
    within one process)."""
    if not _AMP["on"]:
        return ("amp", 0)
    return ("amp", str(_AMP["target"]), tuple(sorted(_AMP["target_ops"])),
            tuple(sorted(_AMP["fp32_ops"])),
            tuple(sorted(_AMP["widest_ops"])),
            tuple(sorted((op, attr, tuple(sorted(map(str, vals))))
                         for op, (attr, vals) in
                         _AMP["conditional_ops"].items())))


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


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def invoke(opdef, args, kwargs):
    """Run ``opdef`` on NDArray (or plain) arguments; tensor results
    come back as NDArrays, a tuple result as a list of them. ``out=``
    (an NDArray) receives the result, as in the JAX package: written in
    place (cast to its dtype) where it keeps its shape outside
    ``autograd.record()``, else rebound; under ``MXNET_GRAPH_VERIFY`` the
    in-place write is checked first (``analysis/donation.py``: GV201 when
    a live autograd graph saved ``out``, GV202 when ``out`` also feeds
    another argument slot)."""
    out = kwargs.get("out")
    if out is not None and "out" not in opdef.signature().parameters:
        kwargs = {k: v for k, v in kwargs.items() if k != "out"}
        return _invoke_out(opdef, args, kwargs, out)
    return _dispatch(opdef, args, kwargs)


def _invoke_out(opdef, args, kwargs, out):
    from ..analysis.diagnostics import verify_mode
    from .ndarray import NDArray, _owns

    if not isinstance(out, NDArray):
        raise MXNetError(f"op '{opdef.name}': out= must be an NDArray")
    recording = autograd.is_recording()
    if not recording and verify_mode() != "off":
        from ..analysis.donation import check_dispatch_donation

        arr_args = [a for a in (*args, *kwargs.values())
                    if isinstance(a, NDArray)]
        slot = next((i for i, a in enumerate(arr_args) if a is out), None)
        check_dispatch_donation(opdef.name, arr_args, slot, out)
    result = _dispatch(opdef, args, kwargs)
    if isinstance(result, list):
        raise MXNetError("out= not supported for multi-output ops")
    res = result._data if isinstance(result, NDArray) else \
        torch.as_tensor(result)
    dst = out._data
    if recording or dst.shape != res.shape or dst.device != res.device \
            or not _owns(dst):
        out._data = res.to(dst.dtype)
    else:
        with torch.no_grad():
            dst.copy_(res)
    return out


def _dispatch(opdef, args, kwargs):
    """:func:`invoke` without ``out=``.

    The seams of the JAX dispatch (``mxnet_tpu/ndarray/registry.py:
    628-649``): with the profiler running and ``profile_imperative`` set,
    each call's host time goes to ``profiler.record_op``; at
    ``MXNET_TELEMETRY=2`` each call is a ``dispatch.<op>`` span. Both
    time the host's dispatch: torch launches asynchronously, and nothing
    here waits for the card. The port has no dispatch executable cache,
    so ``cached`` is always False. Ops run while a CUDA graph is being
    captured get neither: they would be timed once, at the capture, and
    never at the replays."""
    if _prof.imperative_on() and not _capturing():
        t0 = _time.perf_counter()
        try:
            return _invoke(opdef, args, kwargs)
        finally:
            _prof.record_op(opdef.name, t0 * 1e6,
                            (_time.perf_counter() - t0) * 1e6,
                            cached=False)
    if _telem.tracing(2) and not _capturing():
        with _telem.span(f"dispatch.{opdef.name}", cat="dispatch",
                         need=2) as sp:
            out = _invoke(opdef, args, kwargs)
            sp.set(cached=False)
            return out
    return _invoke(opdef, args, kwargs)


def _bucket_plan(opdef, args, kwargs):
    """``compile_cache.plan_bucketing`` for one dispatch (positional
    tensor slots), or None: off unless ``MXNET_SHAPE_BUCKETS`` is set,
    and never inside ``autograd.record()`` or with tensor keywords."""
    if _cc.bucket_spec() is None or autograd.is_recording() or any(
            isinstance(v, torch.Tensor) for v in kwargs.values()):
        return None
    pos = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    if not pos:
        return None
    template = [("arr", pos.index(i)) if i in pos else ("lit", a)
                for i, a in enumerate(args)]
    plan = _cc.plan_bucketing(opdef.name, [args[i] for i in pos],
                              template, kwargs)
    if plan is None:
        return None
    return plan[0], plan[1], tuple(pos[j] for j in plan[2])


def _invoke(opdef, args, kwargs):
    from .ndarray import NDArray, _own

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
        plan = _bucket_plan(opdef, args, kwargs)
        if plan is not None:
            padded, true, slots = plan
            args = list(args)
            for i in slots:
                args[i] = _cc.pad_batch(args[i], padded)
            _cc.note_bucketed(padded, true)
        result = opdef.fn(*args, **kwargs)
        if plan is not None:
            def cut(r):
                return _cc.slice_batch(r, padded, true) \
                    if isinstance(r, torch.Tensor) else r
            result = tuple(map(cut, result)) if isinstance(result, tuple) \
                else cut(result)
        if opdef.name != "_slice_take":
            # an op's result is an array of its own, as in MXNet: a torch
            # view of an input, or the input passed through
            # (stop_gradient, make_loss, dropout outside training), is
            # copied (``ndarray._own``); the basic slices behind
            # ``__getitem__`` share, and the optimizer updates, not
            # differentiable, return the weight they wrote
            ins = (*args, *kwargs.values())

            def own(r):
                if not opdef.differentiable and any(r is a for a in ins):
                    return r
                return _own(r, ins)
            result = tuple(map(own, result)) if isinstance(result, tuple) \
                else own(result)
    if isinstance(result, tuple):
        return [NDArray(r) if isinstance(r, torch.Tensor) else r
                for r in result]
    return NDArray(result) if isinstance(result, torch.Tensor) else result
