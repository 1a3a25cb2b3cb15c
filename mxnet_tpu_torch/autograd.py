"""Autograd: recording scopes and the tape.

The PyTorch counterpart of ``mxnet_tpu/autograd.py`` (reference:
python/mxnet/autograd.py). The tape is torch's own autograd graph:
``record()`` turns recording on, and with it torch's grad mode, so the
ops run inside it build a graph; outside ``record()`` (and inside
``pause()``) blocks, registered ops and NDArray arithmetic run with grad
mode off, so a serving step holds no activations.

What stays MXNet's is how gradients land. :func:`mark_variables` (and
``NDArray.attach_grad``, ``Parameter`` initialization) gives a leaf a
gradient buffer and a ``grad_req``; :func:`backward` computes the
gradients of the heads with respect to every marked leaf with
``torch.autograd.grad`` and then writes them:

- ``"write"`` overwrites the buffer on each ``backward``;
- ``"add"`` accumulates into it;
- ``"null"`` never gets one;
- a marked leaf that a ``backward`` does not reach keeps its old value.

A leaf reached along several paths (the tied embedding of
``TransformerLM(tie_weights=True)``) gets the sum once. Nothing goes
through ``tensor.grad``: torch's accumulate-by-default is not MXNet's
``write``.

:func:`grad` returns gradients instead of writing buffers; with
``create_graph=True`` its results sit on the graph, so a second
``grad`` or ``backward`` gives higher-order derivatives. A
:class:`Function` is a custom VJP over NDArrays, tied into the graph as
one ``torch.autograd.Function``.
"""
from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function",
           "get_symbol", "register_grad_ready_hook"]


class _AutogradState(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False
        # record() scopes entered from outside one: a hybridized block
        # reuses the captured graphs of a call made in an earlier scope
        self.record_scopes = 0


_STATE = _AutogradState()

# guards: _MARKED
_MARK_LOCK = threading.Lock()
# NDArrays given a gradient buffer, keyed by id: a WeakSet would compare
# two live arrays with ``==``, which is elementwise on NDArrays
_MARKED = weakref.WeakValueDictionary()


def is_recording():
    """Reference: python/mxnet/autograd.py is_recording."""
    return _STATE.recording


def is_training():
    """Reference: python/mxnet/autograd.py is_training."""
    return _STATE.training


def _grad_mode(differentiable=True):
    """torch's grad mode for running one op: on only while recording,
    and only for a differentiable op."""
    return torch.set_grad_enabled(_STATE.recording and differentiable)


@contextmanager
def _scope(recording=None, training=None):
    prev_r, prev_t = _STATE.recording, _STATE.training
    if recording is not None:
        _STATE.recording = recording
    if training is not None:
        _STATE.training = training
    try:
        if recording is None:
            yield
        else:
            with torch.set_grad_enabled(recording):
                yield
    finally:
        _STATE.recording, _STATE.training = prev_r, prev_t


@contextmanager
def record(train_mode=True):
    """Scope in which the ops run are recorded for :func:`backward`
    (reference: python/mxnet/autograd.py:122 record())."""
    if not _STATE.recording:
        _STATE.record_scopes += 1
    with _scope(recording=True, training=train_mode):
        yield


def _record_scope_id():
    """Which outermost ``record()`` scope this thread is in (or was in
    last)."""
    return _STATE.record_scopes


def pause(train_mode=False):
    """Reference: python/mxnet/autograd.py:141 pause()."""
    return _scope(recording=False, training=train_mode)


def train_mode():
    """Reference: python/mxnet/autograd.py:163."""
    return _scope(training=True)


def predict_mode():
    """Reference: python/mxnet/autograd.py:181."""
    return _scope(training=False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as leaves with gradient buffers ``gradients``
    (reference: python/mxnet/autograd.py mark_variables). A buffer may
    be None: the first ``backward`` that reaches the variable allocates
    it. A variable whose tensor already has a history is cut from it
    and becomes a leaf, as MXNet's ``attach_grad`` does."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"grad_req must be 'write', 'add' or 'null', "
                             f"got {req!r}")
        data = var._data
        if not data.is_leaf:
            data = var._data = data.detach()
        if req != "null" and not data.is_floating_point():
            raise MXNetError(f"cannot attach a gradient to a {data.dtype} "
                             "array")
        data.requires_grad_(req != "null")
        var._grad = grad  # under "null", a buffer no backward writes
        var._grad_req = req
        with _MARK_LOCK:
            if req == "null":
                _MARKED.pop(id(var), None)
            else:
                _MARKED[id(var)] = var


def _heads_and_seeds(heads, head_grads):
    """The head tensors and their seeds (``head_grads``, ones by
    default) as ``torch.autograd.grad`` takes them."""
    from .ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    outs, seeds = [], []
    for i, h in enumerate(heads):
        t = h.data if isinstance(h, NDArray) else h
        if not t.requires_grad:
            raise MXNetError(
                "backward: a head was not computed inside autograd.record() "
                "from a variable with a gradient buffer")
        hg = None if head_grads is None else head_grads[i]
        if hg is None:
            hg = torch.ones_like(t)
        elif isinstance(hg, NDArray):
            hg = hg.data
        else:
            hg = torch.as_tensor(hg, dtype=t.dtype, device=t.device)
        outs.append(t)
        seeds.append(hg)
    return outs, seeds


def _torch_grad(outs, inputs, seeds, retain_graph, create_graph=False):
    """``torch.autograd.grad`` in the scopes the forwards ran in:
    convolutions' backward in float32 and products' sums in float32."""
    from .ndarray.ops_nn import cublas_fp32_accumulate, cudnn_fp32

    with cudnn_fp32(), cublas_fp32_accumulate():
        return torch.autograd.grad(outs, inputs, grad_outputs=seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)


# grad-ready hooks: called with each marked variable right after
# ``backward`` writes its gradient (the seam the bucketed gradient
# all-reduce, ``pipeline/grad_sync.py``, dispatches on). torch computes
# every gradient of a backward at once (a hybridized block's captured
# backward too), so the signals follow in one run after it.
_GRAD_READY_HOOKS = []


def register_grad_ready_hook(hook):
    """Register ``hook(marked_ndarray)`` to fire right after each marked
    variable's gradient is written by :func:`backward` (the JAX
    package's ``autograd.py:175-262``). Returns a callable that removes
    it (idempotent)."""
    _GRAD_READY_HOOKS.append(hook)

    def remove():
        try:
            _GRAD_READY_HOOKS.remove(hook)
        except ValueError:
            pass

    return remove


def _signal_grad_ready(arr):
    for hook in tuple(_GRAD_READY_HOOKS):
        hook(arr)


def backward(heads, head_grads=None, retain_graph=False):
    """Compute the gradients of ``heads`` with respect to every marked
    variable and write them into the variables' buffers by their
    ``grad_req`` (reference: python/mxnet/autograd.py:246 backward).
    ``head_grads`` default to ones. The graph is freed unless
    ``retain_graph``."""
    from .ndarray import NDArray

    outs, seeds = _heads_and_seeds(heads, head_grads)
    with _MARK_LOCK:
        marked = [a for a in list(_MARKED.values())
                  if a._grad_req != "null" and a._data.requires_grad]
    if not marked:
        return
    grads = _torch_grad(outs, [a._data for a in marked], seeds,
                        retain_graph)
    with torch.no_grad():
        for var, g in zip(marked, grads):
            if g is None:  # not reached: keeps its old gradient
                continue
            if var._grad is None:
                var._grad = NDArray(torch.empty_like(var._data,
                                                     requires_grad=False))
                var._grad._data.copy_(g)
            elif var._grad_req == "add":
                var._grad._data.add_(g)
            else:
                var._grad._data.copy_(g)
            if _GRAD_READY_HOOKS:
                _signal_grad_ready(var)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, returned
    rather than written into the variables' buffers (reference:
    python/mxnet/autograd.py:273 grad; the JAX package's
    ``autograd.py:353-400``). Each variable's buffer and ``grad_req``
    stay as they were. ``retain_graph`` defaults to ``create_graph``.
    With ``create_graph=True`` the results are on the graph, so a
    ``backward`` or ``grad`` of an expression in them, inside
    ``record()``, gives higher-order derivatives. A variable the heads
    do not reach gets zeros. ``train_mode`` is accepted as in the
    reference; the graph keeps the mode it was recorded in."""
    from .ndarray import NDArray

    single = isinstance(variables, NDArray)
    variables = [variables] if single else list(variables)
    if retain_graph is None:
        retain_graph = create_graph
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError(
                "grad: a variable has no gradient buffer; call attach_grad() "
                "on it before recording the heads")
    outs, seeds = _heads_and_seeds(heads, head_grads)
    with torch.set_grad_enabled(create_graph):
        gs = _torch_grad(outs, [v._data for v in variables], seeds,
                         retain_graph, create_graph)
    res = [NDArray(g if create_graph else g.detach()) if g is not None
           else NDArray(torch.zeros_like(v._data, requires_grad=False))
           for v, g in zip(variables, gs)]
    return res[0] if single else res


def get_symbol(x):
    """The reference returns the recorded graph as a Symbol; this tape is
    torch's graph, which has no Symbol form. As in the JAX package,
    trace a block with ``HybridBlock.export`` instead."""
    raise NotImplementedError(
        "get_symbol is not supported on the torch tape; use "
        "HybridBlock.export to trace a graph")


class Function:
    """A user-defined differentiable function (reference:
    python/mxnet/autograd.py:368 Function; the JAX package's
    ``autograd.py:410-453``). Subclasses override ``forward(*inputs)``
    and ``backward(*output_grads)`` over NDArrays; ``backward`` returns
    one gradient per NDArray input. Both run outside the graph
    (``pause()``). Under ``record()`` a call is one
    ``torch.autograd.Function`` node whose backward calls the override,
    so the gradients land by ``grad_req`` like any op's. The override's
    own ops are not recorded: higher orders through it are zero, as the
    JAX package truncates them."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray

        if not is_recording():
            with pause(train_mode=is_training()):
                return self.forward(*inputs)
        pos = [i for i, a in enumerate(inputs) if isinstance(a, NDArray)]
        box = {}
        outs = _FunctionNode.apply(self, inputs, pos, box,
                                   *[inputs[i]._data for i in pos])
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if box["single"] else wrapped


class _FunctionNode(torch.autograd.Function):
    """One :class:`Function` call on torch's graph."""

    @staticmethod
    def forward(ctx, fn, inputs, pos, box, *tensors):
        from .ndarray import NDArray

        args = list(inputs)
        for i, t in zip(pos, tensors):
            args[i] = NDArray(t)
        with pause(train_mode=is_training()):
            out = fn.forward(*args)
        box["single"] = not isinstance(out, (list, tuple))
        outs = [out] if box["single"] else list(out)
        ctx.fn, ctx.n = fn, len(tensors)
        return tuple(o.data for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray

        with pause():
            igrads = ctx.fn.backward(*[NDArray(g) for g in grads])
        if not isinstance(igrads, (list, tuple)):
            igrads = [igrads]
        if len(igrads) != ctx.n:
            raise MXNetError(f"Function.backward returned {len(igrads)} "
                             f"gradients for {ctx.n} array inputs")
        return (None, None, None, None) + tuple(
            g.data if isinstance(g, NDArray) else g for g in igrads)
