"""Executor: the forward and backward of a bound symbol graph.

The PyTorch counterpart of ``mxnet_tpu/executor.py`` (reference:
src/executor/graph_executor.cc, python/mxnet/executor.py). Where the JAX
executor lowers the bound graph to one jitted computation per bind, this
one evaluates the graph's op bodies on the bound arrays, and on a CUDA
device captures that evaluation as CUDA graphs, one set per (bound
shapes, ``is_train``): the forward, and when the bind takes gradients
the backward by the loss-head rule and the backward of caller-given
head gradients, both captured from the forward's autograd graph in the
forward's memory pool. Each later call replays them: the bound arrays
are the graphs' inputs and the gradient arrays their outputs, written in
place by ``grad_req`` ("write" copies, "add" adds), so data fed with
``forward(**kwargs)`` and weights an optimizer updates in place are read
at the next replay. Before a capture the executor runs the forward and
backward once eagerly on a side stream (cuDNN's autotuning, cuBLAS's
handles and torch's RNN workspace come up there) and restores the aux
states that warm-up moved. ``mx.random``'s device generator is
registered with each graph, so every replay draws fresh dropout masks.
Kernel launches are counted per replay (``kernels/_build.py``). A
capture that fails raises :class:`MXNetError`; nothing falls back.
A monitor callback (``set_monitor_callback``) and the CPU run the same
evaluation eagerly, and so does every executor constructed inside
:func:`eager_binds`: the mode is fixed when the executor is made, so an
eager baseline to measure or check the captured one against stays eager
for its whole life.

Loss heads keep the JAX executor's rule (``executor.py:190-240``):
without head gradients, ``backward`` differentiates the sum over the
heads of softmax cross-entropy for ``softmax_output`` (one-hot of the
label; a label outside the classes adds nothing), half the squared error
for ``linear_regression_output``, the binary cross-entropy for
``logistic_regression_output``, the absolute error for
``mae_regression_output``, and the plain sum of any other head
(``make_loss``): ``grad_scale`` and ``normalization`` are ignored. The
ops' own backward on the ``nd``/``autograd`` path is another rule (they
scale and normalize), as in the JAX package.

A training forward updates each batch norm's moving statistics in place:
``momentum * moving + (1 - momentum) * batch``, the batch variance the
biased one (``executor.py:137-180``). A multi-context bind (the JAX
executor's mesh and sharding branch) waits for the multi-device slice's
second half, 9b, and raises.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import autograd
from . import telemetry as _telemetry
from . import random as _random
from .base import MXNetError
from .context import Context, cuda_graph, resolve_device
from .kernels import _build
from .ndarray import NDArray
from .resilience import faults as _faults
from .symbol import _DEVICE

__all__ = ["Executor", "eager_binds", "executor_stats",
           "reset_executor_stats"]

_LOSS_HEADS = ("softmax_output", "make_loss", "linear_regression_output",
               "logistic_regression_output", "mae_regression_output")

# the ``executor`` family of the telemetry registry
_STATS = _telemetry.counter_family(
    "executor", dict.fromkeys(("binds", "captures", "replays",
                               "backward_replays", "eager_forwards",
                               "eager_backwards"), 0))


_BIND_MODE = threading.local()


@contextlib.contextmanager
def eager_binds():
    """Executors constructed inside (``simple_bind``, ``bind``, a
    ``Module``'s or a bucket's bind) never capture: they run eagerly on
    a CUDA device too, for their whole life. The baseline that the
    captured executor is checked and timed against."""
    old = getattr(_BIND_MODE, "eager", False)
    _BIND_MODE.eager = True
    try:
        yield
    finally:
        _BIND_MODE.eager = old


def _count(name, n=1):
    _STATS.add(name, n)


def one_context(ctx):
    """``ctx``, or the one context of a list; several raise: a bind over
    several contexts (the JAX executor's mesh and sharding branch,
    ``mxnet_tpu/executor.py:257-313``) comes with slice 9b. Data
    parallelism over processes (one context a rank, ``tools/launch.py``)
    is ported."""
    if isinstance(ctx, (list, tuple)):
        if len(ctx) > 1:
            raise MXNetError(
                "a bind over several contexts (data parallelism over a "
                "mesh) is not ported yet: it comes with the multi-device "
                "slice's second half, slice 9b; bind to one context a "
                "process and launch ranks with mxnet_tpu_torch.tools.launch")
        return ctx[0] if ctx else None
    return ctx


def executor_stats():
    """Counters over every Executor: ``binds``, ``captures`` (signatures
    captured), ``replays`` (forward graph replays), ``backward_replays``,
    and the ``eager_forwards``/``eager_backwards`` of uncaptured runs (the
    CPU, a monitor, an executor bound inside :func:`eager_binds`)."""
    return _STATS.snapshot()


def reset_executor_stats():
    _STATS.reset()


class _Graphs:
    """One signature's captured graphs and static buffers."""

    def __init__(self, key):
        self.key = key
        self.fwd = self.bwd = self.vjp = None
        self.outputs = []      # NDArrays over the forward's static outputs
        self.out_diff = []     # which outputs carry a gradient
        self.gouts = []        # head-gradient buffers of those outputs
        self.ptrs = None       # the bound arrays' addresses it captured
        self.fwd_launches = {}
        self.bwd_launches = {}
        self.vjp_launches = {}
        self.replays = 0
        self.bwd_replays = 0

    def info(self):
        return {"shapes": self.key[0], "is_train": self.key[1],
                "grads": self.key[2], "replays": self.replays,
                "backward_replays": self.bwd_replays,
                "launches_per_replay": dict(self.fwd_launches),
                "backward_launches_per_replay": dict(self.bwd_launches)}


class Executor:
    """A symbol bound to arrays (reference: executor.py Executor)."""

    def __init__(self, symbol, arg_names, arg_arrays, grad_arrays, grad_req,
                 ctx=None, aux_names=(), aux_arrays=(), output_shapes=None):
        ctx = one_context(ctx)
        self._symbol = symbol
        self.arg_names = list(arg_names)
        self.arg_arrays = list(arg_arrays)
        n = len(self.arg_arrays)
        self.grad_arrays = list(grad_arrays) if grad_arrays is not None \
            else [None] * n
        reqs = [grad_req] * n if isinstance(grad_req, str) else \
            list(grad_req)
        self._reqs = [r if g is not None and a.data.is_floating_point()
                      else "null" for r, g, a in
                      zip(reqs, self.grad_arrays, self.arg_arrays)]
        self.grad_req = grad_req
        self.aux_names = list(aux_names)
        self.aux_arrays = list(aux_arrays)
        self.output_shapes = None if output_shapes is None else \
            [None if s is None else tuple(s) for s in output_shapes]
        self.outputs = []
        self._ctx = ctx if isinstance(ctx, Context) or ctx is None else \
            Context.from_device(ctx)
        self._device = self.arg_arrays[0].data.device if self.arg_arrays \
            else resolve_device(self._ctx)
        self._graphs = {}
        self._pending = None   # the last eager training forward's graph
        self._captured_fwd = None  # the last captured training forward
        self._mon_cb = None
        self._mon_all = False
        self._graphs_on = self._device.type == "cuda" and \
            not getattr(_BIND_MODE, "eager", False)
        self._analyze_on_bind()
        self._bn_specs = self._batch_norm_specs()
        _count("binds")

    # -- bind-time analysis ---------------------------------------------

    def _analyze_on_bind(self):
        """``MXNET_GRAPH_VERIFY``-gated verification, then the
        ``MXNET_GRAPH_OPT``-gated rewrite for this bind's shapes, dtypes
        and device (JAX ``executor.py:52-86``). Both share one
        ``PassContext``. The arrays are fed by name, so the bound lists
        stay valid for any rewrite."""
        from . import analysis
        from .analysis import graph_opt

        mode = analysis.verify_mode()
        level = graph_opt.opt_level()
        if mode == "off" and level == 0:
            return
        shapes, dtypes = {}, {}
        for n, a in zip(self.arg_names + self.aux_names,
                        self.arg_arrays + self.aux_arrays):
            shapes[n] = tuple(a.shape)
            dtypes[n] = a.data.dtype
        subject = f"bind:{self._symbol._name or 'symbol'}"
        ctx = analysis.PassContext(self._symbol, shapes=shapes,
                                   dtypes=dtypes, subject=subject)
        if mode != "off":
            analysis.run_passes(ctx)
            ctx.report.disposition(mode)
        if level > 0:
            self._symbol, _ = graph_opt.optimize_symbol(
                self._symbol, shapes=shapes, dtypes=dtypes, level=level,
                ctx=ctx, subject=subject, device=self._device)

    def _batch_norm_specs(self):
        """The batch norms whose moving statistics are bound aux arrays:
        (node, mean index, var index, momentum, axis)."""
        aux_index = {n: i for i, n in enumerate(self.aux_names)}
        specs = []
        for node in self._symbol._walk():
            if node._op != "batch_norm" or len(node._inputs) < 5 or \
                    node._kwargs.get("use_global_stats"):
                continue
            m, v = node._inputs[3]._name, node._inputs[4]._name
            if m in aux_index and v in aux_index:
                specs.append((node, aux_index[m], aux_index[v],
                              float(node._kwargs.get("momentum", 0.9)),
                              int(node._kwargs.get("axis", 1))))
        return specs

    # -- the bound arrays ------------------------------------------------

    @property
    def arg_dict(self):
        return dict(zip(self.arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return {n: g for n, g in zip(self.arg_names, self.grad_arrays)
                if g is not None}

    @property
    def aux_dict(self):
        return dict(zip(self.aux_names, self.aux_arrays))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``arg_params``/``aux_params`` (name -> NDArray) into the
        bound arrays, in place (reference: executor.py
        copy_params_from)."""
        for table, bound, what in ((arg_params, self.arg_dict, "arguments"),
                                   (aux_params or {}, self.aux_dict,
                                    "aux states")):
            for name, array in table.items():
                if name in bound:
                    if tuple(array.shape) != bound[name].shape:
                        raise ValueError(
                            f"param '{name}' has shape {tuple(array.shape)}"
                            f" but the executor binds it as "
                            f"{bound[name].shape}")
                    _assign(bound[name], array)
                elif not allow_extra_params:
                    raise ValueError(f"Found name '{name}' that is not in "
                                     f"the {what}")

    def _need_grad(self):
        return any(r != "null" for r in self._reqs)

    def _use_graphs(self):
        return self._graphs_on and self._mon_cb is None and \
            not torch.cuda.is_current_stream_capturing()

    # -- evaluation ------------------------------------------------------

    def _leaves(self):
        """Aliases of the arrays that take a gradient, as autograd
        leaves: they share the arrays' storage, so an in-place feed or
        update is what the next evaluation (or replay) reads."""
        return [a.data.detach().requires_grad_(True) if r != "null" else
                None for a, r in zip(self.arg_arrays, self._reqs)]

    def _evaluate(self, train, leaves, want_loss, update_aux=True):
        """The outputs (tensors) and, with ``want_loss``, the loss heads'
        total, over the bound arrays (``leaves`` in place of those that
        take a gradient); a training forward updates the moving
        statistics in place. Returns (outputs, total, cache)."""
        feed = {}
        for n, a, leaf in zip(self.arg_names, self.arg_arrays, leaves):
            feed[n] = NDArray(leaf) if leaf is not None else a
        for n, a in zip(self.aux_names, self.aux_arrays):
            feed[n] = a
        cache = {_DEVICE: self._device}
        record = any(leaf is not None for leaf in leaves)
        heads = self._symbol._group or [self._symbol]
        total = None
        with autograd._scope(recording=record, training=train):
            outs = []
            for h in heads:
                o = h._eval_nodes(feed, cache)
                outs.extend(o if isinstance(o, (list, tuple)) else [o])
            if want_loss:
                total = self._loss_total(heads, feed, cache)
        if train and update_aux:
            self._update_moving_stats(feed, cache)
        return [o.data for o in outs], total, cache

    @staticmethod
    def _value(node, feed, cache):
        v = node._eval_nodes(feed, cache)
        return v[node._output_index] if isinstance(v, (list, tuple)) else v

    def _loss_total(self, heads, feed, cache):
        """The scalar the loss-head rule differentiates (JAX
        ``executor.py:190-240``)."""
        total = None
        for h in heads:
            if h._op in _LOSS_HEADS and h._op != "make_loss":
                d = self._value(h._inputs[0], feed, cache).data
                lab = self._value(h._inputs[1], feed, cache).data
                if h._op == "softmax_output":
                    logp = torch.log_softmax(d, dim=-1)
                    C = d.shape[-1]
                    idx = lab.reshape(d.shape[:-1]).to(torch.int64)
                    ok = (idx >= 0) & (idx < C)
                    picked = torch.gather(logp, -1, idx.clamp(0, C - 1)
                                          .unsqueeze(-1)).squeeze(-1)
                    t = -(picked * ok).sum()
                else:
                    lab = lab.reshape(d.shape).to(d.dtype)
                    if h._op == "linear_regression_output":
                        t = 0.5 * torch.square(d - lab).sum()
                    elif h._op == "mae_regression_output":
                        t = torch.abs(d - lab).sum()
                    else:
                        p = torch.sigmoid(d)
                        t = -(lab * torch.log(p + 1e-12) + (1 - lab)
                              * torch.log(1 - p + 1e-12)).sum()
            else:
                o = h._eval_nodes(feed, cache)
                t = sum(x.data.sum() for x in
                        (o if isinstance(o, (list, tuple)) else [o]))
            total = t if total is None else total + t
        return total

    def _update_moving_stats(self, feed, cache):
        with torch.no_grad():
            for node, mi, vi, mom, bax in self._bn_specs:
                x = self._value(node._inputs[0], feed, cache).data.float()
                axes = tuple(i for i in range(x.dim()) if i != bax % x.dim())
                bm = x.mean(dim=axes)
                bv = x.var(dim=axes, unbiased=False)
                for i, b in ((mi, bm), (vi, bv)):
                    t = self.aux_arrays[i].data
                    t.copy_(mom * t + (1 - mom) * b.to(t.dtype))

    def _grads(self, leaves, outs, total, out_grads, retain_graph=False):
        """Gradients of the loss total (``out_grads`` None) or of the
        outputs against ``out_grads``, one per argument (None where the
        argument takes none or the graph does not reach it)."""
        targets = [t for t in leaves if t is not None]
        if not targets:
            return [None] * len(leaves)
        if out_grads is None:
            heads, seeds = [total], [torch.ones_like(total)]
        else:
            pairs = [(o, g) for o, g in zip(outs, out_grads)
                     if o.requires_grad]
            heads, seeds = [o for o, _ in pairs], [g for _, g in pairs]
        if not heads or not any(h.requires_grad for h in heads):
            return [None] * len(leaves)
        got = iter(autograd._torch_grad(heads, targets, seeds,
                                        retain_graph=retain_graph))
        return [next(got) if t is not None else None for t in leaves]

    def _write_grads(self, grads):
        """Each gradient into its array by ``grad_req``: "write" copies
        (zeros where the graph does not reach the argument, as the JAX
        executor writes), "add" adds."""
        with torch.no_grad():
            for garr, req, g in zip(self.grad_arrays, self._reqs, grads):
                if req == "null":
                    continue
                if req == "add":
                    if g is not None:
                        garr.data.add_(g)
                elif g is None:
                    garr.data.zero_()
                else:
                    garr.data.copy_(g)

    # -- CUDA graphs -----------------------------------------------------

    def _key(self, is_train, need_grad):
        return (tuple(a.shape for a in self.arg_arrays + self.aux_arrays),
                bool(is_train), bool(need_grad))

    def _ptrs(self):
        return tuple(a.data.data_ptr() for a in
                     self.arg_arrays + self.aux_arrays +
                     [g for g in self.grad_arrays if g is not None])

    def _graphs_for(self, is_train, need_grad):
        key = self._key(is_train, need_grad)
        g = self._graphs.get(key)
        if g is None or g.ptrs != self._ptrs():
            g = self._capture(key, is_train, need_grad)
            self._graphs[key] = g
        return g

    def _capture(self, key, train, need_grad):
        """Warm up, then capture the forward (and with ``need_grad`` the
        two backwards) for ``key``. Runs nothing of the call itself: the
        caller replays. Raises :class:`MXNetError`."""
        g = _Graphs(key)
        dev = self._device
        aux = [a.data for a in self.aux_arrays]
        try:
            _faults.maybe_fail("executor_capture")
            with torch.no_grad():
                snap = [t.clone() for t in aux]
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                leaves = self._leaves() if need_grad else [None] * \
                    len(self.arg_arrays)
                outs, total, _ = self._evaluate(train, leaves, need_grad)
                if need_grad:
                    self._grads(leaves, outs, total, None, retain_graph=True)
                    self._grads(leaves, outs, total,
                                [torch.ones_like(o) for o in outs])
                del outs, total, leaves
            cur.wait_stream(side)
            with torch.no_grad():
                for t, s in zip(aux, snap):
                    t.copy_(s)
            del snap
            gen = _random.device_generator(dev)
            fwd = torch.cuda.CUDAGraph()
            fwd.register_generator_state(gen)
            leaves = self._leaves() if need_grad else [None] * \
                len(self.arg_arrays)
            with _build.recording_launches() as frec:
                with cuda_graph(fwd, capture_error_mode="thread_local"):
                    outs, total, _ = self._evaluate(train, leaves, need_grad)
            g.fwd, g.fwd_launches = fwd, frec
            g.out_diff = [need_grad and o.requires_grad for o in outs]
            if need_grad:
                bwd = torch.cuda.CUDAGraph()
                bwd.register_generator_state(gen)
                with _build.recording_launches() as brec:
                    with cuda_graph(bwd, pool=fwd.pool(),
                                    capture_error_mode="thread_local"):
                        self._write_grads(self._grads(
                            leaves, outs, total, None, retain_graph=True))
                g.bwd, g.bwd_launches = bwd, brec
                g.gouts = [torch.zeros_like(o) for o, d in
                           zip(outs, g.out_diff) if d]
                it = iter(g.gouts)
                seeds = [next(it) if d else None for d in g.out_diff]
                vjp = torch.cuda.CUDAGraph()
                vjp.register_generator_state(gen)
                with _build.recording_launches() as vrec:
                    with cuda_graph(vjp, pool=fwd.pool(),
                                    capture_error_mode="thread_local"):
                        self._write_grads(self._grads(
                            leaves, outs, total, seeds))
                g.vjp, g.vjp_launches = vjp, vrec
        except Exception as e:
            raise MXNetError(
                f"executor: capturing the bound graph "
                f"'{self._symbol._name or 'symbol'}' as CUDA graphs failed "
                f"for the shapes {key[0]} (is_train={train}) "
                f"({type(e).__name__}: {e}); on a CUDA device a bound graph "
                "runs only captured, so no op of it may sync with the host "
                "or take a data-dependent shape") from e
        g.outputs = [NDArray(o.detach()) for o in outs]
        g.ptrs = self._ptrs()
        _count("captures")
        return g

    # -- the public calls ------------------------------------------------

    def forward(self, is_train=False, **kwargs):
        """Feed ``kwargs`` (name -> NDArray or array-like) into the bound
        arrays, in place, and run the graph (reference: executor.py
        forward). Returns ``outputs``."""
        for k, v in kwargs.items():
            if k not in self.arg_names:
                raise MXNetError(
                    f"unknown input '{k}' fed to executor; bound arguments "
                    f"are {self.arg_names}")
            _assign(self.arg_dict[k], v)
        need_grad = bool(is_train) and self._need_grad()
        self._pending = self._captured_fwd = None
        if self._use_graphs():
            g = self._graphs_for(is_train, need_grad)
            g.fwd.replay()
            g.replays += 1
            _build.count_replay(g.fwd_launches)
            _count("replays")
            self.outputs = g.outputs
            if need_grad:
                self._captured_fwd = g
        else:
            leaves = self._leaves() if need_grad else \
                [None] * len(self.arg_arrays)
            outs, total, cache = self._evaluate(bool(is_train), leaves,
                                                need_grad)
            _count("eager_forwards")
            self.outputs = [NDArray(o.detach()) for o in outs]
            if need_grad:
                self._pending = (leaves, outs, total)
            self._run_monitor(cache)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Write the gradients into the gradient arrays by ``grad_req``
        (reference: executor.py backward): of the outputs against
        ``out_grads`` when given, else by the loss-head rule. Uses the
        last training forward; without one it runs the forward again
        (the moving statistics and outputs untouched)."""
        if not self._need_grad():
            return
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        if self._use_graphs():
            g = self._captured_fwd
            if g is None:
                g = self._graphs_for(True, True)
                with torch.no_grad():
                    snap = [a.data.clone() for a in self.aux_arrays]
                g.fwd.replay()
                _build.count_replay(g.fwd_launches)
                with torch.no_grad():
                    for a, s in zip(self.aux_arrays, snap):
                        a.data.copy_(s)
            if out_grads is None:
                graph, launches = g.bwd, g.bwd_launches
            else:
                with torch.no_grad():
                    it = iter(g.gouts)
                    for og, d in zip(out_grads, g.out_diff):
                        if d:
                            buf = next(it)
                            buf.copy_(_tensor_of(og, buf))
                graph, launches = g.vjp, g.vjp_launches
            graph.replay()
            g.bwd_replays += 1
            _build.count_replay(launches)
            _count("backward_replays")
            return
        pending = self._pending
        if pending is None:
            leaves = self._leaves()
            outs, total, _ = self._evaluate(True, leaves, True,
                                            update_aux=False)
        else:
            leaves, outs, total = pending
        seeds = None if out_grads is None else \
            [_tensor_of(g, o) for g, o in zip(out_grads, outs)]
        self._write_grads(self._grads(leaves, outs, total, seeds))
        self._pending = None
        _count("eager_backwards")

    def warmup(self, is_train=None):
        """Capture the graphs for the bound shapes now, writing no
        output, gradient or aux state (on the CPU, nothing to do)."""
        if is_train is None:
            is_train = self._need_grad()
        if self._use_graphs():
            self._graphs_for(is_train, bool(is_train) and self._need_grad())

    def graph_info(self):
        """One record per captured signature: its replays and the kernel
        launches per replay."""
        return [g.info() for g in self._graphs.values()]

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """New arrays (zeros) for the arguments named in ``kwargs`` with
        their new shapes, the rest kept; the graphs are recaptured at the
        next call (reference: graph_executor.cc Reshape)."""
        from .ndarray import zeros

        changed = False
        for name, shape in kwargs.items():
            if name in self.arg_names:
                i = self.arg_names.index(name)
                a = self.arg_arrays[i]
                self.arg_arrays[i] = zeros(shape, ctx=a.context,
                                           dtype=a.dtype)
                if self.grad_arrays[i] is not None:
                    self.grad_arrays[i] = zeros(shape, ctx=a.context,
                                                dtype=a.dtype)
                changed = True
        if changed:
            self._graphs.clear()
            try:
                _, out_shapes, _ = self._symbol.infer_shape(
                    **{n: a.shape for n, a in self.arg_dict.items()})
                self.output_shapes = [tuple(s) for s in out_shapes]
            except MXNetError:
                self.output_shapes = None
        return self

    # -- monitor taps ----------------------------------------------------

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` with every op output by name
        after each forward (with ``monitor_all`` the bound inputs too);
        the executor then runs eagerly (reference: executor.py
        set_monitor_callback)."""
        self._mon_cb = callback
        self._mon_all = bool(monitor_all)

    def _run_monitor(self, cache):
        cb = self._mon_cb
        if cb is None:
            return
        active = getattr(cb, "mx_monitor_active", None)
        if active is not None and not active():
            return
        if self._mon_all:
            for n, a in zip(self.arg_names + self.aux_names,
                            self.arg_arrays + self.aux_arrays):
                cb(n, a)
        seen = set()
        for node in self._symbol._walk():
            key = node._eval_key()
            if node._op is None or key in seen or key not in cache:
                continue
            seen.add(key)
            val = cache[key]
            vals = val if isinstance(val, (list, tuple)) else [val]
            names = node.list_outputs() if node._num_outputs > 1 else \
                [f"{node._name}_output"]
            for name, v in zip(names, vals):
                cb(name, NDArray(v.data.detach()))


def _tensor_of(value, like):
    """``value`` (an NDArray, tensor or array-like) as a tensor of
    ``like``'s dtype, device and shape (a one-element value for a 0-d
    output: ``nd.array`` of a scalar has shape (1,))."""
    if isinstance(value, NDArray):
        value = value.data
    t = torch.as_tensor(value).to(device=like.device, dtype=like.dtype)
    return t.reshape(like.shape) if t.numel() == like.numel() else t


def _assign(dst, value):
    """Write ``value`` into the bound array ``dst`` in place (its storage
    is what a captured graph reads); host data goes through pinned
    memory."""
    src = value.data if isinstance(value, NDArray) else \
        torch.as_tensor(value)
    if tuple(src.shape) != dst.shape:
        raise MXNetError(f"executor: array of shape {tuple(src.shape)} fed "
                         f"to a bound array of shape {dst.shape}")
    t = dst.data
    with torch.no_grad():
        if t.is_cuda and src.device.type == "cpu":
            t.copy_(src.to(t.dtype).pin_memory(), non_blocking=True)
        else:
            t.copy_(src)
