"""InferenceSession: a Block as a bucketed serving engine.

The PyTorch counterpart of ``mxnet_tpu/serving/session.py``. Without
states a session serves stateless :meth:`~InferenceSession.predict`:
each request is cut into chunks of at most ``max_batch`` rows, and each
chunk runs the block's forward once, eagerly, in eval mode under
``torch.inference_mode()``, padded with zero rows to the smallest
**batch bucket** that covers it (:func:`parse_buckets`,
``MXNET_SERVING_BUCKETS``); the padded rows' outputs are sliced off.
:meth:`InferenceSession.load` builds a session from an export through
``SymbolBlock.imports``, so ``MXNET_GRAPH_OPT`` and the fusion pass
apply to what it serves.

A session built with ``state_store=`` (or ``state_shapes=``) runs the
block's decode step

    forward(*inputs, *states) -> (*outputs, *new_states)

padded to the smallest **occupancy bucket** that covers the live rows.
The reference compiles one step executable per occupancy bucket; the
port's counterpart on a CUDA device is one **CUDA graph per bucket**,
captured at :meth:`warmup` (or on first use) over static input tensors
the session owns: one set of ``max_batch``-row buffers, whose leading
``bucket`` rows each bucket's graph reads. A step loads its inputs into
the buffers, gathers the live sessions' states into them
(``SessionStateStore.gather(out=)``, which dequantizes int8 pages),
replays the graph and scatters the new states back. The step never
falls back: a capture or replay that fails raises, as the reference's
step path is breaker-free. On a CPU context the step runs eagerly over
the same buffers: the plain path the tests use. Padding rows are zero
inputs and zero states, sliced off before anyone reads them.

The port's decoder appends each step's K/V into the cache tensors it is
handed, in place: here, the session's own buffers. Explicit states
(:meth:`step`) are copied into them first, and what a step returns is
copied out, so the caller's tensors are never written and never alias
the buffers.

Python-side work inside the forward runs at capture only, not at
replay: the session counts the kernel launches a capture recorded
(``kernels._build.recording_launches``) once per replay, and its
metrics are bumped around the replay.

An int8 block (``contrib.quantization.quantize_net_graph``) serves as
any block; its KV pages can be int8 too (``SessionStateStore(...,
kv_int8=True)``). The stateless path captures no graph of its own: a
block hybridized before it is served replays its ``CachedOp`` captures,
which a quantized block keys by its resolved quantize lowering (the JAX
package salts its AOT fingerprints the same way).

Not ported yet: AOT artifacts and their disk cache, the per-bucket
circuit breakers of the stateless path, the session's own graphs for
the stateless buckets, sharded sessions and AMP.
"""
from __future__ import annotations

import threading
import time

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError, getenv
from ..context import Context, cuda_graph, host_to_device, resolve_device
from ..ndarray import NDArray
from ..ndarray.ndarray import torch_dtype
from ..kernels import _build
from ..kernels import serving_fused as _sf
from ..resilience import faults as _faults
from .metrics import METRICS

__all__ = ["InferenceSession", "parse_buckets"]


def parse_buckets(raw, max_batch):
    """Batch-size buckets from an ``MXNET_SERVING_BUCKETS``-style spec:
    ``pow2`` (default) — powers of two up to ``max_batch``; ``mult:N`` —
    multiples of N up to ``max_batch``; or an explicit comma list
    ("1,4,16,64"). Always includes ``max_batch`` itself and is returned
    sorted ascending."""
    raw = (raw or "pow2").strip()
    buckets = set()
    if raw == "pow2":
        b = 1
        while b < max_batch:
            buckets.add(b)
            b <<= 1
    elif raw.startswith("mult:"):
        try:
            n = int(raw.split(":", 1)[1])
        except ValueError:
            n = 0
        if n < 1:
            raise MXNetError(
                f"invalid bucket spec {raw!r} (expected mult:N, N >= 1)")
        buckets.update(range(n, max_batch, n))
    else:
        try:
            buckets.update(int(tok) for tok in raw.split(",") if tok.strip())
        except ValueError:
            raise MXNetError(
                f"invalid bucket spec {raw!r} (expected pow2 | mult:N | "
                "comma list)") from None
        if any(b < 1 for b in buckets):
            raise MXNetError(f"bucket sizes must be >= 1 (got {raw!r})")
        # explicit lists fail fast instead of silently dropping entries
        too_big = sorted(b for b in buckets if b > max_batch)
        if too_big:
            raise MXNetError(
                f"explicit bucket(s) {too_big} exceed max_batch "
                f"{max_batch}; raise MXNET_SERVING_MAX_BATCH or drop "
                "them")
    buckets.add(int(max_batch))
    return sorted(b for b in buckets if b <= max_batch)


class _StepBucket:
    """One occupancy bucket of the decode step: views of the session's
    static buffers and, on a CUDA device, the graph captured over them
    with its static outputs and the launches its capture recorded."""

    __slots__ = ("bucket", "inputs", "states", "graph", "outs", "news",
                 "launches", "replays")

    def __init__(self, bucket, inputs, states):
        self.bucket = bucket
        self.inputs = inputs
        self.states = states
        self.graph = None
        self.outs = self.news = None
        self.launches = {}
        self.replays = 0


class _InputSpec:
    """One data input: name + per-row (batch-less) shape + dtype."""

    __slots__ = ("name", "row_shape", "dtype")

    def __init__(self, name, row_shape, dtype):
        self.name = name
        self.row_shape = tuple(int(d) for d in row_shape)
        self.dtype = onp.dtype(dtype)

    def __repr__(self):
        return (f"_InputSpec({self.name!r}, (N, "
                f"{', '.join(map(str, self.row_shape))}), {self.dtype})")


class InferenceSession:
    """Eval-mode, bucketed forward (stateless) or decode step (stateful)
    over a Block.

    Parameters
    ----------
    block : gluon.Block
        The model. Parameters must be initialized on the session's
        device, or initializable from one forward over zeros.
    example : NDArray / numpy array / tuple of them, optional
        Example input(s), batch axis first, giving each input's row
        shape and dtype. Exactly one of ``example``/``input_shapes``.
    input_shapes : sequence of shape tuples, optional
        Full input shapes INCLUDING a placeholder batch axis, e.g.
        ``[(1, 1)]``; dtype float32 unless ``input_dtypes`` is given.
    input_dtypes : sequence of dtypes, optional
    buckets : sequence of int, optional
        Batch (or occupancy) buckets (default: the
        ``MXNET_SERVING_BUCKETS`` policy, :func:`parse_buckets`, over
        ``max_batch``).
    max_batch : int, optional (default: the largest bucket, else
        ``MXNET_SERVING_MAX_BATCH``, 32)
    warm : bool
        Run :meth:`warmup` in the constructor (on a CUDA device: capture
        every bucket's decode-step graph).
    label : str, optional
        Display tag (repository healthz, the owned store's logs).
    state_shapes / state_dtypes : per-state ROW shapes and dtypes; the
        session is then stateful and owns a
        :class:`~.state.SessionStateStore`, whose pageable rows follow
        the block's ``state_row_pageable()`` (paged when
        ``MXNET_SERVING_STATE_PAGE_TOKENS`` is set).
    state_store : SessionStateStore, optional
        Use this store (its shapes and dtypes) instead.
    graphs : bool, optional
        Run the decode step as one captured CUDA graph per bucket
        (default: on a CUDA device). ``False`` runs it eagerly there, as
        the measurement tools do to compare the two; ``True`` on the CPU
        raises.
    ctx : Context, optional
        The device the session runs on (default: the current context,
        ``gpu(0)``). It must be the store's device. With no CUDA device
        and no explicit ``cpu()``, construction raises
        :class:`MXNetError`.
    """

    def __init__(self, block, example=None, input_shapes=None,
                 input_dtypes=None, buckets=None, max_batch=None, warm=True,
                 label=None, state_shapes=None, state_dtypes=None,
                 state_store=None, graphs=None, ctx=None):
        self._block = block
        self.label = label
        self.device = resolve_device(ctx)
        max_batch = int(max_batch or (max(buckets) if buckets else
                                      getenv("MXNET_SERVING_MAX_BATCH", 32,
                                             int)))
        if buckets is None:
            buckets = parse_buckets(getenv("MXNET_SERVING_BUCKETS", None),
                                    max_batch)
        self.buckets = sorted(int(b) for b in set(buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("buckets must be a non-empty set of positive "
                             f"batch sizes (got {buckets})")
        on_cuda = self.device.type == "cuda"
        if graphs and not on_cuda:
            raise MXNetError("graphs=True needs a CUDA device; the decode "
                             f"step runs eagerly on {self.device}")
        self.graphs = on_cuda if graphs is None else bool(graphs)
        self._input_specs = self._resolve_input_specs(example, input_shapes,
                                                      input_dtypes)
        self._owns_store = False
        self.state_store = None
        self._state_specs = []
        if state_store is not None or state_shapes is not None:
            self._owns_store = state_store is None
            if state_store is None:
                from .state import SessionStateStore

                # blocks that declare KV-cache rows opt them into paged
                # storage, active only when MXNET_SERVING_STATE_PAGE_TOKENS
                # is set
                proto = getattr(block, "state_row_pageable", None)
                pageable = list(proto()) if callable(proto) else None
                if pageable is not None and \
                        len(pageable) != len(state_shapes):
                    pageable = None
                state_store = SessionStateStore(
                    state_shapes, state_dtypes, pageable=pageable,
                    label=label, ctx=Context.from_device(self.device))
            elif state_store.device != self.device:
                raise MXNetError(
                    f"state store lives on {state_store.device} but the "
                    f"session runs on {self.device}; pass the same ctx= "
                    "to both")
            self.state_store = state_store
            self._state_specs = [
                _InputSpec(f"state{i}", s, dt) for i, (s, dt) in enumerate(
                    zip(state_store.state_shapes, state_store.state_dtypes))]
        self._num_outputs = None
        # guards: _steps, _buffers and the buffers' contents (one decode
        # step at a time)
        self._lock = threading.RLock()
        self._steps = {}  # occupancy bucket -> _StepBucket
        self._buffers = None  # (inputs, states) of max_batch rows
        self._ready = set()  # stateless buckets that have run
        self._ensure_initialized()
        if warm:
            self.warmup()

    # -- construction helpers -----------------------------------------

    @classmethod
    def load(cls, prefix, input_names=None, epoch=0, input_shapes=None,
             ctx=None, **kwargs):
        """A session over an export: ``{prefix}-symbol.json`` and
        ``{prefix}-{epoch:04d}.params``, loaded by
        ``SymbolBlock.imports`` with the parameters on ``ctx`` (default:
        the current context). ``input_names=None`` takes the data inputs
        to be the graph variables the params file does not hold."""
        import os

        from ..gluon.block import SymbolBlock

        param_file = f"{prefix}-{epoch:04d}.params"
        if not os.path.exists(param_file):
            raise MXNetError(f"params file {param_file!r} not found (an "
                             "export writes {prefix}-{epoch:04d}.params; "
                             "check prefix and epoch)")
        block = SymbolBlock.imports(f"{prefix}-symbol.json", input_names,
                                    param_file, ctx=ctx)
        return cls(block, input_shapes=input_shapes, ctx=ctx, **kwargs)

    def _resolve_input_specs(self, example, input_shapes, input_dtypes):
        if (example is None) == (input_shapes is None):
            raise MXNetError("exactly one of example= / input_shapes= is "
                             "required")
        names = [i.name for i in getattr(self._block, "_inputs", [])]
        if example is not None:
            if not isinstance(example, (list, tuple)):
                example = [example]
            rows = [(ex.shape, ex.dtype) for ex in example]
        else:
            input_dtypes = input_dtypes or ["float32"] * len(input_shapes)
            rows = list(zip(input_shapes, input_dtypes))
        specs = []
        for k, (shape, dt) in enumerate(rows):
            if len(shape) < 1:
                raise MXNetError("input shapes must include the batch axis")
            name = names[k] if k < len(names) else f"data{k}"
            specs.append(_InputSpec(name, tuple(shape)[1:], dt))
        return specs

    def _zeros(self, specs, rows):
        return [torch.zeros((rows,) + s.row_shape,
                            dtype=torch_dtype(s.dtype), device=self.device)
                for s in specs]

    def _ensure_initialized(self):
        params = self._block.collect_params()
        if any(p._ndarray is None for p in params.values()):
            # one throwaway forward over zeros finishes deferred init
            self._forward(self._zeros(self._input_specs, 1),
                          self._zeros(self._state_specs, 1))
        wrong = sorted(name for name, p in params.items()
                       if p.data().data.device != self.device)
        if wrong:
            raise MXNetError(
                f"parameter(s) {wrong[:3]} do not live on the session's "
                f"device {self.device}; initialize the block with the "
                "same ctx=")

    # -- the forward ---------------------------------------------------

    def _forward(self, input_datas, state_datas):
        """``(inputs, states) -> (outputs, new_states)`` as tensors, in
        eval mode with no autograd. ``state_datas`` must be tensors the
        session owns: the step writes KV rows into them."""
        with torch.inference_mode(), autograd.pause(train_mode=False):
            outs = self._block(*[NDArray(d) for d in input_datas],
                               *[NDArray(d) for d in state_datas])
        flat = [outs] if isinstance(outs, NDArray) else list(outs)
        n_states = len(self._state_specs)
        if n_states and len(flat) <= n_states:
            raise MXNetError(
                f"stateful forward returned {len(flat)} value(s); expected "
                f"outputs followed by {n_states} new state(s)")
        self._num_outputs = len(flat) - n_states
        flat = [o.data for o in flat]
        return flat[:self._num_outputs], flat[self._num_outputs:]

    def warmup(self, buckets=None):
        """Make every bucket ready before the first request (metrics not
        counted). A stateless session runs one zero forward per bucket;
        a stateful one builds each occupancy bucket's step, which on a
        CUDA device captures its graph (the reference's per-bucket step
        executables). Either way the CUDA kernels are built and cuBLAS
        is up. Returns ``{"buckets": [...], "graphs": n captured,
        "seconds": s}``."""
        t0 = time.perf_counter()
        todo = [int(b) for b in (buckets or self.buckets)]
        graphs = 0
        for b in todo:
            if self._state_specs:
                with self._lock:
                    ent = self._step_bucket(b)
                    if ent.graph is None:  # eager: bring up the kernels
                        self._forward(ent.inputs, ent.states)
                graphs += ent.graph is not None
            else:
                self._forward(self._zeros(self._input_specs, b), [])
                self._ready.add(b)
        self._synchronize()
        return {"buckets": todo, "graphs": graphs,
                "seconds": time.perf_counter() - t0}

    # -- the decode step: static buffers and one graph per bucket -------

    def _step_bucket(self, bucket):
        """The :class:`_StepBucket` of ``bucket``, built at first use: a
        view of the static buffers' leading ``bucket`` rows and, with
        graphs, the step captured over it. A failed capture raises and
        leaves no entry behind, so the next use tries again."""
        with self._lock:
            ent = self._steps.get(bucket)
            if ent is not None:
                return ent
            if self._buffers is None:
                self._buffers = (self._zeros(self._input_specs,
                                             self.max_batch),
                                 self._zeros(self._state_specs,
                                             self.max_batch))
            ent = _StepBucket(bucket,
                              [t[:bucket] for t in self._buffers[0]],
                              [t[:bucket] for t in self._buffers[1]])
            if self.graphs:
                self._capture(ent)
            self._steps[bucket] = ent
            return ent

    def _capture(self, ent):
        """Capture one decode step at ``ent.bucket`` into a CUDA graph.
        One eager step on a side stream first brings up what a capture
        may not (cuBLAS handles, the kernels' modules); its launches are
        real and count. The capture's own launches do not: they are
        recorded, and each replay counts them."""
        dev = self.device
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._forward(ent.inputs, ent.states)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread-local capture: other sessions may serve on other
            # threads meanwhile (a repository deploys while it serves)
            with _build.recording_launches() as rec:
                with cuda_graph(graph,
                                capture_error_mode="thread_local"):
                    outs, news = self._forward(ent.inputs, ent.states)
        except Exception as e:
            raise MXNetError(
                f"capturing the decode step at bucket {ent.bucket} as a "
                f"CUDA graph failed ({type(e).__name__}: {e}); a CUDA "
                "session runs its step only as a graph (graphs=False "
                "runs it eagerly)") from e
        ent.graph, ent.outs, ent.news, ent.launches = graph, outs, news, rec

    def _execute(self, ent):
        """One decode step over ``ent``'s buffers (inputs and states
        loaded): ``(outputs, new_states)`` at bucket rows. A graph's
        outputs are its static outputs, valid until the next replay."""
        _faults.maybe_fail("serving_execute")
        if ent.graph is None:
            return self._forward(ent.inputs, ent.states)
        ent.graph.replay()
        ent.replays += 1
        _build.count_replay(ent.launches)
        return ent.outs, ent.news

    def _load_rows(self, dsts, srcs, n):
        """Copy ``n`` rows of each source (NDArray or host array) into the
        leading rows of its buffer view and zero the rest."""
        with torch.inference_mode():
            for dst, x in zip(dsts, srcs):
                src = x.data if isinstance(x, NDArray) else host_to_device(
                    torch.from_numpy(onp.ascontiguousarray(x)), dst.device)
                dst[:n].copy_(src)
                dst[n:].zero_()

    def graph_stats(self):
        """``{bucket: {"graph": captured?, "replays": n}}`` for every
        built occupancy bucket."""
        with self._lock:
            return {b: {"graph": ent.graph is not None,
                        "replays": ent.replays}
                    for b, ent in sorted(self._steps.items())}

    def health_snapshot(self):
        """The ``/healthz`` view, in the reference's keys: ``warm`` once
        every bucket is ready (stateless: it has run; stateful: its step
        is built, captured on a CUDA device). The port's session has no
        per-bucket breakers yet, so nothing is degraded or open."""
        with self._lock:
            ready = self._steps if self._state_specs else self._ready
            warm = all(b in ready for b in self.buckets)
        return {"warm": warm, "buckets": list(self.buckets),
                "degraded_buckets": [], "breaker_states": {},
                "open_buckets": []}

    def _synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the request path ----------------------------------------------

    @property
    def max_batch(self):
        return self.buckets[-1]

    @property
    def stateful(self):
        return bool(self._state_specs)

    @property
    def input_specs(self):
        return list(self._input_specs)

    def _check_array(self, x, spec, kind):
        if isinstance(x, NDArray):
            if onp.dtype(x.dtype) != spec.dtype:
                raise ValueError(f"{kind} {spec.name!r} dtype {x.dtype} != "
                                 f"expected {spec.dtype}")
            arr = x
        else:
            try:
                arr = onp.asarray(x, dtype=spec.dtype)
            except (TypeError, ValueError) as e:
                raise ValueError(f"{kind} {spec.name!r} is not convertible "
                                 f"to dtype {spec.dtype}: {e}") from None
        if tuple(arr.shape[1:]) != spec.row_shape:
            raise ValueError(f"{kind} {spec.name!r} row shape "
                             f"{tuple(arr.shape[1:])} != expected "
                             f"{spec.row_shape}")
        return arr

    def validate(self, *inputs):
        """Check request inputs against the input specs; returns
        ``(arrays, batch)``. NDArrays pass through; everything else
        becomes a host numpy array of the spec dtype. Raises
        ``ValueError``, the per-request failure a batcher reports on one
        future."""
        if len(inputs) != len(self._input_specs):
            raise ValueError(f"expected {len(self._input_specs)} input(s), "
                             f"got {len(inputs)}")
        arrs, batch = [], None
        for x, spec in zip(inputs, self._input_specs):
            arr = self._check_array(x, spec, "input")
            if batch is None:
                batch = arr.shape[0]
            elif arr.shape[0] != batch:
                raise ValueError("inputs disagree on batch size "
                                 f"({batch} vs {arr.shape[0]})")
            if batch == 0:
                raise ValueError("empty batch")
            arrs.append(arr)
        return arrs, batch

    def _validate_states(self, states, batch):
        if len(states) != len(self._state_specs):
            raise ValueError(f"expected {len(self._state_specs)} state(s), "
                             f"got {len(states)}")
        out = []
        for s, spec in zip(states, self._state_specs):
            arr = self._check_array(s, spec, "state")
            if arr.shape[0] != batch:
                raise ValueError(f"state {spec.name!r} batch {arr.shape[0]} "
                                 f"!= input batch {batch}")
            out.append(arr)
        return out

    def _bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run_bucket(self, arrs, n):
        """One chunk of at most ``max_batch`` rows through its bucket;
        returns the output tensors cut back to ``n`` rows. Host inputs
        are padded in numpy and uploaded once; device inputs are padded
        on the device (``pad_all``)."""
        bucket = self._bucket_for(n)
        datas = [None] * len(arrs)
        dev_idx, dev_arrs = [], []
        for i, a in enumerate(arrs):
            if isinstance(a, NDArray):
                dev_idx.append(i)
                dev_arrs.append(a.data.to(self.device))
                continue
            if a.shape[0] != bucket:
                padded = onp.zeros((bucket,) + a.shape[1:], a.dtype)
                padded[:a.shape[0]] = a
                a = padded
            datas[i] = torch.from_numpy(onp.ascontiguousarray(a)).to(
                self.device)
        if dev_arrs:
            for i, p in zip(dev_idx, _sf.pad_all(dev_arrs, bucket)):
                datas[i] = p
        _faults.maybe_fail("serving_execute")
        outs, _ = self._forward(datas, [])
        self._ready.add(bucket)
        METRICS.bump("bucket_execs")
        METRICS.bump("padded_rows", bucket - n)
        METRICS.bump("true_rows", n)
        return _sf.slice_all(outs, bucket, n)

    def predict(self, *inputs):
        """Eval-mode inference: inputs are NDArrays or anything
        ``numpy.asarray`` takes, batch axis first. A batch above
        ``max_batch`` is chunked. Returns an NDArray (one output) or a
        tuple of NDArrays, on the session's device."""
        if self._state_specs:
            raise MXNetError("predict() is stateless; this session threads "
                             "state — use step() or a stateful "
                             "DynamicBatcher")
        arrs, batch = self.validate(*inputs)
        t0 = time.perf_counter()
        chunks = []
        for start in range(0, batch, self.max_batch):
            n = min(self.max_batch, batch - start)
            chunk = arrs if n == batch else [
                NDArray(a.data[start:start + n]) if isinstance(a, NDArray)
                else a[start:start + n] for a in arrs]
            chunks.append(self._run_bucket(chunk, n))
        outs = chunks[0] if len(chunks) == 1 else [
            torch.cat([c[i] for c in chunks]) for i in range(len(chunks[0]))]
        self._synchronize()
        METRICS.observe_batch(batch, time.perf_counter() - t0)
        result = tuple(NDArray(o) for o in outs)
        return result[0] if len(result) == 1 else result

    def __call__(self, *inputs):
        return self.predict(*inputs)

    def _run_step(self, arrs, states, n):
        """One decode step of explicit ``states`` at occupancy ``n``:
        inputs and states are copied into the bucket's buffers (the
        caller's tensors are never written), and the outputs and new
        states come back as fresh tensors of ``n`` rows."""
        with self._lock:
            ent = self._step_bucket(self._bucket_for(n))
            self._load_rows(ent.inputs, arrs, n)
            self._load_rows(ent.states, states, n)
            outs, news = self._execute(ent)
            with torch.inference_mode():
                outs = [o[:n].clone() for o in outs]
                news = [s[:n].clone() for s in news]
        self._count_step(ent.bucket, n)
        return outs, news

    def _run_store_step(self, arrs, recs, bucket=None):
        """The batcher's decode step: the sessions of slot records
        ``recs`` (acquired from the state store) step once together.
        Their states are gathered into the bucket's buffers, the step
        runs, the new states are scattered back, and the outputs come
        back as host arrays of ``len(recs)`` rows. The copy to the host
        waits for the step, so a device fault surfaces here. ``bucket``
        pins the occupancy bucket (at least ``len(recs)``; default the
        smallest that covers it)."""
        n = len(recs)
        bucket = self._bucket_for(n) if bucket is None else int(bucket)
        if bucket not in self.buckets or bucket < n:
            raise MXNetError(f"bucket {bucket} is not a bucket of this "
                             f"session that holds {n} rows")
        store = self.state_store
        with self._lock:
            ent = self._step_bucket(bucket)
            self._load_rows(ent.inputs, arrs, n)
            store.gather(recs, out=ent.states)
            outs, news = self._execute(ent)
            store.scatter(recs, news)
            host = [o[:n].cpu().numpy() for o in outs]
        self._count_step(bucket, n)
        return host

    @staticmethod
    def _count_step(bucket, n):
        METRICS.bump("bucket_execs")
        METRICS.bump("padded_rows", bucket - n)
        METRICS.bump("true_rows", n)

    def step(self, *inputs, states):
        """One decode step with EXPLICIT states: ``(one row-batch of
        inputs, current states) -> (outputs, new states)``, as NDArrays.
        The single-process stateful API (offline decode loops, tests);
        served traffic goes through a stateful ``DynamicBatcher``.
        Occupancy above ``max_batch`` is rejected (a decode step is
        never chunked)."""
        if not self._state_specs:
            raise MXNetError("step() threads state; this session is "
                             "stateless — use predict()")
        arrs, batch = self.validate(*inputs)
        if batch > self.max_batch:
            raise ValueError(f"step occupancy {batch} exceeds max_batch "
                             f"{self.max_batch}")
        svals = self._validate_states(states, batch)
        t0 = time.perf_counter()
        outs, news = self._run_step(arrs, svals, batch)
        self._synchronize()
        METRICS.bump("decode_steps")
        METRICS.observe_batch(batch, time.perf_counter() - t0)
        result = tuple(NDArray(o) for o in outs)
        return (result[0] if len(result) == 1 else result,
                [NDArray(s) for s in news])

    def close(self):
        """Release the state store this session made for itself."""
        if self._owns_store and self.state_store is not None:
            self.state_store.close()

    def __repr__(self):
        return (f"InferenceSession({type(self._block).__name__}, "
                f"inputs={self._input_specs}, buckets={self.buckets}, "
                f"graphs={self.graphs}, device={self.device})")
