"""InferenceSession: a Block as a bucketed serving engine.

The PyTorch counterpart of ``mxnet_tpu/serving/session.py:137-302,
938-1014,1053-1188``. Without states a session serves stateless
:meth:`~InferenceSession.predict`: each request is cut into chunks of at
most ``max_batch`` rows, and each chunk runs the block's forward once,
eagerly, in eval mode under ``torch.inference_mode()``, padded with zero
rows to the smallest **batch bucket** that covers it; the padded rows'
outputs are sliced off. Host (numpy) inputs are padded in numpy and
uploaded once; device inputs are padded on the device
(``kernels/serving_fused.pad_all``). :meth:`InferenceSession.load`
builds a session from an export (``{prefix}-symbol.json`` and
``{prefix}-{epoch:04d}.params``) through ``SymbolBlock.imports``, so
``MXNET_GRAPH_OPT`` and the fusion pass apply to what it serves.

A session built with ``state_store=`` (or ``state_shapes=``) runs the
block's decode step

    forward(*inputs, *states) -> (*outputs, *new_states)

eagerly, in eval mode under ``torch.inference_mode()``, padded to the
smallest **occupancy bucket** that covers the live rows, as the
reference pads to its step executables' buckets. Padding rows are zero
inputs and zero states; they are sliced off before anyone reads them.
:meth:`step` is the single-process API with explicit states;
:class:`~.batcher.DynamicBatcher` drives :meth:`_run_step` with slots
gathered from the session's :class:`~.state.SessionStateStore`.

The port's decoder appends each step's K/V into the cache tensors it is
handed, in place. So the session only ever hands it tensors it owns: a
fresh copy of a caller's explicit states (the caller's tensors are never
written), or the state store's gather output.

Not ported yet: AOT artifacts and their disk cache (PyTorch runs
eagerly; a CUDA graph is the later tool), circuit breakers, fault seams,
sharded sessions and AMP.
"""
from __future__ import annotations

import time

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError
from ..context import Context, resolve_device
from ..ndarray import NDArray
from ..ndarray.ndarray import torch_dtype
from ..kernels import serving_fused as _sf
from .metrics import METRICS

__all__ = ["InferenceSession"]


def _pow2_buckets(max_batch):
    """Powers of two below ``max_batch``, and ``max_batch`` itself: the
    reference's default ``MXNET_SERVING_BUCKETS=pow2`` policy."""
    buckets = {max_batch}
    b = 1
    while b < max_batch:
        buckets.add(b)
        b <<= 1
    return sorted(buckets)


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
        Batch (or occupancy) buckets (default: powers of two up to
        ``max_batch``).
    max_batch : int, optional (default 32)
    warm : bool
        Run :meth:`warmup` in the constructor.
    state_shapes / state_dtypes : per-state ROW shapes and dtypes; the
        session is then stateful and owns a
        :class:`~.state.SessionStateStore`.
    state_store : SessionStateStore, optional
        Use this store (its shapes and dtypes) instead.
    ctx : Context, optional
        The device the session runs on (default: the current context,
        ``gpu(0)``). It must be the store's device. With no CUDA device
        and no explicit ``cpu()``, construction raises
        :class:`MXNetError`.
    """

    def __init__(self, block, example=None, input_shapes=None,
                 input_dtypes=None, buckets=None, max_batch=None, warm=True,
                 state_shapes=None, state_dtypes=None, state_store=None,
                 ctx=None):
        self._block = block
        self.device = resolve_device(ctx)
        max_batch = int(max_batch or (max(buckets) if buckets else 32))
        if buckets is None:
            buckets = _pow2_buckets(max_batch)
        self.buckets = sorted(int(b) for b in set(buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("buckets must be a non-empty set of positive "
                             f"batch sizes (got {buckets})")
        self._input_specs = self._resolve_input_specs(example, input_shapes,
                                                      input_dtypes)
        self._owns_store = False
        self.state_store = None
        self._state_specs = []
        if state_store is not None or state_shapes is not None:
            self._owns_store = state_store is None
            if state_store is None:
                from .state import SessionStateStore

                state_store = SessionStateStore(
                    state_shapes, state_dtypes,
                    ctx=Context.from_device(self.device))
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
        """Run one zero forward (or step) at every bucket (state store
        untouched, metrics not counted). On the card this builds the
        CUDA kernels and brings up cuBLAS before the first request.
        Returns ``{"buckets": [...], "seconds": s}``."""
        t0 = time.perf_counter()
        todo = [int(b) for b in (buckets or self.buckets)]
        for b in todo:
            self._forward(self._zeros(self._input_specs, b),
                          self._zeros(self._state_specs, b))
        self._synchronize()
        return {"buckets": todo, "seconds": time.perf_counter() - t0}

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

    def _owned_padded(self, x, spec, bucket):
        """A fresh device tensor of ``bucket`` rows holding ``x`` (NDArray
        or host array) in its first rows and zeros after."""
        src = x.data if isinstance(x, NDArray) else torch.from_numpy(
            onp.ascontiguousarray(x))
        dst = torch.zeros((bucket,) + spec.row_shape,
                          dtype=torch_dtype(spec.dtype), device=self.device)
        dst[:src.shape[0]].copy_(src)
        return dst

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
        outs, _ = self._forward(datas, [])
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

    def _run_step(self, arrs, states, n, adopted=False):
        """One decode step at occupancy ``n``, padded to its bucket;
        returns ``(outputs, new_states)`` as tensors of ``n`` rows.

        ``adopted=True`` is the batcher's path: ``states`` are the state
        store's gather output, owned by this step, already on the device
        (at ``n`` or at bucket rows). Otherwise ``states`` are a caller's
        explicit states, copied first so the caller's tensors are never
        written."""
        bucket = self._bucket_for(n)
        with torch.inference_mode():
            datas = [self._owned_padded(a, s, bucket)
                     for a, s in zip(arrs, self._input_specs)]
            if adopted:
                sdatas = [s if s.shape[0] == bucket else
                          torch.cat([s, s.new_zeros((bucket - s.shape[0],)
                                                    + s.shape[1:])])
                          for s in states]
            else:
                sdatas = [self._owned_padded(s, spec, bucket)
                          for s, spec in zip(states, self._state_specs)]
        outs, news = self._forward(datas, sdatas)
        METRICS.bump("bucket_execs")
        METRICS.bump("padded_rows", bucket - n)
        METRICS.bump("true_rows", n)
        if bucket != n:
            outs = [o[:n] for o in outs]
            news = [s[:n] for s in news]
        return outs, news

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
                f"device={self.device})")
