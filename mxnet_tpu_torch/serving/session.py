"""InferenceSession: a Block as a stateful decode-serving engine.

The PyTorch counterpart of the stateful half of
``mxnet_tpu/serving/session.py:137-246,1053-1143``. A session built with
``state_store=`` (or ``state_shapes=``) runs the block's decode step

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

Not ported yet: stateless ``predict`` batching, AOT step artifacts and
their disk cache (PyTorch runs eagerly; a CUDA graph is the later tool),
circuit breakers, fault seams and sharded serving.
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
    """Eval-mode, occupancy-bucketed decode step over a Block.

    Parameters
    ----------
    block : gluon.Block
        The model. Parameters must be initialized on the session's
        device, or initializable from one forward over zeros.
    input_shapes : sequence of shape tuples
        Full input shapes INCLUDING a placeholder batch axis, e.g.
        ``[(1, 1)]``; dtype float32 unless ``input_dtypes`` is given.
    input_dtypes : sequence of dtypes, optional
    buckets : sequence of int, optional
        Occupancy buckets (default: powers of two up to ``max_batch``).
    max_batch : int, optional (default 32)
    warm : bool
        Run :meth:`warmup` in the constructor.
    state_shapes / state_dtypes : per-state ROW shapes and dtypes; the
        session then owns a :class:`~.state.SessionStateStore`.
    state_store : SessionStateStore, optional
        Use this store (its shapes and dtypes) instead.
    ctx : Context, optional
        The device the session runs on (default: the current context,
        ``gpu(0)``). It must be the store's device. With no CUDA device
        and no explicit ``cpu()``, construction raises
        :class:`MXNetError`.
    """

    def __init__(self, block, input_shapes, input_dtypes=None, buckets=None,
                 max_batch=None, warm=True, state_shapes=None,
                 state_dtypes=None, state_store=None, ctx=None):
        self._block = block
        self.device = resolve_device(ctx)
        max_batch = int(max_batch or (max(buckets) if buckets else 32))
        if buckets is None:
            buckets = _pow2_buckets(max_batch)
        self.buckets = sorted(int(b) for b in set(buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise MXNetError("buckets must be a non-empty set of positive "
                             f"batch sizes (got {buckets})")
        input_dtypes = input_dtypes or ["float32"] * len(input_shapes)
        self._input_specs = []
        for k, (shape, dt) in enumerate(zip(input_shapes, input_dtypes)):
            if len(shape) < 1:
                raise MXNetError("input_shapes entries must include the "
                                 "batch axis")
            self._input_specs.append(_InputSpec(f"data{k}", shape[1:], dt))
        if state_store is None and state_shapes is None:
            raise MXNetError(
                "the port serves stateful decode only: pass state_store= "
                "or state_shapes= (stateless predict() is not ported yet)")
        self._owns_store = state_store is None
        if state_store is None:
            from .state import SessionStateStore

            state_store = SessionStateStore(
                state_shapes, state_dtypes,
                ctx=Context.from_device(self.device))
        elif state_store.device != self.device:
            raise MXNetError(
                f"state store lives on {state_store.device} but the "
                f"session runs on {self.device}; pass the same ctx= to "
                "both")
        self.state_store = state_store
        self._state_specs = [
            _InputSpec(f"state{i}", s, dt) for i, (s, dt) in enumerate(
                zip(state_store.state_shapes, state_store.state_dtypes))]
        self._num_outputs = None
        self._ensure_initialized()
        if warm:
            self.warmup()

    # -- construction helpers -----------------------------------------

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
        if len(flat) <= n_states:
            raise MXNetError(
                f"stateful forward returned {len(flat)} value(s); expected "
                f"outputs followed by {n_states} new state(s)")
        self._num_outputs = len(flat) - n_states
        flat = [o.data for o in flat]
        return flat[:self._num_outputs], flat[self._num_outputs:]

    def warmup(self, buckets=None):
        """Run one zero step at every occupancy bucket (state store
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
        return True

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
        if self._owns_store:
            self.state_store.close()

    def __repr__(self):
        return (f"InferenceSession({type(self._block).__name__}, "
                f"inputs={self._input_specs}, buckets={self.buckets}, "
                f"device={self.device})")
