"""Bucketed dispatch-as-ready gradient all-reduce.

The PyTorch counterpart of ``mxnet_tpu/pipeline/grad_sync.py`` (DDP-
and horovod-style gradient bucketing). A distributed ``Trainer`` makes
one :class:`AsyncGradReducer` over its parameters and hooks it into
autograd (``autograd.register_grad_ready_hook``): ``backward`` signals
each parameter as it writes its gradient, the gradients fill per-dtype
buckets in the Trainer's parameter order, and a bucket that reaches
``MXNET_GRAD_BUCKET_KB`` bytes starts its all-reduce at once
(``dist.all_reduce(flat, async_op=True)``), so the collective runs
while the host goes on through the rest of ``backward``.

The reductions are speculative. Each records the gradient tensor it
read and that tensor's version counter; ``flush()`` (from
``Trainer.allreduce_grads`` at the step) waits for every dispatched
collective and writes a bucket's sums into a gradient buffer only if
the buffer is still the one it reduced, untouched since (same tensor,
same version). A gradient written again after its dispatch (a second
``backward``, ``grad_req="add"``) or never signalled (a parameter the
backward did not reach) is reduced again at the flush. The sums are
written in place, so a captured fused step reads them.

Buckets fill in parameter order, not in the order the signals come:
every rank issues the same collectives in the same order. The
reduction is elementwise, so the values are bitwise the same with the
reducer on or off and whatever the bucket bounds
(``parallel.all_reduce_coalesced``'s contract). Outside a process group
the reducer is bookkeeping only (the all-reduce is the identity), unless
``reduce_fn`` replaces the collective (tests).
"""
from __future__ import annotations

import torch

from ..telemetry import tracer as _telem
from . import _count, async_grad_sync_enabled, grad_bucket_bytes

__all__ = ["AsyncGradReducer"]


class AsyncGradReducer:
    """Dispatch-as-ready bucketed all-reduce over a parameter group.

    Single-threaded: the hook fires on the thread running ``backward``
    and ``flush()`` on the one running ``step()``, the training loop's
    in both cases."""

    def __init__(self, params, bucket_bytes=None, reduce_fn=None):
        self._params = list(params)
        self._bucket_bytes = bucket_bytes
        self._reduce_fn = reduce_fn
        self._order = {}        # id(param._ndarray) -> position
        self._unhook = None
        self._round_enabled = None  # the knob, read once a round
        self._reset_round()

    def _reset_round(self):
        self._ready = set()     # positions signalled this round
        self._cursor = 0        # next position to enter a bucket
        self._pending = {}      # (dtype, device) -> [grad NDArray]
        self._pending_bytes = {}
        self._inflight = []     # work handles of dispatched buckets
        self._spec = {}         # id(grad) -> (tensor, version, view)

    # -- wiring -------------------------------------------------------------

    def attach(self):
        """Register the grad-ready hook (idempotent). The hook holds this
        reducer only weakly: a dropped trainer unhooks at the next
        backward."""
        if self._unhook is None:
            import weakref

            from .. import autograd

            self._refresh_index()
            ref = weakref.ref(self)
            handle = []

            def hook(arr):
                r = ref()
                if r is None:
                    handle[0]()
                else:
                    r._on_grad_ready(arr)

            handle.append(autograd.register_grad_ready_hook(hook))
            self._unhook = handle[0]
        return self

    def detach(self):
        if self._unhook is not None:
            self._unhook()
            self._unhook = None

    def _refresh_index(self):
        live = [p for p in self._params
                if getattr(p, "_ndarray", None) is not None
                and p.grad_req != "null"]
        self._live = live
        self._order = {id(p._ndarray): i for i, p in enumerate(live)}

    # -- dispatch as ready --------------------------------------------------

    def _on_grad_ready(self, arr):
        if self._round_enabled is None:
            self._round_enabled = async_grad_sync_enabled()
            if self._round_enabled:
                self._refresh_index()  # parameters may have materialized
        if not self._round_enabled:
            return
        pos = self._order.get(id(arr))
        if pos is None or pos < self._cursor:
            return
        self._ready.add(pos)
        cap = self._bucket_bytes if self._bucket_bytes is not None \
            else grad_bucket_bytes()
        while self._cursor in self._ready:
            g = self._live[self._cursor]._ndarray._grad
            self._cursor += 1
            if not self._reducible(g):
                continue
            t = g._data
            key = (t.dtype, t.device)
            self._pending.setdefault(key, []).append(g)
            size = self._pending_bytes.get(key, 0) + \
                t.numel() * t.element_size()
            self._pending_bytes[key] = size
            if size >= cap:
                self._dispatch(key)
                _count("grad_buckets")

    @staticmethod
    def _reducible(g):
        """Whether the buckets take ``g``: a dense gradient (a sparse one
        stays on the Trainer's per-tensor path, as in the JAX package's
        ``pipeline/grad_sync.py:135``)."""
        from ..ndarray import sparse as _sp

        return g is not None and not isinstance(g, _sp.BaseSparseNDArray)

    def _dispatch(self, key):
        from .. import _rendezvous
        from ..parallel import spmd
        from ..resilience import faults as _faults

        bucket = self._pending.pop(key, [])
        self._pending_bytes.pop(key, None)
        if not bucket:
            return False
        # a failed collective during backward: raised with the bucket
        # already popped, the state a real failure leaves; abandon()
        # recovers
        _faults.maybe_fail("grad_bucket_dispatch")
        tensors = [g._data for g in bucket]
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        with _telem.span("pipeline.grad_bucket", cat="pipeline",
                         grads=len(bucket), bytes=nbytes):
            if self._reduce_fn is None and \
                    not _rendezvous.is_initialized():
                views = [None] * len(tensors)  # the identity
            else:
                flat = spmd.flatten(tensors)
                if self._reduce_fn is not None:
                    flat = self._reduce_fn(flat)
                else:
                    self._inflight.append(spmd.all_reduce_async(flat))
                views = spmd.unflatten(flat, tensors)
        for g, t, v in zip(bucket, tensors, views):
            self._spec[id(g)] = (t, t._version, v)
        _count("grad_bucket_bytes", nbytes)
        _count("grad_async_grads", len(bucket))
        return True

    def _wait(self):
        inflight, self._inflight = self._inflight, []
        for work in inflight:
            work.wait()

    def abandon(self):
        """Drop the round without binding anything: the dispatched
        collectives are waited for (every rank issued them) and their
        sums discarded; the gradients themselves were never written. Also
        re-reads the knob at the next backward."""
        self._wait()
        self._reset_round()
        self._round_enabled = None

    # -- the flush at the step ----------------------------------------------

    def flush(self, grads):
        """Finish the round: dispatch the partial buckets, wait for every
        collective, then write each gradient of ``grads`` (NDArrays) its
        sum: the speculative one where the buffer is untouched since its
        dispatch, a fresh reduction otherwise. Returns how many were
        reduced afresh."""
        from .. import parallel

        for key in list(self._pending):
            if self._dispatch(key):
                _count("grad_flush_buckets")
        self._wait()
        spec = self._spec
        self._reset_round()
        self._round_enabled = None
        todo = []
        with torch.no_grad():
            for g in grads:
                ent = spec.get(id(g))
                if ent is not None and g._data is ent[0] and \
                        g._data._version == ent[1]:
                    if ent[2] is not None:
                        g._data.copy_(ent[2])
                    continue
                if ent is not None:
                    _count("grad_stale_discards")
                todo.append(g)
            if todo:
                with _telem.span("pipeline.grad_flush", cat="pipeline",
                                 grads=len(todo)):
                    reduced = parallel.all_reduce_coalesced(
                        [g._data for g in todo], reduce_fn=self._reduce_fn)
                for g, r in zip(todo, reduced):
                    if r is not g._data:
                        g._data.copy_(r)
                _count("grad_flush_grads", len(todo))
        return len(todo)
