"""DeviceFeed: batches staged on the device ahead of the step.

The PyTorch counterpart of ``mxnet_tpu/pipeline/device_feed.py:75-330``
(reference: src/io/iter_prefetcher.h:142). It wraps any batch source —
an ``io`` DataIter, a gluon ``DataLoader``, a plain iterable — and:

- pulls batches on a worker thread, so the host's decode, augment and
  batchify run beside the step;
- stages every array leaf (host NDArray, torch tensor or numpy array)
  onto the device with a ``non_blocking`` copy from pinned memory on a
  side stream of its own, records an event on that stream, and waits
  for it on the worker before it pulls the next batch (a source may
  refill the memory it handed out);
- at ``next()``, makes the consumer's current stream wait on that event
  before it reads the batch, and ``record_stream``-s each staged tensor
  onto the consumer's stream, so the caching allocator does not hand
  its memory to another allocation while the consumer's work on it is
  still queued;
- holds at most ``depth`` staged batches in its queue (one more may be
  mid-staging on the worker), so prefetch cannot fill the card;
- re-raises a source's exception in the consumer at ``next()``; and
  ``close()``/``reset()`` drain a worker blocked on the full queue;
- with ``depth=0`` (or ``MXNET_DEVICE_PREFETCH=0``) stages inline on the
  caller's thread and stream: no thread, no queue.

A leaf already on the device passes through; on a CPU ``device`` the
leaves become host NDArrays. Under ``MXNET_TELEMETRY>=1`` the staging
is a ``pipeline.prefetch_stage`` span on the feed's thread and each
``next()``'s wait a ``pipeline.feed_wait`` span, as in the JAX package;
the counters are the ``pipeline`` family. The fault seam ``device_put``
fires in the staging.
"""
from __future__ import annotations

import queue as _queue
import threading
import time

import numpy as onp
import torch

from ..context import resolve_device
from ..ndarray import NDArray
from ..ndarray.ndarray import host_tensor
from ..resilience import faults as _faults
from ..telemetry import tracer as _telem
from . import _count, _count_set, prefetch_depth

__all__ = ["DeviceFeed"]

# end-of-stream marker: an object of its own, not None, so a source that
# yields None shows as a None batch rather than a short epoch
_END = object()


class _Raised:
    """A source exception on its way to the consumer (distinct from a
    batch that happens to be an exception object)."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _Epoch:
    """One pass's worker state: queue, stop flag and thread, so a worker
    from before a reset can never deliver into the next pass."""

    __slots__ = ("q", "stop", "thread")

    def __init__(self, depth):
        self.q = _queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.thread = None


class _Staged:
    """A staged batch, the event its copies end with and its tensors."""

    __slots__ = ("batch", "event", "tensors")

    def __init__(self, batch, event, tensors):
        self.batch, self.event, self.tensors = batch, event, tensors


class DeviceFeed:
    """Prefetching device-feed iterator (see the module docstring).

    ``for batch in feed`` mirrors ``for batch in source`` with every
    array leaf on ``device`` (default: the current context, the card).
    A finished or failed pass re-arms on the next ``iter()``; call
    ``feed.reset()`` to rewind a DataIter source too."""

    def __init__(self, source, depth=None, device=None):
        self.source = source
        self.batch_size = getattr(source, "batch_size", None)
        self._depth = prefetch_depth() if depth is None \
            else max(0, int(depth))
        self._device = resolve_device(device)
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" and self._depth > 0 else None
        self._epoch = None
        self._sync_it = None
        self._finished = False
        self._t_first = None
        _count_set("prefetch_depth", self._depth)

    # -- staging ---------------------------------------------------------

    def _stage_leaf(self, x, tensors):
        _faults.maybe_fail("device_put")
        if isinstance(x, NDArray):
            t = x.data
        elif isinstance(x, torch.Tensor):
            t = x
        elif isinstance(x, onp.ndarray):
            t = host_tensor(onp.array(x))  # a copy: the source may reuse x
        else:
            return x
        if t.device == self._device:
            return NDArray(t)
        if self._device.type == "cuda":
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            t = t.to(self._device, non_blocking=True)
            tensors.append(t)
            return NDArray(t)
        return NDArray(t.to(self._device))

    def _stage(self, item, tensors):
        """``_stage_leaf`` over the batch's structure (DataBatch, list,
        tuple, dict or a bare array), keeping the container."""
        from ..io.io import DataBatch

        if isinstance(item, DataBatch):
            return DataBatch(
                data=[self._stage_leaf(d, tensors) for d in item.data or []],
                label=[self._stage_leaf(lb, tensors)
                       for lb in item.label or []],
                pad=item.pad, index=item.index, bucket_key=item.bucket_key,
                provide_data=item.provide_data,
                provide_label=item.provide_label)
        if isinstance(item, (list, tuple)):
            return type(item)(self._stage(v, tensors) for v in item)
        if isinstance(item, dict):
            return {k: self._stage(v, tensors) for k, v in item.items()}
        return self._stage_leaf(item, tensors)

    def _stage_async(self, item):
        """Stage ``item`` on the feed's side stream; the copies end with
        the returned item's event."""
        tensors = []
        if self._stream is None:
            return _Staged(self._stage(item, tensors), None, tensors)
        with torch.cuda.stream(self._stream):
            batch = self._stage(item, tensors)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(batch, event, tensors)

    def _hand_over(self, staged):
        """Order the consumer's stream after the batch's copies and tie
        the staged memory to that stream."""
        if staged.event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(staged.event)
            for t in staged.tensors:
                t.record_stream(consumer)
        return staged.batch

    # -- worker ----------------------------------------------------------

    @staticmethod
    def _put(ep, item):
        """A bounded put that ``close()`` can always unblock; False when
        stopped before the item landed."""
        while not ep.stop.is_set():
            try:
                ep.q.put(item, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def _worker(self, ep):
        try:
            for batch in self.source:
                if ep.stop.is_set():
                    return
                # its own lane in the trace: staging runs on the feed's
                # thread, beside the consumer's step spans; the span ends
                # before the wait on the copies below
                with _telem.span("pipeline.prefetch_stage",
                                 cat="pipeline"):
                    staged = self._stage_async(batch)
                if staged.event is not None:
                    # the copies read the source's memory: let them land
                    # before the source may refill it with the next batch
                    staged.event.synchronize()
                if not self._put(ep, staged):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._put(ep, _Raised(e))
        finally:
            self._put(ep, _END)

    def _start(self):
        ep = _Epoch(self._depth)
        ep.thread = threading.Thread(target=self._worker, args=(ep,),
                                     daemon=True, name="device-feed")
        self._epoch = ep
        self._finished = False
        self._t_first = None
        ep.thread.start()

    # -- iteration -------------------------------------------------------

    def __iter__(self):
        if self._finished:
            self.close()  # the last pass ended: re-arm a fresh one
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        if self._depth <= 0:
            return self._next_sync()
        if self._epoch is None:
            self._start()
        ep = self._epoch
        t0 = time.perf_counter()
        if self._t_first is None:
            self._t_first = t0
        stalled = ep.q.empty()
        tm0 = time.monotonic() if _telem.tracing() else 0.0
        item = ep.q.get()
        if tm0:
            _telem.emit_span("pipeline.feed_wait", "pipeline", tm0,
                             time.monotonic(), stalled=stalled)
        wait = time.perf_counter() - t0
        if item is _END:
            self._end_pass()
            raise StopIteration
        if isinstance(item, _Raised):
            _count("feed_errors")
            self._end_pass()
            raise item.exc
        if stalled:
            _count("prefetch_stalls")
            _count("prefetch_stall_s", wait)
        else:
            _count("prefetch_hits")
        _count("prefetch_batches")
        return self._hand_over(item)

    next = __next__

    def _next_sync(self):
        """depth 0: pull and stage inline, on the caller's stream."""
        if self._sync_it is None:
            self._sync_it = iter(self.source)
            self._t_first = time.perf_counter()
        try:
            item = self._stage(next(self._sync_it), [])
        except StopIteration:
            self._end_pass()
            raise
        return item

    def _end_pass(self):
        if self._t_first is not None:
            _count("feed_active_s", time.perf_counter() - self._t_first)
            self._t_first = None
        self._finished = True
        self._epoch = None
        self._sync_it = None

    # -- lifecycle -------------------------------------------------------

    def close(self):
        """Stop and join the worker, dropping staged batches. Idempotent,
        safe mid-pass (a worker blocked on the full queue is drained) and
        from ``__del__``."""
        ep = self._epoch
        self._epoch = None
        self._sync_it = None
        if self._t_first is not None:
            _count("feed_active_s", time.perf_counter() - self._t_first)
            self._t_first = None
        self._finished = False
        if ep is None:
            return
        ep.stop.set()
        while ep.thread.is_alive():  # each get frees a slot
            try:
                ep.q.get(timeout=0.1)
            except _queue.Empty:
                pass
        ep.thread.join()

    def reset(self):
        """DataIter-style rewind: drain the worker, reset the source; the
        next ``next()`` starts a new pass."""
        self.close()
        reset = getattr(self.source, "reset", None)
        if reset is not None:
            reset()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — a finalizer must not raise
            pass

    def __len__(self):
        return len(self.source)
