"""Continuous batching of decode steps over a stateful InferenceSession.

The PyTorch counterpart of the stateful half of
``mxnet_tpu/serving/batcher.py:204-296,627-819``. Each ``submit`` is ONE
decode step of the stream named by ``session_id``; a single step-loop
thread keeps per-session FIFO queues and, between decode steps,
re-forms the executing batch from the head step of every live session:
streams JOIN the batch the moment they arrive and LEAVE the moment
their queue empties. One fused step per iteration: acquire each
stream's slot in the session's :class:`~.state.SessionStateStore`,
gather the slots, run the occupancy-bucket step, scatter the new states
back, release the slots, resolve each step's future with its output row
as host numpy.

Failure isolation: a failure tied to one session (an evicted slot, a
full pool) rejects only that session's future; a failure of the step
itself rejects every member of that step and leaves every state at its
last completed step. A step that outlives its deadline (``timeout_ms``)
fails with :class:`RequestTimeout` without executing; its session state
stays put, so it can be retried.

``close()`` drains every accepted step to its boundary; a submit after
close runs inline. SLO classes, admission control and telemetry come
with a later slice.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as onp

from ..base import MXNetError
from ..ndarray import NDArray
from .metrics import METRICS

__all__ = ["DynamicBatcher", "ServerBusy", "RequestTimeout"]


class ServerBusy(MXNetError):
    """The request queue or the state pool is full; retry later."""


class RequestTimeout(MXNetError):
    """The request outlived its deadline before execution."""


_STOP = object()  # queue sentinel, put once at close()


class _Request:
    __slots__ = ("arrs", "future", "t_submit", "deadline", "session_id")

    def __init__(self, arrs, deadline, session_id):
        self.arrs = arrs  # list of host arrays, one row each
        self.future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline
        self.session_id = session_id

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline


def _env_float(name, default):
    raw = os.environ.get(name)
    return float(raw) if raw not in (None, "") else default


class DynamicBatcher:
    """Continuous batcher over a stateful InferenceSession.

    Parameters (defaults from their ``MXNET_SERVING_*`` knobs)
    ----------
    session : a stateful InferenceSession (``state_store=`` or
        ``state_shapes=``)
    max_batch_size : int — most sessions in one step (capped at the
        session's ``max_batch``; default 32)
    max_latency_ms : float — how long an under-occupied step waits for
        joiners, from its oldest member's submit (default 5)
    max_queue : int — bound on queued steps (default 256)
    timeout_ms : float — per-step deadline; <= 0 disables (default 2000)
    admission : None or False — SLO admission control is not ported
        yet; ``True`` raises
    """

    def __init__(self, session, max_batch_size=None, max_latency_ms=None,
                 max_queue=None, timeout_ms=None, admission=None):
        if not getattr(session, "stateful", False):
            raise MXNetError("DynamicBatcher needs a stateful session "
                             "(state_store= or state_shapes=); stateless "
                             "batching is not ported yet")
        if admission:
            raise MXNetError("admission control is not ported yet; pass "
                             "admission=False")
        self.session = session
        self._max_batch = min(
            int(max_batch_size or _env_float("MXNET_SERVING_MAX_BATCH", 32)),
            int(session.max_batch))
        self._max_latency_s = float(
            max_latency_ms if max_latency_ms is not None else
            _env_float("MXNET_SERVING_MAX_LATENCY_MS", 5.0)) / 1e3
        self._timeout_s = float(
            timeout_ms if timeout_ms is not None else
            _env_float("MXNET_SERVING_TIMEOUT_MS", 2000.0)) / 1e3
        self._queue = queue.Queue(int(
            max_queue or _env_float("MXNET_SERVING_QUEUE_DEPTH", 256)))
        # guards: _closed
        self._lock = threading.Lock()
        self._closed = False
        # continuous batching is a single-scheduler discipline: one
        # step-loop thread owns batch membership, which is what makes
        # session affinity hold by construction
        self._worker = threading.Thread(target=self._step_loop,
                                        name="mxnet-serving-step-loop",
                                        daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------

    def submit(self, *inputs, session_id=None, timeout_ms=None):
        """Validate and enqueue one decode step of ``session_id`` (one
        row per input); returns a ``concurrent.futures.Future`` resolving
        to the step's output row(s) as host numpy arrays. Validation
        failures raise ``ValueError`` here; a full queue raises
        :class:`ServerBusy`. After ``close()`` the step runs inline."""
        METRICS.bump("requests")
        try:
            if session_id is None:
                raise ValueError("stateful serving: submit needs "
                                 "session_id= (one decode step of one "
                                 "session)")
            arrs, rows = self.session.validate(*inputs)
            if rows != 1:
                raise ValueError(
                    f"stateful serving: one decode step is one row (got "
                    f"{rows}); stream steps, not batches")
            arrs = [a.asnumpy() if isinstance(a, NDArray)
                    else onp.asarray(a) for a in arrs]
        except ValueError:
            METRICS.bump("invalid")
            raise
        t = self._timeout_s if timeout_ms is None else \
            float(timeout_ms) / 1e3
        req = _Request(arrs, time.monotonic() + t if t > 0 else None,
                       str(session_id))
        with self._lock:
            inline = self._closed
            if not inline:
                try:
                    self._queue.put_nowait(req)
                except queue.Full:
                    METRICS.bump("rejected")
                    raise ServerBusy(
                        f"serving queue full ({self._queue.maxsize} "
                        "steps); backpressure — retry later") from None
        if inline:
            METRICS.bump("inline")
            self._execute_step_batch([req])
        return req.future

    # -- the step loop -------------------------------------------------

    def _step_loop(self):
        """Between decode steps, re-form the batch from the HEAD step
        of every live session. Per-session FIFO queues keep each
        stream's steps in order; one head per session per step keeps a
        stream from ever sharing a step with itself."""
        pending = {}  # session_id -> deque[_Request] (FIFO per stream)
        arrival = deque()  # session_ids in join order
        stop = False

        def admit(item):
            nonlocal stop
            if item is _STOP:
                stop = True
                return
            q = pending.get(item.session_id)
            if q is None:
                pending[item.session_id] = q = deque()
                arrival.append(item.session_id)
            q.append(item)

        while True:
            while True:  # joiners enter without blocking
                try:
                    admit(self._queue.get_nowait())
                except queue.Empty:
                    break
            if not pending:
                if stop:
                    return
                try:
                    admit(self._queue.get(timeout=0.05))
                except queue.Empty:
                    pass
                continue
            # the batch: each live session's head step, failing expired
            # heads first (their session state stays put)
            heads = []
            now = time.monotonic()
            for sid in list(arrival):
                q = pending[sid]
                while q and q[0].expired(now):
                    self._fail_timeout(q.popleft())
                if not q:
                    del pending[sid]
                    arrival.remove(sid)
                else:
                    heads.append(q[0])
            if not heads:
                continue
            heads = heads[:self._max_batch]
            # coalescing window: an under-occupied step waits for
            # joiners until its oldest member's flush time (or deadline
            # less the expected step time), unless every live session
            # already has its head aboard
            if (not stop and len(heads) < self._max_batch
                    and len(heads) < len(pending)):
                margin = METRICS.exec_estimate_s()
                flush_at = min(
                    r.t_submit + self._max_latency_s if r.deadline is None
                    else min(r.t_submit + self._max_latency_s,
                             r.deadline - margin)
                    for r in heads)
                remaining = flush_at - time.monotonic()
                if remaining > 0:
                    try:
                        admit(self._queue.get(timeout=remaining))
                        continue  # re-form with the joiner aboard
                    except queue.Empty:
                        pass
            self._execute_step_batch(heads)
            for r in heads:
                q = pending.get(r.session_id)
                if q and q[0] is r:
                    q.popleft()
                if q is not None and not q:
                    del pending[r.session_id]
                    arrival.remove(r.session_id)

    def _reject(self, r, err):
        if r.future.set_running_or_notify_cancel():
            r.future.set_exception(err)
        METRICS.observe_request(failed=True)

    def _execute_step_batch(self, batch):
        """One fused decode step over the batch's sessions. A failure
        at acquire rejects that one session's future; a failure of the
        step rejects every live member and releases the slots
        un-stepped, so each state still describes its last completed
        step."""
        store = self.session.state_store
        live, recs = [], []
        for r in batch:
            try:
                if not store.has(r.session_id):
                    store.open_for_step(r.session_id)
                recs.append(store.acquire(r.session_id))
                live.append(r)
            except Exception as e:  # noqa: BLE001 — delivered per future
                self._reject(r, e)
        if not live:
            return
        t0 = time.perf_counter()
        try:
            arrs = [onp.concatenate([r.arrs[i] for r in live], axis=0)
                    for i in range(len(live[0].arrs))]
            states = store.gather(
                recs, pad_to=self.session._bucket_for(len(live)))
            outs, news = self.session._run_step(arrs, states, len(live),
                                                adopted=True)
            store.scatter(recs, news)
            # one device->host copy per output; it also waits for the
            # step, so a device fault surfaces here
            host = [o.cpu().numpy() for o in outs]
        except Exception as e:  # noqa: BLE001 — delivered per future
            logging.exception("serving: decode step failed for %d "
                              "session(s)", len(live))
            for rec in recs:
                store.release(rec, stepped=False)
            for r in live:
                self._reject(r, e)
            return
        for rec in recs:
            store.release(rec)
        METRICS.bump("decode_steps")
        METRICS.observe_batch(len(live), time.perf_counter() - t0)
        for i, r in enumerate(live):
            rows = tuple(h[i:i + 1] for h in host)
            if r.future.set_running_or_notify_cancel():
                r.future.set_result(rows[0] if len(rows) == 1 else rows)
            METRICS.observe_request()

    def _fail_timeout(self, req):
        if req.future.set_running_or_notify_cancel():
            budget_ms = (req.deadline - req.t_submit) * 1e3
            req.future.set_exception(RequestTimeout(
                f"request expired after {budget_ms:.0f} ms in queue"))
        METRICS.observe_request(failed=True, timed_out=True)

    # -- lifecycle -----------------------------------------------------

    def close(self):
        """Stop accepting queued work, run every accepted step to its
        boundary, join the step loop. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_STOP)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
