"""Dynamic batching over an InferenceSession, with SLO classes.

The PyTorch counterpart of ``mxnet_tpu/serving/batcher.py``. Requests
land on per-SLO-class priority lanes (:class:`_ClassQueues`: ``critical``
before ``standard`` before ``best_effort``, each lane bounded on its
own; a full lane raises :class:`ServerBusy`). An
:class:`~.admission.AdmissionController` may shed sheddable classes at
``submit`` before they take a queue slot.

Two disciplines, chosen by the session:

- **Stateless** (``predict`` sessions): workers pop the highest lane,
  coalesce requests until ``max_batch_size`` rows or the oldest
  request's ``max_latency_ms`` (never past the earliest member deadline
  less the execution estimate), run ONE ``session.predict`` over the
  concatenated rows and slice each request's rows back.
- **Stateful** (decode sessions, ``state_store=``): each ``submit`` is
  ONE decode step of the stream named by ``session_id``. A single
  step-loop thread keeps per-session FIFO queues and, between steps,
  re-forms the batch from the head step of every live session: streams
  JOIN the moment they arrive and LEAVE when their queue empties. Under
  contention higher classes win membership. Each step acquires the
  streams' slots, runs the session's store step (gather, the bucket's
  step, scatter), releases the slots and resolves each future with its
  output row as host numpy.

Failure isolation: a malformed request fails alone at ``submit``
(``ValueError``); a failure tied to one session (an evicted slot, a full
pool) rejects only that session's future; a failure of the step itself
rejects every member and leaves every state at its last completed step.
A request that outlives its deadline fails with :class:`RequestTimeout`
without executing (its session state stays put, so it can be retried).

``close()`` stops accepting queued work, drains every accepted request
to its boundary and joins the workers; afterwards, or with
``MXNET_SERVING=0``, ``submit`` runs inline. The session-state
checkpoint at close comes with slice 9b.

Telemetry (``MXNET_TELEMETRY>=1``), with the JAX batcher's names: a
request's ``serving.admission`` span on the submitting thread, then on
the worker ``serving.coalesce``, one ``serving.queue_wait`` per member,
``serving.pad``, ``serving.execute`` and ``serving.respond`` (stateless)
or ``serving.decode_step`` (stateful), and the instant
``serving.timeout``. Each request carries the trace id current at
``submit`` across the queue, so its spans share one trace id. The
execute and decode-step spans end with the host copy of the outputs
the batcher makes anyway; no span adds a wait on the card.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as onp

from ..base import MXNetError, getenv
from ..ndarray import NDArray
from ..utils import locks as _locks
from ..telemetry import tracer as _telem
from .metrics import METRICS, SLO_CLASSES

__all__ = ["DynamicBatcher", "ServerBusy", "RequestTimeout"]


class ServerBusy(MXNetError):
    """The request queue or the state pool is full; retry later (HTTP
    503)."""


class RequestTimeout(MXNetError):
    """The request outlived its deadline before execution (HTTP 504)."""


_STOP = object()  # queue sentinel, one per worker at close()


class _Request:
    __slots__ = ("arrs", "rows", "future", "t_submit", "deadline",
                 "slo_class", "session_id", "trace_id")

    def __init__(self, arrs, rows, deadline, slo_class="standard",
                 session_id=None):
        self.arrs = arrs  # list of host arrays, one per session input
        self.rows = rows
        self.future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline
        self.slo_class = slo_class
        self.session_id = session_id  # stateful: one step of this stream
        # the trace id crosses the queue with the request: submit runs on
        # the caller's thread (inside the HTTP layer's trace_context),
        # the batch on a worker
        self.trace_id = _telem.current_trace_id()

    def expired(self, now=None):
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) > self.deadline


class _ClassQueues:
    """Per-SLO-class priority lanes behind one condition variable.

    The slice of the ``queue.Queue`` API the batcher uses (``put`` /
    ``put_nowait`` / ``get`` / ``get_nowait`` / ``qsize`` / ``maxsize``,
    raising ``queue.Full`` / ``queue.Empty``), but ``get`` pops the
    highest-priority non-empty lane, each lane is bounded on its own
    (``maxsize`` per class: a best-effort flood never crowds critical
    requests out), and ``_STOP`` sentinels ride an unbounded control
    lane delivered only once every data lane is empty — so ``close()``
    drains all accepted work, whatever its class."""

    __slots__ = ("maxsize", "_order", "_lanes", "_ctrl", "_cond")

    def __init__(self, maxsize, classes=SLO_CLASSES):
        self.maxsize = int(maxsize)
        self._order = {c: i for i, c in enumerate(classes)}
        self._lanes = [deque() for _ in classes]
        self._ctrl = deque()
        # guards: _lanes, _ctrl
        self._cond = _locks.RankedCondition("batcher.queue")

    def _lane_locked(self, item):
        cls = getattr(item, "slo_class", "standard")
        return self._lanes[self._order.get(cls, 1)]

    def put(self, item, timeout=None):
        """Append to the item's class lane; ``timeout=None`` blocks,
        ``timeout=0`` is the non-blocking put."""
        with self._cond:
            if item is _STOP:
                self._ctrl.append(item)
                self._cond.notify_all()
                return
            lane = self._lane_locked(item)
            deadline = None if timeout is None else \
                time.monotonic() + timeout
            while len(lane) >= self.maxsize:
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise queue.Full
                    self._cond.wait(remaining)
            lane.append(item)
            self._cond.notify_all()

    def put_nowait(self, item):
        self.put(item, timeout=0)

    def get(self, timeout=None):
        """Pop the highest-priority non-empty lane; sentinels only when
        every data lane is empty."""
        with self._cond:
            deadline = None if timeout is None else \
                time.monotonic() + timeout
            while True:
                for lane in self._lanes:
                    if lane:
                        item = lane.popleft()
                        self._cond.notify_all()
                        return item
                if self._ctrl:
                    return self._ctrl.popleft()
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise queue.Empty
                    self._cond.wait(remaining)

    def get_nowait(self):
        return self.get(timeout=0)

    def qsize(self):
        with self._cond:
            return sum(len(lane) for lane in self._lanes)

    def qsize_by_class(self):
        with self._cond:
            return {c: len(self._lanes[i]) for c, i in self._order.items()}

    def capacity(self):
        return self.maxsize * len(self._lanes)


class DynamicBatcher:
    """Bounded-queue dynamic batcher over an InferenceSession.

    Parameters (defaults from their ``MXNET_SERVING_*`` knobs)
    ----------
    session : InferenceSession (or any object with ``validate`` /
        ``predict`` and a ``max_batch`` property); a stateful session
        gets the continuous-batching step loop
    max_batch_size : int — rows per execution (capped at the session's
        ``max_batch``; default 32)
    max_latency_ms : float — how long a forming batch waits for company,
        from its oldest member's submit (default 5)
    max_queue : int — bound on queued requests PER SLO class (default
        256)
    timeout_ms : float — default per-request deadline; <= 0 disables
        (default 2000)
    num_workers : int — batch-forming threads of a stateless batcher
        (default 1; a stateful one always has one step loop)
    admission : bool | None — SLO admission control (None reads
        ``MXNET_SERVING_ADMISSION``, default on)
    """

    def __init__(self, session, max_batch_size=None, max_latency_ms=None,
                 max_queue=None, timeout_ms=None, num_workers=None,
                 admission=None):
        from . import serving_enabled

        self.session = session
        self._stateful = bool(getattr(session, "stateful", False))
        self._max_batch = int(max_batch_size or getenv(
            "MXNET_SERVING_MAX_BATCH", 32, int))
        sess_max = getattr(session, "max_batch", None)
        if sess_max:
            self._max_batch = min(self._max_batch, int(sess_max))
        self._max_latency_s = float(
            max_latency_ms if max_latency_ms is not None else
            getenv("MXNET_SERVING_MAX_LATENCY_MS", 5.0, float)) / 1e3
        self._timeout_s = float(
            timeout_ms if timeout_ms is not None else
            getenv("MXNET_SERVING_TIMEOUT_MS", 2000.0, float)) / 1e3
        nworkers = 1 if self._stateful else int(
            num_workers or getenv("MXNET_SERVING_WORKERS", 1, int))
        self._queue = _ClassQueues(int(
            max_queue or getenv("MXNET_SERVING_QUEUE_DEPTH", 256, int)))
        # guards: _closed, _outstanding
        self._lock = _locks.RankedCondition("batcher")
        self._closed = False
        self._outstanding = 0  # queued requests not yet resolved
        self._pass_through = not serving_enabled()
        self._admission = None
        self._workers = []
        if not self._pass_through:
            from .admission import AdmissionController

            self._admission = AdmissionController(self, enabled=admission)
            # continuous batching is a single-scheduler discipline: one
            # step-loop thread owns batch membership, which is what
            # makes session affinity hold by construction
            loop = self._step_loop if self._stateful else self._worker_loop
            for i in range(max(nworkers, 1)):
                t = threading.Thread(target=loop,
                                     name=f"mxnet-serving-batcher-{i}",
                                     daemon=True)
                t.start()
                self._workers.append(t)
        self._depth_token = METRICS.register_depth_probe(
            self._queue.qsize)

    # -- client side ---------------------------------------------------

    def submit(self, *inputs, timeout_ms=None, block=False,
               slo_class=None, session_id=None):
        """Validate and enqueue one request; returns a
        ``concurrent.futures.Future`` resolving to the request's output
        rows as host numpy arrays (one array, or a tuple for
        multi-output models). Validation failures raise ``ValueError``
        here. ``slo_class`` is one of :data:`SLO_CLASSES` (default
        "standard"); when SLO headroom says the protected class is at
        risk, sheddable classes raise :class:`~.admission.ShedLoad`
        before taking a queue slot. A full class lane raises
        :class:`ServerBusy` (or blocks with ``block=True``). After
        ``close()`` / under ``MXNET_SERVING=0`` the request runs inline.

        Stateful batchers: every submit is ONE decode step of the
        stream ``session_id`` (required, one row); the future resolves
        to that step's output row(s), and a reclaimed slot rejects with
        :class:`~.state.SessionEvicted` on exactly this stream."""
        # the lifecycle's first span: validation, admission and the
        # queue put on the caller's thread; a rejection is its error
        if not _telem.tracing():
            return self._submit_inner(inputs, timeout_ms, block,
                                      slo_class, session_id)
        t0 = time.monotonic()
        attrs = {"slo_class": slo_class or "standard"}
        try:
            return self._submit_inner(inputs, timeout_ms, block,
                                      slo_class, session_id)
        except Exception as e:
            attrs["error"] = type(e).__name__
            raise
        finally:
            _telem.emit_span("serving.admission", "serving", t0,
                             time.monotonic(), **attrs)

    def _submit_inner(self, inputs, timeout_ms, block, slo_class,
                      session_id):
        from .admission import normalize_class

        cls = normalize_class(slo_class)
        METRICS.bump("requests")
        METRICS.bump_class("requests", cls)
        try:
            if self._stateful:
                if session_id is None:
                    raise ValueError("stateful serving: submit needs "
                                     "session_id= (one decode step of one "
                                     "session)")
            elif session_id is not None:
                raise ValueError("session_id= requires a stateful "
                                 "session (state_shapes=)")
            arrs, rows = self.session.validate(*inputs)
            if self._stateful and rows != 1:
                raise ValueError(
                    f"stateful serving: one decode step is one row (got "
                    f"{rows}); stream steps, not batches")
            arrs = [a.asnumpy() if isinstance(a, NDArray)
                    else onp.asarray(a) for a in arrs]
        except ValueError:
            METRICS.bump("invalid")
            raise
        if rows > self._max_batch:
            METRICS.bump("invalid")
            raise ValueError(f"request batch {rows} exceeds max_batch_size "
                             f"{self._max_batch}; split the request")
        t = self._timeout_s if timeout_ms is None else \
            float(timeout_ms) / 1e3
        req = _Request(arrs, rows, time.monotonic() + t if t > 0 else None,
                       cls, None if session_id is None else str(session_id))
        with self._lock:
            inline = self._closed or self._pass_through
        if inline:
            METRICS.bump("inline")
            self._run_inline(req)
            return req.future
        if self._admission is not None:
            # a step that must ALLOCATE a state slot competes for pool
            # space; steps of live sessions never pay the slot term
            allocates = self._stateful and \
                not self.session.state_store.has(req.session_id)
            self._admission.check(cls, allocates_state=allocates)
        with self._lock:
            self._outstanding += 1
        try:
            if block:
                # bounded waits that re-check _closed: a blocking put on
                # a full queue whose consumers close() just joined would
                # otherwise wait forever
                while True:
                    try:
                        self._queue.put(req, timeout=0.05)
                        break
                    except queue.Full:
                        with self._lock:
                            closed = self._closed
                        if closed:
                            self._settle(1)
                            METRICS.bump("inline")
                            self._run_inline(req)
                            return req.future
            else:
                try:
                    self._queue.put_nowait(req)
                except queue.Full:
                    METRICS.bump("rejected")
                    raise ServerBusy(
                        f"serving queue full ({self._queue.maxsize} {cls} "
                        "requests); backpressure — retry later") from None
        except BaseException:
            self._settle(1)
            raise
        # close() may have finished between the _closed check and the
        # put: nobody would consume this request, so drain it here
        # (get_nowait is atomic: racing drains never double-execute)
        with self._lock:
            orphaned = self._closed
        if orphaned:
            self._drain_queue()
        return req.future

    def predict(self, *inputs, timeout_ms=None, slo_class=None,
                session_id=None):
        """Blocking ``submit(...).result()``, the wait bounded by the
        request deadline plus execution slack."""
        fut = self.submit(*inputs, timeout_ms=timeout_ms,
                          slo_class=slo_class, session_id=session_id)
        t = self._timeout_s if timeout_ms is None else \
            float(timeout_ms) / 1e3
        return fut.result(timeout=(t + 60.0) if t > 0 else None)

    def qsize(self):
        return self._queue.qsize()

    def qsize_by_class(self):
        """Live queue depth per SLO class (``/healthz``)."""
        return self._queue.qsize_by_class()

    def queue_capacity(self):
        """Queued-request capacity across the class lanes (the admission
        controller's queue-headroom denominator)."""
        return self._queue.capacity()

    @property
    def admission(self):
        """The batcher's AdmissionController (None when pass-through)."""
        return self._admission

    def wait_idle(self, timeout=None):
        """Wait until every queued request has resolved (the repository
        quiesces an incumbent this way before migrating its sessions).
        Returns False if ``timeout`` seconds passed first."""
        with self._lock:
            return self._lock.wait_for(lambda: self._outstanding == 0,
                                       timeout)

    # -- resolving requests --------------------------------------------

    def _settle(self, n):
        with self._lock:
            self._outstanding -= n
            if self._outstanding == 0:
                self._lock.notify_all()

    def _fail(self, r, err, now=None, timed_out=False):
        if r.future.set_running_or_notify_cancel():
            r.future.set_exception(err)
        METRICS.observe_request(
            (now or time.monotonic()) - r.t_submit, failed=True,
            timed_out=timed_out, slo_class=r.slo_class, met_deadline=False)

    def _succeed(self, r, rows, now):
        if r.future.set_running_or_notify_cancel():
            r.future.set_result(rows[0] if len(rows) == 1 else rows)
        METRICS.observe_request(
            now - r.t_submit, slo_class=r.slo_class,
            met_deadline=r.deadline is None or now <= r.deadline)

    def _fail_timeout(self, req):
        _telem.instant("serving.timeout", cat="serving",
                       trace_id=req.trace_id, slo_class=req.slo_class)
        budget_ms = (req.deadline - req.t_submit) * 1e3
        self._fail(req, RequestTimeout(
            f"request expired after {budget_ms:.0f} ms in queue"),
            timed_out=True)

    def _run_inline(self, req):
        if self._stateful:
            self._execute_step_batch([req])
        else:
            self._execute([req])

    # -- stateless workers ---------------------------------------------

    def _worker_loop(self):
        holdover = None
        while True:
            req = holdover if holdover is not None else self._queue.get()
            holdover = None
            if req is _STOP:
                break
            if req.expired():
                self._fail_timeout(req)
                self._settle(1)
                continue
            batch, rows = [req], req.rows
            # the flush deadline runs from the oldest request's SUBMIT:
            # past it the worker stops waiting but still drains what is
            # queued; never past the earliest member deadline less the
            # execution estimate
            margin = METRICS.exec_estimate_s()
            flush_at = req.t_submit + self._max_latency_s
            if req.deadline is not None:
                flush_at = min(flush_at, req.deadline - margin)
            t_co = time.monotonic() if _telem.tracing() else 0.0
            while rows < self._max_batch:
                remaining = flush_at - time.monotonic()
                try:
                    nxt = self._queue.get_nowait() if remaining <= 0 \
                        else self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    holdover = nxt  # finish the formed batch first
                    break
                if nxt.expired():
                    self._fail_timeout(nxt)
                    self._settle(1)
                    continue
                if rows + nxt.rows > self._max_batch:
                    holdover = nxt  # opens the next batch
                    break
                batch.append(nxt)
                rows += nxt.rows
                if nxt.deadline is not None:
                    flush_at = min(flush_at, nxt.deadline - margin)
            if t_co:
                _telem.emit_span("serving.coalesce", "serving", t_co,
                                 time.monotonic(),
                                 trace_id=batch[0].trace_id,
                                 requests=len(batch), rows=rows)
            METRICS.observe_flush(time.monotonic() - batch[0].t_submit)
            try:
                self._execute(batch)
            finally:
                self._settle(len(batch))

    def _execute(self, batch):
        """One session execution over the batch's concatenated rows;
        one device-to-host copy per output, numpy slices back per
        request. A failure here is systemic (inputs were validated at
        submit): it fails the whole batch."""
        tid = batch[0].trace_id
        if _telem.tracing():
            # each member's queue wait, from its own submit to now
            now = time.monotonic()
            for r in batch:
                _telem.emit_span("serving.queue_wait", "serving",
                                 r.t_submit, now, trace_id=r.trace_id,
                                 slo_class=r.slo_class)
        try:
            with _telem.span("serving.pad", cat="serving", trace_id=tid,
                             requests=len(batch)):
                arrs = batch[0].arrs if len(batch) == 1 else [
                    onp.concatenate([r.arrs[i] for r in batch], axis=0)
                    for i in range(len(batch[0].arrs))]
            with _telem.span("serving.execute", cat="serving",
                             trace_id=tid,
                             rows=sum(r.rows for r in batch)):
                outs = self.session.predict(*arrs)
                outs = outs if isinstance(outs, tuple) else (outs,)
                # ONE device-to-host copy per output
                host = [o.asnumpy() if isinstance(o, NDArray)
                        else onp.asarray(o) for o in outs]
            if len(batch) > 1:
                # every output must be batch-major over exactly the
                # coalesced rows, or slicing would hand one request
                # another's data
                total = sum(r.rows for r in batch)
                bad = [i for i, h in enumerate(host)
                       if not (h.ndim and h.shape[0] == total)]
                if bad:
                    raise MXNetError(
                        f"output(s) {bad} are not batch-major over "
                        f"{total} coalesced rows (shapes "
                        f"{[host[i].shape for i in bad]}); batched serving "
                        "needs row-independent outputs — use "
                        "max_batch_size=1 or a direct InferenceSession")
        except Exception as e:  # noqa: BLE001 — delivered per future
            now = time.monotonic()
            for r in batch:
                self._fail(r, e, now)
            return
        with _telem.span("serving.respond", cat="serving", trace_id=tid,
                         requests=len(batch)):
            offset, now = 0, time.monotonic()
            for r in batch:
                rows = tuple(host) if len(batch) == 1 else \
                    tuple(h[offset:offset + r.rows] for h in host)
                offset += r.rows
                self._succeed(r, rows, now)

    # -- continuous batching (stateful sessions) -----------------------

    def _step_loop(self):
        """Between decode steps, re-form the batch from the HEAD step of
        every live session. Per-session FIFO queues keep each stream's
        steps in order; one head per session per step keeps a stream
        from ever sharing a step with itself."""
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
                    self._settle(1)
                if not q:
                    del pending[sid]
                    arrival.remove(sid)
                else:
                    heads.append(q[0])
            if not heads:
                continue
            if len(heads) > self._max_batch:
                # contention: higher SLO classes win membership; the
                # stable sort keeps join order within a class
                order = {c: i for i, c in enumerate(SLO_CLASSES)}
                heads.sort(key=lambda r: order.get(r.slo_class, 1))
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
            METRICS.observe_flush(
                time.monotonic() - min(r.t_submit for r in heads))
            try:
                self._execute_step_batch(heads)
            finally:
                self._settle(len(heads))
            for r in heads:
                q = pending.get(r.session_id)
                if q and q[0] is r:
                    q.popleft()
                if q is not None and not q:
                    del pending[r.session_id]
                    arrival.remove(r.session_id)

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
                self._fail(r, e)
        if not live:
            return
        if _telem.tracing():
            now = time.monotonic()
            for r in live:
                _telem.emit_span("serving.queue_wait", "serving",
                                 r.t_submit, now, trace_id=r.trace_id,
                                 slo_class=r.slo_class,
                                 session=r.session_id)
        t0 = time.perf_counter()
        try:
            with _telem.span("serving.decode_step", cat="serving",
                             trace_id=live[0].trace_id,
                             sessions=len(live)):
                arrs = live[0].arrs if len(live) == 1 else [
                    onp.concatenate([r.arrs[i] for r in live], axis=0)
                    for i in range(len(live[0].arrs))]
                host = self.session._run_store_step(arrs, recs)
        except Exception as e:  # noqa: BLE001 — delivered per future
            logging.exception("serving: decode step failed for %d "
                              "session(s)", len(live))
            for rec in recs:
                store.release(rec, stepped=False)
            now = time.monotonic()
            for r in live:
                self._fail(r, e, now)
            return
        for rec in recs:
            store.release(rec)
        METRICS.bump("decode_steps")
        METRICS.observe_batch(len(live), time.perf_counter() - t0)
        now = time.monotonic()
        for i, r in enumerate(live):
            self._succeed(r, tuple(h[i:i + 1] for h in host), now)

    # -- lifecycle -----------------------------------------------------

    def close(self):
        """Stop accepting queued work, run every accepted request to its
        boundary, join the workers. Idempotent; later submits run
        inline."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._workers:
            self._queue.put(_STOP)
        for t in self._workers:
            t.join()
        self._workers = []
        self._drain_queue()  # what a racing submit slipped in
        METRICS.unregister_depth_probe(self._depth_token)
        if self._admission is not None:
            self._admission.close()

    def _drain_queue(self):
        """Pop and execute everything queued (skipping stray sentinels);
        expired requests fail with RequestTimeout here too."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            try:
                if item.expired():
                    self._fail_timeout(item)
                else:
                    self._run_inline(item)
            finally:
                self._settle(1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
