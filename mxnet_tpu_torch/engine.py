"""Dependency engine: asynchronous host tasks ordered by var dependencies.

The PyTorch counterpart of ``mxnet_tpu/engine.py`` (reference:
include/mxnet/engine.h, src/engine/threaded_engine*.cc). The native core
(``csrc/engine.cc``, built by ``_native.py`` and loaded with ctypes)
implements var versioning, per-var waiter FIFOs, the lanes' worker
pools, and asynchronous exception propagation: an op's exception
poisons its mutable vars and is raised again at the next sync point
(``wait_for_var``), as the reference defers its raise
(threaded_engine.h:466-498). ``MXNET_ENGINE_TYPE=NaiveEngine`` selects
the synchronous engine (reference: src/engine/naive_engine.cc). A native
library that does not build raises :class:`MXNetError`; the engine
never picks ``NaiveEngine`` by itself (the JAX package does when its
library is missing).

**Work on the card.** An engine op runs on a worker thread. CUDA work
it issues goes to that thread's current stream, and ``push`` returns
when the op is queued, not when it is done. The engine's consumers
keep their ops on the host where they can (the DataLoader's collect,
``PrefetchingIter``'s fetch, ``nd.save``'s write, the libjpeg decode).
An op that touches the card is pushed with ``device=`` (the nvJPEG
decode of ``io/image_record.py``): it then runs on a side stream of its
worker, ordered after the work the pusher's stream had queued at push,
and records a ``torch.cuda.Event`` at its end; ``wait_for_var`` makes
the caller's current stream wait on the event of the var's last such
writer, so whatever the caller launches next reads the op's results.
The host is not blocked by that wait: ``nd.waitall()`` is
``wait_all()`` followed by the card's synchronize.
"""
from __future__ import annotations

import ctypes
import os
import threading

from .base import MXNetError

# module-level on purpose: push() is the framework's hottest host path,
# and the disarmed fault seam must cost one global read, not an import
# lookup per call (resilience.faults has no imports back into engine)
from .resilience import faults as _faults
from .utils import locks as _locks

__all__ = ["Engine", "NaiveEngine", "get", "var", "push", "wait_for_var",
           "wait_all", "LANE_COMPUTE", "LANE_IO"]

_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)


class _Var:
    __slots__ = ("id",)

    def __init__(self, vid):
        self.id = vid


#: named lanes over the per-lane worker pools (ThreadedEnginePerDevice
#: analog — threaded_engine_perdevice.cc runs a pool per device plus
#: dedicated copy workers; the card's work is ordered by CUDA streams,
#: so the split that matters is compute vs host copy/IO)
LANE_COMPUTE = 0
LANE_IO = 1


class Engine:
    """Threaded native engine (reference: ThreadedEnginePerDevice —
    `nlanes` independent worker pools over one dependency state; push
    with ``lane=LANE_IO`` to keep slow IO from starving compute ops)."""

    def __init__(self, nthreads=None, nlanes=None):
        from . import _native
        from . import env as _env

        self._lib = _native.engine_lib()  # a failed build raises

        nthreads = nthreads or _env.get_int(
            "MXNET_CPU_WORKER_NTHREADS", os.cpu_count() or 4)
        nlanes = nlanes or _env.get_int("MXNET_ENGINE_NUM_LANES", 2)
        # guards: _active, _var_poison, _exceptions, _live_cbs, _h
        self._lock = _locks.RankedLock("engine.waiters")
        # close() coordination: _active counts threads inside a native
        # call on the handle (close must not destroy it under them);
        # _drained flips once close() has fully drained + destroyed, so
        # post-close callers can order themselves after every pre-close
        # op (a wait_for_var racing close() must NOT return before the
        # op writing its slot ran — that silently loses the write)
        self._cond = _locks.RankedCondition(lock=self._lock)
        self._active = 0
        self._drained = threading.Event()
        self._var_poison = {}  # var id -> exception, frozen at close()
        self._exceptions = {}  # op_id -> exception
        self._live_cbs = {}  # op_id -> (callback, ctx) keepalive
        self._device_events = {}  # var id -> (device, event) of its writer
        self._h = self._lib.eng_create_lanes(int(nthreads), int(nlanes))
        self._nlanes = int(nlanes)
        # the process whose worker threads the handle owns; a copy of
        # this object in a forked child must never reach them
        self._pid = os.getpid()

    def _reserve(self):
        """Pin the native handle for one call; None when closed. Every
        _reserve() pairs with _release() — close() destroys the handle
        only once no thread holds a reservation."""
        with self._lock:
            if self._h is None:
                return None
            self._active += 1
            return self._h

    def _release(self):
        with self._cond:
            self._active -= 1
            if self._active == 0:
                self._cond.notify_all()

    def new_variable(self):
        h = self._reserve()
        if h is None:  # closed: inline mode needs no real deps
            return _Var(-1)
        try:
            return _Var(self._lib.eng_new_var(h))
        finally:
            self._release()

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             lane=LANE_COMPUTE, device=None):
        """Schedule fn() after its deps; returns the op id. An exception
        in fn poisons `mutable_vars` and surfaces at wait_for_var.
        ``device``: the CUDA device whose card the op works on (see the
        module docstring), None for a host-only op."""
        # registered fault point: a failed host-task schedule (raises
        # synchronously in the pusher, like a dead worker pool)
        _faults.maybe_fail("engine_push")
        if device is not None:
            fn = self._on_device(fn, device, mutable_vars)
        # deliberate unlocked read: close() only transitions _h to None
        # once, at atexit, and a push that loses the race blocks on the
        # drain event below — locking here would tax every op push
        if self._h is None:
            # closed (atexit shutdown): run inline, but only after the
            # drain — an in-flight pre-close op may write the same
            # vars this fn depends on
            self._drained.wait()
            fn()
            return -1
        holder = {}
        inline = False

        def run(_ctx):
            try:
                fn()
                return 0
            except BaseException as e:  # noqa: BLE001 — deferred re-raise
                with self._lock:
                    self._exceptions[holder["op_id"]] = e
                return 1

        cb = _CB(run)
        cv = (ctypes.c_int64 * max(len(const_vars), 1))(
            *[v.id for v in const_vars])
        mv = (ctypes.c_int64 * max(len(mutable_vars), 1))(
            *[v.id for v in mutable_vars])
        # writer var ids only: WaitForVar barriers WRITERS of the var
        # (its sync op is itself a reader, and readers run concurrently),
        # so only ops holding the var mutable are provably finished when
        # a wait on it returns — GC'ing a reader's keepalive early would
        # free a trampoline the worker may still call
        writer_ids = frozenset(v.id for v in mutable_vars)
        with self._lock:
            if self._h is None:
                # close() swapped the handle between the unlocked check
                # above and here — fall through to inline execution
                # rather than hand NULL to the native library
                inline = True
            else:
                op_id = self._lib.eng_push_lane(
                    self._h, ctypes.cast(cb, ctypes.c_void_p), None, cv,
                    len(const_vars), mv, len(mutable_vars),
                    int(priority), int(lane))
                holder["op_id"] = op_id
                # keepalive carries the op's WRITER var set so
                # wait_for_var can GC it: after the wait returns, every
                # writer of that var has completed AND its trampoline
                # frame has returned (the native engine marks completion
                # after the callback returns), so steady-state pipelines
                # (IO iterators, nd.save) don't grow _live_cbs
                # unboundedly between wait_all barriers
                self._live_cbs[op_id] = (cb, writer_ids)
        if inline:
            self._drained.wait()
            fn()
            return -1
        return op_id

    def _on_device(self, fn, device, mutable_vars):
        """``fn`` run on the worker's side stream of ``device``, after
        the pusher's queued work, ending with an event that waits on
        ``mutable_vars`` order the caller's stream after."""
        import torch

        device = torch.device(device)
        if device.type != "cuda":
            return fn
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))

        def run_on_side_stream():
            stream = _side_stream(device)
            stream.wait_event(ready)
            with torch.cuda.stream(stream):
                fn()
            done = torch.cuda.Event()
            done.record(stream)
            with self._lock:
                for v in mutable_vars:
                    self._device_events[v.id] = (device, done)
        return run_on_side_stream

    def _order_after_device(self, v):
        with self._lock:
            rec = self._device_events.get(v.id)
        if rec is not None:
            import torch

            torch.cuda.current_stream(rec[0]).wait_event(rec[1])

    def wait_for_var(self, v):
        """Block until all ops touching v finish; re-raise its poison.
        Racing close() is safe on both sides: a wait already inside the
        native call pins the handle (close drains first and the live
        pool completes the awaited op), and a wait arriving after the
        close blocks on the drain — so when it returns, every pre-close
        op touching v has truly run — then re-raises frozen poison."""
        h = self._reserve()
        if h is None:
            self._drained.wait()
            # post-drain read: the worker pool has quiesced, nothing
            # writes poison any more
            exc = self._var_poison.get(v.id)
            if exc is not None:
                raise exc
            self._order_after_device(v)
            return
        try:
            # snapshot BEFORE the barrier: an op pushed concurrently
            # with the wait may still be running when it returns — only
            # ops registered before the wait are provably done (same
            # rule as wait_all)
            with self._lock:
                dead = [oid for oid, (_, var_ids) in self._live_cbs.items()
                        if v.id in var_ids]
            err_op = self._lib.eng_wait_for_var(h, v.id)
            # those ops have completed and their trampolines returned
            # (Complete runs after op->fn) — drop the keepalives
            with self._lock:
                for oid in dead:
                    self._live_cbs.pop(oid, None)
            if err_op >= 0:
                with self._lock:
                    exc = self._exceptions.get(err_op)
                if exc is not None:
                    raise exc
                raise MXNetError(f"engine op {err_op} failed")
            self._order_after_device(v)
        finally:
            self._release()

    def wait_all(self):
        h = self._reserve()
        if h is None:
            self._drained.wait()
            return
        try:
            # snapshot BEFORE the barrier: a concurrent push() racing
            # with the barrier's return may register a new callback
            # whose op is still in flight — only ops pushed before the
            # barrier are provably done
            with self._lock:
                done_ids = list(self._live_cbs)
            self._lib.eng_wait_all(h)
            self._gc_callbacks(done_ids)
        finally:
            self._release()

    def var_version(self, v):
        h = self._reserve()
        if h is None:
            self._drained.wait()
            return 0
        try:
            return int(self._lib.eng_var_version(h, v.id))
        finally:
            self._release()

    def num_live_callbacks(self):
        with self._lock:
            return len(self._live_cbs)

    def _gc_callbacks(self, done_ids):
        # WaitForAll is a full barrier: every op pushed before it has
        # completed and its trampoline frame has returned, so no worker
        # can still be inside those ctypes callbacks — safe to drop their
        # keepalives. Poison exceptions stay (bounded by error count) so
        # a later wait_for_var on a still-poisoned var re-raises.
        with self._lock:
            for op_id in done_ids:
                self._live_cbs.pop(op_id, None)

    def close(self):
        """Drain in-flight ops and join the native worker pool.
        Idempotent; after close() pushes run inline (NaiveEngine-style)
        so late callers (atexit hooks, iterator teardown) stay correct.

        Ordering vs concurrent waiters (the DeviceFeed/DataLoader
        pipeline closes the engine mid-epoch in tests): (1) swap the
        handle out under the push lock (a racing push re-checks and
        goes inline); (2) wait for threads already inside a native call
        to return — their awaited ops complete on the still-live pool;
        (3) drain every pending op, freeze per-var poison for
        post-close wait_for_var, destroy, and only then flip _drained —
        the gate every post-close path (inline push, closed-path waits)
        blocks on, so no pre-close slot write can be skipped over. The
        drain runs OUTSIDE the lock — in-flight callbacks take the same
        lock to record exceptions, so holding it through eng_wait_all
        would deadlock. getattr guards: __del__ may see a
        half-constructed instance whose __init__ raised before _h/_lock
        were assigned."""
        lock = getattr(self, "_lock", None)
        if lock is None:
            return
        if getattr(self, "_pid", None) != os.getpid():
            self._abandon_after_fork()
            return
        missing = object()
        with lock:
            h = getattr(self, "_h", missing)
            if h is missing:  # __init__ raised before the handle existed
                return
            self._h = None
        if h is None:
            # another close() owns (or finished) the drain — order after
            self._drained.wait()
            return
        try:
            with self._cond:
                while self._active > 0:
                    self._cond.wait()
            try:
                self._lib.eng_wait_all(h)
            except Exception:  # noqa: BLE001 — teardown must finish
                pass
            with lock:
                poison = {}
                for oid, (_, var_ids) in self._live_cbs.items():
                    exc = self._exceptions.get(oid)
                    if exc is not None:
                        for vid in var_ids:
                            poison[vid] = exc
                self._var_poison = poison
                self._live_cbs.clear()
            try:
                self._lib.eng_destroy(h)
            except Exception:  # noqa: BLE001 — teardown must finish
                pass
        finally:
            self._drained.set()

    def _abandon_after_fork(self):
        """Drop the handle of an engine inherited across ``fork``
        without a native call: its worker threads did not survive the
        fork, so draining or joining them (``eng_wait_all``,
        ``eng_destroy``) in the child waits on or frees thread state the
        child does not own (a segfault). The locks may have been copied
        held, so none is taken; later pushes on this object run inline."""
        self._h = None
        self._active = 0
        self._drained = threading.Event()
        self._drained.set()

    def __del__(self):
        try:
            # finalizers interleave arbitrarily; this instance is
            # unreachable so its locks cannot be held elsewhere
            with _locks.exempt("gc finalizer on unreachable engine"):
                self.close()
        except Exception:  # noqa: BLE001 — teardown must finish
            pass


class NaiveEngine:
    """Synchronous debug engine (reference: naive_engine.cc) — executes on
    push, same exception-on-var semantics."""

    def __init__(self, nthreads=None):
        self._versions = {}
        self._errors = {}
        self._exceptions = {}
        self._next = 0

    def new_variable(self):
        v = _Var(self._next)
        self._next += 1
        self._versions[v.id] = 0
        return v

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0,
             lane=0, device=None):
        """Run fn() now, on the caller's thread and stream (so ``device``
        needs no event)."""
        _faults.maybe_fail("engine_push")
        op_id = self._next
        self._next += 1
        poisoned = [v for v in list(const_vars) + list(mutable_vars)
                    if v.id in self._errors]
        if poisoned:
            src = self._errors[poisoned[0].id]
            for v in mutable_vars:
                self._errors.setdefault(v.id, src)
                # native Complete() bumps versions for skipped ops too
                self._versions[v.id] += 1
            return op_id
        try:
            fn()
            for v in mutable_vars:
                self._versions[v.id] += 1
        except BaseException as e:  # noqa: BLE001
            self._exceptions[op_id] = e
            for v in mutable_vars:
                self._errors[v.id] = op_id
                # native Complete() bumps versions even on failure
                # (engine.cc) — keep the two engine types in lockstep
                self._versions[v.id] += 1
        return op_id

    def wait_for_var(self, v):
        if v.id in self._errors:
            raise self._exceptions[self._errors[v.id]]

    def wait_all(self):
        pass

    def var_version(self, v):
        return self._versions.get(v.id, 0)


_SIDE = threading.local()


def _side_stream(device):
    """This worker thread's side stream on ``device``."""
    import torch

    streams = getattr(_SIDE, "streams", None)
    if streams is None:
        streams = _SIDE.streams = {}
    s = streams.get(device.index)
    if s is None:
        s = streams[device.index] = torch.cuda.Stream(device)
    return s


_engine = None
# guards: _engine
_engine_lock = _locks.RankedLock("engine.singleton")


def get():
    """The process engine singleton (reference: Engine::Get(), selection
    via MXNET_ENGINE_TYPE — engine.cc:32-45). ``NaiveEngine`` only when
    the knob asks for it: a native library that does not build raises."""
    global _engine
    with _engine_lock:
        if _engine is None:
            from . import env as _env

            etype = _env.get_str("MXNET_ENGINE_TYPE", "ThreadedEngine")
            _engine = NaiveEngine() if etype == "NaiveEngine" else Engine()
        return _engine


def var():
    return get().new_variable()


def push(fn, const_vars=(), mutable_vars=(), priority=0, lane=0,
         device=None):
    return get().push(fn, const_vars, mutable_vars, priority, lane, device)


def wait_for_var(v):
    get().wait_for_var(v)


def wait_all():
    get().wait_all()


def _shutdown_at_exit():
    """Join the native worker pool BEFORE interpreter teardown.

    Without this, a process exiting with decode/IO ops still in flight
    tears down the Python runtime while a native worker is inside (or
    about to enter) a ctypes callback trampoline: an intermittent
    teardown segfault. atexit runs while Python is
    fully alive: drain every op, join the threads, and flip the engine
    to inline mode so any later atexit hook that pushes still runs."""
    global _engine
    with _engine_lock:
        eng = _engine
    if eng is not None and isinstance(eng, Engine):
        eng.close()


import atexit  # noqa: E402

atexit.register(_shutdown_at_exit)
