"""Ranked locks: one declared lock order and a runtime deadlock witness.

The PyTorch counterpart of ``mxnet_tpu/utils/locks.py``. The port's
locks whose JAX counterparts have a name in :data:`LOCK_RANKS` (the
serving control plane, the state store, the resilience seams, the
profiler and the telemetry registry) are created through the factories
here (:func:`RankedLock` / :func:`RankedRLock` / :func:`RankedCondition`)
and carry a **name** and a **rank** from the one table below (lower =
outer = acquired first). The table is the JAX package's, name for name
and rank for rank, so both packages declare one lock order.

``MXNET_LOCK_CHECK`` selects the mode **at lock construction**:

- ``0`` (default): the factories return the raw ``threading`` object
  (one env read at import, then literal passthrough: nothing to pay);
- ``warn`` / ``error``: the factories return checked wrappers and the
  witness runs on every acquire; ``warn`` counts and logs a violation,
  ``error`` raises :class:`LockOrderError` at the violating acquire,
  before the acquire. :func:`set_check_mode` flips the mode at run time;
  checked locks consult the live mode when a violation fires.

The witness is lockdep-style, two layers:

1. **Held-stack rank check**: a thread-local stack of held locks;
   acquiring a lock whose rank is not strictly greater than the
   innermost held lock's is an ``out_of_rank`` violation, reported
   before the acquire. Re-entry on a held :func:`RankedRLock` is exempt.
2. **Acquisition-order graph**: a process-wide edge set (``A -> B``
   recorded when B is acquired while A is held) with cycle detection on
   every new edge, so an AB/BA potential deadlock is reported even when
   the interleaving never deadlocks.

Violations surface three ways: the bounded :func:`violations` list
(read by :func:`capture_violations`), the ``lock_check`` counter family
of the metrics registry (Prometheus ``mxnet_lock_check_*`` and
``profiler.lock_check_counters()``), and a telemetry instant event
naming both locks when tracing is on.
"""
from __future__ import annotations

import logging
import threading
from contextlib import contextmanager

from .. import env

__all__ = [
    "LOCK_RANKS", "LockOrderError",
    "RankedLock", "RankedRLock", "RankedCondition",
    "check_mode", "set_check_mode",
    "violations", "clear_violations", "capture_violations", "exempt",
    "held_locks", "order_graph", "reset_order_graph",
    "lock_check_counters",
]

log = logging.getLogger(__name__)

# The one declared lock order (lower rank = outer = acquired first), the
# JAX package's table. A name whose subsystem the port lacks yet (the
# engine, the fleet, autotune, artifacts, the LRU and the save pool)
# keeps its row, so a lock ported later takes the same place.

LOCK_RANKS = {
    # engine band: outermost. engine.waiters is the _reserve/_release
    # drain-protocol lock (_lock + _cond share it); nothing may be held
    # when it is taken, because it is acquired on every op push/wait.
    "engine.waiters": 0,
    "engine.singleton": 5,      # get()/fork re-init guard; never nests
    # serving control plane (outer -> inner along the request path)
    "serving.fleet": 8,         # FleetRouter replica table + hash ring
    "repository": 10,           # ModelRepository registration dict
    "repository.model": 20,     # per-_Model deploy/promote/rollback
    "batcher": 30,              # DynamicBatcher _closed flag
    "batcher.queue": 35,        # per-SLO-class lane condition
    "serving.session": 40,      # InferenceSession AOT-entry tables
    "serving.store": 50,        # SessionStateStore slots + page pool
    "serving.metrics": 60,      # ServingMetrics counters/histograms
    # autotune tier: consulted from graph optimization (which may run
    # under serving.session) and salt resolution; nothing but telemetry
    # counters is ever acquired under these
    "autotune.registry": 66,    # DecisionPoint table
    "autotune.records": 68,     # TuningRecord cache + trial overrides
    # artifact tier (session/store call down into it)
    "artifact.salts": 70,       # salt-provider registry
    "artifact.remote.breakers": 72,  # per-URL breaker table
    "artifact.server.store": 74,     # ArtifactCacheServer object store
    "artifact.bundle.protected": 75,  # live-bundle fingerprint pins
    "kernels.serving_fused": 76,     # pad/slice jit caches
    # leaf utilities: callable from under any of the above
    "resilience.faults": 78,    # fault-injection plan + fire counts
    "resilience.breaker": 80,   # per-CircuitBreaker state
    "utils.lru": 82,            # CountedLRUCache (compile caches)
    "ndarray.save_pool": 84,    # save() writer-pool keepalive
    "profiler": 86,             # host-side aggregate/event tables
    # telemetry: innermost — counters are bumped under everything
    "telemetry.boot": 88,       # one-shot probe bootstrap
    "telemetry.registry": 90,   # MetricsRegistry family tables
    "telemetry.counters": 95,   # every CounterFamily instance
}


class LockOrderError(RuntimeError):
    """Raised (``MXNET_LOCK_CHECK=error``) at a violating acquire site,
    *before* the acquire — the lock is NOT taken when this raises."""


# -- mode ------------------------------------------------------------------

def _read_mode():
    v = (env.get_str("MXNET_LOCK_CHECK", "0") or "0").strip().lower()
    if v in ("", "0", "off", "false"):
        return "0"
    if v in ("warn", "1", "warning"):
        return "warn"
    if v == "error":
        return "error"
    log.warning("MXNET_LOCK_CHECK=%r not recognized; using 'warn'", v)
    return "warn"


_MODE = _read_mode()  # the one env read; level 0 never pays again


def check_mode():
    """Current witness mode: ``"0"``, ``"warn"`` or ``"error"``."""
    return _MODE


def set_check_mode(mode):
    """Override the witness mode at runtime (tests, benchmarks).

    Affects (a) which flavor the factories return from now on and
    (b) whether already-constructed *checked* locks raise or count —
    it cannot retrofit checking onto raw locks built at level 0.
    Returns the previous mode."""
    global _MODE
    if mode not in ("0", "warn", "error"):
        raise ValueError(f"bad lock-check mode {mode!r}")
    prev, _MODE = _MODE, mode
    return prev


# -- witness state ---------------------------------------------------------

class _TLS(threading.local):
    def __init__(self):
        self.stack = []       # [lock, entry_count] innermost last
        self.reporting = False  # re-entrancy guard for the witness itself


_tls = _TLS()

# The witness's own locks stay raw on purpose: ranking them would make
# the witness recurse into itself.
_GRAPH_LOCK = threading.Lock()
_EDGES = {}        # name -> set(name): B acquired while A held
_SEEN_EDGES = set()  # (a, b) dedupe; unlocked membership fast path
_VIOLATIONS = []   # bounded; violations() and capture_violations() read it
_MAX_VIOLATIONS = 256
_FAMILY = None     # lazy lock_check CounterFamily

_COUNTER_ZEROS = {"out_of_rank": 0, "cycles": 0, "edges": 0,
                  "self_deadlock": 0, "violations_dropped": 0}


def _bump(key, n=1):
    """Bump the lock_check counter family without re-entering the
    witness (the family's own lock is ranked)."""
    global _FAMILY
    was = _tls.reporting
    _tls.reporting = True
    try:
        if _FAMILY is None:
            from ..telemetry.metrics import counter_family
            _FAMILY = counter_family("lock_check", _COUNTER_ZEROS)
        _FAMILY.add(key, n)
    finally:
        _tls.reporting = was


def lock_check_counters():
    """Snapshot of the ``lock_check`` family (zeros before first use)."""
    if _FAMILY is None:
        return dict(_COUNTER_ZEROS)
    return _FAMILY.snapshot()


def _report(kind, message, acquiring=None):
    """Record one violation: bounded list + counter + log + telemetry
    instant; raises LockOrderError in ``error`` mode (before acquire)."""
    if _tls.reporting:
        return
    _tls.reporting = True
    try:
        held = [(lk.name, lk.rank) for lk, _ in _tls.stack]
        rec = {"kind": kind, "message": message,
               "thread": threading.current_thread().name,
               "held": held,
               "acquiring": None if acquiring is None else acquiring.name}
        with _GRAPH_LOCK:
            dropped = len(_VIOLATIONS) >= _MAX_VIOLATIONS
            if not dropped:
                _VIOLATIONS.append(rec)
        _bump("cycles" if kind == "cycle" else kind)
        if dropped:
            _bump("violations_dropped")
        log.warning("lock_check[%s]: %s (thread=%s held=%s)",
                    kind, message, rec["thread"], held)
        try:
            from ..telemetry import tracer
            tracer.instant("lock_check." + kind, cat="lock",
                           message=message,
                           held=",".join(n for n, _ in held),
                           acquiring=rec["acquiring"] or "")
        except Exception:  # noqa: BLE001 — the witness must not throw
            pass
    finally:
        _tls.reporting = False
    if _MODE == "error":
        raise LockOrderError(message)


def _find_path(src, dst):
    """DFS over the edge graph: a path src -> ... -> dst, or None."""
    stack, seen = [(src, (src,))], {src}
    while stack:
        node, path = stack.pop()
        for nxt in _EDGES.get(node, ()):
            if nxt == dst:
                return path + (nxt,)
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + (nxt,)))
    return None


def _note_edge(outer, inner):
    """Record outer->inner in the acquisition-order graph; on a NEW
    edge, run incremental cycle detection (lockdep-style)."""
    key = (outer.name, inner.name)
    if key in _SEEN_EDGES:  # benign unlocked fast path; recheck below
        return
    with _GRAPH_LOCK:
        if key in _SEEN_EDGES:
            return
        _SEEN_EDGES.add(key)
        _EDGES.setdefault(outer.name, set()).add(inner.name)
        # cycle through the new edge <=> a path inner -> ... -> outer
        path = _find_path(inner.name, outer.name)
    _bump("edges")
    if path is not None:
        cycle = " -> ".join((outer.name,) + path)
        _report(
            "cycle",
            f"lock-order cycle (potential deadlock): {cycle}; "
            f"edge {outer.name}->{inner.name} closes it",
            acquiring=inner)


def _check_acquire(lock):
    """Pre-acquire witness: rank check + edge recording. Returns True
    when this is a re-entrant acquire of an already-held RLock."""
    st = _tls.stack
    for ent in st:
        if ent[0] is lock:
            if lock._reentrant:
                return True
            _report(
                "self_deadlock",
                f"re-acquiring non-reentrant lock '{lock.name}' "
                f"already held by this thread (certain deadlock)",
                acquiring=lock)
            return False
    if st and not _tls.reporting:
        top = st[-1][0]
        if lock.rank <= top.rank:
            _report(
                "out_of_rank",
                f"acquiring '{lock.name}' (rank {lock.rank}) while "
                f"holding '{top.name}' (rank {top.rank}); declared "
                f"order is ascending — see LOCK_RANKS in "
                f"mxnet_tpu_torch/utils/locks.py",
                acquiring=lock)
        _note_edge(top, lock)
    return False


def _push(lock):
    _tls.stack.append([lock, 1])


def _pop(lock):
    st = _tls.stack
    for i in range(len(st) - 1, -1, -1):
        if st[i][0] is lock:
            st[i][1] -= 1
            if st[i][1] == 0:
                del st[i]
            return
    # released on a different thread than acquired (legal for Lock used
    # as a gate); nothing to pop here.


# -- checked wrappers ------------------------------------------------------

class _CheckedLock:
    """Witness wrapper over threading.Lock/RLock. Context-manager and
    acquire/release compatible; the raw primitive is ``_raw``."""

    __slots__ = ("_raw", "name", "rank", "_reentrant")

    def __init__(self, raw, name, rank, reentrant):
        self._raw = raw
        self.name = name
        self.rank = rank
        self._reentrant = reentrant

    def acquire(self, blocking=True, timeout=-1):
        reentry = _check_acquire(self)
        got = self._raw.acquire(blocking, timeout)
        if got:
            if reentry:
                for ent in _tls.stack:
                    if ent[0] is self:
                        ent[1] += 1
                        break
            else:
                _push(self)
        return got

    def release(self):
        self._raw.release()
        _pop(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._raw.locked()

    def held_by_me(self):
        """Whether the calling thread holds this lock (witness data)."""
        return any(ent[0] is self for ent in _tls.stack)

    def __repr__(self):
        kind = "RankedRLock" if self._reentrant else "RankedLock"
        return f"<{kind} {self.name!r} rank={self.rank}>"


class _CheckedCondition:
    """Condition over a checked lock: enter/exit run the witness; the
    internal threading.Condition operates on the RAW lock, so wait()
    brackets the raw release/reacquire by popping and re-pushing the
    held-stack entry (the wakeup reacquire recreates exactly the
    pre-wait held state, already vetted at the original acquire)."""

    __slots__ = ("_clock", "_cond")

    def __init__(self, checked_lock):
        self._clock = checked_lock
        self._cond = threading.Condition(checked_lock._raw)

    @property
    def name(self):
        return self._clock.name

    @property
    def rank(self):
        return self._clock.rank

    @property
    def lock(self):
        """The checked lock this condition synchronizes on."""
        return self._clock

    def acquire(self, blocking=True, timeout=-1):
        return self._clock.acquire(blocking, timeout)

    def release(self):
        self._clock.release()

    def __enter__(self):
        self._clock.acquire()
        return self

    def __exit__(self, *exc):
        self._clock.release()

    def wait(self, timeout=None):
        st = _tls.stack
        ent = None
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is self._clock:
                ent = st.pop(i)
                break
        try:
            return self._cond.wait(timeout)
        finally:
            if ent is not None:
                st.append(ent)

    def wait_for(self, predicate, timeout=None):
        import time as _time
        result = predicate()
        if result:
            return result
        endtime = None if timeout is None \
            else _time.monotonic() + timeout
        while not result:
            if endtime is not None:
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n=1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()

    def __repr__(self):
        return f"<RankedCondition {self.name!r} rank={self.rank}>"


# -- factories -------------------------------------------------------------

def _rank_of(name, rank):
    if rank is not None:
        return rank
    try:
        return LOCK_RANKS[name]
    except KeyError:
        raise KeyError(
            f"lock name {name!r} is not in LOCK_RANKS; declare it in "
            f"mxnet_tpu_torch/utils/locks.py"
        ) from None


def RankedLock(name, rank=None):
    """A named, ranked mutex. Level 0: a raw ``threading.Lock``."""
    if _MODE == "0":
        return threading.Lock()
    return _CheckedLock(threading.Lock(), name, _rank_of(name, rank),
                        reentrant=False)


def RankedRLock(name, rank=None):
    """A named, ranked re-entrant mutex. Level 0: a raw RLock."""
    if _MODE == "0":
        return threading.RLock()
    return _CheckedLock(threading.RLock(), name, _rank_of(name, rank),
                        reentrant=True)


def RankedCondition(name=None, lock=None, rank=None):
    """A condition variable over a ranked lock.

    ``lock=`` shares an existing :func:`RankedLock`/:func:`RankedRLock`
    (the engine ``_cond = Condition(self._lock)`` pattern — same lock,
    same rank, ONE held-stack identity); otherwise a new RankedRLock
    ``name`` is created underneath, mirroring ``threading.Condition()``
    defaulting to an RLock."""
    if _MODE == "0":
        if isinstance(lock, _CheckedLock):  # mixed modes (tests)
            lock = lock._raw
        return threading.Condition(lock)
    if lock is None:
        if name is None:
            raise ValueError("RankedCondition needs name= or lock=")
        lock = _CheckedLock(threading.RLock(), name,
                            _rank_of(name, rank), reentrant=True)
    elif not isinstance(lock, _CheckedLock):
        raise TypeError(
            "RankedCondition(lock=...) wants a RankedLock/RankedRLock "
            f"(got {type(lock).__name__}); raw locks are invisible to "
            "the witness")
    return _CheckedCondition(lock)


# -- introspection / test support -----------------------------------------

@contextmanager
def exempt(reason):
    """Suppress the witness for acquisitions inside the block (locks
    are still tracked on the held stack, so release stays balanced).

    For acquisition contexts whose interleaving is arbitrary *by
    construction* and provably deadlock-free: a GC finalizer
    (``__del__`` → ``close()``) runs at whatever allocation point the
    interpreter picked, under whatever locks the interrupted thread
    holds — but the locks it takes belong to an unreachable instance
    no live thread can hold, so the inverted-looking order it records
    can never complete a real deadlock. Every call site must pass a
    ``reason`` string (it is the audit trail)."""
    if not reason:
        raise ValueError("locks.exempt() requires a reason")
    was = _tls.reporting
    _tls.reporting = True
    try:
        yield
    finally:
        _tls.reporting = was


def held_locks():
    """``[(name, rank), ...]`` held by the calling thread, outer first."""
    return [(lk.name, lk.rank) for lk, _ in _tls.stack]


def violations():
    """Snapshot of recorded violations (bounded at 256)."""
    with _GRAPH_LOCK:
        return list(_VIOLATIONS)


def clear_violations():
    with _GRAPH_LOCK:
        _VIOLATIONS.clear()


@contextmanager
def capture_violations():
    """Collect violations recorded inside the block into the yielded
    list and REMOVE them from the global record, so a witness test
    asserts on them and leaves no trace for a zero-violation check."""
    with _GRAPH_LOCK:
        start = len(_VIOLATIONS)
    captured = []
    try:
        yield captured
    finally:
        with _GRAPH_LOCK:
            captured.extend(_VIOLATIONS[start:])
            del _VIOLATIONS[start:]


def order_graph():
    """Copy of the acquisition-order graph: ``{name: set(names)}``."""
    with _GRAPH_LOCK:
        return {k: set(v) for k, v in _EDGES.items()}


def reset_order_graph():
    """Forget observed edges (witness tests build synthetic orders)."""
    with _GRAPH_LOCK:
        _EDGES.clear()
        _SEEN_EDGES.clear()
