"""The port's ranked-lock witness (``mxnet_tpu_torch/utils/locks.py``):
the twin of ``tests/test_lock_check.py``. Out-of-rank detection, the
AB/BA cycle witness, error-mode semantics, condition re-entry, the
level-0 passthrough, the JAX package's rank table name for name, the
port's locks built on the factories, and a store-and-batcher stress
under ``MXNET_LOCK_CHECK=error``.

Witness tests provoke violations on purpose, inside
``locks.capture_violations()``; the autouse gate below fails a test
that leaves a violation of the port's witness behind.
"""
import threading
import time

import numpy as onp
import pytest

from mxnet_tpu.utils import locks as jlocks

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.utils import locks


@pytest.fixture(autouse=True)
def _port_gate():
    before = len(locks.violations())
    yield
    new = locks.violations()[before:]
    assert not new, "\n".join(f"[{v['kind']}] {v['message']}" for v in new)


@pytest.fixture(autouse=True)
def _checked():
    """The suite exports MXNET_LOCK_CHECK=warn; these tests need the
    checked wrappers whatever the environment says."""
    prev = locks.set_check_mode("warn") if locks.check_mode() == "0" \
        else None
    yield
    if prev is not None:
        locks.set_check_mode(prev)


@pytest.fixture
def error_mode():
    prev = locks.set_check_mode("error")
    yield
    locks.set_check_mode(prev)


def test_ascending_acquire_is_clean():
    a = locks.RankedLock("repository")
    b = locks.RankedLock("serving.session")
    with locks.capture_violations() as got:
        with a:
            assert locks.held_locks() == [("repository", 10)]
            with b:
                assert locks.held_locks() == [
                    ("repository", 10), ("serving.session", 40)]
    assert got == []


def test_out_of_rank_counts_under_warn():
    hi = locks.RankedLock("serving.session")
    lo = locks.RankedLock("repository")
    before = locks.lock_check_counters()["out_of_rank"]
    with locks.capture_violations() as got:
        with hi:
            with lo:  # rank 10 under rank 40: out of declared order
                pass
    kinds = [v["kind"] for v in got]
    assert "out_of_rank" in kinds, got
    v = got[kinds.index("out_of_rank")]
    assert "repository" in v["message"]
    assert "serving.session" in v["message"]
    assert locks.lock_check_counters()["out_of_rank"] > before


def test_error_mode_raises_before_acquiring(error_mode):
    hi = locks.RankedLock("serving.session")
    lo = locks.RankedLock("repository")
    with locks.capture_violations():
        with hi:
            with pytest.raises(locks.LockOrderError):
                lo.acquire()
    # the raise happened BEFORE the raw acquire: nothing to release,
    # nothing leaked on the held stack
    assert not lo._raw.locked()
    assert locks.held_locks() == []


def test_self_deadlock_on_nonreentrant_lock(error_mode):
    a = locks.RankedLock("repository")
    with locks.capture_violations() as got:
        with a:
            with pytest.raises(locks.LockOrderError):
                a.acquire()
    assert [v["kind"] for v in got] == ["self_deadlock"]


def test_rlock_reentry_is_one_stack_entry():
    m = locks.RankedRLock("repository.model")
    with locks.capture_violations() as got:
        with m:
            with m:  # re-entry: no violation, no second stack entry
                assert locks.held_locks() == [("repository.model", 20)]
    assert got == []


def test_ab_ba_cycle_witness_without_deadlocking():
    """The lockdep payoff: thread 1 records edge A->B, thread 2 then
    takes B->A — the witness reports the potential deadlock from the
    ORDER GRAPH alone, with both acquisitions strictly sequential (no
    actual contention, so the test can never hang)."""
    a = locks.RankedLock("batcher")        # rank 30
    b = locks.RankedLock("batcher.queue")  # rank 35
    t1_done = threading.Event()
    captured = []

    def t1():
        with a:
            with b:  # clean ascending acquire: edge batcher->queue
                pass
        t1_done.set()

    def t2():
        t1_done.wait(10)
        with locks.capture_violations() as got:
            with b:
                with a:  # closes the cycle (and is out of rank)
                    pass
        captured.extend(got)

    th1 = threading.Thread(target=t1)
    th2 = threading.Thread(target=t2)
    th1.start(), th2.start()
    th1.join(10), th2.join(10)
    kinds = [v["kind"] for v in captured]
    assert "cycle" in kinds, captured
    cyc = captured[kinds.index("cycle")]["message"]
    assert "potential deadlock" in cyc
    assert "batcher" in cyc and "batcher.queue" in cyc
    graph = locks.order_graph()
    assert "batcher.queue" in graph.get("batcher", set())


def test_condition_wait_releases_held_stack():
    """engine pattern: a RankedCondition sharing its lock; wait() must
    drop the held-stack entry (the raw lock IS released) and restore
    it on wakeup, so the witness never sees a phantom hold."""
    lock = locks.RankedLock("engine.waiters")
    cond = locks.RankedCondition(lock=lock)
    seen = []

    def waiter():
        with cond:
            seen.append(locks.held_locks())
            cond.wait(10)
            seen.append(locks.held_locks())

    t = threading.Thread(target=waiter)
    with locks.capture_violations() as got:
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with cond:
                if len(seen) == 1:
                    cond.notify_all()
                    break
            time.sleep(0.005)
        t.join(10)
    assert not t.is_alive()
    assert seen == [[("engine.waiters", 0)], [("engine.waiters", 0)]]
    assert got == []


def test_exempt_requires_reason_and_suppresses():
    with pytest.raises(ValueError):
        with locks.exempt(""):
            pass
    hi = locks.RankedLock("serving.session")
    lo = locks.RankedLock("repository")
    with locks.capture_violations() as got:
        with locks.exempt("test: deliberate inversion"):
            with hi:
                with lo:
                    pass
    assert got == []


def test_level0_factories_return_raw_primitives():
    prev = locks.set_check_mode("0")
    try:
        lk = locks.RankedLock("repository")
        rl = locks.RankedRLock("repository.model")
        cv = locks.RankedCondition("batcher.queue")
        assert type(lk) is type(threading.Lock())
        assert type(rl) is type(threading.RLock())
        assert isinstance(cv, threading.Condition)
    finally:
        locks.set_check_mode(prev)


def test_unknown_lock_name_is_rejected():
    with pytest.raises(KeyError):
        locks.RankedLock("no.such.lock")


# -- the port's own contracts -------------------------------------------


def test_rank_table_is_the_jax_one():
    assert locks.LOCK_RANKS == jlocks.LOCK_RANKS


@pytest.mark.parametrize("kind", ["out_of_rank", "self_deadlock"])
def test_violation_kinds_equal_jax(kind):
    """The same inversion recorded by both witnesses, on locks of names
    of their own: an edge between real names would stay in the JAX
    package's process-wide order graph and close a cycle in a later JAX
    test."""
    got = {}
    for key, mod in (("jax", jlocks), ("port", locks)):
        prev = mod.set_check_mode("warn")
        try:
            hi = mod.RankedLock(f"twin.{kind}.hi", rank=40)
            lo = mod.RankedLock(f"twin.{kind}.lo", rank=10)
            with mod.capture_violations() as rec:
                with hi:
                    if kind == "out_of_rank":
                        with lo:
                            pass
                    else:
                        hi.acquire(blocking=False)
            got[key] = [(v["kind"], v["held"], v["acquiring"])
                        for v in rec]
        finally:
            mod.set_check_mode(prev)
    assert got["port"] == got["jax"] and got["port"]


def test_port_locks_are_built_on_the_factories():
    """Every port lock whose JAX counterpart has a name in LOCK_RANKS."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.gluon import fused_step
    from mxnet_tpu_torch.resilience import CircuitBreaker, faults
    from mxnet_tpu_torch.serving import metrics as smetrics
    from mxnet_tpu_torch.serving.repository import ModelRepository, _Model
    from mxnet_tpu_torch.serving.state import SessionStateStore
    from mxnet_tpu_torch.telemetry import metrics as tmetrics

    store = SessionStateStore([(4,)], max_sessions=2, ctx=mx.cpu())
    bat = serving.DynamicBatcher(_EchoSession(), max_batch_size=2,
                                 max_latency_ms=1, admission=False)
    repo = ModelRepository()
    try:
        found = {
            "serving.store": store._lock,
            "batcher": bat._lock,
            "batcher.queue": bat._queue._cond,
            "repository": repo._lock,
            "repository.model": _Model("m").lock,
            "serving.metrics": smetrics.ServingMetrics()._lock,
            "resilience.breaker": CircuitBreaker()._lock,
            "utils.lru": fused_step._FusedStepCache(4)._lock,
            "telemetry.counters": tmetrics.CounterFamily("x")._lock,
            "telemetry.registry": tmetrics.MetricsRegistry()._lock,
        }
        for lname, lock in found.items():
            assert lock.name == lname and \
                lock.rank == locks.LOCK_RANKS[lname], lname
        # module-level locks, built at import under the suite's mode
        for lname, lock in (("resilience.faults", faults._LOCK),
                            ("profiler", profiler._lock),
                            ("telemetry.boot", tmetrics._BOOT_LOCK)):
            assert getattr(lock, "name", lname) == lname
    finally:
        bat.close()
        store.close()
        repo.close()


def test_session_lock_is_reentrant_and_ranked():
    from mxnet_tpu_torch.models import DecoderBlockLM

    mx.random.seed(0)
    net = DecoderBlockLM(16, embed_dim=8, num_layers=1, num_heads=2,
                         max_len=8)
    net.initialize(ctx=mx.cpu())
    sess = serving.InferenceSession(net, input_shapes=[(1, 1)],
                                    input_dtypes=["int32"],
                                    state_shapes=net.state_row_shapes(),
                                    state_dtypes=net.state_row_dtypes(),
                                    buckets=[1], ctx=mx.cpu())
    try:
        assert sess._lock.name == "serving.session"
        with sess._lock:
            with sess._lock:
                assert locks.held_locks() == [("serving.session", 40)]
    finally:
        sess.close()


class _EchoSession:
    """Duck-typed session for the batcher: echoes 2*x per row."""

    max_batch = 8

    def validate(self, *inputs):
        arr = onp.asarray(inputs[0], dtype="float32")
        return [arr], arr.shape[0]

    def predict(self, x):
        return x * 2.0


def test_stress_store_and_batcher_under_error_mode(error_mode):
    """4 threads churn a SessionStateStore (open/acquire/gather/scatter/
    release/evict) while 4 more drive a DynamicBatcher submit storm
    through close, in ``error`` mode, where an out-of-rank acquire or a
    cycle raises at its site. No violation and no lost response."""
    from mxnet_tpu_torch.serving.state import SessionStateStore

    store = SessionStateStore([(4,)], max_sessions=16, ctx=mx.cpu())
    bat = serving.DynamicBatcher(_EchoSession(), max_batch_size=8,
                                 max_latency_ms=2, num_workers=2,
                                 admission=False)
    errors = []
    n_iters = 12

    def store_worker(tid):
        try:
            for i in range(n_iters):
                sid = f"s{tid}-{i % 4}"
                try:
                    if not store.has(sid):
                        store.open(sid)
                    rec = store.acquire(sid)
                    states = store.gather([rec])
                    store.scatter([rec], [s + 1.0 for s in states])
                    store.release(rec)
                    if i % 5 == 4:
                        store.evict(sid, reason="stress churn")
                except mx.base.MXNetError:
                    pass  # evicted by a neighbour under pressure
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    def batcher_worker(tid):
        try:
            futs = [bat.submit(onp.full((1, 2), float(tid * n_iters + i),
                                        dtype="float32"))
                    for i in range(n_iters)]
            for i, f in enumerate(futs):
                out = f.result(timeout=30)
                assert float(out[0, 0]) == 2.0 * (tid * n_iters + i)
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=store_worker, args=(t,))
               for t in range(4)]
    threads += [threading.Thread(target=batcher_worker, args=(t,))
                for t in range(4)]
    before = len(locks.violations())
    locks.reset_order_graph()  # only this run's edges below
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    bat.close()
    store.close()
    assert errors == [], errors
    assert locks.violations()[before:] == []
    graph = locks.order_graph()
    assert graph  # the run nested ranked locks
    assert all(locks.LOCK_RANKS[a] < locks.LOCK_RANKS[b]
               for a, outs in graph.items() for b in outs
               if a in locks.LOCK_RANKS and b in locks.LOCK_RANKS)
