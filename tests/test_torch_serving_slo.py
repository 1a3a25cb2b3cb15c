"""SLO machinery of the port against the JAX package's, on the CPU:
latency histograms, the metrics registry's Prometheus families, SLO
admission, the circuit breaker, the fault seams and the per-class
queue lanes.

Each runs the same observation, event and clock sequence in both
packages and must agree EXACTLY: these are bookkeeping and decisions,
no tensor arithmetic (the histogram quantiles are the same float
expressions over the same counts).
"""
import queue
import re

import numpy as onp
import pytest

from mxnet_tpu.resilience import breaker as jbreaker
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.serving import admission as jadmission
from mxnet_tpu.serving import batcher as jbatcher
from mxnet_tpu.serving import metrics as jmetrics
from mxnet_tpu_torch.resilience import breaker as tbreaker
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serving import admission as tadmission
from mxnet_tpu_torch.serving import batcher as tbatcher
from mxnet_tpu_torch.serving import metrics as tmetrics

QS = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)


def _latencies(seed, n=500):
    rs = onp.random.RandomState(seed)
    # log-uniform over the bounds' span, plus overflow values past 60 s
    vals = list(10 ** rs.uniform(-4.5, 1.9, n)) + [75.0, 120.0]
    return [float(v) for v in vals]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_quantiles_equal_reference(seed):
    j, t = jmetrics.LatencyHistogram(), tmetrics.LatencyHistogram()
    assert j.quantile(0.5) == t.quantile(0.5) == 0.0
    for v in _latencies(seed):
        j.observe(v)
        t.observe(v)
    assert t.snapshot() == j.snapshot()
    assert [t.quantile(q) for q in QS] == [j.quantile(q) for q in QS]
    jb = jmetrics.LatencyHistogram(jmetrics.BATCH_BOUNDS)
    tb = tmetrics.LatencyHistogram(tmetrics.BATCH_BOUNDS)
    for v in onp.random.RandomState(seed).randint(1, 700, 100):
        jb.observe(int(v))
        tb.observe(int(v))
    assert [tb.quantile(q) for q in QS] == [jb.quantile(q) for q in QS]


def test_rolling_histogram_equal_reference_on_one_clock():
    """Frames rotate every window/2 on the injected clock: a spike ages
    out, a late read past both frames starts clean."""
    j, t = jmetrics.RollingHistogram(window_s=4.0), \
        tmetrics.RollingHistogram(window_s=4.0)
    lat = _latencies(3, 200)
    clock = onp.cumsum(onp.random.RandomState(4).exponential(0.05, 200))
    for k, (v, now) in enumerate(zip(lat, clock)):
        v = v * (50 if 60 <= k < 80 else 1)  # a spike
        j.observe(v, float(now))
        t.observe(v, float(now))
        if k % 7 == 0:
            assert [t.quantile(q, float(now)) for q in QS] == \
                [j.quantile(q, float(now)) for q in QS]
            assert t.total == j.total
    late = float(clock[-1]) + 100.0
    assert t.quantile(0.99, late) == j.quantile(0.99, late) == 0.0


def _families(text):
    """{family: sorted label keys} of a Prometheus text, for the serving
    families."""
    fams = {}
    for line in text.splitlines():
        m = re.match(r"# TYPE (mxnet_serving_\S+) (\S+)", line)
        if m:
            fams[m.group(1)] = (m.group(2), set())
            continue
        m = re.match(r"(mxnet_serving_[a-z0-9_]+)\{([^}]*)\}", line)
        if m:
            name = re.sub(r"_(bucket|sum|count)$", "", m.group(1)) \
                if m.group(1) not in fams else m.group(1)
            keys = {kv.split("=")[0] for kv in m.group(2).split(",")}
            fams[name][1].update(keys)
    return {k: (typ, sorted(keys)) for k, (typ, keys) in fams.items()}


def _drive(reg):
    for k, v in enumerate(_latencies(5, 60)):
        cls = ("critical", "standard", "best_effort", None)[k % 4]
        reg.observe_request(v, failed=k % 9 == 0, timed_out=k % 18 == 0,
                            slo_class=cls)
        reg.bump("requests")
        reg.bump_class("requests", cls or "standard")
    reg.observe_shed("best_effort")
    reg.observe_batch(3, 0.004)
    reg.observe_flush(0.001)


def test_registry_families_labels_and_snapshot_keys_equal_reference():
    j, t = jmetrics.ServingMetrics(), tmetrics.ServingMetrics()
    for reg in (j, t):
        _drive(reg)
    jt, tt = j.prometheus_text(), t.prometheus_text()
    assert _families(tt) == _families(jt)
    assert any(k == "slo_class" for _, keys in _families(tt).values()
               for k in keys)
    js, ts = j.snapshot(), t.snapshot()
    assert set(ts) == set(js)
    for key in ("requests", "responses", "failures", "timeouts", "shed",
                "deadline_met", "latency_p50_ms", "latency_p99_ms",
                "exec_p50_ms", "latency_p99_ms:critical",
                "responses:best_effort", "shed:best_effort", "pad_ratio",
                "batch_rows_mean"):
        assert ts[key] == js[key], key
    assert t.exec_estimate_s() == j.exec_estimate_s()


def test_probes_feed_gauges_like_reference():
    j, t = jmetrics.ServingMetrics(), tmetrics.ServingMetrics()
    for reg in (j, t):
        tokens = [reg.register_depth_probe(lambda: 3),
                  reg.register_headroom_probe(lambda: 0.4),
                  reg.register_headroom_probe(lambda: 0.7),
                  reg.register_occupancy_probe(lambda: 5),
                  reg.register_page_probe(lambda: {
                      "pages_total": 10, "pages_used": 4,
                      "pages_per_session": [1, 3, 0, 2],
                      "kv_bytes": 4096})]
        reg.register_depth_probe(lambda: 1 / 0)  # a broken probe reads 0
    assert t.queue_depth() == j.queue_depth() == 3
    assert t.slo_headroom() == j.slo_headroom() == 0.4
    assert t.slot_occupancy() == j.slot_occupancy() == 5
    assert t.page_stats() == j.page_stats()
    t.unregister_depth_probe(tokens[0])
    assert t.queue_depth() == 0


class _FakeStore:
    def __init__(self, occupancy, slots, page_headroom=None):
        self.occupancy, self.num_slots = occupancy, slots
        self._ph = page_headroom

    def page_headroom(self):
        return self._ph


class _FakeBatcher:
    """What an AdmissionController reads of its batcher."""

    def __init__(self, depth, capacity, store=None):
        self.depth, self.capacity = depth, capacity
        self.session = type("S", (), {"state_store": store})()

    def qsize(self):
        return self.depth

    def queue_capacity(self):
        return self.capacity


def _decisions(mod, metrics_mod, faults_mod):
    """Shed decisions of one package over a fixed sweep of queue depths,
    rolling p99s, slot/page pressure and a forced-shed fault."""
    metrics_mod.METRICS.reset()
    out = []
    store = _FakeStore(7, 8, page_headroom=0.05)
    for depth in (0, 200, 640, 700, 760):
        bat = _FakeBatcher(depth, 768, store)
        ctl = mod.AdmissionController(bat, slo_ms=100.0, shed_headroom=0.2,
                                      enabled=True)
        for cls in ("critical", "standard", "best_effort"):
            for alloc in (False, True):
                try:
                    ctl.check(cls, allocates_state=alloc)
                    out.append((depth, cls, alloc, "admit"))
                except mod.ShedLoad as e:
                    out.append((depth, cls, alloc, "shed",
                                e.retry_after_s))
        out.append(("headroom", round(ctl.headroom(), 12),
                    round(ctl._slot_headroom(), 12)))
        snap = ctl.snapshot()
        out.append(("snapshot", snap["shedding"], snap["headroom"]))
        ctl.close()
    # latency pressure: the protected class's rolling p99 near the SLO
    for v in (0.05, 0.08, 0.095, 0.2):
        metrics_mod.METRICS.observe_request(v, slo_class="standard")
        ctl = mod.AdmissionController(_FakeBatcher(0, 768), slo_ms=100.0,
                                      shed_headroom=0.2, enabled=True)
        for cls in ("standard", "best_effort"):
            try:
                ctl.check(cls)
                out.append((v, cls, "admit"))
            except mod.ShedLoad:
                out.append((v, cls, "shed"))
        ctl.close()
    metrics_mod.METRICS.reset()
    with faults_mod.inject("serving_admission", every=1):
        ctl = mod.AdmissionController(_FakeBatcher(0, 768), enabled=True)
        for cls in ("critical", "standard", "best_effort"):
            try:
                ctl.check(cls)
                out.append(("fault", cls, "admit"))
            except mod.ShedLoad:
                out.append(("fault", cls, "shed"))
        ctl.close()
    counts = metrics_mod.METRICS.snapshot()
    out.append(("shed", counts["shed"], counts["shed:best_effort"],
                counts["shed:standard"], counts["shed:critical"]))
    metrics_mod.METRICS.reset()
    return out


def test_admission_decisions_equal_reference():
    got = _decisions(tadmission, tmetrics, tfaults)
    assert got == _decisions(jadmission, jmetrics, jfaults)
    assert ("fault", "critical", "admit") in got
    assert ("fault", "best_effort", "shed") in got


def test_normalize_class_as_reference():
    for c in (None, "critical", "standard", "best_effort"):
        assert tadmission.normalize_class(c) == jadmission.normalize_class(c)
    for mod in (tadmission, jadmission):
        with pytest.raises(ValueError, match="unknown SLO class"):
            mod.normalize_class("gold")
    assert tadmission.admission_enabled() == jadmission.admission_enabled()


def _breaker_trace(mod, events):
    now = [100.0]
    br = mod.CircuitBreaker(threshold=3, cooldown_ms=500, name="t",
                            clock=lambda: now[0])
    trace = []
    for ev in events:
        if ev == "f":
            br.record_failure()
        elif ev == "s":
            br.record_success()
        elif ev == "a":
            trace.append(("allow", br.allow()))
        else:
            now[0] += ev
        trace.append((br.state, br.failures))
    try:
        br.check()
        trace.append("pass")
    except mod.CircuitOpen as e:
        trace.append(str(e))
    return trace


@pytest.mark.parametrize("events", [
    ["f", "f", "s", "f", "f", "f", "a", 0.2, "a", 0.4, "a", "a", "s", "a"],
    ["f", "f", "f", 0.6, "a", "f", "a", 0.5, "a", "f", 0.49, "a"],
    ["a", "f", 0.1, "f", "a", "f", "f", 1.0, "a", "s", "f"],
])
def test_breaker_transitions_equal_reference(events, monkeypatch):
    assert _breaker_trace(tbreaker, events) == \
        _breaker_trace(jbreaker, events)
    monkeypatch.setenv("MXNET_RESILIENCE", "0")
    assert _breaker_trace(tbreaker, events) == \
        _breaker_trace(jbreaker, events)


@pytest.mark.parametrize("clause", [
    dict(at=3), dict(every=2), dict(every=3, after=2, times=2),
    dict(prob=0.3, seed=7), dict(at=1, exc=ValueError)])
def test_fault_clauses_fire_as_reference(clause):
    def fires(mod):
        out = []
        with mod.inject("serving_execute", **clause):
            for _ in range(20):
                try:
                    mod.maybe_fail("serving_execute")
                    mod.maybe_fail("model_swap")  # not armed: never fires
                    out.append(0)
                except (mod.InjectedFault, ValueError) as e:
                    out.append(type(e).__name__)
        return out

    assert fires(tfaults) == fires(jfaults)
    assert not tfaults.armed()


def test_inject_nests_and_refuses_unknown_points():
    with tfaults.inject("model_swap", every=1):
        with tfaults.inject("serving_admission", every=1):
            tfaults.maybe_fail("model_swap")  # the inner plan replaced it
        with pytest.raises(tfaults.InjectedFault):
            tfaults.maybe_fail("model_swap")
    with pytest.raises(Exception, match="unknown fault point"):
        tfaults.inject("no_such_point", every=1)
    tfaults.clear()
    assert not tfaults.armed()


def test_class_lanes_pop_in_reference_order():
    """The same puts and gets in both lane sets: the same order out,
    the same per-class Full, sentinels only after the data."""
    def run(mod):
        q = mod._ClassQueues(3)
        reqs = [mod._Request([], 1, None, cls) for cls in
                ("best_effort", "standard", "critical", "standard",
                 "best_effort", "critical", "standard", "standard")]
        out = []
        for i, r in enumerate(reqs):
            try:
                q.put_nowait(r)
            except queue.Full:
                out.append(("full", i))
        q.put(mod._STOP)
        out.append(q.qsize_by_class())
        out.append(q.capacity())
        while True:
            item = q.get(timeout=0)
            if item is mod._STOP:
                out.append("stop")
                break
            out.append(reqs.index(item))
        with pytest.raises(queue.Empty):
            q.get_nowait()
        return out

    assert run(tbatcher) == run(jbatcher)
