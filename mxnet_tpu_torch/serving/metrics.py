"""Serving metrics: latency histograms, per-class counters, gauges and
the Prometheus text of ``/metrics``.

The PyTorch counterpart of ``mxnet_tpu/serving/metrics.py``, with the
same bounds, quantile rule, counter names, probes and Prometheus family
names and label keys. One process-wide :class:`ServingMetrics`,
:data:`METRICS`, backs every session, store, batcher, admission
controller, repository and server:

- **Latency histograms** (log-spaced fixed bounds): request latency
  (submit to result), execution latency (one coalesced batch or decode
  step), time-to-flush, rows per batch. Quantiles interpolate linearly
  inside the owning bucket.
- **Counters**, and their per-SLO-class slices (:data:`SLO_CLASSES`),
  with per-class :class:`RollingHistogram` latencies: a p99 that recovers
  once a spike ages out, which admission control reads.
- **Gauges**, probed at read time from the live components: queue
  depth (batchers), SLO headroom (admission controllers), slot
  occupancy and KV pages (state stores).
"""
from __future__ import annotations

import bisect
import itertools
import threading
import time
from collections import deque


__all__ = ["LatencyHistogram", "RollingHistogram", "ServingMetrics",
           "METRICS", "SLO_CLASSES", "serving_stats",
           "reset_serving_counters", "prometheus_text"]

#: request priority classes, highest priority first. "critical" is the
#: protected class (admission control never sheds it); "best_effort"
#: sheds first when headroom runs out. Defined here (the lowest layer
#: of serving/) so batcher, admission and repository all agree.
SLO_CLASSES = ("critical", "standard", "best_effort")

#: log-spaced latency bucket upper bounds, seconds (last bucket +inf)
LATENCY_BOUNDS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: batch-size bucket upper bounds, rows (last bucket +inf)
BATCH_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

_QPS_WINDOW_S = 60.0


class LatencyHistogram:
    """Fixed-bound histogram with interpolated quantiles.

    Bounds are upper edges; one overflow bucket catches everything past
    the last bound. ``observe`` is O(log buckets) (bisect) under the
    shared registry lock — the caller holds it."""

    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds=LATENCY_BOUNDS_S):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, value):
        self.counts[bisect.bisect_left(self.bounds, float(value))] += 1
        self.total += 1
        self.sum += float(value)

    def quantile(self, q):
        """Value at quantile ``q`` (0..1), linearly interpolated inside
        the owning bucket; 0.0 when empty. The overflow bucket reports
        its lower edge (there is no upper edge to interpolate toward)."""
        if self.total == 0:
            return 0.0
        rank = q * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if i >= len(self.bounds):
                    return self.bounds[-1]
                hi = self.bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.bounds[-1]

    def snapshot(self):
        return {"total": self.total, "sum": self.sum,
                "counts": list(self.counts)}


class RollingHistogram:
    """Sliding-window histogram: two :class:`LatencyHistogram` frames
    rotated every ``window_s / 2``; reads merge both frames, so a
    quantile covers the last ``window_s/2 .. window_s`` seconds of
    observations and recovers once a spike ages out. The caller (the
    registry) holds the lock and passes ``now``."""

    __slots__ = ("bounds", "_half", "_cur", "_prev", "_flip_at")

    def __init__(self, bounds=LATENCY_BOUNDS_S, window_s=20.0):
        self.bounds = tuple(float(b) for b in bounds)
        self._half = float(window_s) / 2.0
        self._cur = LatencyHistogram(self.bounds)
        self._prev = LatencyHistogram(self.bounds)
        self._flip_at = None  # armed on first observe

    def _rotate(self, now):
        if self._flip_at is None:
            self._flip_at = now + self._half
            return
        if now < self._flip_at:
            return
        # one flip when we're late by less than a frame; both frames
        # are stale past that, so start clean instead of promoting
        self._prev = self._cur if now - self._flip_at < self._half \
            else LatencyHistogram(self.bounds)
        self._cur = LatencyHistogram(self.bounds)
        self._flip_at = now + self._half

    def observe(self, value, now):
        self._rotate(now)
        self._cur.observe(value)

    @property
    def total(self):
        return self._cur.total + self._prev.total

    def quantile(self, q, now):
        self._rotate(now)
        if self._prev.total == 0:
            return self._cur.quantile(q)
        merged = LatencyHistogram(self.bounds)
        merged.counts = [a + b for a, b in zip(self._cur.counts,
                                               self._prev.counts)]
        merged.total = self._cur.total + self._prev.total
        return merged.quantile(q)


_COUNTER_NAMES = (
    "requests", "responses", "failures", "invalid", "timeouts",
    "rejected", "batches", "inline", "warm_disk_hits", "warm_compiles",
    "bucket_execs", "padded_rows", "true_rows",
    # round 13: SLO-aware admission + model repository
    "shed", "deadline_met", "canary_requests", "canary_failures",
    "canary_fallbacks", "canary_deploys", "canary_promotions",
    "canary_rollbacks", "model_swaps",
    # round 16: stateful continuous-batching decode
    "decode_steps", "evictions", "resumed_sessions",
    # round 19: the MXNET_QUANTIZE_SHADOW accuracy gate
    "canary_shadow_checks", "canary_shadow_mismatches",
)

#: the per-SLO-class slice of the counters (suffixed ``:<class>``)
_CLASS_COUNTER_NAMES = ("requests", "responses", "failures",
                        "timeouts", "shed")


class ServingMetrics:
    """Process-wide serving metric registry (single lock; every
    mutation is a couple of integer bumps, cheap enough for the request
    path)."""

    def __init__(self):
        # guards: _depth_probes, _headroom_probes, _occupancy_probes,
        # _page_probes
        self._lock = threading.Lock()
        self._tokens = itertools.count()
        self._reset_locked()
        self._depth_probes = {}  # token -> callable() -> int
        self._headroom_probes = {}  # token -> callable() -> float
        self._occupancy_probes = {}  # token -> callable() -> int
        self._page_probes = {}  # token -> callable() -> dict

    def _reset_locked(self):
        self.counters = dict.fromkeys(_COUNTER_NAMES, 0)
        self.class_counters = {
            c: dict.fromkeys(_CLASS_COUNTER_NAMES, 0)
            for c in SLO_CLASSES}
        self.request_latency = LatencyHistogram()
        self.exec_latency = LatencyHistogram()
        self.flush_wait = LatencyHistogram()
        self.batch_rows = LatencyHistogram(BATCH_BOUNDS)
        self.class_latency = {c: RollingHistogram() for c in SLO_CLASSES}
        self._completions = deque()  # monotonic stamps, QPS window
        self._goodput = deque()  # stamps of deadline-met completions
        self._started = time.monotonic()

    # -- mutation (request path) -------------------------------------

    def bump(self, name, n=1):
        with self._lock:
            self.counters[name] += n

    def bump_class(self, name, slo_class, n=1):
        """Bump the per-class slice of counter ``name`` (unknown
        classes fold into "standard" rather than KeyError — the
        request path must never crash on a label)."""
        with self._lock:
            per = self.class_counters.get(slo_class) or \
                self.class_counters["standard"]
            per[name] += n

    def observe_request(self, latency_s, failed=False, timed_out=False,
                        slo_class=None, met_deadline=None):
        """One completed (or failed) request. ``slo_class`` routes the
        observation into the per-class counters and rolling histogram;
        ``met_deadline`` feeds goodput (None means "met iff it didn't
        fail" — callers without a deadline notion stay correct)."""
        now = time.monotonic()
        met = (not failed) if met_deadline is None else bool(met_deadline)
        with self._lock:
            self.counters["responses"] += 1
            if failed:
                self.counters["failures"] += 1
            if timed_out:
                self.counters["timeouts"] += 1
            if met:
                self.counters["deadline_met"] += 1
                self._goodput.append(now)
            self.request_latency.observe(latency_s)
            if slo_class is not None:
                per = self.class_counters.get(slo_class) or \
                    self.class_counters["standard"]
                per["responses"] += 1
                if failed:
                    per["failures"] += 1
                if timed_out:
                    per["timeouts"] += 1
                hist = self.class_latency.get(slo_class) or \
                    self.class_latency["standard"]
                hist.observe(latency_s, now)
            self._completions.append(now)
            self._trim_window_locked(now)

    def observe_shed(self, slo_class):
        """One request shed by admission control (fast 503 at submit —
        it never entered the queue)."""
        with self._lock:
            self.counters["shed"] += 1
            per = self.class_counters.get(slo_class) or \
                self.class_counters["standard"]
            per["shed"] += 1

    def observe_batch(self, rows, exec_s):
        """One session.predict execution (bucket_execs counts the
        underlying bucket-executable invocations separately — a
        chunked oversized predict runs several per batch)."""
        with self._lock:
            self.counters["batches"] += 1
            self.batch_rows.observe(rows)
            self.exec_latency.observe(exec_s)

    def observe_flush(self, wait_s):
        """Time the batcher held a batch's FIRST request before
        executing (the latency cost of coalescing)."""
        with self._lock:
            self.flush_wait.observe(wait_s)

    def _trim_window_locked(self, now):
        cutoff = now - _QPS_WINDOW_S
        while self._completions and self._completions[0] < cutoff:
            self._completions.popleft()
        while self._goodput and self._goodput[0] < cutoff:
            self._goodput.popleft()

    # -- admission-control reads (request path, cheap) ----------------

    def exec_estimate_s(self):
        """p50 model-execution latency in seconds — the batcher's
        flush margin for deadline-aware coalescing. 0.0 before any
        execution (no margin is the right cold-start answer)."""
        with self._lock:
            return self.exec_latency.quantile(0.50)

    def class_latency_s(self, slo_class, q=0.99):
        """Rolling-window latency quantile for one SLO class, seconds
        (0.0 with no recent traffic)."""
        now = time.monotonic()
        with self._lock:
            hist = self.class_latency.get(slo_class)
            return hist.quantile(q, now) if hist is not None else 0.0

    # -- gauges -------------------------------------------------------

    def register_depth_probe(self, probe):
        """Register a live queue-depth callable (a batcher's
        ``qsize``); returns a token for :meth:`unregister_depth_probe`.
        Probed at read time only — depth is never sampled on the
        request path."""
        token = next(self._tokens)
        with self._lock:
            self._depth_probes[token] = probe
        return token

    def unregister_depth_probe(self, token):
        with self._lock:
            self._depth_probes.pop(token, None)

    def queue_depth(self):
        with self._lock:
            probes = list(self._depth_probes.values())
        depth = 0
        for p in probes:
            try:
                depth += int(p())
            except Exception:  # noqa: BLE001 — a probe of a closing
                pass  # component reads as nothing
        return depth

    def register_headroom_probe(self, probe):
        """Register a live SLO-headroom callable (an
        AdmissionController's ``headroom``); returns a token for
        :meth:`unregister_headroom_probe`."""
        token = next(self._tokens)
        with self._lock:
            self._headroom_probes[token] = probe
        return token

    def unregister_headroom_probe(self, token):
        with self._lock:
            self._headroom_probes.pop(token, None)

    def register_occupancy_probe(self, probe):
        """Register a live session-slot occupancy callable (a
        ``SessionStateStore``'s live-session count); returns a token
        for :meth:`unregister_occupancy_probe`. Probed at read time
        only, like queue depth."""
        token = next(self._tokens)
        with self._lock:
            self._occupancy_probes[token] = probe
        return token

    def unregister_occupancy_probe(self, token):
        with self._lock:
            self._occupancy_probes.pop(token, None)

    def slot_occupancy(self):
        """Total live sessions across registered state stores."""
        with self._lock:
            probes = list(self._occupancy_probes.values())
        occ = 0
        for p in probes:
            try:
                occ += int(p())
            except Exception:  # noqa: BLE001 — a probe of a closing
                pass  # component reads as nothing
        return occ

    def register_page_probe(self, probe):
        """Register a KV page-pool sampler (a paged
        ``SessionStateStore``); the callable returns a dict with
        ``pages_total`` / ``pages_used`` / ``pages_per_session``
        (per-live-session page counts) / ``kv_bytes``. Probed at read
        time only. Returns a token for
        :meth:`unregister_page_probe`."""
        token = next(self._tokens)
        with self._lock:
            self._page_probes[token] = probe
        return token

    def unregister_page_probe(self, token):
        with self._lock:
            self._page_probes.pop(token, None)

    def page_stats(self):
        """Aggregated KV page-pool gauges across registered paged
        stores: totals plus p50/p99 pages-per-live-session (0 with no
        paged store or no live sessions)."""
        with self._lock:
            probes = list(self._page_probes.values())
        total = used = kv_bytes = 0
        per = []
        for p in probes:
            try:
                st = p()
                total += int(st.get("pages_total", 0))
                used += int(st.get("pages_used", 0))
                kv_bytes += int(st.get("kv_bytes", 0))
                per.extend(int(v) for v in
                           st.get("pages_per_session", ()))
            except Exception:  # noqa: BLE001 — a probe of a closing
                pass  # component reads as nothing
        per.sort()

        def pct(q):
            if not per:
                return 0
            return per[min(int(q * (len(per) - 1) + 0.5),
                           len(per) - 1)]

        return {"kv_pages_total": total, "kv_pages_used": used,
                "kv_pages_per_session_p50": pct(0.50),
                "kv_pages_per_session_p99": pct(0.99),
                "kv_bytes": kv_bytes}

    def slo_headroom(self):
        """Minimum live headroom across registered admission
        controllers, 0..1 (1.0 with none registered — no controller
        means nothing is at risk that we can see)."""
        with self._lock:
            probes = list(self._headroom_probes.values())
        head = 1.0
        for p in probes:
            try:
                head = min(head, float(p()))
            except Exception:  # noqa: BLE001 — a probe of a closing
                pass  # component reads as nothing
        return max(head, 0.0)

    # -- reading ------------------------------------------------------

    def snapshot(self):
        """Flat numeric dict — the ``profiler.serving_counters()``
        surface. Latencies are reported in milliseconds (matching the
        ``*_ms`` lower-is-better convention of bench_compare)."""
        now = time.monotonic()
        with self._lock:
            st = dict(self.counters)
            self._trim_window_locked(now)
            window = min(_QPS_WINDOW_S, max(now - self._started, 1e-9))
            st["qps_60s"] = round(len(self._completions) / window, 3)
            st["goodput_rps"] = round(len(self._goodput) / window, 3)
            st["shed_rate"] = round(
                st["shed"] / st["requests"], 4) if st["requests"] else 0.0
            for prefix, hist in (("latency", self.request_latency),
                                 ("exec", self.exec_latency)):
                st[f"{prefix}_p50_ms"] = round(
                    hist.quantile(0.50) * 1e3, 3)
                st[f"{prefix}_p95_ms"] = round(
                    hist.quantile(0.95) * 1e3, 3)
                st[f"{prefix}_p99_ms"] = round(
                    hist.quantile(0.99) * 1e3, 3)
            for cls in SLO_CLASSES:
                for name, v in self.class_counters[cls].items():
                    st[f"{name}:{cls}"] = v
                hist = self.class_latency[cls]
                st[f"latency_p50_ms:{cls}"] = round(
                    hist.quantile(0.50, now) * 1e3, 3)
                st[f"latency_p99_ms:{cls}"] = round(
                    hist.quantile(0.99, now) * 1e3, 3)
            st["batch_rows_mean"] = round(
                self.batch_rows.sum / self.batch_rows.total, 3) \
                if self.batch_rows.total else 0.0
            st["pad_ratio"] = round(
                st["padded_rows"] / st["true_rows"], 4) \
                if st["true_rows"] else 0.0
        st["queue_depth"] = self.queue_depth()
        st["slo_headroom"] = round(self.slo_headroom(), 4)
        st["slot_occupancy"] = self.slot_occupancy()
        st.update(self.page_stats())
        return st

    def reset(self):
        """Zero counters and histograms (tests, benchmarks). Depth
        probes survive — they belong to live batchers, not to the
        sample window."""
        with self._lock:
            self._reset_locked()

    def prometheus_text(self):
        """Prometheus text exposition of the registry — the
        ``/metrics`` endpoint body."""
        lines = []

        def emit(name, value, help_=None, typ="counter", labels=""):
            if help_:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {typ}")
            lines.append(f"{name}{labels} {value}")

        now = time.monotonic()
        with self._lock:
            counters = dict(self.counters)
            class_counters = {c: dict(v)
                              for c, v in self.class_counters.items()}
            class_p99 = {c: self.class_latency[c].quantile(0.99, now)
                         for c in SLO_CLASSES}
            hists = [("mxnet_serving_request_latency_seconds",
                      self.request_latency.snapshot(),
                      self.request_latency.bounds,
                      "end-to-end request latency"),
                     ("mxnet_serving_exec_latency_seconds",
                      self.exec_latency.snapshot(),
                      self.exec_latency.bounds,
                      "model execution latency per coalesced batch"),
                     ("mxnet_serving_batch_rows",
                      self.batch_rows.snapshot(),
                      self.batch_rows.bounds,
                      "rows per executed batch")]
        for name, value in sorted(counters.items()):
            emit(f"mxnet_serving_{name}_total", value,
                 help_=f"serving counter {name}")
        for name in _CLASS_COUNTER_NAMES:
            fam = f"mxnet_serving_class_{name}_total"
            lines.append(f"# HELP {fam} per-SLO-class counter {name}")
            lines.append(f"# TYPE {fam} counter")
            for cls in SLO_CLASSES:
                lines.append(f'{fam}{{slo_class="{cls}"}} '
                             f'{class_counters[cls][name]}')
        fam = "mxnet_serving_class_latency_p99_seconds"
        lines.append(f"# HELP {fam} rolling-window p99 request latency")
        lines.append(f"# TYPE {fam} gauge")
        for cls in SLO_CLASSES:
            lines.append(f'{fam}{{slo_class="{cls}"}} {class_p99[cls]}')
        emit("mxnet_serving_queue_depth", self.queue_depth(),
             help_="live batcher queue depth", typ="gauge")
        emit("mxnet_serving_slo_headroom", self.slo_headroom(),
             help_="min live SLO headroom across admission controllers "
                   "(0..1)", typ="gauge")
        emit("mxnet_serving_slot_occupancy", self.slot_occupancy(),
             help_="live sessions holding server-side state slots",
             typ="gauge")
        page_help = {
            "kv_pages_total": "physical KV pages across paged stores",
            "kv_pages_used": "allocated KV pages across paged stores",
            "kv_pages_per_session_p50":
                "median pages held per live session",
            "kv_pages_per_session_p99":
                "p99 pages held per live session",
            "kv_bytes": "bytes held by allocated KV pages"}
        for name, value in sorted(self.page_stats().items()):
            emit(f"mxnet_serving_{name}", value,
                 help_=page_help.get(name, name), typ="gauge")
        try:
            from ..kernels import counters as _fusion_counters

            fam = "mxnet_fusion"
            for name, value in sorted(_fusion_counters().items()):
                emit(f"{fam}_{name}_total", value,
                     help_=f"fusion clustering counter {name}")
        except Exception:  # noqa: BLE001 — best effort on this surface
            pass
        for name, snap, bounds, help_ in hists:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for b, c in zip(bounds, snap["counts"]):
                cum += c
                lines.append(f'{name}_bucket{{le="{b}"}} {cum}')
            lines.append(
                f'{name}_bucket{{le="+Inf"}} {snap["total"]}')
            lines.append(f"{name}_sum {snap['sum']}")
            lines.append(f"{name}_count {snap['total']}")
        return "\n".join(lines) + "\n"


#: the process-wide registry every serving component reports into
METRICS = ServingMetrics()


def serving_stats():
    """Flat numeric serving counters (the profiler surface)."""
    return METRICS.snapshot()


def reset_serving_counters():
    """Zero the process-wide serving counters (tests, benchmarks)."""
    METRICS.reset()


def prometheus_text():
    """Prometheus text rendering of the process-wide registry."""
    return METRICS.prometheus_text()
