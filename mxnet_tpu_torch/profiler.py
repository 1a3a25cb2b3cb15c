"""Profiler (reference: python/mxnet/profiler.py over src/profiler/).

The PyTorch counterpart of ``mxnet_tpu/profiler.py``. Two layers, as in
the reference:

- **the device trace**: ``start()`` opens a ``torch.profiler.profile``
  with the CPU and, when a card is present, the CUDA activity (kineto's
  CUPTI tracing); ``stop()`` writes its Chrome trace beside the host
  trace, as ``<stem>_device.json`` for a configured ``filename``
  ``<stem>.json``. It is the counterpart of the JAX package's
  ``<logdir>_xplane``. On the card a device trace that cannot start or
  cannot be written raises: there is no silent CPU-only stand-in. With
  no card the trace holds the CPU activity only. The device trace keeps
  kineto's clock, apart from the host trace's;
- **host-side scoped stats**: Domain/Task/Frame/Event/Counter/Marker
  objects, ``record_op`` dispatch timings and an aggregate table
  (reference aggregate_stats.cc), printed by ``dumps()``; ``dump()``
  writes them with the telemetry spans and one counter sample per
  registry counter as chrome://tracing JSON.

Each ``*_counters()`` function is a view over the telemetry registry,
one for each JAX family the port has a subsystem for; the port's own
families (``cached_op``, ``executor``, ``kernel_launches``) read through
``telemetry.family_snapshot``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import defaultdict

from .utils import locks as _locks

__all__ = ["set_config", "set_state", "start", "stop", "pause", "resume",
           "is_running", "imperative_on", "record_op", "dump", "dumps",
           "device_trace_path", "Domain", "Task", "Frame", "Event",
           "Counter", "Marker", "fused_step_counters",
           "compile_cache_counters", "serving_counters",
           "pipeline_counters", "resilience_counters", "graph_opt_counters",
           "graph_verify_counters",
           "fusion_counters", "quantize_counters", "lock_check_counters"]

_config = {"filename": "profile.json", "profile_all": False,
           "profile_symbolic": False, "profile_imperative": False,
           "profile_memory": False, "profile_api": False,
           "aggregate_stats": False, "continuous_dump": False}
_state = {"running": False, "device_trace": None, "device_path": None}
# guards: _agg, _events
_lock = _locks.RankedLock("profiler")
_agg = defaultdict(lambda: {"count": 0, "total": 0.0, "min": float("inf"),
                            "max": 0.0})
_events = []  # chrome-trace event dicts


def set_config(**kwargs):
    """Reference: profiler.py:33 set_config."""
    for k, v in kwargs.items():
        if k not in _config:
            raise ValueError(f"unknown profiler option {k}")
        _config[k] = v


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


def _device_path(fname):
    stem = fname[:-5] if fname.endswith(".json") else fname
    return stem + "_device.json"


def start(profile_process="worker"):
    """Start profiling; opens the device trace (``torch.profiler``) when
    a filename is configured. On the card the CUDA activity is required:
    a trace that cannot start raises."""
    if _state["running"]:
        return
    if _config.get("filename") and _state["device_trace"] is None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       profile_memory=bool(_config["profile_memory"]))
        prof.__enter__()
        _state["device_trace"] = prof
    _state["running"] = True


def stop(profile_process="worker"):
    """Stop profiling and write the device trace (``<stem>_device.json``).
    Finalizes the device trace even when ``pause()`` flipped ``running``
    off. Writing it raises on failure."""
    _state["running"] = False
    prof = _state["device_trace"]
    if prof is not None:
        _state["device_trace"] = None
        prof.__exit__(None, None, None)
        path = _device_path(_config.get("filename") or "profile.json")
        prof.export_chrome_trace(path)
        _state["device_path"] = path
    if _config.get("continuous_dump"):
        dump()


def device_trace_path():
    """The device trace the last ``stop()`` wrote, or None."""
    return _state["device_path"]


def pause(profile_process="worker"):
    _state["running"] = False


def resume(profile_process="worker"):
    _state["running"] = True


def is_running():
    return _state["running"]


def imperative_on():
    """Fast gate checked by the op-dispatch layer (reference: the
    PROFILER_MESSAGE taps in src/imperative/imperative_utils.h fire when
    profile_imperative/profile_all is set and the profiler runs)."""
    return _state["running"] and (_config["profile_imperative"]
                                  or _config["profile_all"])


def record_op(name, start_us, dur_us, cached=None):
    """Per-op dispatch timing. Torch launches asynchronously: this is
    the host's dispatch time, not the card's; the card's time is in the
    device trace. ``cached`` is kept for the JAX package's event shape
    (the port has no dispatch executable cache, so it is always
    False)."""
    _record("operator", name, start_us, dur_us, cat="imperative",
            cached=cached)


def _family(name):
    """One registry family as a flat dict ({} when the owning subsystem
    cannot import)."""
    from .telemetry import metrics as _tm

    _tm._bootstrap_probes()
    return _tm.family_snapshot(name)


def fused_step_counters():
    """The fused step's cache counters (hits, misses, evictions,
    bypasses, CUDA-graph captures and replays, size) and the AMP
    skip-step total. Reading ``skipped_steps`` reads each live
    trainer's device counter, which waits for the card."""
    return _family("fused_step")


def compile_cache_counters():
    """Program-cache counters: disk hits, misses, writes, corrupt and
    pruned entries, serialize skips, retraces (graph-optimizer and
    quantize-pass runs), CUDA-graph captures, ``nvcc`` builds,
    calibrations and shape bucketing."""
    return _family("compile_cache")


def serving_counters():
    """Serving counters: requests, responses, failures, timeouts,
    rejections, latency quantiles per SLO class, queue depth, shedding,
    canary transitions, batch sizes, decode steps, slot occupancy,
    evictions and paged-store gauges."""
    return _family("serving")


def pipeline_counters():
    """Training-pipeline counters: prefetch depth, hits and stalls,
    overlap ratio, dispatch-as-ready gradient buckets, async kvstore
    pushes."""
    return _family("pipeline")


def resilience_counters():
    """Fault-tolerance counters: checkpoint saves (async, waits, write
    seconds, bytes), restores, corrupt checkpoints passed over and pruned
    ones, AutoResume's caught faults and restarts, retry attempts and
    give-ups, circuit breaker trips, injected-fault fires."""
    return _family("resilience")


def graph_verify_counters():
    """The graph verifier's counters: reports dispositioned, their
    diagnostics, errors and warnings, and per-code tallies
    (``MXNET_GRAPH_VERIFY``)."""
    return _family("graph_verify")


def graph_opt_counters():
    """Graph-optimizer counters: graphs optimized or rejected, node
    totals, per-pass rewrite counts and time."""
    return _family("graph_opt")


def fusion_counters():
    """Fusion-clustering counters: clusters per pattern, nodes absorbed,
    implementation picks, fallbacks, serving pad/slice."""
    return _family("fusion")


def quantize_counters():
    """Int8 quantization counters: graphs and nodes quantized, islands
    elided, nodes calibrated, scales folded, weight bytes saved, KV
    pages quantized."""
    return _family("quantize")


def lock_check_counters():
    """Ranked-lock witness counters (out-of-rank acquires, lock-order
    cycles, order-graph edges, self-deadlocks, dropped records); zero
    when ``MXNET_LOCK_CHECK`` is off or nothing fired."""
    return _locks.lock_check_counters()


def _record(domain, name, start_us, dur_us, cat="event", value=None,
            cached=None):
    with _lock:
        if cat == "counter":
            # chrome-trace counter sample: ph 'C' with the value payload
            _events.append({"name": name, "cat": cat, "ph": "C",
                            "ts": start_us, "pid": 0,
                            "args": {name: value}})
        else:
            args = {"domain": domain}
            if cached is not None:
                args["cached"] = bool(cached)
            _events.append({"name": name, "cat": cat, "ph": "X",
                            "ts": start_us, "dur": dur_us, "pid": 0,
                            "tid": threading.get_ident() % 100000,
                            "args": args})
        a = _agg[(domain, name)]
        a["count"] += 1
        if cat == "counter":
            a["total"] = float(value)  # last observed value
            a["min"] = min(a["min"], float(value))
            a["max"] = max(a["max"], float(value))
        else:
            a["total"] += dur_us
            a["min"] = min(a["min"], dur_us)
            a["max"] = max(a["max"], dur_us)


def dump(finished=True, profile_process="worker"):
    """Write the host trace as chrome://tracing JSON: the profiler's
    own events (Domain/Task scopes, ``record_op`` timings), the
    telemetry spans, and one counter sample per registry counter
    (``<family>/<counter>``). Returns the file name."""
    from .telemetry import exporter as _exporter

    fname = _config.get("filename") or "profile.json"
    with _lock:
        host = list(_events)
    _exporter.dump_trace(fname, extra_events=host)
    return fname


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Aggregate stats table (reference: profiler.py:151 dumps)."""
    with _lock:
        rows = [(d, n, v["count"], v["total"], v["min"], v["max"],
                 v["total"] / max(v["count"], 1))
                for (d, n), v in _agg.items()]
        if reset:
            _agg.clear()
    rows.sort(key=lambda r: r[3], reverse=not ascending)
    if format == "json":
        return json.dumps([{"domain": d, "name": n, "count": c,
                            "total_us": t, "min_us": mn, "max_us": mx,
                            "avg_us": av}
                           for d, n, c, t, mn, mx, av in rows])
    lines = ["%-20s %-30s %8s %12s %10s %10s %10s" %
             ("Domain", "Name", "Count", "Total(us)", "Min(us)",
              "Max(us)", "Avg(us)")]
    for d, n, c, t, mn, mx, av in rows:
        lines.append("%-20s %-30s %8d %12.1f %10.1f %10.1f %10.1f"
                     % (d, n, c, t, mn, mx, av))
    return "\n".join(lines)


class Domain:
    """Reference: profiler.py Domain — namespace for profiler objects."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_event(self, name):
        return Event(name, domain=self)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Scoped:
    def __init__(self, domain, name):
        self.domain = domain.name if isinstance(domain, Domain) else \
            str(domain)
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        dur = (time.perf_counter() - self._t0) * 1e6
        _record(self.domain, self.name, self._t0 * 1e6, dur,
                cat=type(self).__name__.lower())
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class Task(_Scoped):
    pass


class Frame(_Scoped):
    pass


class Event(_Scoped):
    def __init__(self, name, domain=None):
        super().__init__(domain or Domain("event"), name)


class Counter:
    def __init__(self, domain, name, value=None):
        self.domain = domain.name
        self.name = name
        self.value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self.value = value
        _record(self.domain, self.name, time.perf_counter() * 1e6, 0,
                cat="counter", value=value)

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Marker:
    def __init__(self, domain, name):
        self.domain = domain.name
        self.name = name

    def mark(self, scope="process"):
        _record(self.domain, self.name, time.perf_counter() * 1e6, 0,
                cat="marker")

