"""Chrome-trace / Perfetto JSON exporter.

The PyTorch counterpart of ``mxnet_tpu/telemetry/exporter.py``: one
assembly point for what the process knows about host time:

- the tracer ring's span and instant events (``tracer.events()``);
- thread-name metadata (``"ph": "M"``), so Perfetto labels the batcher
  worker and the device-feed thread by name;
- one counter sample per registry counter (``"ph": "C"``), named
  ``<family>/<counter>``, the samples ``profiler.dump()`` writes;
- optionally, caller-supplied events: ``profiler.dump()`` passes its
  Domain/Task/Frame scopes and ``record_op`` dispatch events, so both
  timelines land in one file.

The output is the Trace Event Format that chrome://tracing and
https://ui.perfetto.dev load: ``{"traceEvents": [...],
"displayTimeUnit": "ms"}``. The card's kernels are in the separate
device trace (``profiler``'s ``<stem>_device.json``), on torch.profiler's
own clock.
"""
from __future__ import annotations

import json

from . import tracer
from . import metrics as _metrics

__all__ = ["counter_samples", "thread_metadata", "build_trace",
           "dump_trace"]


def counter_samples(ts=None):
    """One ``"ph": "C"`` sample per numeric counter in every registry
    family, stamped at ``ts`` (µs; default: now on the tracer clock).
    Sample names are ``<family>/<counter>``, as the JAX package's
    ``profiler.dump()`` names them."""
    _metrics._bootstrap_probes()
    if ts is None:
        import time

        ts = (time.monotonic() - tracer._EPOCH) * 1e6
    out = []
    for family, snap in _metrics.snapshot().items():
        for cname in sorted(snap):
            cval = snap[cname]
            if isinstance(cval, bool):
                cval = int(cval)
            if not isinstance(cval, (int, float)):
                continue
            out.append({"name": f"{family}/{cname}", "cat": "counter",
                        "ph": "C", "ts": ts, "pid": tracer._PID,
                        "args": {cname: cval}})
    return out


def thread_metadata():
    """``"ph": "M"`` thread_name events for every thread that emitted
    a span, so Perfetto names the lanes."""
    return [{"name": "thread_name", "ph": "M", "pid": tracer._PID,
             "tid": tid, "args": {"name": name}}
            for tid, name in sorted(tracer.thread_names().items())]


def build_trace(extra_events=None, counters=True):
    """Assemble the full Chrome-trace payload dict (no IO).

    ``extra_events`` are appended verbatim (the profiler's host event
    list rides along here); ``counters=False`` skips the registry
    sample pass."""
    events = thread_metadata()
    events.extend(tracer.events())
    if extra_events:
        events.extend(extra_events)
    if counters:
        events.extend(counter_samples())
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    dropped = tracer.dropped_spans()
    if dropped:
        payload["otherData"] = {"dropped_spans": dropped}
    return payload


def dump_trace(path, extra_events=None, counters=True):
    """Write the assembled trace to ``path`` and return the payload —
    ``json.load(open(path))`` round-trips, and the file opens directly
    in Perfetto / chrome://tracing."""
    payload = build_trace(extra_events=extra_events, counters=counters)
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload
