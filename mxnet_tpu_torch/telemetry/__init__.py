"""Telemetry: span tracing and one metrics registry.

The PyTorch counterpart of ``mxnet_tpu/telemetry/``: the observability
layer MXNet ships as its engine profiler (``MXSetProfilerConfig`` /
``MXDumpProfile``, chrome://tracing). Nested and parallel spans show the
pipeline's overlap and continuous batching, a request-scoped trace id
follows one HTTP request through the batcher's threads, and every
counter family of the process, training and serving, reads from one
registry.

- :mod:`.tracer`: ``span()`` / ``instant()`` / ``trace_context()``,
  gated by ``MXNET_TELEMETRY={0,1,2}``, into a bounded drop-oldest ring;
- :mod:`.metrics`: :class:`MetricsRegistry` (:data:`REGISTRY`), owned
  :class:`CounterFamily` dicts and probed families, and ONE Prometheus
  exposition;
- :mod:`.exporter`: ``dump_trace(path)``, the Chrome-trace JSON of the
  spans, the thread names and the registry's counter samples.

``profiler`` keeps MXNet's surface (``set_config`` / ``dump`` /
``dumps`` / ``*_counters()``) over this package and adds the card's
trace through ``torch.profiler``. This package imports nothing else of
``mxnet_tpu_torch`` at import time, and no torch.
"""
from __future__ import annotations

from .tracer import (TELEMETRY_KNOB, buffer_capacity, current_trace_id,
                     dropped_spans, emit_span, events, instant, level,
                     new_trace_id, reset as reset_trace, span,
                     thread_names, trace_context, tracing)
from .metrics import (REGISTRY, CounterFamily, MetricsRegistry,
                      counter_family, family_snapshot, prometheus_text,
                      register_exposition, register_family, snapshot)
from .exporter import build_trace, counter_samples, dump_trace

__all__ = [
    # tracer
    "TELEMETRY_KNOB", "level", "tracing", "span", "instant",
    "emit_span", "trace_context", "current_trace_id", "new_trace_id",
    "events", "reset_trace", "dropped_spans", "buffer_capacity",
    "thread_names",
    # metrics
    "REGISTRY", "MetricsRegistry", "CounterFamily", "counter_family",
    "register_family", "register_exposition", "family_snapshot",
    "snapshot", "prometheus_text",
    # exporter
    "build_trace", "counter_samples", "dump_trace",
]
