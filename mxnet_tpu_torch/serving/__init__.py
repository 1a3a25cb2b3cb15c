"""mxnet_tpu_torch.serving — bucketed predict, continuous-batching decode,
SLO admission, a model repository and an HTTP front end.

The PyTorch counterpart of ``mxnet_tpu.serving``, with its names:

- :class:`~.session.InferenceSession` — stateless ``predict`` padded to
  batch buckets (``InferenceSession.load`` serves an export), or the
  decode step at occupancy buckets, one captured CUDA graph per bucket
  on the card (:meth:`~.session.InferenceSession.step` with explicit
  states); :func:`~.session.parse_buckets`.
- :class:`~.state.SessionStateStore` — device-resident per-session
  state, row-slot or paged (fixed-size KV pages behind page tables);
  TTL + LRU eviction (:class:`~.state.SessionEvicted`).
- :class:`~.batcher.DynamicBatcher` — coalescing batches for stateless
  sessions, the continuous-batching step loop for stateful ones, both
  over per-SLO-class lanes (:data:`SLO_CLASSES`).
- :class:`~.admission.AdmissionController` / :class:`~.admission.ShedLoad`
  — shed sheddable classes when SLO headroom runs out.
- :class:`~.repository.ModelRepository` — models x versions, canary
  rollout with breaker-driven rollback, session migration at promote.
- :class:`~.server.ModelServer` — the stdlib HTTP front end.
- :mod:`~.metrics` — histograms, per-class counters and the Prometheus
  text (:data:`METRICS`).

Knobs: ``MXNET_SERVING`` (0 makes batchers run requests inline), the
``MXNET_SERVING_*`` family (``MAX_BATCH``, ``MAX_LATENCY_MS``,
``QUEUE_DEPTH``, ``TIMEOUT_MS``, ``WORKERS``, ``BUCKETS``, ``HOST``,
``PORT``, ``ADMISSION``, ``SLO_MS``, ``SHED_HEADROOM``,
``RETRY_AFTER_MS``, ``CANARY_*``, ``STATE_SLOTS``, ``STATE_BUDGET_MB``,
``STATE_TTL_S``, ``STATE_PAGE_TOKENS``), as in the reference. Not
ported yet: the replica fleet (``fleet.py``), telemetry spans,
deployment bundles.
"""
from __future__ import annotations

from ..base import getenv

__all__ = ["InferenceSession", "DynamicBatcher", "ModelServer",
           "ModelRepository", "AdmissionController", "ShedLoad",
           "ServerBusy", "RequestTimeout", "SLO_CLASSES",
           "SessionStateStore", "SessionEvicted", "parse_buckets",
           "serving_enabled", "serving_stats", "reset_serving_counters",
           "prometheus_text", "METRICS"]


def serving_enabled():
    """``MXNET_SERVING`` (default on): 0 makes batchers execute requests
    inline. Read per use, so tests can toggle it."""
    return getenv("MXNET_SERVING", True, bool)


from .metrics import (METRICS, SLO_CLASSES, prometheus_text,  # noqa: E402
                      reset_serving_counters, serving_stats)
from .batcher import DynamicBatcher, RequestTimeout, ServerBusy  # noqa: E402
from .state import SessionEvicted, SessionStateStore  # noqa: E402
from .session import InferenceSession, parse_buckets  # noqa: E402
from .admission import AdmissionController, ShedLoad  # noqa: E402
from .repository import ModelRepository  # noqa: E402
from .server import ModelServer  # noqa: E402
