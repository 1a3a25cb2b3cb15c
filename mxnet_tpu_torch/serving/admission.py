"""SLO-aware admission control: shed best-effort load BEFORE it queues.

The PyTorch counterpart of ``mxnet_tpu/serving/admission.py``, with the
same decisions. Requests carry one of :data:`SLO_CLASSES` (``critical``
> ``standard`` > ``best_effort``). The controller's **headroom** in
[0, 1] is the minimum of

- *queue headroom*: ``1 - depth / capacity`` over the batcher's bounded
  class lanes (the leading indicator);
- *latency headroom*: ``1 - p99 / slo_target``, the rolling-window p99
  of the highest-priority class with recent traffic;

and, for a stateful submit that would open a NEW stream
(``allocates_state=True``), *slot headroom*: the free share of the
state store's slots and, for a paged store, of its KV pages.

``best_effort`` sheds below ``MXNET_SERVING_SHED_HEADROOM``,
``standard`` below half of it, ``critical`` never (only queue-full
backpressure rejects it). A shed is an immediate :class:`ShedLoad`
(HTTP 503 with ``Retry-After``). The ``serving_admission`` fault seam
forces the shed path for the sheddable classes.
"""
from __future__ import annotations

import time

from ..base import getenv
from ..resilience import faults as _faults
from .batcher import ServerBusy
from .metrics import METRICS, SLO_CLASSES

__all__ = ["AdmissionController", "ShedLoad", "SLO_CLASSES",
           "normalize_class", "admission_enabled"]

_PRIORITY = {c: i for i, c in enumerate(SLO_CLASSES)}


class ShedLoad(ServerBusy):
    """Request shed by admission control (HTTP 503). Carries
    ``retry_after_s`` so the HTTP layer can emit ``Retry-After`` and a
    well-behaved client backs off instead of hammering."""

    def __init__(self, message, retry_after_s=0.25):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


def normalize_class(slo_class):
    """Default None to "standard"; reject unknown labels loudly (a
    typo'd class silently landing in best_effort would be shed —
    exactly the bug a 400 at the boundary prevents)."""
    if slo_class is None:
        return "standard"
    if slo_class not in _PRIORITY:
        raise ValueError(
            f"unknown SLO class {slo_class!r}; expected one of "
            f"{SLO_CLASSES}")
    return slo_class


def admission_enabled():
    """MXNET_SERVING_ADMISSION gate (default on). Off, every class is
    plain FIFO-with-backpressure — the round-10 behavior."""
    return getenv("MXNET_SERVING_ADMISSION", True, bool)


class AdmissionController:
    """Per-batcher admission decisions + the /healthz headroom signal.

    One controller per :class:`~mxnet_tpu.serving.batcher.DynamicBatcher`
    (constructed by it); registers a headroom probe on the process
    metrics registry so ``slo_headroom`` in ``serving_counters()`` and
    ``/metrics`` always reflects the live minimum."""

    def __init__(self, batcher, slo_ms=None, shed_headroom=None,
                 retry_after_ms=None, enabled=None):
        self._batcher = batcher
        self._slo_s = float(
            slo_ms if slo_ms is not None else
            getenv("MXNET_SERVING_SLO_MS", 100.0, float)) / 1e3
        self._shed_headroom = float(
            shed_headroom if shed_headroom is not None else
            getenv("MXNET_SERVING_SHED_HEADROOM", 0.15, float))
        self._retry_after_s = float(
            retry_after_ms if retry_after_ms is not None else
            getenv("MXNET_SERVING_RETRY_AFTER_MS", 250.0, float)) / 1e3
        self.enabled = admission_enabled() if enabled is None else \
            bool(enabled)
        self._probe_token = METRICS.register_headroom_probe(
            self.headroom)

    # -- signals -------------------------------------------------------

    def _queue_headroom(self):
        cap = max(self._batcher.queue_capacity(), 1)
        return 1.0 - min(self._batcher.qsize(), cap) / cap

    def _latency_headroom(self):
        # protect the highest-priority class with recent traffic; with
        # none, the overall rolling picture would lag — report full
        # headroom instead (no traffic means no SLO at risk)
        for cls in SLO_CLASSES:
            if METRICS.class_latency[cls].total:
                p99 = METRICS.class_latency_s(cls, 0.99)
                return 1.0 - min(p99 / self._slo_s, 1.0)
        return 1.0

    def _slot_headroom(self):
        """Free fraction of the session state pool (1.0 for stateless
        batchers — no pool, nothing to protect). A paged store folds
        in its KV page pool too: slots may be plentiful while every
        page is spoken for, and a new stream needs at least one."""
        store = getattr(getattr(self._batcher, "session", None),
                        "state_store", None)
        if store is None:
            return 1.0
        slots = max(store.num_slots, 1)
        head = 1.0 - min(store.occupancy, slots) / slots
        pages = getattr(store, "page_headroom", None)
        if callable(pages):
            ph = pages()
            if ph is not None:
                head = min(head, ph)
        return head

    def headroom(self):
        """Live SLO headroom in [0, 1]: min(queue, latency) signals.
        1.0 = idle, 0.0 = the protected SLO is already blown."""
        return max(min(self._queue_headroom(),
                       self._latency_headroom()), 0.0)

    def shed_threshold(self, slo_class):
        """Headroom floor below which ``slo_class`` sheds: graduated
        by priority (best_effort at the full knob, standard at half,
        critical never)."""
        pri = _PRIORITY[slo_class]
        return self._shed_headroom * pri / (len(SLO_CLASSES) - 1)

    # -- the decision (request path) -----------------------------------

    def check(self, slo_class, allocates_state=False):
        """Admit or raise :class:`ShedLoad`. Called by
        ``DynamicBatcher.submit`` after validation, before enqueue —
        a shed request never occupies a queue slot.
        ``allocates_state=True`` (a stateful submit opening a NEW
        stream) additionally folds slot headroom into the decision, so
        sheddable classes stop claiming state slots before the pool
        starts evicting live streams to make room."""
        if not self.enabled:
            return
        try:
            _faults.maybe_fail("serving_admission")
        except Exception as e:  # noqa: BLE001 — any armed exception
            # an injected admission fault forces the shed path (for
            # critical it downgrades to headroom-based shedding below
            # — the protected class is never force-shed either)
            if _PRIORITY[slo_class] > 0:
                self._shed(slo_class, forced=True, cause=e)
        if _PRIORITY[slo_class] == 0:
            return  # protected class: backpressure only
        head = self.headroom()
        if allocates_state:
            head = min(head, self._slot_headroom())
        if head < self.shed_threshold(slo_class):
            self._shed(slo_class, headroom=head)

    def _shed(self, slo_class, headroom=None, forced=False, cause=None):
        METRICS.observe_shed(slo_class)
        detail = "fault-injected shed" if forced else (
            f"SLO headroom {headroom:.3f} below "
            f"{self.shed_threshold(slo_class):.3f}")
        err = ShedLoad(
            f"request shed ({slo_class}): {detail}; retry after "
            f"{self._retry_after_s * 1e3:.0f} ms",
            retry_after_s=self._retry_after_s)
        raise err from cause

    # -- observability -------------------------------------------------

    def snapshot(self):
        """The /healthz ``slo`` block: live headroom, its component
        signals, per-class shed thresholds and rolling p99s."""
        qh, lh = self._queue_headroom(), self._latency_headroom()
        return {
            "enabled": self.enabled,
            "headroom": round(max(min(qh, lh), 0.0), 4),
            "queue_headroom": round(max(qh, 0.0), 4),
            "latency_headroom": round(max(lh, 0.0), 4),
            "slot_headroom": round(max(self._slot_headroom(), 0.0), 4),
            "slo_ms": self._slo_s * 1e3,
            "shedding": [c for c in SLO_CLASSES if _PRIORITY[c] > 0 and
                         min(qh, lh) < self.shed_threshold(c)],
            "p99_ms": {c: round(METRICS.class_latency_s(c, 0.99) * 1e3,
                                3) for c in SLO_CLASSES},
        }

    def close(self):
        METRICS.unregister_headroom_probe(self._probe_token)
