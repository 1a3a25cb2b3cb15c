"""Circuit breaker: stop hammering a failing dependency.

The PyTorch counterpart of ``mxnet_tpu/resilience/breaker.py``, with
the same three-state machine: CLOSED passes calls and counts
consecutive failures; ``threshold`` of them TRIP it OPEN, and calls fail
fast (:class:`CircuitOpen`, HTTP 503); after ``cooldown_ms`` it is
HALF-OPEN and admits one probe, whose success closes it and whose
failure re-opens it and restarts the cooldown. The clock is injectable.
With ``MXNET_RESILIENCE=0`` the breaker never trips.

The port's serving uses it for the repository's canary rollback; the
session's per-bucket breakers come with the AOT artifacts of a later
slice.
"""
from __future__ import annotations

import time

from ..base import MXNetError, getenv
from ..utils import locks as _locks
from . import _count

__all__ = ["CircuitBreaker", "CircuitOpen"]


class CircuitOpen(MXNetError):
    """Fail-fast rejection: the breaker is open (retry after the
    cooldown)."""


class CircuitBreaker:
    """Three-state (closed / open / half-open) breaker; thread-safe."""

    def __init__(self, threshold=None, cooldown_ms=None, name="",
                 clock=None):
        self.threshold = int(threshold if threshold is not None else
                             getenv("MXNET_BREAKER_THRESHOLD", 5, int))
        self.cooldown_s = float(
            cooldown_ms if cooldown_ms is not None else
            getenv("MXNET_BREAKER_COOLDOWN_MS", 30000.0, float)) / 1e3
        self.name = name
        self._clock = clock if clock is not None else time.monotonic
        # guards: _failures, _opened_at, _probing
        self._lock = _locks.RankedLock("resilience.breaker")
        self._failures = 0  # consecutive, while closed / half-open
        self._opened_at = None  # clock stamp, while open
        self._probing = False  # the one half-open probe is out

    @property
    def state(self):
        with self._lock:
            return self._state_locked()

    def _state_locked(self):
        if self._opened_at is None:
            return "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    @property
    def failures(self):
        with self._lock:
            return self._failures

    def allow(self):
        """True when a call may proceed (closed, or the one half-open
        probe); False means fail fast (:meth:`check` raises)."""
        from . import resilience_enabled

        if not resilience_enabled():
            return True
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "half-open" and not self._probing:
                self._probing = True
                return True
        _count("breaker_fast_fails")
        return False

    def check(self):
        """:meth:`allow` or raise :class:`CircuitOpen`."""
        if not self.allow():
            raise CircuitOpen(
                f"circuit {self.name or 'breaker'} is open after "
                f"{self.threshold} consecutive failure(s); retry after "
                f"the {self.cooldown_s * 1e3:.0f}ms cooldown")

    def record_success(self):
        with self._lock:
            was_open = self._opened_at is not None
            self._failures = 0
            self._opened_at = None
            self._probing = False
        if was_open:
            _count("breaker_resets")

    def record_failure(self):
        from . import resilience_enabled

        if not resilience_enabled():
            return
        with self._lock:
            self._failures += 1
            self._probing = False
            tripped = self._opened_at is None and \
                self._failures >= self.threshold
            if tripped or self._opened_at is not None:
                # a trip, or a failed half-open probe: the cooldown
                # restarts now
                self._opened_at = self._clock()
        if tripped:
            _count("breaker_trips")
