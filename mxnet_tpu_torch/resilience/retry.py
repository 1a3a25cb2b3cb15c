"""The one retry policy: bounded attempts, jittered exponential backoff.

The PyTorch counterpart of ``mxnet_tpu/resilience/retry.py``. Every
retrying seam (the async parameter server's sends) routes through
:class:`RetryPolicy`, so behaviour and counters are uniform (reference
analog: ps-lite's van resend and timeouts).

Defaults come from ``MXNET_RETRY_MAX_ATTEMPTS`` (4),
``MXNET_RETRY_BACKOFF_MS`` (50) and ``MXNET_RETRY_BACKOFF_MAX_MS``
(2000); with ``MXNET_RESILIENCE=0`` a policy makes exactly one attempt.
The delay before retry ``k`` is ``base * 2**(k-1)``, capped at the
maximum, times a uniform draw in ``[1 - jitter, 1]``; a seeded policy
draws deterministically. Counters (:func:`retry_counters`):
``retry_attempts``, ``retry_sleep_s``, ``retry_giveups``.
"""
from __future__ import annotations

import logging
import random as _pyrandom
import threading
import time

from ..base import MXNetError, getenv

__all__ = ["RetryPolicy", "RetryExhausted", "retry_counters",
           "reset_retry_counters"]

# guards: _COUNTERS
_LOCK = threading.Lock()
_COUNTERS = {"retry_attempts": 0, "retry_sleep_s": 0.0, "retry_giveups": 0}


def _count(name, delta=1):
    with _LOCK:
        _COUNTERS[name] += delta


def retry_counters():
    with _LOCK:
        return dict(_COUNTERS)


def reset_retry_counters():
    with _LOCK:
        _COUNTERS.update(retry_attempts=0, retry_sleep_s=0.0,
                         retry_giveups=0)


class RetryExhausted(MXNetError):
    """Every attempt failed. Chains the last failure and carries
    ``attempts``."""

    def __init__(self, message, attempts=0):
        super().__init__(message)
        self.attempts = attempts


class RetryPolicy:
    """Bounded-attempt, jittered-exponential-backoff retry runner.

    ``max_attempts`` counts the first attempt too (1 = no retries);
    ``base_ms``/``max_ms`` bound the backoff; ``jitter`` in [0, 1];
    ``retry_on`` the exception types taken as transient (others
    propagate at once); ``seed`` a deterministic jitter stream;
    ``name`` labels logs and the terminal error; ``sleep`` an injectable
    clock. None takes the knob's default."""

    def __init__(self, max_attempts=None, base_ms=None, max_ms=None,
                 jitter=0.5, retry_on=(Exception,), seed=None,
                 name="retry", sleep=None):
        self.max_attempts = int(
            max_attempts if max_attempts is not None else
            getenv("MXNET_RETRY_MAX_ATTEMPTS", 4, int))
        self.base_ms = float(
            base_ms if base_ms is not None else
            getenv("MXNET_RETRY_BACKOFF_MS", 50.0, float))
        self.max_ms = float(
            max_ms if max_ms is not None else
            getenv("MXNET_RETRY_BACKOFF_MAX_MS", 2000.0, float))
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self.retry_on = retry_on if isinstance(retry_on, tuple) \
            else (retry_on,)
        self.name = name
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = _pyrandom.Random(seed) if seed is not None \
            else _pyrandom

    def delay_ms(self, attempt):
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = min(self.max_ms, self.base_ms * (2.0 ** (attempt - 1)))
        if self.jitter:
            raw *= 1.0 - self.jitter * self._rng.random()
        return raw

    def run(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, retrying transient failures; raises
        :class:`RetryExhausted` (from the last failure) when every
        attempt failed."""
        from . import resilience_enabled

        attempts = max(1, self.max_attempts if resilience_enabled() else 1)
        last = None
        for attempt in range(1, attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                last = e
                if attempt >= attempts:
                    break
                delay = self.delay_ms(attempt) / 1e3
                _count("retry_attempts")
                _count("retry_sleep_s", delay)
                logging.getLogger(__name__).debug(
                    "%s: attempt %d/%d failed (%s); retrying in %.0fms",
                    self.name, attempt, attempts, e, delay * 1e3)
                if delay > 0:
                    self._sleep(delay)
        _count("retry_giveups")
        raise RetryExhausted(
            f"{self.name}: all {attempts} attempt(s) failed "
            f"(last error: {type(last).__name__}: {last})",
            attempts=attempts) from last

    def wrap(self, fn):
        """Decorator form of :meth:`run`."""
        import functools

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.run(fn, *args, **kwargs)

        return wrapped
