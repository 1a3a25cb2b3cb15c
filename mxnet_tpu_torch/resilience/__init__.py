"""mxnet_tpu_torch.resilience — what serving uses of the reference's
resilience layer (``mxnet_tpu/resilience/``): the fault seams
(:mod:`.faults`), the circuit breaker (:mod:`.breaker`) and the retry
policy (:mod:`.retry`, which the async parameter server's sends use).
Their counters are the ``resilience`` family of the telemetry registry
(:func:`resilience_counters`).

Checkpoints and the supervisor come with slice 9b.
"""
from __future__ import annotations

from .. import telemetry as _telemetry
from ..base import getenv

__all__ = ["faults", "CircuitBreaker", "CircuitOpen", "RetryPolicy",
           "RetryExhausted", "resilience_enabled", "resilience_counters",
           "reset_resilience_counters"]


def _zero_counters():
    """The JAX package's resilience counters the port has a subsystem
    for; its checkpoint and auto-resume counters come with slice 9b."""
    return {"retry_attempts": 0, "retry_giveups": 0, "retry_sleep_s": 0.0,
            "breaker_trips": 0, "breaker_fast_fails": 0,
            "breaker_resets": 0, "fault_fires": 0}


_COUNTERS = _telemetry.counter_family("resilience", _zero_counters())


def _count(name, delta=1):
    _COUNTERS.add(name, delta)


def resilience_counters():
    """Live resilience counters, plus one ``fault_fires:<point>`` entry
    per fault point that fired, ``fault_armed`` and ``enabled``."""
    out = _COUNTERS.snapshot()
    for point, n in faults.fire_counts().items():
        out[f"fault_fires:{point}"] = n
    out["fault_armed"] = 1 if faults.armed() else 0
    out["enabled"] = resilience_enabled()
    return out


def reset_resilience_counters():
    """Zero every counter; an armed fault plan stays armed."""
    _COUNTERS.reset()
    faults.reset_fire_counts()


from . import faults  # noqa: E402
from .breaker import CircuitBreaker, CircuitOpen  # noqa: E402
from .retry import RetryExhausted, RetryPolicy  # noqa: E402


def resilience_enabled():
    """``MXNET_RESILIENCE`` master switch (default on). Off, circuit
    breakers never trip; the fault seams still fire. Read per use, so
    tests can toggle it."""
    return getenv("MXNET_RESILIENCE", True, bool)
