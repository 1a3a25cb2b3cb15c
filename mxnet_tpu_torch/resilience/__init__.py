"""mxnet_tpu_torch.resilience — what serving uses of the reference's
resilience layer (``mxnet_tpu/resilience/``): the fault seams
(:mod:`.faults`), the circuit breaker (:mod:`.breaker`) and the retry
policy (:mod:`.retry`, which the async parameter server's sends use).

Checkpoints and the supervisor come with a later slice.
"""
from __future__ import annotations

from ..base import getenv
from . import faults
from .breaker import CircuitBreaker, CircuitOpen
from .retry import RetryExhausted, RetryPolicy

__all__ = ["faults", "CircuitBreaker", "CircuitOpen", "RetryPolicy",
           "RetryExhausted", "resilience_enabled"]


def resilience_enabled():
    """``MXNET_RESILIENCE`` master switch (default on). Off, circuit
    breakers never trip; the fault seams still fire. Read per use, so
    tests can toggle it."""
    return getenv("MXNET_RESILIENCE", True, bool)
