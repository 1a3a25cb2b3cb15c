"""mxnet_tpu_torch.resilience — the reference's resilience layer
(``mxnet_tpu/resilience/``) on one device:

- :class:`~.checkpoint.CheckpointManager`: crash-consistent snapshots of
  the whole training state (parameters, optimizer state and counters,
  the AMP loss scaler, the fused step's device counters, every device
  generator's position, the store, a data cursor, serving session
  state), written under ``.tmp-*`` and renamed into place, validated by
  version-salted sha256 hashes, keep-last-N, inline or on a writer
  thread;
- :class:`~.supervisor.AutoResume`: a training loop that catches a fault
  (or finds a checkpoint a killed process left), restores and resumes
  at the exact step, bitwise;
- the fault seams (:mod:`.faults`), the circuit breaker
  (:mod:`.breaker`) and the retry policy (:mod:`.retry`, which the async
  parameter server's sends use).

Their counters are the ``resilience`` family of the telemetry registry
(:func:`resilience_counters`). The sharded checkpoint (one file of
shards per device of a mesh) comes with slice 9b.
"""
from __future__ import annotations

from .. import telemetry as _telemetry
from ..base import getenv

__all__ = ["CheckpointManager", "AutoResume", "ResumeExhausted", "faults",
           "InjectedFault", "CircuitBreaker", "CircuitOpen", "RetryPolicy",
           "RetryExhausted", "resilience_enabled", "resilience_counters",
           "reset_resilience_counters"]


def _zero_counters():
    """The JAX package's resilience counters the port has a subsystem
    for (``mxnet_tpu/resilience/__init__.py:79-101``)."""
    return {
        # checkpoints
        "ckpt_saves": 0,            # completed checkpoint writes
        "ckpt_async_saves": 0,      # of which rode the writer thread
        "ckpt_async_waits": 0,      # saves that waited for a queue slot
        "ckpt_write_s": 0.0,        # the writes' wall time (writer)
        "ckpt_bytes": 0,            # bytes written
        "ckpt_restores": 0,         # restores
        "ckpt_corrupt_skipped": 0,  # invalid checkpoints passed over
        "ckpt_pruned": 0,           # checkpoints removed by retention
        # auto-resume
        "resume_faults_caught": 0,  # step-loop faults the supervisor caught
        "resume_restarts": 0,       # restore-and-continue cycles
        # retry and the circuit breaker
        "retry_attempts": 0, "retry_giveups": 0, "retry_sleep_s": 0.0,
        "breaker_trips": 0, "breaker_fast_fails": 0, "breaker_resets": 0,
        "fault_fires": 0}


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
from .faults import InjectedFault  # noqa: E402
from .breaker import CircuitBreaker, CircuitOpen  # noqa: E402
from .retry import RetryExhausted, RetryPolicy  # noqa: E402
from .checkpoint import CheckpointManager  # noqa: E402
from .supervisor import AutoResume, ResumeExhausted  # noqa: E402


def resilience_enabled():
    """``MXNET_RESILIENCE`` master switch (default on). Off, circuit
    breakers never trip and AutoResume propagates the first fault;
    checkpoint writes and the fault seams still run. Read per use, so
    tests can toggle it."""
    return getenv("MXNET_RESILIENCE", True, bool)
