"""Deterministic fault injection at the serving path's failure seams.

The PyTorch counterpart of the part of ``mxnet_tpu/resilience/faults.py``
that serving uses, plus the port's own seam in the fused step's graph
capture. A seam calls :func:`maybe_fail` with its point name; while a
clause for that point is armed (:func:`inject`), the clause decides per
call whether the seam raises. The seams:

========================  ==============================================
``serving_admission``     the admission decision at ``submit`` — a fire
                          forces the shed path for sheddable SLO classes
``session_state_evict``   ``SessionStateStore.acquire`` — a fire evicts
                          the acquiring session (``SessionEvicted`` to
                          exactly that client)
``serving_execute``       one bucket execution (predict) or decode step
                          of an ``InferenceSession``
``model_swap``            ``ModelRepository``'s version activation (first
                          deploy, promote); rollback has no seam
``fused_step_capture``    the Trainer's CUDA-graph capture of its fused
                          step (a fire makes the capture fail, which
                          raises: there is no eager fallback)
``cached_op_capture``     a hybridized block's CUDA-graph capture of one
                          signature (raises; no eager fallback)
``executor_capture``      a bound executor's CUDA-graph capture of its
                          forward and backward (raises; no eager fallback)
``device_put``            ``DeviceFeed``'s staging of one batch leaf on
                          its worker thread (re-raised at ``next()``)
``kvstore_push``          a kvstore push (a lost gradient send)
``kvstore_pull``          a kvstore pull (a failed parameter fetch)
``grad_bucket_dispatch``  the bucketed all-reduce's dispatch of one
                          bucket during backward
``compile_cache_io``      a compile-cache disk load or store (a miss or
                          a skipped write; the entry survives)
``autotune_measure``      one autotune candidate's measurement (the
                          sweep skips that candidate)
========================  ==============================================

Clause keys, as in the reference: ``at=N`` fires on the Nth call (once);
``every=N`` on every Nth call; ``prob=P`` with probability P from a
``random.Random`` seeded by ``seed`` (default ``MXNET_FAULT_SEED``)
folded with the point name; ``after=N`` ignores the first N calls;
``times=K`` caps the fires (default 1 for ``at``); ``exc`` is the
exception class (default :class:`InjectedFault`).

Disarmed, a seam costs one module-global read. The ``MXNET_FAULT_PLAN``
grammar and the JAX package's training seams come with a later slice.
"""
from __future__ import annotations

import random as _pyrandom
import zlib

from ..base import MXNetError, getenv
from ..utils import locks as _locks
from . import _count

__all__ = ["InjectedFault", "FAULT_POINTS", "maybe_fail", "inject",
           "disarm", "clear", "armed", "fire_counts", "reset_fire_counts"]


class InjectedFault(MXNetError, OSError):
    """The default injected exception (an ``MXNetError`` and an
    ``OSError``, as in the reference)."""


FAULT_POINTS = {
    "serving_admission": "admission-control decision (forces the shed "
                         "path for sheddable classes)",
    "session_state_evict": "SessionStateStore slot acquire on the decode "
                           "path (evicts the acquiring session)",
    "serving_execute": "InferenceSession bucket execution or decode step",
    "model_swap": "ModelRepository version activation (first deploy / "
                  "promote; rollback is seam-free)",
    "fused_step_capture": "the Trainer's CUDA-graph capture of its fused "
                          "step (raises; no eager fallback)",
    "cached_op_capture": "a hybridized block's CUDA-graph capture of one "
                         "signature (raises; no eager fallback)",
    "executor_capture": "a bound executor's CUDA-graph capture of its "
                        "forward and backward (raises; no eager fallback)",
    "device_put": "DeviceFeed's staging of a batch leaf (re-raised in the "
                  "consumer)",
    "kvstore_push": "a kvstore push (a lost gradient send)",
    "kvstore_pull": "a kvstore pull (a failed parameter fetch)",
    "grad_bucket_dispatch": "the bucketed gradient all-reduce's dispatch "
                            "of one bucket during backward",
    "compile_cache_io": "persistent compile-cache disk load/store (a "
                        "fire is a miss or a skipped write)",
    "autotune_measure": "autotune candidate measurement (a fire skips "
                        "that candidate)",
    "engine_push": "dependency-engine host-task push",
}


class _Clause:
    """One point's firing rule and its call and fire counters, ticked
    under the module lock."""

    __slots__ = ("point", "at", "every", "prob", "after", "times", "exc",
                 "calls", "fires", "_rng")

    def __init__(self, point, at=None, every=None, prob=None, after=0,
                 times=None, exc=InjectedFault, seed=None):
        if at is None and every is None and prob is None:
            raise MXNetError(f"fault clause for {point!r} needs a trigger "
                             "(at=N | every=N | prob=P)")
        self.point = point
        self.at = None if at is None else int(at)
        self.every = None if every is None else max(1, int(every))
        self.prob = None if prob is None else float(prob)
        self.after = int(after or 0)
        if times is None:
            times = 1 if self.at is not None else None
        self.times = None if times is None else int(times)
        self.exc = exc
        self.calls = 0
        self.fires = 0
        self._rng = None
        if self.prob is not None:
            seed = getenv("MXNET_FAULT_SEED", 0, int) if seed is None \
                else seed
            # crc32, not hash(): str hashes vary per process
            self._rng = _pyrandom.Random(
                (int(seed) << 32) ^ zlib.crc32(point.encode()))

    def should_fire(self):
        self.calls += 1
        n = self.calls
        if n <= self.after:
            return False
        if self.times is not None and self.fires >= self.times:
            return False
        if self.at is not None:
            hit = n == self.at
        elif self.every is not None:
            hit = (n - self.after) % self.every == 0
        else:
            hit = self._rng.random() < self.prob
        if hit:
            self.fires += 1
        return hit


# guards: _PLAN, _FIRES and the armed clauses' counters
_LOCK = _locks.RankedLock("resilience.faults")
_PLAN = None  # point -> _Clause, or None (disarmed)
_FIRES = {}  # point -> total fires across plans (counters)


class inject:
    """Arm ONE point for the ``with`` block::

        with faults.inject("serving_admission", every=1):
            ...

    The previously armed plan comes back on exit, so injections nest."""

    def __init__(self, point, **clause):
        if point not in FAULT_POINTS:
            raise MXNetError(f"unknown fault point {point!r} (known: "
                             f"{', '.join(sorted(FAULT_POINTS))})")
        self._clause = _Clause(point, **clause)
        self._prev = None

    def __enter__(self):
        global _PLAN
        with _LOCK:
            self._prev = _PLAN
            _PLAN = {self._clause.point: self._clause}
        return self

    def __exit__(self, *exc):
        global _PLAN
        with _LOCK:
            _PLAN = self._prev


def disarm():
    """Drop the armed plan: every seam is back to one global read."""
    global _PLAN
    with _LOCK:
        _PLAN = None


#: another name for :func:`disarm`
clear = disarm


def armed():
    return _PLAN is not None


def maybe_fail(point):
    """The seam hook: raise the armed exception when ``point``'s clause
    says this call fires, else return at once."""
    plan = _PLAN  # one unlocked read: rebinding is atomic
    if plan is None:
        return
    clause = plan.get(point)
    if clause is None:
        return
    with _LOCK:
        fire = clause.should_fire()
        if fire:
            _FIRES[point] = _FIRES.get(point, 0) + 1
    if fire:
        _count("fault_fires")
        raise clause.exc(f"injected fault at point {point!r} "
                         f"(call {clause.calls}, fire {clause.fires})")


def fire_counts():
    """{point: total injected fires} since the last reset."""
    with _LOCK:
        return dict(_FIRES)


def reset_fire_counts():
    with _LOCK:
        _FIRES.clear()
