"""Empirical autotuning: measure performance policy, cache the answer,
share it with the fleet.

The PyTorch counterpart of ``mxnet_tpu/autotune/``. The port carries
the JAX package's hand-written heuristics — the fusion cost model's
thresholds, the quantized ops' lowering — and each may be wrong on some
(graph, shapes, device). Measure once on the hardware that will run it,
persist the winner, consult it everywhere:

- :mod:`.registry` — the :class:`DecisionPoint` catalogue;
- :mod:`.records` — the TuningRecord store (memory, disk, remote) and
  the ``autotune`` salt provider;
- :mod:`.tuner` — the budgeted candidate sweep over the paired-median
  harness (``benchmark/_measure.py``);
- here — the knob, the counters, and :func:`lookup`, which the cost
  model and ``ops_quant.lowering`` consult before their heuristic.

``MXNET_AUTOTUNE``: ``0`` off (consults return None, the salt is
empty); ``consult`` (default) reads records and never measures;
``tune`` also allows :func:`tune` sweeps. An explicit knob of the
decision (``MXNET_QUANTIZE_LOWERING=native``) beats a record, which
beats the heuristic.

Counters: the ``autotune`` family (``mxnet_autotune_*``).
"""
from __future__ import annotations

from ..base import MXNetError
from ..telemetry import metrics as _metrics
from .registry import (DecisionPoint, declare_decision, decision_points,
                       get_point)
from . import records
from .records import (RECORD_VERSION, record_fingerprint, records_dir,
                      store_record, trial)

__all__ = ["DecisionPoint", "declare_decision", "decision_points",
           "get_point", "RECORD_VERSION", "record_fingerprint",
           "records_dir", "store_record", "trial", "mode", "lookup",
           "tune", "counters", "autotune_salt", "reset_autotune_state"]

_COUNTERS = _metrics.counter_family("autotune", zeros={
    "lookups": 0, "hits": 0, "measurements": 0, "wins": 0,
    "record_load": 0, "record_store": 0, "record_corrupt": 0,
    "measure_failures": 0})


def _count(name, n=1):
    _COUNTERS.add(name, n)


def counters():
    """Snapshot of the ``autotune`` counter family."""
    return _COUNTERS.snapshot()


def mode():
    """MXNET_AUTOTUNE: ``0`` / ``consult`` (default) / ``tune``."""
    from .. import env

    m = (env.get_str("MXNET_AUTOTUNE", "consult") or "consult").lower()
    if m in ("", "off", "false"):
        m = "0"
    if m not in ("0", "consult", "tune"):
        raise MXNetError(
            f"MXNET_AUTOTUNE must be 0, consult or tune (got {m!r})")
    return m


def lookup(decision, key):
    """Consult-before-heuristic: the tuned choice for ``(decision,
    key)`` or None (caller falls back to its heuristic). Never measures
    and never raises on stored state — mode ``0`` short-circuits, a
    corrupt record degrades to a miss."""
    _count("lookups")
    if mode() == "0":
        return None
    choice = records.consult(decision, key)
    if choice is not None:
        _count("hits")
    return choice


def tune(decision, key, make_measure, **kwargs):
    """Sweep ``decision``'s candidates for ``key`` and persist the
    winner — see :func:`.tuner.tune` (imported lazily so the consult
    path never pays for the harness)."""
    from . import tuner as _tuner

    return _tuner.tune(decision, key, make_measure, **kwargs)


def autotune_salt():
    """Cache-tag form of the active-record salt for in-memory caches
    (the SymbolBlock's optimized-graph tag folds it, so a record or a
    trial landing re-optimizes): what the ``autotune`` salt provider
    contributes, ``()`` when nothing is active."""
    return records.fingerprint_salt()


def reset_autotune_state():
    """Zero counters and forget in-memory records/trials (tests)."""
    _COUNTERS.reset()
    records.reset_record_state()


# the salt provider registers at package import (mirrors graph_opt);
# artifact.salts also lists "autotune" as a lazy built-in so declaring
# the salt never depends on import order
from ..artifact import salts as _artifact_salts  # noqa: E402

_artifact_salts.register_salt_provider(
    "autotune", records.fingerprint_salt, replace=True)
