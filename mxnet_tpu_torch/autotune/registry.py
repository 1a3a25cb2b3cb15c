"""DecisionPoint registry: the catalogue of tunable performance policy.

The PyTorch counterpart of ``mxnet_tpu/autotune/registry.py``. A module
that owns a heuristic constant declares it with
:func:`declare_decision`, which returns the heuristic default (so the
module's constant IS the declaration) and records the candidate space
the tuner may sweep. The catalogue is the JAX package's, name for name:
the fusion cost model's three thresholds
(``kernels/cost_model.py``) and the quantized ops' lowering
(``ndarray/ops_quant.py``). The kernel routes (``_flash_route``,
``_int8_conv_route``, ``_nms_plan``) stay heuristics, not decision
points. :func:`get_point` lazily imports a built-in's owning module.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..base import MXNetError
from ..utils import locks as _locks

__all__ = ["DecisionPoint", "declare_decision", "decision_points",
           "get_point"]

# guards: _POINTS
_LOCK = _locks.RankedLock("autotune.registry")
_POINTS = {}

# lazy built-ins: the declaration lives with the module that consults
# it (which declares at import); resolving an undeclared built-in
# imports the owner instead of failing on import order
_BUILTIN_MODULES = {
    "fusion.min_cluster": "mxnet_tpu_torch.kernels.cost_model",
    "fusion.attn_compute_bound_seq": "mxnet_tpu_torch.kernels.cost_model",
    "fusion.elementwise_bandwidth_log2": "mxnet_tpu_torch.kernels.cost_model",
    "quantize.lowering": "mxnet_tpu_torch.ndarray.ops_quant",
}


@dataclass(frozen=True)
class DecisionPoint:
    """One tunable policy decision.

    ``name`` is the registry key (``family.decision``); ``candidates``
    the sweep space; ``default`` the heuristic value used on record
    miss (it may sit outside ``candidates`` when the heuristic is
    dynamic — quantize's ``auto`` resolves per backend); ``key_doc``
    documents what the consult key tuple is made of, because record
    fingerprints are only as shared as the keys are canonical."""

    name: str
    candidates: tuple
    default: object
    key_doc: str = ""


def declare_decision(name, candidates, default, key_doc=""):
    """Declare a decision point and return ``default`` — written as

        THRESHOLD = declare_decision("family.name", (...), 8, "...")

    so the module constant and the registry entry cannot drift apart.
    Idempotent for an identical declaration (module reimport); a
    conflicting redeclaration raises (two subsystems fighting over one
    name would alias distinct record spaces)."""
    point = DecisionPoint(str(name), tuple(candidates), default,
                          str(key_doc))
    if not point.candidates:
        raise MXNetError(
            f"decision point {point.name!r} declares no candidates")
    with _LOCK:
        prev = _POINTS.get(point.name)
        if prev is not None and prev != point:
            raise MXNetError(
                f"decision point {point.name!r} is already declared "
                f"with a different shape ({prev} vs {point})")
        _POINTS[point.name] = point
    return default


def decision_points():
    """Declared decision names, sorted (forces the built-ins so docs
    and tests see the full catalogue)."""
    for mod in set(_BUILTIN_MODULES.values()):
        importlib.import_module(mod)
    with _LOCK:
        return sorted(_POINTS)


def get_point(name):
    """The :class:`DecisionPoint` for ``name``, lazily importing the
    owning module for built-in names; raises on unknown."""
    with _LOCK:
        point = _POINTS.get(name)
    if point is None and name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[name])
        with _LOCK:
            point = _POINTS.get(name)
    if point is None:
        with _LOCK:
            known = sorted(_POINTS)
        raise MXNetError(
            f"unknown decision point {name!r} (declared: {known})")
    return point
