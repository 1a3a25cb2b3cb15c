"""Kernels: the hand-written CUDA kernels and the ops built on them.

The PyTorch counterpart of ``mxnet_tpu/kernels``. ``_build`` compiles
``csrc/*.cu`` at first use and counts launches. ``flash_attention``
holds K1 and K2 with their plain versions, ``norm_act`` the fused
LayerNorm→activation kernel K3 with its plain version, ``box_nms`` the
greedy NMS sweep N1 of the ``box_nms`` op (not a TPU kernel: the JAX op
runs a ``lax.fori_loop`` there) with its plain version; ``attention``
registers the decode ops and the fused attention cluster op,
``elementwise`` the fused elementwise chain. The fusion pass
(``analysis/fusion.py``) lowers clusters to these ops, with the
implementation ``cost_model.decide`` picks: ``cuda`` (the kernel) or
``torch`` (the replay of the member ops' bodies, bit-identical to the
unfused graph).

Knobs, as in the JAX package: ``MXNET_FUSION=0`` kill switch,
``MXNET_FUSION_PATTERNS`` (comma list of
``elementwise,norm_act,attention,serving``), ``MXNET_FUSION_COST_MODEL``
(``heuristic`` | ``always`` | ``never``). The counters are a plain dict
under a lock (:func:`counters`).
"""
from __future__ import annotations

import os
import threading

#: every pattern the clustering pass and the serving specialization know
ALL_PATTERNS = ("elementwise", "norm_act", "attention", "serving")

# guards: _COUNTERS
_COUNT_LOCK = threading.Lock()
_COUNTERS = {}


def _count(name, n=1):
    with _COUNT_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters():
    """Snapshot of the fusion counters: ``clusters_<pattern>``,
    ``nodes_absorbed``, ``impl_<torch|cuda>``, ``fallback_<reason>``,
    and the serving ``serving_pad_fused``/``serving_slice_fused``
    calls."""
    with _COUNT_LOCK:
        return dict(_COUNTERS)


def reset_counters():
    with _COUNT_LOCK:
        _COUNTERS.clear()


def fusion_enabled():
    """``MXNET_FUSION`` kill switch (default on; the clustering pass
    itself runs only under ``MXNET_GRAPH_OPT>=1``)."""
    return os.environ.get("MXNET_FUSION") not in ("0", "false", "False", "")


def enabled_patterns():
    """Patterns armed by ``MXNET_FUSION_PATTERNS``; unknown names are
    ignored."""
    raw = os.environ.get("MXNET_FUSION_PATTERNS",
                         "elementwise,norm_act,attention,serving")
    pats = (p.strip() for p in raw.split(","))
    return tuple(p for p in pats if p in ALL_PATTERNS)


def cost_model_mode():
    """``MXNET_FUSION_COST_MODEL``: ``heuristic`` (default), ``always``
    or ``never``."""
    mode = os.environ.get("MXNET_FUSION_COST_MODEL", "heuristic")
    return mode if mode in ("heuristic", "always", "never") else "heuristic"


def fusion_salt():
    """Cache-key component of the fusion configuration: flipping a
    fusion knob never reuses a graph optimized under the old one."""
    if not fusion_enabled():
        return ("fusion", 0)
    return ("fusion", 1, enabled_patterns(), cost_model_mode())


# registering the fused ops is an import side effect, as the ndarray ops'
from . import _build, attention, elementwise  # noqa: E402,F401
from . import box_nms, flash_attention, norm_act  # noqa: E402,F401
from .cost_model import decide  # noqa: E402,F401

__all__ = ["ALL_PATTERNS", "counters", "reset_counters", "fusion_enabled",
           "enabled_patterns", "cost_model_mode", "fusion_salt", "decide",
           "_build", "attention", "box_nms", "elementwise",
           "flash_attention", "norm_act"]
