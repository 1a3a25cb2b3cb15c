"""The training pipeline's prefetch: ``DeviceFeed`` and its counters.

The PyTorch counterpart of ``mxnet_tpu/pipeline/__init__.py`` (the
JAX package's async pipeline; reference: src/io/iter_prefetcher.h).
:class:`DeviceFeed` keeps ``MXNET_DEVICE_PREFETCH`` batches (default 2)
staged on the card ahead of the step that consumes them, copied from
pinned host memory on a side stream. The gradient all-reduce
(``grad_sync.py``) and the async kvstore belong to the multi-device
slice and are not ported yet.

Counters (:func:`pipeline_counters`): ``prefetch_batches`` staged and
served, ``prefetch_hits`` (a ``next()`` that found its batch staged),
``prefetch_stalls`` and ``prefetch_stall_s`` (a ``next()`` that waited
for the worker, and the total wait: the time the step loop sat idle on
data), ``feed_errors``, ``feed_active_s``, ``prefetch_depth``, and the
derived ``engine_idle_s`` (= the stall time) and ``overlap_ratio``.
"""
from __future__ import annotations

import threading

from ..base import getenv

__all__ = ["DeviceFeed", "prefetch_depth", "pipeline_enabled",
           "pipeline_counters", "reset_pipeline_counters"]


def prefetch_depth():
    """``MXNET_DEVICE_PREFETCH`` (default 2); 0 stages inline. Read when a
    feed is made."""
    return max(0, getenv("MXNET_DEVICE_PREFETCH", 2, int))


def pipeline_enabled():
    """Prefetch is armed (depth > 0)."""
    return prefetch_depth() > 0


def _zero():
    return {"prefetch_depth": 0, "prefetch_batches": 0, "prefetch_hits": 0,
            "prefetch_stalls": 0, "prefetch_stall_s": 0.0,
            "feed_active_s": 0.0, "feed_errors": 0}


# guards: _COUNTERS
_LOCK = threading.Lock()
_COUNTERS = _zero()


def _count(name, delta=1):
    with _LOCK:
        _COUNTERS[name] += delta


def _count_set(name, value):
    with _LOCK:
        _COUNTERS[name] = value


def pipeline_counters():
    """The counters, with ``engine_idle_s`` (the stall time) and
    ``overlap_ratio`` (the share of the feeds' consumption time not spent
    stalled; 1.0 when the source always led)."""
    with _LOCK:
        out = dict(_COUNTERS)
    out["engine_idle_s"] = out["prefetch_stall_s"]
    active = out["feed_active_s"]
    out["overlap_ratio"] = (max(0.0, 1.0 - out["prefetch_stall_s"] / active)
                            if active > 0 else 0.0)
    return out


def reset_pipeline_counters():
    with _LOCK:
        _COUNTERS.update(_zero())


from .device_feed import DeviceFeed  # noqa: E402
