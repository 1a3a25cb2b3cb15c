"""The training pipeline: ``DeviceFeed``, the bucketed gradient
all-reduce, and their counters.

The PyTorch counterpart of ``mxnet_tpu/pipeline/__init__.py`` (the
JAX package's async pipeline; reference: src/io/iter_prefetcher.h).
:class:`DeviceFeed` keeps ``MXNET_DEVICE_PREFETCH`` batches (default 2)
staged on the card ahead of the step that consumes them, copied from
pinned host memory on a side stream. :class:`AsyncGradReducer`
(``grad_sync.py``) dispatches the gradient all-reduce of a distributed
``Trainer`` in buckets of ``MXNET_GRAD_BUCKET_KB`` as ``backward``
writes the gradients (``MXNET_ASYNC_GRAD_SYNC``, default on); the
async kvstore's opt-in is ``MXNET_KVSTORE_ASYNC`` (``kvstore.py``).

Counters (:func:`pipeline_counters`): ``prefetch_batches`` staged and
served, ``prefetch_hits`` (a ``next()`` that found its batch staged),
``prefetch_stalls`` and ``prefetch_stall_s`` (a ``next()`` that waited
for the worker, and the total wait: the time the step loop sat idle on
data), ``feed_errors``, ``feed_active_s``, ``prefetch_depth``, and the
derived ``engine_idle_s`` (= the stall time) and ``overlap_ratio``;
``grad_buckets`` and ``grad_bucket_bytes`` (buckets dispatched during
backward and their bytes), ``grad_flush_buckets`` (partial buckets
dispatched at the step), ``grad_async_grads`` (gradients reduced ahead
of the step), ``grad_flush_grads`` (reduced at the step),
``grad_stale_discards`` (a speculative reduction whose buffer changed
after dispatch, reduced again) and ``kvstore_async_pushes``. They are
the ``pipeline`` family of the telemetry registry.
"""
from __future__ import annotations

from .. import telemetry as _telemetry
from ..base import getenv

__all__ = ["DeviceFeed", "AsyncGradReducer", "prefetch_depth",
           "pipeline_enabled", "async_grad_sync_enabled",
           "grad_bucket_bytes", "kvstore_async_enabled",
           "pipeline_counters", "reset_pipeline_counters"]


def prefetch_depth():
    """``MXNET_DEVICE_PREFETCH`` (default 2); 0 stages inline. Read when a
    feed is made."""
    return max(0, getenv("MXNET_DEVICE_PREFETCH", 2, int))


def pipeline_enabled():
    """Prefetch is armed (depth > 0)."""
    return prefetch_depth() > 0


def async_grad_sync_enabled():
    """``MXNET_ASYNC_GRAD_SYNC`` (default on): the bucketed all-reduce
    dispatched during backward; 0 reduces everything at ``step()``."""
    return getenv("MXNET_ASYNC_GRAD_SYNC", True, bool)


def grad_bucket_bytes():
    """``MXNET_GRAD_BUCKET_KB`` (default 512) in bytes."""
    return max(1, getenv("MXNET_GRAD_BUCKET_KB", 512, int)) * 1024


def kvstore_async_enabled():
    """``MXNET_KVSTORE_ASYNC`` (default off): a local kvstore applies its
    pushes on a background thread."""
    return getenv("MXNET_KVSTORE_ASYNC", False, bool)


def _zero():
    return {"prefetch_depth": 0, "prefetch_batches": 0, "prefetch_hits": 0,
            "prefetch_stalls": 0, "prefetch_stall_s": 0.0,
            "feed_active_s": 0.0, "feed_errors": 0,
            "grad_buckets": 0, "grad_bucket_bytes": 0,
            "grad_flush_buckets": 0, "grad_async_grads": 0,
            "grad_flush_grads": 0, "grad_stale_discards": 0,
            "kvstore_async_pushes": 0}


# the ``pipeline`` family of the telemetry registry
_COUNTERS = _telemetry.counter_family("pipeline", _zero())


def _count(name, delta=1):
    _COUNTERS.add(name, delta)


def _count_set(name, value):
    _COUNTERS.set(name, value)


def pipeline_counters():
    """The counters, with ``engine_idle_s`` (the stall time) and
    ``overlap_ratio`` (the share of the feeds' consumption time not spent
    stalled; 1.0 when the source always led)."""
    out = _COUNTERS.snapshot()
    out["engine_idle_s"] = out["prefetch_stall_s"]
    active = out["feed_active_s"]
    out["overlap_ratio"] = (max(0.0, 1.0 - out["prefetch_stall_s"] / active)
                            if active > 0 else 0.0)
    return out


def reset_pipeline_counters():
    _COUNTERS.reset()


from .device_feed import DeviceFeed  # noqa: E402
from .grad_sync import AsyncGradReducer  # noqa: E402
