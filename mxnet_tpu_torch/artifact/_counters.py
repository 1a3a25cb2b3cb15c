"""Counter family of the artifact layer (remote tier and bundles).

The PyTorch counterpart of ``mxnet_tpu/artifact/_counters.py``, with its
17 counters by the same names: the remote tier's hits, misses, errors
and bytes both ways, the bundle exports and imports, and the remote
store's garbage collection. They render on ``/metrics`` as
``mxnet_artifact_*`` beside the ``compile_cache`` family.
"""
from __future__ import annotations

from ..telemetry import metrics as _telemetry

__all__ = ["STATS", "artifact_stats", "reset_artifact_counters"]


def _zero_stats():
    return {
        # remote tier (fetch side)
        "remote_hits": 0, "remote_misses": 0, "remote_errors": 0,
        "remote_corrupt": 0, "remote_skipped": 0, "fetch_bytes": 0,
        # remote tier (publish side)
        "remote_publishes": 0, "publish_errors": 0, "publish_bytes": 0,
        # deployment bundles
        "bundle_exports": 0, "bundle_imports": 0,
        "bundle_entries_written": 0, "bundle_entries_skipped": 0,
        # remote-store GC (file:// pruner + ArtifactCacheServer LRU)
        "gc_runs": 0, "gc_evicted": 0, "gc_bytes": 0,
        # age-bounded eviction + live-bundle protection
        "gc_age_evicted": 0, "gc_protected": 0,
    }


STATS = _telemetry.counter_family("artifact", _zero_stats())


def artifact_stats():
    """Remote-tier and bundle counters (the ``artifact`` family)."""
    return STATS.snapshot()


def reset_artifact_counters():
    """Zero the counters (tests, benchmarks)."""
    STATS.reset()
