"""``gluon.contrib.nn`` (reference:
python/mxnet/gluon/contrib/nn/__init__.py): ``Concurrent``,
``HybridConcurrent``, ``Identity`` and ``PixelShuffle1D/2D``.
``SparseEmbedding`` waits for the sparse types and ``SyncBatchNorm`` for
slice 9b, the single-controller mesh (ROADMAP A)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           PixelShuffle1D, PixelShuffle2D)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "PixelShuffle1D",
           "PixelShuffle2D"]
