"""``gluon.contrib.nn`` (reference:
python/mxnet/gluon/contrib/nn/__init__.py): ``Concurrent``,
``HybridConcurrent``, ``Identity``, ``SparseEmbedding`` and
``PixelShuffle1D/2D``. ``SyncBatchNorm`` waits for slice 9b, the
single-controller mesh (ROADMAP A)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           PixelShuffle1D, PixelShuffle2D, SparseEmbedding)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "PixelShuffle1D", "PixelShuffle2D"]
