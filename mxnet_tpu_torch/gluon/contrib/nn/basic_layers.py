"""Contrib layers: Concurrent, HybridConcurrent, Identity, SparseEmbedding
and PixelShuffle1D/2D.

The PyTorch counterparts of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py:
17-101`` (reference: python/mxnet/gluon/contrib/nn/basic_layers.py).
The concurrent blocks run every child on the same input and concatenate
the outputs along ``axis``; DenseNet, Inception and SqueezeNet are made
of them.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn.basic_layers import HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "PixelShuffle1D", "PixelShuffle2D"]


class Concurrent(Sequential):
    """Reference: contrib/nn/basic_layers.py Concurrent."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd

        return nd.concat(*[block(x) for block in self._children.values()],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Reference: contrib/nn/basic_layers.py HybridConcurrent."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        from .... import ndarray as nd
        from .... import symbol as _sym

        F = _sym if isinstance(x, _sym.Symbol) else nd
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """Reference: contrib/nn/basic_layers.py Identity."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(HybridBlock):
    """An embedding whose weight asks for a ``row_sparse`` gradient
    (reference: contrib/nn/basic_layers.py SparseEmbedding). As in the
    JAX package, ``grad_stype`` is recorded and the gradient autograd
    writes is dense; a ``row_sparse`` gradient made by the caller (for
    example ``nd.sparse.dot(x, g, transpose_a=True)
    .tostype("row_sparse")``) takes the optimizers' lazy row updates."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, grad_stype="row_sparse")

    def hybrid_forward(self, F, x, weight):
        return F.embedding(x, weight, **self._kwargs)


class PixelShuffle1D(HybridBlock):
    """(N, f*C, W) to (N, C, f*W) (reference: contrib/nn/basic_layers.py
    PixelShuffle1D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factor = int(factor)

    def hybrid_forward(self, F, x):
        f = self._factor
        n, c, w = x.shape
        x = x.reshape(n, c // f, f, w)
        x = x.transpose((0, 1, 3, 2))
        return x.reshape(n, c // f, w * f)


class PixelShuffle2D(HybridBlock):
    """(N, f1*f2*C, H, W) to (N, C, f1*H, f2*W) (reference:
    contrib/nn/basic_layers.py PixelShuffle2D)."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        f = factor if isinstance(factor, (list, tuple)) else (factor, factor)
        self._factors = tuple(int(v) for v in f)

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        n, c, h, w = x.shape
        x = x.reshape(n, c // (f1 * f2), f1, f2, h, w)
        x = x.transpose((0, 1, 4, 2, 5, 3))
        return x.reshape(n, c // (f1 * f2), h * f1, w * f2)
