"""Basic tensor ops the transformer and its loss use.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_basic.py`` (``dot``
:666, ``transpose`` :377, the reductions :254, the elementwise table
:28-32 and ``broadcast_mul`` :159), cut to what this slice's path
calls. The JAX package left them to XLA; the port leaves them to torch.
"""
from __future__ import annotations

import torch

from .ndarray import _reduce
from .registry import register


@register()
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: contracts lhs's last axis with rhs's first axis, after
    reversing the axes of either operand on request (reference:
    src/operator/tensor/dot-inl.h)."""
    if transpose_a:
        lhs = lhs.permute(*reversed(range(lhs.dim())))
    if transpose_b:
        rhs = rhs.permute(*reversed(range(rhs.dim())))
    if lhs.dim() <= 2 and rhs.dim() <= 2:
        return torch.matmul(lhs, rhs)
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register()
def transpose(data, axes=None):
    """Permute axes (default: reverse them) (reference: matrix_op.cc
    transpose)."""
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register()
def sum(data, axis=None, keepdims=False):
    """Reference: broadcast_reduce_op_value.cc sum."""
    return _reduce(torch.sum, data, axis, keepdims)


@register()
def mean(data, axis=None, keepdims=False):
    """Reference: broadcast_reduce_op_value.cc mean."""
    return _reduce(torch.mean, data, axis, keepdims)


@register()
def abs(data):
    return torch.abs(data)


@register()
def square(data):
    return torch.square(data)


@register()
def broadcast_mul(lhs, rhs):
    return torch.mul(lhs, rhs)
