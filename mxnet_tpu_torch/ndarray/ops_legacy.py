"""Legacy regression output heads.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_legacy.py:26-85``
(reference: src/operator/regression_output-inl.h): the forward is the
identity (the sigmoid for the logistic head); the backward ignores the
incoming head gradient's value and gives
``(forward - label) * grad_scale / num_output`` (the sign of
``data - label`` for the MAE head), ``num_output`` the per-sample
feature count; the label gets a zero gradient. A bound executor gives
these heads the unscaled loss-head gradient instead (``executor.py``),
as the JAX executor's ``loss_fn`` does.
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ["linear_regression_output", "mae_regression_output",
           "logistic_regression_output"]


def _per_sample(data):
    """grad_scale / num_output scaling, num_output the per-sample feature
    count (reference regression_output-inl.h:201)."""
    return max(math.prod(data.shape[1:]), 1) if data.dim() > 1 else 1


class _HeadGradFree(torch.autograd.Function):
    """``fwd(data)`` forward; ``grad(data, label)`` * grad_scale /
    num_output backward, whatever the head gradient holds."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, fwd, grad):
        ctx.save_for_backward(data, label)
        ctx.grad_scale, ctx.grad = grad_scale, grad
        return fwd(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        gd = ctx.grad(data, label.reshape(data.shape)) * \
            (ctx.grad_scale / _per_sample(data))
        return gd, torch.zeros_like(label), None, None, None


def _identity(x):
    return x.view_as(x)


def _head(data, label, grad_scale, fwd, grad):
    if data.is_meta:
        return torch.empty_like(data)
    return _HeadGradFree.apply(data, label, float(grad_scale), fwd, grad)


@register()
def linear_regression_output(data, label, grad_scale=1.0):
    """Reference: regression_output.cc LinearRegressionOutput."""
    return _head(data, label, grad_scale, _identity, lambda d, l: d - l)


@register()
def mae_regression_output(data, label, grad_scale=1.0):
    """Reference: regression_output.cc MAERegressionOutput."""
    return _head(data, label, grad_scale, _identity,
                 lambda d, l: torch.sign(d - l))


@register()
def logistic_regression_output(data, label, grad_scale=1.0):
    """Reference: regression_output.cc LogisticRegressionOutput."""
    return _head(data, label, grad_scale, torch.sigmoid,
                 lambda d, l: torch.sigmoid(d) - l)
