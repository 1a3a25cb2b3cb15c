"""Optimizer update ops, in place.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_optim.py:28,37,57``
(reference: src/operator/optimizer_op-inl.h): ``sgd_update``,
``sgd_mom_update`` and ``adam_update``, with the same ``rescale_grad``,
``clip_gradient`` (a value <= 0 disables it) and ``wd`` arithmetic.

The JAX ops are pure functions whose results the optimizer swaps into
the NDArray. These write **in place**, under ``torch.no_grad()``, into
the weight and state tensors they are given, and return those same
tensors, as MXNet's own kernels do. A parameter's tensor is the
``torch.nn.Parameter`` its blocks registered (``Parameter._attach``), so
an update must never swap it for a new one: the blocks would keep the
old. The JAX package left these to XLA; the port leaves them to torch.
"""
from __future__ import annotations

import torch

from .registry import register


def _prep_grad(grad, rescale_grad, clip_gradient):
    grad = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        grad = grad.clamp(-clip_gradient, clip_gradient)
    return grad


@register(differentiable=False)
def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """w -= lr * (rescale*clip(g) + wd*w), in place; returns ``weight``
    (reference: optimizer_op.cc sgd_update)."""
    with torch.no_grad():
        g = _prep_grad(grad, rescale_grad, clip_gradient)
        weight.sub_(lr * (g + wd * weight))
    return weight


@register(differentiable=False)
def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum*mom - lr*(rescale*clip(g) + wd*w); w += mom, in
    place; returns (weight, mom) (reference: optimizer_op.cc
    sgd_mom_update)."""
    with torch.no_grad():
        g = _prep_grad(grad, rescale_grad, clip_gradient)
        mom.mul_(momentum).sub_(lr * (g + wd * weight))
        weight.add_(mom)
    return weight, mom


@register(differentiable=False)
def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """One Adam step over the (mean, var) moments, in place; returns
    (weight, mean, var) (reference: optimizer_op.cc adam_update). ``lr``
    arrives bias-corrected from the optimizer."""
    with torch.no_grad():
        g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
        mean.mul_(beta1).add_((1 - beta1) * g)
        var.mul_(beta2).add_((1 - beta2) * torch.square(g))
        weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
    return weight, mean, var
