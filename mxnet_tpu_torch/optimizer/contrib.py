"""Contrib optimizers (reference: python/mxnet/optimizer/contrib.py; the
JAX package's ``mxnet_tpu/optimizer/contrib.py``): ``GroupAdaGrad``."""
from __future__ import annotations

import torch

from ..ndarray import NDArray
from ..ndarray import ops_optim as _oo
from ..ndarray import sparse as _sp
from .optimizer import Optimizer, register

__all__ = ["GroupAdaGrad"]


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one history per row of a 2-D weight (reference:
    optimizer/contrib.py GroupAdaGrad over group_adagrad_update)::

        history += mean(grad^2, axis=1, keepdims=True)
        weight -= lr * grad / sqrt(history + eps)

    No weight decay (the reference asserts it is 0). A ``row_sparse``
    gradient updates its stored rows and their histories alone
    (``sparse.group_adagrad_update_rsp``), the lazy update embedding
    tables rely on."""

    def __init__(self, eps=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        assert len(weight.shape) == 2, \
            "GroupAdaGrad expects 2-D weights (rows share one rate)"
        return NDArray(torch.zeros((weight.shape[0], 1),
                                   dtype=weight.data.dtype,
                                   device=weight.data.device))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        assert self._get_wd(index) == 0, \
            "Weight decay is not supported for GroupAdaGrad"
        if isinstance(grad, _sp.RowSparseNDArray):
            _sp.group_adagrad_update_rsp(
                weight, grad, state, lr, epsilon=self.float_stable_eps,
                rescale_grad=self.rescale_grad,
                clip_gradient=self.clip_gradient)
            return
        w, h = weight.data, state.data
        with torch.no_grad():
            g = grad.data * self.rescale_grad
            if self.clip_gradient is not None:
                c = float(self.clip_gradient)
                g = torch.clamp(g, -c, c)
            h2 = h + torch.mean(g * g, dim=1, keepdim=True)
            w2 = w - lr * (g / (h2 + self.float_stable_eps) ** 0.5)
        _oo._commit([w, h], [w2, h2])
