"""Optimizer classes.

The PyTorch counterpart of ``mxnet_tpu/optimizer/optimizer.py:25-164,
172,344`` (reference: python/mxnet/optimizer/optimizer.py): the
``Optimizer`` base with its registry, the parameters' learning-rate and
weight-decay multipliers and per-index update counts, ``SGD`` (with
momentum) and ``Adam``. The update arithmetic is in the registered ops
(``ndarray/ops_optim.py``), which write the weight and the state in
place; these classes keep state and hyperparameters. Adam's bias
correction is computed on the host in float64, as the JAX package's
eager path does.

Not ported: the multi-tensor ``update_multi`` path, sparse gradients,
multi-precision master weights, lr schedulers, per-name multiplier
tables (``set_lr_mult``) and the fused-step kernels (``_fused_kernel``);
they come with the slices that need them (ROADMAP).
"""
from __future__ import annotations

import torch

from ..ndarray import NDArray
from ..ndarray import ops_optim as _oo

__all__ = ["Optimizer", "register", "create", "SGD", "Adam"]

_REGISTRY = {}


def register(klass):
    """Register an optimizer class under its lower-cased name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer from an instance or a registered name."""
    if isinstance(name, Optimizer):
        return name
    try:
        klass = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"optimizer {name!r} not registered; known: "
                         f"{sorted(_REGISTRY)}") from None
    return klass(**kwargs)


class Optimizer:
    """Base optimizer (reference: optimizer.py:143)."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, begin_num_update=0, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}  # index -> gluon Parameter

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        return wd

    def _clip(self):
        """clip_gradient as the ops take it: a value <= 0 disables it."""
        return -1.0 if self.clip_gradient is None else \
            float(self.clip_gradient)

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr})"


def _zeros_like(weight):
    return NDArray(torch.zeros_like(weight.data, requires_grad=False))


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py:601)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is None:
            _oo.sgd_update(weight.data, grad.data, lr, wd=wd,
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self._clip())
        else:
            _oo.sgd_mom_update(weight.data, grad.data, state.data, lr,
                               momentum=self.momentum, wd=wd,
                               rescale_grad=self.rescale_grad,
                               clip_gradient=self._clip())


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        # bias correction on the host in float64 (optimizer.py:361)
        lr *= (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)
        mean, var = state
        _oo.adam_update(weight.data, grad.data, mean.data, var.data, lr,
                        beta1=self.beta1, beta2=self.beta2,
                        epsilon=self.epsilon, wd=wd,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self._clip())
