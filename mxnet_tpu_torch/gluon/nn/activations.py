"""Activation layers.

The PyTorch counterparts of ``mxnet_tpu/gluon/nn/activations.py:11-62``
(reference: python/mxnet/gluon/nn/activations.py): ``LeakyReLU``,
``PReLU``, ``ELU``, ``SELU``, ``Swish`` and ``GELU`` over the
``leaky_relu`` op; ``Activation`` stays in ``basic_layers`` and is
importable from here too. ``PReLU``'s slope is one learned parameter,
``alpha`` of shape (1,), shared by every channel, as in the JAX layer.
"""
from __future__ import annotations

from ... import initializer
from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "Swish",
           "GELU"]


class LeakyReLU(HybridBlock):
    """x for x > 0, ``alpha * x`` otherwise."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="leaky", slope=self._alpha)

    def extra_repr(self):
        return str(self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope, initialized to 0.25."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.leaky_relu(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """x for x > 0, ``alpha * (exp(x) - 1)`` otherwise."""

    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """The self-normalizing ELU (Klambauer et al. 2017)."""

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """The Gaussian error linear unit, as the ``leaky_relu`` op computes
    it."""

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="gelu")
