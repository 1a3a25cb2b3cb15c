"""Basic Gluon layers.

The PyTorch counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py:56,89,
253,308`` (reference: python/mxnet/gluon/nn/basic_layers.py):
HybridSequential, Dense, Activation, LayerNorm and Embedding.
"""
from __future__ import annotations

import math

from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "Activation", "LayerNorm",
           "Embedding"]


class HybridSequential(HybridBlock):
    """Reference: basic_layers.py HybridSequential."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                args = tuple(x[1:])
                x = x[0]
        if args:
            return (x,) + args
        return x


class Dense(HybridBlock):
    """Fully-connected layer (reference: basic_layers.py Dense). The
    weight is (units, in_units), MXNet's layout and ``nn.Linear``'s;
    ``in_units=0`` defers the shape to the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), init=weight_initializer,
                dtype=dtype, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=bias_initializer,
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            self.act = Activation(activation) if activation is not None \
                else None

    def infer_param_shapes(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.fully_connected(x, weight, bias, num_hidden=self._units,
                                flatten=self._flatten, no_bias=bias is None)
        if self.act is not None:
            out = self.act(out)
        return out

    def extra_repr(self):
        shape = self.weight.shape
        return f"{shape[1] if shape and len(shape) > 1 else None} -> " \
               f"{self._units}"


class Activation(HybridBlock):
    """Reference: nn/activations.py Activation."""

    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class LayerNorm(HybridBlock):
    """Reference: basic_layers.py LayerNorm."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(in_channels,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(in_channels,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def infer_param_shapes(self, x, *args):
        c = x.shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.layer_norm(x, gamma, beta, axis=self._axis,
                            eps=self._epsilon)


class Embedding(HybridBlock):
    """Reference: basic_layers.py Embedding (op: indexing_op.h)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype)

    def hybrid_forward(self, F, x, weight):
        return F.embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"
