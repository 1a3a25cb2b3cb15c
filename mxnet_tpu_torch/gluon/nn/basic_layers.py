"""Basic Gluon layers.

The PyTorch counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``
(reference: python/mxnet/gluon/nn/basic_layers.py): Sequential,
HybridSequential, Dense, Activation, Dropout, BatchNorm, InstanceNorm,
LayerNorm, GroupNorm, Embedding, Flatten, Lambda and HybridLambda.
``GroupNorm`` keeps one gamma and one beta per group, ``(num_groups,)``,
the JAX layer's and MXNet 1.5's rule.
"""
from __future__ import annotations

import math

import torch

from ... import ndarray as nd
from ..block import Block, HybridBlock
from ...ndarray.ndarray import torch_dtype

__all__ = ["Sequential", "HybridSequential", "Dense", "Activation",
           "Dropout", "BatchNorm", "InstanceNorm", "LayerNorm", "GroupNorm",
           "Embedding", "Flatten", "Lambda", "HybridLambda"]


class _SequentialMixin:
    """The children run in order; a child returning several outputs
    passes the rest on as extra arguments of the next."""

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

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)()
            net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)


class Sequential(_SequentialMixin, Block):
    """Reference: basic_layers.py Sequential: a plain Block, run eagerly
    (``hybridize`` reaches its hybridizable children)."""


class HybridSequential(_SequentialMixin, HybridBlock):
    """Reference: basic_layers.py HybridSequential."""


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


class Dropout(HybridBlock):
    """Reference: basic_layers.py Dropout. The identity at ``rate`` 0 and
    outside training."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        if self._rate > 0:
            return F.dropout(x, p=self._rate, axes=self._axes)
        return x


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics (reference:
    basic_layers.py BatchNorm, src/operator/nn/batch_norm.cc).

    ``running_mean`` and ``running_var`` are ``grad_req="null"``
    parameters. Under ``autograd.is_training()`` (and without
    ``use_global_stats``) the layer normalizes with the batch's mean and
    biased variance and then writes the running statistics back, in
    place: ``m * running + (1 - m) * batch`` with MXNet's ``momentum``
    (0.9 keeps 90% of the old value; torch's own momentum means the
    opposite). Otherwise it normalizes with the running statistics and
    writes nothing. Half-precision inputs compute their statistics in
    float32 (the op's rule), and :meth:`cast` to a half type keeps the
    layer's parameters and statistics in float32 (the AMP rule)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True)

    def infer_param_shapes(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        """Norm parameters and statistics stay float32 under a half cast
        (``mxnet_tpu/gluon/nn/basic_layers.py:202-206``)."""
        if torch_dtype(dtype) in (torch.float16, torch.bfloat16):
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        from ... import autograd

        if autograd.is_training() and not self._use_global_stats:
            out, mean, var = F.batch_norm(
                x, gamma, beta, running_mean, running_var,
                eps=self._epsilon, momentum=self._momentum,
                fix_gamma=not self._scale, output_mean_var=True,
                axis=self._axis, use_batch_stats=True)
            m = self._momentum
            runs = [running_mean.data, running_var.data]
            with torch.no_grad():
                # both statistics in one multi-tensor pass per operation
                torch._foreach_mul_(runs, m)
                torch._foreach_add_(runs, [b.data.to(r.dtype) for r, b in
                                           zip(runs, (mean, var))],
                                    alpha=1 - m)
            return out
        return F.batch_norm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=True, axis=self._axis, use_batch_stats=False)

    def extra_repr(self):
        return f"axis={self._axis}, eps={self._epsilon}, " \
               f"momentum={self._momentum}"


class InstanceNorm(HybridBlock):
    """Reference: basic_layers.py InstanceNorm: each sample's channels
    normalized over their spatial axes, then scaled and shifted per
    channel. As in the JAX layer, ``center`` and ``scale`` are accepted
    and gamma and beta always take part."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
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
        return F.instance_norm(x, gamma, beta, eps=self._epsilon)


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


class GroupNorm(HybridBlock):
    """Reference: basic_layers.py GroupNorm: the channels split into
    ``num_groups`` groups, each normalized over its channels and spatial
    axes, with one gamma and one beta per group."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_groups = num_groups
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(num_groups,),
                                         init=gamma_initializer,
                                         allow_deferred_init=True)
            self.beta = self.params.get("beta", shape=(num_groups,),
                                        init=beta_initializer,
                                        allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.group_norm(x, gamma, beta, num_groups=self._num_groups,
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


class Flatten(HybridBlock):
    """Reference: basic_layers.py Flatten: (N, ...) to (N, -1)."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Lambda(Block):
    """A function as a Block (reference: basic_layers.py Lambda):
    ``function`` is a callable on NDArrays or the name of an ``nd``
    function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            if not hasattr(nd, function):
                raise ValueError(
                    f"Function name {function} is not found in ndarray.")
            self._func_impl = getattr(nd, function)
        else:
            self._func_impl = function

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """A function as a HybridBlock (reference: basic_layers.py
    HybridLambda): ``function(F, x, *args)``, or the name of a function
    both ``nd`` and ``sym`` have."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            if not hasattr(nd, function):
                raise ValueError(
                    f"Function name {function} is not found in ndarray.")
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, "__name__", "custom")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def extra_repr(self):
        return self._func_name
