"""Gluon Block / HybridBlock over ``torch.nn.Module``.

The PyTorch counterpart of ``mxnet_tpu/gluon/block.py:92,156,279,292,522``
(reference: python/mxnet/gluon/block.py). A :class:`Block` is an
``nn.Module``: its children are the module's submodules, and each
Gluon :class:`~.parameter.Parameter` registers its tensor on the block
once it is initialized. MXNet's naming survives — ``name_scope``
prefixes, ``collect_params`` and the structural names of
``_collect_params_with_prefix`` — so checkpoints and carried weights
line up with the JAX package. ``hybrid_forward(F, ...)`` runs with
``F`` = the port's ``nd`` module, so model files port line for line.
A block's forward builds an autograd graph only inside
``autograd.record()``; outside it, grad mode is off for the call.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import ndarray as nd
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _BlockScope(threading.local):
    def __init__(self):
        self.current = None
        self.counters = {}


_SCOPE = _BlockScope()


def _gen_prefix(hint):
    if _SCOPE.current is None:
        counters = _SCOPE.counters
        base = ""
    else:
        counters = _SCOPE.current._counters
        base = _SCOPE.current.prefix
    idx = counters.get(hint, 0)
    counters[hint] = idx + 1
    return f"{base}{hint}{idx}_"


class _NameScope:
    def __init__(self, block):
        self._block = block
        self._old = None

    def __enter__(self):
        self._old = _SCOPE.current
        _SCOPE.current = self._block
        return self

    def __exit__(self, *exc):
        _SCOPE.current = self._old


class Block(torch.nn.Module):
    """Base building block (reference: gluon/block.py:228)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = prefix if prefix is not None else \
            _gen_prefix(type(self).__name__.lower())
        self._params = ParameterDict(params.prefix if params is not None
                                     else self._prefix)
        if params is not None:
            self._params.update(params)
        self._reg_params = {}
        self._counters = {}

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    @property
    def _children(self):
        return self._modules

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else \
            self._prefix

    def name_scope(self):
        """Reference: gluon/block.py name_scope."""
        return _NameScope(self)

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """Reference: gluon/block.py:372 collect_params with regex select."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, ``gpu(0)`` unless a scope says otherwise)."""
        from .. import initializer

        self.collect_params().initialize(init or initializer.Uniform(), ctx,
                                         verbose, force_reinit)

    def _collect_params_with_prefix(self, prefix=""):
        """Structure-based parameter names ("0.weight", "body.1.bias"),
        the names the JAX package's ``save_parameters`` writes."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def __call__(self, *args, **kwargs):
        with autograd._grad_mode():
            return super().__call__(*args, **kwargs)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block written as ``hybrid_forward(F, x, *args, **params)``
    (reference: gluon/block.py:838)."""

    def hybridize(self, active=True, **kwargs):
        """Accepted and does nothing yet: the port runs blocks eagerly.
        Compiling the forward (the reference's ``CachedOp``) comes in a
        later slice."""
        super().hybridize(active, **kwargs)

    def forward(self, x, *args):
        """Dispatch to ``hybrid_forward`` with the parameters as keyword
        arguments, finishing deferred initialization from ``x`` first."""
        params = {}
        for name, param in self._reg_params.items():
            try:
                params[name] = param.data()
            except DeferredInitializationError:
                self._infer_param_shapes(x, *args)
                params[name] = param.data()
        return self.hybrid_forward(nd, x, *args, **params)

    def _infer_param_shapes(self, x, *args):
        infer = getattr(self, "infer_param_shapes", None)
        if infer is None:
            raise DeferredInitializationError(
                f"{type(self).__name__} has deferred parameters and no "
                "shape-inference hook; call initialize() with known shapes")
        infer(x, *args)
        for p in self._reg_params.values():
            if p._ndarray is None and p._deferred_init is not None:
                p._finish_deferred_init()

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
