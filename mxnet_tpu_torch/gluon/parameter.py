"""Gluon Parameter / ParameterDict.

The PyTorch counterpart of ``mxnet_tpu/gluon/parameter.py:35,244``
(reference: python/mxnet/gluon/parameter.py). A :class:`Parameter` keeps
MXNet's naming, deferred shape inference (``Dense(in_units=0)``) and
initializer dispatch; once its shape is known it owns one
``torch.nn.Parameter`` on one device, which it also registers on every
block that holds it, so ``Block.named_parameters()`` and
``state_dict()`` see it.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as onp
import torch

from ..base import MXNetError
from .. import initializer
from ..context import resolve_device
from ..ndarray import NDArray
from ..ndarray.ndarray import torch_dtype

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization (reference:
    gluon/parameter.py:40)."""


class Parameter:
    """A Block parameter (reference: gluon/parameter.py:48)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 init=None, allow_deferred_init=False):
        self.name = name
        self.grad_req = grad_req
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._ndarray = None  # NDArray over the torch.nn.Parameter
        self._deferred_init = None  # (init, device, default_init)
        self._owners = []  # (block, attribute name) holding this param

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(d) for d in new_shape)
        if self._shape is None:
            self._shape = new_shape
            return
        # per-dim merge, 0 = unknown on either side (reference
        # parameter.py inferred_shape)
        if len(self._shape) != len(new_shape) or not all(
                i == 0 or j == 0 or i == j
                for i, j in zip(new_shape, self._shape)):
            raise MXNetError(
                f"shape {new_shape} is incompatible with {self._shape} "
                f"for Parameter {self.name}")
        self._shape = tuple(j if i == 0 else i
                            for i, j in zip(new_shape, self._shape))

    def _shape_complete(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def _attach(self, block, attr):
        """Register this parameter's tensor on ``block`` as ``attr``
        (now, or when initialization finishes)."""
        self._owners.append((block, attr))
        if self._ndarray is not None:
            block._parameters[attr] = self._ndarray.data

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate and fill on ``ctx`` (default: the current context),
        or defer until the first forward infers the shape."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._ndarray is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        device = resolve_device(ctx)
        if not self._shape_complete():
            if not self.allow_deferred_init:
                raise ValueError(
                    f"Cannot initialize Parameter {self.name} because it "
                    f"has invalid shape {self._shape}")
            self._deferred_init = (init, device, default_init)
            return
        self._finish_init(init, device, default_init)

    def _finish_init(self, init, device, default_init, value=None):
        """Allocate on ``device`` and fill from the initializer, or copy
        ``value`` (a tensor of this shape) instead of drawing. A deferred
        init may finish inside an inference-mode forward; the parameter
        is made a normal tensor all the same, so it can be updated later."""
        with torch.inference_mode(False):
            var = torch.nn.Parameter(
                torch.empty(self._shape, dtype=torch_dtype(self.dtype),
                            device=device),
                requires_grad=self.grad_req != "null")
            arr = NDArray(var)
            if value is not None:
                with torch.no_grad():
                    var.copy_(value)
            else:
                actual = init if init is not None else (
                    self.init if self.init is not None else default_init)
                initializer.create(actual)(self.name, arr)
        self._ndarray = arr
        self._deferred_init = None
        for block, attr in self._owners:
            block._parameters[attr] = var

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                f"Parameter {self.name} has not been initialized")
        self._finish_init(*self._deferred_init)

    def _check_initialized(self):
        if self._ndarray is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has not been initialized yet "
                    "because initialization was deferred. Actual "
                    "initialization happens during the first forward pass.")
            raise RuntimeError(
                f"Parameter {self.name} has not been initialized. You "
                "should initialize parameters with Block.initialize() "
                "first")

    def data(self, ctx=None):
        self._check_initialized()
        return self._ndarray

    def set_data(self, data, ctx=None):
        """Copy ``data`` (NDArray, tensor or array-like) into the
        parameter, which keeps its device, dtype and identity. Raises
        :class:`MXNetError` on a shape mismatch. A parameter not yet
        allocated (never initialized, or deferred) takes its missing
        dims from ``data`` and is allocated holding ``data`` — nothing is
        drawn — on its deferred device, else on ``ctx`` (default: the
        current context)."""
        if isinstance(data, NDArray):
            data = data.data
        elif not isinstance(data, torch.Tensor):
            # a copy: the source may be a read-only numpy view
            data = torch.from_numpy(onp.array(data))
        if self._ndarray is None:
            self.shape = data.shape
            if tuple(self._shape) != tuple(data.shape):
                raise MXNetError(
                    f"Parameter {self.name}: shape {tuple(data.shape)} "
                    f"does not match {self._shape}")
            device = self._deferred_init[1] if self._deferred_init \
                else resolve_device(ctx)
            self._finish_init(None, device, None, value=data)
            return
        var = self._ndarray.data
        if tuple(data.shape) != tuple(var.shape):
            raise MXNetError(
                f"Parameter {self.name}: shape {tuple(data.shape)} does "
                f"not match {tuple(var.shape)}")
        with torch.no_grad():
            var.copy_(data.to(device=var.device, dtype=var.dtype))


class ParameterDict:
    """Dict of Parameters with a name prefix (reference:
    gluon/parameter.py ParameterDict)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = OrderedDict()

    @property
    def prefix(self):
        return self._prefix

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        s = "\n".join(repr(p) for p in self._params.values())
        return f"ParameterDict {self._prefix}(\n{s}\n)"

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """Create (or retrieve) parameter ``prefix + name``."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        elif kwargs.get("shape") is not None:
            param.shape = kwargs["shape"]
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(
                    "Cannot update self with other because they have "
                    f"different Parameters with the same name '{k}'")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)
