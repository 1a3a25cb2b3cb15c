"""Gluon Parameter / ParameterDict.

The PyTorch counterpart of ``mxnet_tpu/gluon/parameter.py:35,244``
(reference: python/mxnet/gluon/parameter.py). A :class:`Parameter` keeps
MXNet's naming, deferred shape inference (``Dense(in_units=0)``) and
initializer dispatch; once its shape is known it owns one
``torch.nn.Parameter`` on one device, which it also registers on every
block that holds it, so ``Block.named_parameters()`` and
``state_dict()`` see it. That tensor is the parameter for its whole
life: ``set_data`` and the optimizer write into it in place, never
replace it. Unless ``grad_req`` is ``"null"`` it is an autograd leaf
with a gradient buffer (``grad()``) that ``autograd.backward`` writes
by MXNet's ``grad_req`` rules. The buffer is allocated by the first
``backward`` (or ``grad()``), so a model that only serves never holds
one.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as onp
import torch

from ..base import MXNetError
from .. import autograd, initializer
from ..context import resolve_device
from ..ndarray import NDArray
from ..ndarray.ndarray import host_tensor, torch_dtype

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]

_GRAD_REQS = ("write", "add", "null")


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization (reference:
    gluon/parameter.py:40)."""


class Parameter:
    """A Block parameter (reference: gluon/parameter.py:48)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False):
        self.name = name
        if grad_req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{grad_req!r}")
        self._grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
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
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """Change how ``backward`` treats this parameter: ``"null"``
        drops its gradient buffer and stops recording its gradient;
        ``"write"``/``"add"`` give it a zero buffer (reference:
        gluon/parameter.py grad_req)."""
        if req not in _GRAD_REQS:
            raise ValueError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{req!r}")
        self._grad_req = req
        if self._ndarray is not None:
            self._mark()

    def _mark(self):
        """Mark the tensor as a leaf by ``grad_req``, its gradient
        buffer (re)set to zero: not yet allocated."""
        autograd.mark_variables([self._ndarray], [None], self._grad_req)

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
            self._mark()
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

    def grad(self, ctx=None):
        """The gradient buffer ``backward`` writes; zeros before the first
        ``backward`` (reference: gluon/parameter.py grad)."""
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError(
                f"Cannot get gradient array for Parameter {self.name} "
                "because grad_req='null'")
        arr = self._ndarray
        if arr.grad is None:
            # a normal tensor even inside inference mode: backward writes
            # it later
            with torch.inference_mode(False):
                arr._grad = NDArray(torch.zeros_like(arr.data,
                                                     requires_grad=False))
        return arr.grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient buffer to zero, in place."""
        if self._ndarray is not None and self._ndarray.grad is not None:
            with torch.no_grad():
                self._ndarray.grad.data.zero_()

    def cast(self, dtype):
        """Convert the parameter to ``dtype`` (reference:
        gluon/parameter.py cast). Its ``torch.nn.Parameter`` stays the
        same object, so the blocks that registered it see the new dtype;
        it keeps its device, its ``grad_req`` and its gradient buffer,
        which takes the new dtype as zeros."""
        self.dtype = dtype if isinstance(dtype, str) else \
            str(torch_dtype(dtype)).replace("torch.", "")
        arr = self._ndarray
        if arr is None:
            return
        dt = torch_dtype(dtype)
        var = arr.data
        if var.dtype == dt:
            return
        with torch.no_grad():
            var.data = var.data.to(dt)
            if arr.grad is not None:
                arr.grad._data = torch.zeros_like(var, requires_grad=False)

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
            # a copy (the source may be a read-only numpy view); bfloat16
            # arrays of the JAX package bit for bit
            data = host_tensor(onp.array(data))
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

    def _load_init_from(self, data, ctx=None):
        """Take ``data`` as the parameter's value, allocating it first
        if it is not yet (its shape from ``data``, nothing drawn), as
        ``ParameterDict.load`` does (``mxnet_tpu/gluon/parameter.py:371``)."""
        self.set_data(data, ctx=ctx)


class _ConstantInit(initializer.Initializer):
    """Fills a parameter with a fixed value, whatever its name."""

    def __init__(self, value):
        super().__init__()
        self._value = value

    def __call__(self, desc, arr):
        with torch.no_grad():
            arr.data.copy_(self._value.to(arr.data.device, arr.data.dtype))


class Constant(Parameter):
    """A parameter that holds a fixed value and takes no gradient
    (reference: gluon/parameter.py Constant; ``mxnet_tpu/gluon/
    parameter.py:225``): ``grad_req="null"``, and its own initializer
    copies ``value`` in."""

    def __init__(self, name, value):
        if isinstance(value, NDArray):
            t = value.data.detach().to("cpu")
        elif isinstance(value, torch.Tensor):
            t = value.detach().to("cpu")
        else:
            t = host_tensor(onp.array(value, dtype=onp.float32)
                            if not hasattr(value, "dtype")
                            else onp.array(value))
        self.value = NDArray(t.clone())
        super().__init__(name, grad_req="null", shape=tuple(t.shape),
                         dtype=str(t.dtype).replace("torch.", ""),
                         init=_ConstantInit(t.clone()))


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

    def get_constant(self, name, value=None):
        """Create (or retrieve) constant ``prefix + name`` holding
        ``value`` (reference: gluon/parameter.py get_constant)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None:
            if value is None:
                raise KeyError(f"No constant named '{name}'")
            param = Constant(name, value)
            self._params[name] = param
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

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def save(self, filename, strip_prefix=""):
        """Write every parameter under its full name less
        ``strip_prefix`` (reference: gluon/parameter.py save)."""
        from .. import ndarray as nd

        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    f"Prefix '{strip_prefix}' is to be striped before "
                    f"saving, but Parameter's name '{param.name}' does not "
                    "start with it")
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load what :meth:`save` wrote; a parameter not yet allocated is
        allocated holding its value (reference: gluon/parameter.py
        load)."""
        from .. import ndarray as nd
        from ..context import cpu

        arg_dict = {restore_prefix + k: v
                    for k, v in nd.load(filename, ctx=cpu()).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise IOError(f"Parameter {name} is missing in file "
                                  f"{filename}")
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError(f"Parameter {name} loaded from file "
                                  f"{filename} is not present in this dict")
                continue
            self._params[name]._load_init_from(value, ctx=ctx)
