"""NDArray over a ``torch.Tensor``.

The PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``, cut to what
the decoder, the serving stack and the transformer's training loop
touch: creation (``array``, ``zeros``, ``arange``, ``expand_dims``),
``reshape``, ``transpose``, basic indexing, arithmetic, ``sum``/``mean``,
``astype``, ``asnumpy``/``asscalar``, ``context``, ``dtype``,
``wait_to_read``, and the autograd surface (``attach_grad``, ``grad``,
``backward``, ``detach``). The device is always explicit: creation
functions take ``ctx=`` and default to the current context, which is
``gpu(0)`` unless a scope says otherwise.

Every method that computes runs with torch's grad mode on only inside
``autograd.record()``, so arithmetic outside it builds no graph.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError
from ..context import Context, resolve_device

__all__ = ["NDArray", "array", "zeros", "arange", "expand_dims",
           "torch_dtype"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(dtype):
    """``torch.dtype`` for a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else onp.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError(f"unsupported dtype {dtype!r}") from None


def _numpy_dtype(dtype):
    return onp.dtype(str(dtype).replace("torch.", ""))


class NDArray:
    """An n-dimensional array on one device, backed by a tensor."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data).__name__}")
        self._data = data
        self._grad = None
        self._grad_req = "null"

    @property
    def data(self):
        """The backing ``torch.Tensor``."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        return _numpy_dtype(self._data.dtype)

    @property
    def context(self):
        return Context.from_device(self._data.device)

    def asnumpy(self):
        """A host copy (waits for the device). Always a copy, never a
        view of a CPU tensor that a later in-place op could change."""
        t = self._data.detach()
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def asscalar(self):
        """The value of a one-element array as a Python number."""
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self._data.item()

    def wait_to_read(self):
        """Block until the array's value is computed."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    # -- autograd ----------------------------------------------------------

    @property
    def grad(self):
        """The gradient buffer attached by :meth:`attach_grad` (None
        before)."""
        return self._grad

    def attach_grad(self, grad_req="write"):
        """Give this array a zero gradient buffer; ``backward`` writes
        (or, with ``grad_req="add"``, adds) its gradient there
        (reference: ndarray.py attach_grad)."""
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data,
                                              requires_grad=False))],
            grad_req)

    def backward(self, out_grad=None, retain_graph=False):
        """Reference: ndarray.py backward."""
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph)

    def detach(self):
        """The same values, cut from the recorded graph."""
        return NDArray(self._data.detach())

    # -- shape and type ----------------------------------------------------

    def _apply(self, fn, *args, **kwargs):
        with autograd._grad_mode():
            return NDArray(fn(*args, **kwargs))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._apply(self._data.reshape, shape)

    def transpose(self, axes=None):
        """Permute the axes (default: reverse them)."""
        axes = tuple(reversed(range(self.ndim))) if not axes else axes
        return self._apply(self._data.permute, *axes)

    def astype(self, dtype, copy=True):
        return self._apply(self._data.to, torch_dtype(dtype), copy=copy)

    def __getitem__(self, key):
        """Basic indexing: ints, slices, ``None`` and ``...`` (a view, as
        in numpy)."""
        items = key if isinstance(key, tuple) else (key,)
        if not all(k is None or k is Ellipsis or isinstance(k, (int, slice))
                   for k in items):
            raise MXNetError(f"NDArray indexing takes ints, slices, None and "
                             f"..., got {key!r}")
        return self._apply(self._data.__getitem__, key)

    # -- arithmetic --------------------------------------------------------

    @staticmethod
    def _other(x):
        return x._data if isinstance(x, NDArray) else x

    def __add__(self, other):
        return self._apply(torch.add, self._data, self._other(other))

    __radd__ = __add__

    def __sub__(self, other):
        return self._apply(torch.sub, self._data, self._other(other))

    def __mul__(self, other):
        return self._apply(torch.mul, self._data, self._other(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._apply(torch.div, self._data, self._other(other))

    def __neg__(self):
        return self._apply(torch.neg, self._data)

    # -- reductions --------------------------------------------------------

    def sum(self, axis=None, keepdims=False):
        return self._apply(_reduce, torch.sum, self._data, axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._apply(_reduce, torch.mean, self._data, axis, keepdims)

    def __repr__(self):
        return f"\n{self.asnumpy()!r}\n<NDArray {self.shape} @{self.context}>"


def _reduce(fn, data, axis=None, keepdims=False):
    """``fn`` (torch.sum or torch.mean) over ``axis`` (an int, a tuple,
    or None for every axis), MXNet's reduce signature."""
    if axis is None or (isinstance(axis, (tuple, list)) and not axis):
        axis = tuple(range(data.dim()))
    return fn(data, dim=axis, keepdim=keepdims)


def array(source_array, ctx=None, dtype=None):
    """An NDArray copy of ``source_array`` on ``ctx``. The dtype is
    ``dtype`` if given, else the source's, with float64 (and Python
    lists of floats) narrowed to float32 as in MXNet."""
    dev = resolve_device(ctx)
    if isinstance(source_array, NDArray):
        src = source_array.data
        dt = torch_dtype(dtype) if dtype is not None else src.dtype
        return NDArray(src.to(device=dev, dtype=dt, copy=True))
    if isinstance(source_array, torch.Tensor):
        src = source_array.detach()
        dt = torch_dtype(dtype) if dtype is not None else src.dtype
        return NDArray(src.to(device=dev, dtype=dt, copy=True))
    arr = onp.asarray(source_array)
    if dtype is not None:
        arr = arr.astype(_numpy_dtype(dtype), copy=False)
    elif arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return NDArray(torch.from_numpy(onp.ascontiguousarray(arr)).to(dev))


def zeros(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)))


def arange(start, stop=None, step=1.0, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                                device=resolve_device(ctx)))


def expand_dims(data, axis):
    return NDArray(data.data.unsqueeze(axis))
