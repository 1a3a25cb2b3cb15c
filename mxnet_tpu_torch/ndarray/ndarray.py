"""NDArray over a ``torch.Tensor``.

The PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``, cut to what
the decoder and the serving stack touch: creation (``array``,
``zeros``, ``arange``, ``expand_dims``), ``reshape``, ``+``/``*``,
``asnumpy``, ``context``, ``dtype`` and ``wait_to_read``. The device is
always explicit: creation functions take ``ctx=`` and default to the
current context, which is ``gpu(0)`` unless a scope says otherwise.
"""
from __future__ import annotations

import numpy as onp
import torch

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

    __slots__ = ("_data",)

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError(f"NDArray wraps a torch.Tensor, got "
                             f"{type(data).__name__}")
        self._data = data

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

    def wait_to_read(self):
        """Block until the array's value is computed."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(self._data.reshape(shape))

    @staticmethod
    def _other(x):
        return x._data if isinstance(x, NDArray) else x

    def __add__(self, other):
        return NDArray(self._data + self._other(other))

    __radd__ = __add__

    def __mul__(self, other):
        return NDArray(self._data * self._other(other))

    __rmul__ = __mul__

    def __repr__(self):
        return f"\n{self.asnumpy()!r}\n<NDArray {self.shape} @{self.context}>"


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
