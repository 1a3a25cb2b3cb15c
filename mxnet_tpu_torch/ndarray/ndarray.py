"""NDArray over a ``torch.Tensor``.

The PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``, cut to what
the decoder, the serving stack and the transformer's training loop
touch: creation (``array``, ``zeros``, ``arange``, ``expand_dims``),
``reshape``, ``transpose``, basic indexing and assignment, arithmetic,
``sum``/``mean``, ``astype``, ``asnumpy``/``asscalar``, ``context``,
``dtype``, ``wait_to_read``, and the autograd surface (``attach_grad``,
``grad``, ``backward``, ``detach``). The device is always explicit: creation
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

__all__ = ["NDArray", "array", "zeros", "ones", "arange", "expand_dims",
           "torch_dtype", "save", "load", "load_frombuffer"]

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


def _bfloat16_numpy():
    """numpy's bfloat16 (``ml_dtypes``, which JAX arrays use), or None
    where that package is not installed."""
    try:
        import ml_dtypes
    except ImportError:
        return None
    return onp.dtype(ml_dtypes.bfloat16)


def _numpy_dtype(dtype):
    """The numpy dtype of a torch dtype. bfloat16 is ``ml_dtypes``'
    where installed (the JAX package's), else the name "bfloat16"."""
    name = str(dtype).replace("torch.", "")
    if name == "bfloat16":
        bf = _bfloat16_numpy()
        return bf if bf is not None else name
    return onp.dtype(name)


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

    def __len__(self):
        """The length of the first axis."""
        if self._data.dim() == 0:
            raise TypeError("len() of a 0-d NDArray")
        return self._data.shape[0]

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
        if t.dtype == torch.bfloat16:
            # bit for bit as ml_dtypes' bfloat16, as the JAX package
            # returns it; float32 (exact) where ml_dtypes is missing
            bf = _bfloat16_numpy()
            if bf is None:
                return t.float().cpu().numpy()
            return t.cpu().view(torch.int16).numpy().copy().view(bf)
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()

    def asscalar(self):
        """The value of a one-element array as a Python number."""
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self._data.item()

    def as_in_context(self, ctx):
        """This array on ``ctx``: itself if it is there already, else a
        copy (reference: ndarray.py as_in_context). A host array bound
        for the card goes through pinned memory without blocking the
        host."""
        from ..context import host_to_device

        dev = resolve_device(ctx)
        if self._data.device == dev:
            return self
        with autograd._grad_mode():
            return NDArray(host_to_device(self._data, dev))

    as_in_ctx = as_in_context

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

    def squeeze(self, axis=None):
        """Drop size-1 axes, all or ``axis``."""
        if axis is None:
            return self._apply(self._data.squeeze)
        return self._apply(self._data.squeeze, axis)

    def copyto(self, other):
        """Copy into ``other``: an NDArray, written in place (its tensor
        keeps its storage, so a captured graph that reads it sees the
        new values), or a Context, a new array there (reference:
        ndarray.py copyto)."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError(f"copyto: shape {self.shape} into "
                                 f"{other.shape}")
            with torch.no_grad():
                other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        raise TypeError(f"copyto does not support type {type(other)}")

    def copy(self):
        """A copy on the same device, off any recorded graph."""
        return NDArray(self._data.detach().clone())

    def __getitem__(self, key):
        """Basic indexing: ints, slices, ``None`` and ``...`` (a view, as
        in numpy)."""
        items = key if isinstance(key, tuple) else (key,)
        if not all(k is None or k is Ellipsis or isinstance(k, (int, slice))
                   for k in items):
            raise MXNetError(f"NDArray indexing takes ints, slices, None and "
                             f"..., got {key!r}")
        return self._apply(self._data.__getitem__, key)

    def __setitem__(self, key, value):
        """Write ``value`` (an NDArray, tensor, number or array-like) into
        the region basic indexing selects, in place and outside any
        recorded graph, as ``CustomOp.assign`` does (``dst[:] = src``)."""
        items = key if isinstance(key, tuple) else (key,)
        if not all(k is None or k is Ellipsis or isinstance(k, (int, slice))
                   for k in items):
            raise MXNetError(f"NDArray indexing takes ints, slices, None and "
                             f"..., got {key!r}")
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (torch.Tensor, int, float, bool)):
            value = torch.from_numpy(onp.array(value))
        with torch.no_grad():
            self._data[key] = value

    # -- arithmetic --------------------------------------------------------
    # An array operand goes through the registered broadcast op, as in the
    # JAX package (``_binop``), so the AMP policy's widest-type rule
    # applies; a Python number keeps the array's dtype (the ``_scalar``
    # ops, which no AMP list names).

    def _binop(self, name, torch_fn, other, reverse=False):
        """``name`` (the broadcast op) on an array ``other``; else
        ``torch_fn(self's tensor, other)``, already reversed where the
        operator is."""
        if isinstance(other, (NDArray, torch.Tensor)):
            from .registry import get_op, invoke

            a, b = (other, self) if reverse else (self, other)
            return invoke(get_op(name), (a, b), {})
        return self._apply(torch_fn, self._data, other)

    def __add__(self, other):
        return self._binop("broadcast_add", torch.add, other)

    def __radd__(self, other):
        return self._binop("broadcast_add", torch.add, other, True)

    def __sub__(self, other):
        return self._binop("broadcast_sub", torch.sub, other)

    def __rsub__(self, other):
        return self._binop("broadcast_sub", torch.rsub, other, True)

    def __mul__(self, other):
        return self._binop("broadcast_mul", torch.mul, other)

    def __rmul__(self, other):
        return self._binop("broadcast_mul", torch.mul, other, True)

    def __truediv__(self, other):
        return self._binop("broadcast_div", torch.div, other)

    def __rtruediv__(self, other):
        return self._binop("broadcast_div", torch.Tensor.__rtruediv__, other,
                           True)

    def __neg__(self):
        return self._apply(torch.neg, self._data)

    # -- reductions (the registered ops: AMP keeps them in float32) --------

    def sum(self, axis=None, keepdims=False):
        from .registry import get_op, invoke

        return invoke(get_op("sum"), (self,),
                      {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        from .registry import get_op, invoke

        return invoke(get_op("mean"), (self,),
                      {"axis": axis, "keepdims": keepdims})

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
    return NDArray(host_tensor(source_array, dtype).to(dev, copy=True))


def host_tensor(source_array, dtype=None):
    """A CPU tensor of an array-like (it may alias a numpy source): the
    dtype is ``dtype`` if given, else the source's, float64 narrowed to
    float32; ``ml_dtypes`` bfloat16 arrays (the JAX package's) carried
    bit for bit through an int16 view."""
    arr = onp.ascontiguousarray(onp.asarray(source_array))
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(onp.int16)).view(torch.bfloat16)
    elif dtype is not None and torch_dtype(dtype) == torch.bfloat16:
        t = torch.from_numpy(arr.astype(onp.float32, copy=False))
    elif dtype is not None:
        t = torch.from_numpy(arr.astype(_numpy_dtype(dtype), copy=False))
    elif arr.dtype == onp.float64:
        t = torch.from_numpy(arr.astype(onp.float32))
    else:
        t = torch.from_numpy(arr)
    return t if dtype is None else t.to(torch_dtype(dtype))


def zeros(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)))


def ones(shape, ctx=None, dtype="float32"):
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.ones(tuple(shape), dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


def arange(start, stop=None, step=1.0, ctx=None, dtype="float32"):
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                                device=resolve_device(ctx)))


def expand_dims(data, axis):
    return NDArray(data.data.unsqueeze(axis))


def concatenate(arrays, axis=0):
    """Join NDArrays along ``axis`` (reference: ndarray.py concatenate)."""
    with autograd._grad_mode():
        return NDArray(torch.cat([a.data for a in arrays], dim=axis))


# -- serialization ----------------------------------------------------------
# The reference's binary .params format (src/ndarray/ndarray.cc:1596-1860),
# as the JAX package writes and reads it (``ndarray.py:723-921``): uint64
# 0x112 list magic, uint64 reserved, uint64 count; per array uint32 V2
# magic, int32 storage type 0, int32 ndim then int64 dims, int32 dev_type
# and dev_id (cpu 0), int32 mshadow type flag, the raw little-endian data;
# then uint64 key count and per key uint64 length and bytes. The same
# dict writes the same bytes from either package.

_LIST_MAGIC = 0x112
_ND_V1_MAGIC = 0xF993FAC8
_ND_V2_MAGIC = 0xF993FAC9
_ND_V3_MAGIC = 0xF993FACA
_TYPE_FLAG_TO_DTYPE = {0: "float32", 1: "float64", 2: "float16",
                       3: "uint8", 4: "int32", 5: "int8", 6: "int64",
                       7: "bool"}
_DTYPE_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_DTYPE.items()}


def _host_array(a):
    """A host numpy array of ``a``, widened to the nearest lossless
    type flag the format has (bfloat16 to float32, as the JAX package
    does)."""
    if isinstance(a, NDArray):
        a = a.data
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.numpy()
    arr = onp.ascontiguousarray(onp.asarray(a))
    if str(arr.dtype) in _DTYPE_TO_TYPE_FLAG:
        return arr
    if arr.dtype.kind == "i" or (arr.dtype.kind == "u"
                                 and arr.dtype.itemsize < 8):
        return arr.astype("int64")
    if arr.dtype.kind == "f" and arr.dtype.itemsize <= 4:
        return arr.astype("float32")
    raise TypeError(f"cannot save dtype {arr.dtype}: no lossless type flag "
                    "in the format")


def save(fname, data):
    """Save an NDArray, a list of them, a dict name -> NDArray or a list
    of (name, NDArray) pairs in the reference's binary format."""
    import struct

    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = [str(k) for k in data], list(data.values())
    elif isinstance(data, (list, tuple)) and data and all(
            isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str)
            for x in data):
        names, arrays = [k for k, _ in data], [v for _, v in data]
    elif isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    else:
        raise TypeError("save expects NDArray, list or dict")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        for a in arrays:
            arr = _host_array(a)
            f.write(struct.pack("<Ii", _ND_V2_MAGIC, 0))
            f.write(struct.pack(f"<i{arr.ndim}q", arr.ndim, *arr.shape))
            f.write(struct.pack("<iii", 1, 0,
                                _DTYPE_TO_TYPE_FLAG[str(arr.dtype)]))
            if arr.dtype.byteorder == ">":
                arr = arr.byteswap().view(arr.dtype.newbyteorder("<"))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(names)))
        for n in names:
            b = n.encode()
            f.write(struct.pack("<Q", len(b)) + b)


def load(fname, ctx=None):
    """Load a file :func:`save` (or the JAX package, or the reference)
    wrote: a dict name -> NDArray, or a list when it holds no names.
    The arrays land on ``ctx`` (default: the current context)."""
    with open(fname, "rb") as f:
        return load_frombuffer(f.read(), ctx=ctx)


def load_frombuffer(buf, ctx=None):
    """:func:`load` from bytes in memory."""
    import struct

    buf = bytes(buf)
    if len(buf) < 8 or struct.unpack_from("<Q", buf)[0] != _LIST_MAGIC:
        raise MXNetError("not an NDArray file in the reference's binary "
                         "format (no 0x112 list magic)")
    dev = resolve_device(ctx)
    off = 16
    (count,) = struct.unpack_from("<Q", buf, off)
    off += 8
    arrays = []
    for _ in range(count):
        (magic,) = struct.unpack_from("<I", buf, off)
        off += 4
        if magic in (_ND_V2_MAGIC, _ND_V3_MAGIC):
            (stype,) = struct.unpack_from("<i", buf, off)
            off += 4
            if stype != 0:
                raise MXNetError("only dense NDArrays can be loaded")
        if magic in (_ND_V1_MAGIC, _ND_V2_MAGIC, _ND_V3_MAGIC):
            (ndim,) = struct.unpack_from("<i", buf, off)
            off += 4
            shape = struct.unpack_from(f"<{ndim}q", buf, off)
            off += 8 * ndim
        else:  # the oldest format: the magic word is the ndim
            ndim = magic
            shape = struct.unpack_from(f"<{ndim}I", buf, off)
            off += 4 * ndim
        off += 8  # the saved context: placement is the caller's
        (flag,) = struct.unpack_from("<i", buf, off)
        off += 4
        dtype = onp.dtype(_TYPE_FLAG_TO_DTYPE[flag])
        n = int(onp.prod(shape)) if ndim else 1
        host = onp.frombuffer(buf, dtype.newbyteorder("<"), n, off)
        off += dtype.itemsize * n
        host = host.reshape(shape).astype(dtype)  # a writable copy
        arrays.append(NDArray(torch.from_numpy(host).to(dev)))
    (nkeys,) = struct.unpack_from("<Q", buf, off)
    off += 8
    names = []
    for _ in range(nkeys):
        (ln,) = struct.unpack_from("<Q", buf, off)
        off += 8
        names.append(buf[off:off + ln].decode())
        off += ln
    if not names:
        return arrays
    return dict(zip(names, arrays))
