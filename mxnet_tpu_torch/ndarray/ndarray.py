"""NDArray over a ``torch.Tensor``.

The PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``: creation
(``array``, ``zeros``, ``ones``, ``full``, ``empty``, ``arange``),
indexing and assignment (basic, advanced, negative steps), MXNet's Python
operators (arithmetic, comparisons, ``%``, ``**``, ``@``, ``abs``, the
scalar conversions and the in-place ``+= -= *= /=``), the fluent methods
that dispatch to the registered ops, host and DLPack transfer, and the
autograd surface (``attach_grad``, ``grad``, ``backward``, ``detach``).
The device is always explicit: creation functions take ``ctx=`` and
default to the current context, which is ``gpu(0)`` unless a scope says
otherwise.

Every method that computes runs with torch's grad mode on only inside
``autograd.record()``, so arithmetic outside it builds no graph.

An in-place operator writes into the handle's own tensor when the
handle owns it (not a view of another array's memory) and the result
keeps its dtype and shape, so every holder of that tensor sees the new
values: a ``Parameter``'s registered leaf, and a captured CUDA graph
that reads its storage. Otherwise the handle rebinds to the result, as
the JAX package's always does: an int32 array ``+= 0.5``, or ``y += 1``
on a ``y`` that ``x.T`` or ``stop_gradient(x)`` made, which leaves ``x``
as it was. Memory is shared as in MXNet, by ``reshape``, basic slices
and ``detach`` only: where a torch op hands back a view of its input
(``T``, ``swapaxes``, ``expand_dims``, ``broadcast_to``, an input passed
through), the array gets a copy (``_own``), so ``y = x.T; x += 1``
leaves ``y`` as it was.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import autograd
from ..base import MXNetError
from ..context import Context, resolve_device
from ..utils import locks as _locks
from . import registry as _reg

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "expand_dims", "moveaxis", "waitall", "from_numpy", "from_dlpack",
           "to_dlpack_for_read", "to_dlpack_for_write", "torch_dtype",
           "save", "load", "load_frombuffer"]

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

    ctx = context

    @property
    def stype(self):
        """The storage type: "default" (dense); ``sparse.CSRNDArray`` and
        ``sparse.RowSparseNDArray`` say "csr" and "row_sparse"."""
        return "default"

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

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        """False for an empty array, the value's truth for one element;
        ambiguous, so a ValueError, for more."""
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

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
        return self

    wait_to_write = wait_to_read

    def asnative(self):
        """The backing ``torch.Tensor`` (the JAX package returns its
        ``jax.Array``)."""
        return self._data

    def as_nd_ndarray(self):
        return self

    def as_np_ndarray(self):
        raise MXNetError("as_np_ndarray: the mx.np front end (numpy/ and "
                         "numpy_extension/, ROADMAP A's slice 11) is not "
                         "ported yet")

    def tostype(self, stype):
        """This array in storage ``stype``: itself for "default", else a
        ``sparse.CSRNDArray`` ("csr") or ``sparse.RowSparseNDArray``
        ("row_sparse") on the same device (``sparse.cast_storage``)."""
        if stype == "default":
            return self
        from . import sparse

        return sparse.cast_storage(self, stype)

    def to_dlpack_for_read(self):
        return to_dlpack_for_read(self)

    to_dlpack_for_write = to_dlpack_for_read

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
        return self._apply(lambda: _own(self._data.permute(*axes),
                                        (self._data,)))

    def astype(self, dtype, copy=True):
        return self._apply(self._data.to, torch_dtype(dtype), copy=copy)

    def squeeze(self, axis=None):
        """Drop size-1 axes, all or ``axis``."""
        args = () if axis is None else (axis,)
        return self._apply(lambda: _own(self._data.squeeze(*args),
                                        (self._data,)))

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
        """numpy indexing: ints, slices (negative steps too), ``None``,
        ``...``, and index arrays (NDArrays, lists, numpy arrays; float
        ones are taken as integers). Basic keys give a view, as in
        numpy; a key with an index array or a negative step gives a
        copy."""
        return _invoke1("_slice_take", self,
                        key=_index_key(key, self._data.device))

    def __setitem__(self, key, value):
        """Write ``value`` (an NDArray, tensor, number or array-like) into
        the region ``key`` selects (the keys of :meth:`__getitem__`), in
        place and outside any recorded graph, as ``CustomOp.assign`` does
        (``dst[:] = src``): an index array goes through ``index_put_``;
        a negative step writes through a flipped copy."""
        key = _index_key(key, self._data.device)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, (torch.Tensor, int, float, bool)):
            value = torch.from_numpy(onp.array(value))
        items = key if isinstance(key, tuple) else (key,)
        flips = _negative_steps(items, self._data.dim())
        with torch.no_grad():
            if not flips:
                self._data[key] = value
                return
            # torch slices take only positive steps: the reversed axes
            # flipped (a copy), written ascending, and copied back
            axes = [ax for _, ax in flips]
            rev = self._data.flip(axes)
            rev[_flipped_key(items, self._data.shape, flips)] = value
            self._data.copy_(rev.flip(axes))

    # -- operators ---------------------------------------------------------
    # Through the registered ops, as in the JAX package (``_binop``): an
    # array operand takes the broadcast op, so the AMP policy's
    # widest-type rule applies; a Python number takes the ``_scalar`` op,
    # which keeps a float array's dtype; a numpy array or a list becomes
    # an array of this one's dtype. Comparisons return 0/1 in the input's
    # dtype.

    def _binop(self, name, other, reverse=False):
        if isinstance(other, (NDArray, torch.Tensor)):
            a, b = (other, self) if reverse else (self, other)
            return _invoke1(name, a, b)
        if isinstance(other, (int, float, bool, onp.number)):
            if isinstance(other, onp.number):
                other = other.item()
            return _invoke1(name + "_scalar", self, scalar=other,
                            reverse=reverse)
        if isinstance(other, (onp.ndarray, list, tuple)):
            other = array(other, ctx=self.context, dtype=self._data.dtype)
            a, b = (other, self) if reverse else (self, other)
            return _invoke1(name, a, b)
        return NotImplemented

    def __add__(self, o): return self._binop("broadcast_add", o)
    def __radd__(self, o): return self._binop("broadcast_add", o, True)
    def __sub__(self, o): return self._binop("broadcast_sub", o)
    def __rsub__(self, o): return self._binop("broadcast_sub", o, True)
    def __mul__(self, o): return self._binop("broadcast_mul", o)
    def __rmul__(self, o): return self._binop("broadcast_mul", o, True)
    def __truediv__(self, o): return self._binop("broadcast_div", o)
    def __rtruediv__(self, o): return self._binop("broadcast_div", o, True)
    def __mod__(self, o): return self._binop("broadcast_mod", o)
    def __rmod__(self, o): return self._binop("broadcast_mod", o, True)
    def __pow__(self, o): return self._binop("broadcast_power", o)
    def __rpow__(self, o): return self._binop("broadcast_power", o, True)

    def __matmul__(self, o):
        if not isinstance(o, (NDArray, torch.Tensor)):
            return NotImplemented
        return _invoke1("_matmul", self, o)

    def __neg__(self): return _invoke1("negative", self)
    def __abs__(self): return _invoke1("abs", self)

    def __eq__(self, o): return self._binop("broadcast_equal", o)
    def __ne__(self, o): return self._binop("broadcast_not_equal", o)
    def __lt__(self, o): return self._binop("broadcast_lesser", o)
    def __le__(self, o): return self._binop("broadcast_lesser_equal", o)
    def __gt__(self, o): return self._binop("broadcast_greater", o)
    def __ge__(self, o): return self._binop("broadcast_greater_equal", o)

    def __hash__(self):
        return id(self)

    # In place: raises while recording, as the JAX package and the
    # reference do (the tape cannot alias a mutated output). Outside it
    # the result goes into the handle's own tensor when the handle owns
    # it and the result keeps the dtype and the shape (the module
    # docstring says why); else the handle rebinds, as the JAX
    # package's always does.

    def _inplace(self, opname, o):
        if autograd.is_recording():
            raise MXNetError(
                "Inplace operations (+=, -=, *=, /=) are not supported "
                "when recording with autograd")
        r = self._binop(opname, o)
        if r is NotImplemented:
            return r
        t = self._data
        if r._data.dtype == t.dtype and r._data.shape == t.shape and \
                _owns(t):
            with torch.no_grad():
                t.copy_(r._data)
        else:
            self._data = r._data
        return self

    def __iadd__(self, o): return self._inplace("broadcast_add", o)
    def __isub__(self, o): return self._inplace("broadcast_sub", o)
    def __imul__(self, o): return self._inplace("broadcast_mul", o)
    def __itruediv__(self, o): return self._inplace("broadcast_div", o)

    # -- fluent methods (the registered ops) ---------------------------------

    @property
    def T(self):
        return _invoke1("transpose", self)

    def reshape_like(self, other):
        return _invoke1("reshape", self, shape=other.shape)

    def flatten(self):
        return _invoke1("flatten", self)

    def swapaxes(self, dim1, dim2):
        return _invoke1("swapaxes", self, dim1=dim1, dim2=dim2)

    def expand_dims(self, axis):
        return _invoke1("expand_dims", self, axis=axis)

    def broadcast_to(self, shape):
        return _invoke1("broadcast_to", self, shape=shape)

    def broadcast_like(self, other):
        return _invoke1("broadcast_to", self, shape=other.shape)

    def slice_axis(self, axis, begin, end):
        return _invoke1("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _invoke1("take", self, indices, axis=axis, mode=mode)

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return _invoke1("one_hot", self, depth=depth, on_value=on_value,
                        off_value=off_value, dtype=dtype)

    def sum(self, axis=None, keepdims=False, exclude=False):
        return _invoke1("sum", self, axis=axis, keepdims=keepdims,
                        exclude=exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return _invoke1("mean", self, axis=axis, keepdims=keepdims,
                        exclude=exclude)

    def max(self, axis=None, keepdims=False):
        return _invoke1("max", self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _invoke1("min", self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return _invoke1("prod", self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None):
        return _invoke1("argmax", self, axis=axis)

    def argmin(self, axis=None):
        return _invoke1("argmin", self, axis=axis)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke1("norm", self, ord=ord, axis=axis, keepdims=keepdims)

    def clip(self, a_min=None, a_max=None):
        return _invoke1("clip", self, a_min=a_min, a_max=a_max)

    def __repr__(self):
        return f"\n{self.asnumpy()!r}\n<NDArray {self.shape} @{self.context}>"


# fluent methods generated from the registry, the JAX package's list
# (``ndarray.py:411-423``; reference: ndarray.py's fluent-method autogen)
def _install_methods(names):
    for name in names:
        if hasattr(NDArray, name):
            continue

        def method(self, *args, _name=name, **kwargs):
            return _invoke1(_name, self, *args, **kwargs)

        method.__name__ = name
        setattr(NDArray, name, method)


_install_methods((
    "abs", "exp", "expm1", "log", "log1p", "log10", "log2",
    "sqrt", "rsqrt", "square", "cbrt", "rcbrt", "reciprocal",
    "sign", "round", "rint", "ceil", "floor", "trunc", "fix",
    "relu", "sigmoid", "tanh", "softmax", "log_softmax", "sin",
    "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
    "arcsinh", "arccosh", "arctanh", "degrees", "radians",
    "erf", "erfinv", "gamma", "gammaln",
    "argmax_channel", "argsort", "broadcast_axes", "depth_to_space",
    "diag", "flip", "nanprod", "nansum", "pad", "pick", "repeat",
    "shape_array", "size_array", "slice", "slice_like", "softmin",
    "sort", "space_to_depth", "split", "split_v2", "tile", "topk",
    "ones_like", "zeros_like"))


def _invoke1(opname, *args, **kwargs):
    opdef = _reg.get_op(opname)
    if opdef is None:
        raise MXNetError(f"op '{opname}' not registered")
    return _reg.invoke(opdef, args, kwargs)


def repeat_each(t, repeats, dim=None):
    """Each element of ``t`` ``repeats`` times in a row along ``dim`` (of
    the flattened tensor for None): an expanded view, copied once.
    ``repeat_interleave`` may size its output on the host, which a CUDA
    graph capture cannot wait for."""
    if dim is None:
        t, dim = t.reshape(-1), 0
    dim = dim % t.dim()
    shape = list(t.shape)
    x = t.unsqueeze(dim + 1).expand(shape[:dim + 1] + [repeats]
                                    + shape[dim + 1:])
    shape[dim] *= repeats
    return x.reshape(shape)


def _owns(t):
    """Whether an in-place write may go into ``t``: not a view of another
    tensor's memory, not a broadcast (several elements in one memory
    location), and not a tensor made in inference mode, outside it."""
    return t._base is None \
        and not any(st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)) \
        and not (t.is_inference() and not torch.is_inference_mode_enabled())


# -- results that are arrays of their own ----------------------------------
# MXNet shares memory between arrays only through ``reshape``, basic
# slices and ``detach``; any op's result is an array of its own. Where a
# torch op hands back a view of its input, the result is copied, row-major
# as MXNet's arrays are (so that a ``reshape`` of it shares its memory).

def _own(r, inputs):
    """``r``, or a row-major copy of it (recorded, as any op is) where it
    shares memory with one of the tensors ``inputs``."""
    if not isinstance(r, torch.Tensor) or r.layout != torch.strided or \
            r.device.type == "meta" or r.numel() == 0:
        return r
    ptr = None
    for a in inputs:
        if isinstance(a, torch.Tensor) and a.device == r.device:
            if ptr is None:
                ptr = r.untyped_storage().data_ptr()
            if a.untyped_storage().data_ptr() == ptr:
                return r.clone(memory_format=torch.contiguous_format)
    return r


# -- indexing -----------------------------------------------------------------

def _index_item(k, device):
    if isinstance(k, NDArray):
        k = k._data
    elif isinstance(k, (list, onp.ndarray)):
        k = torch.as_tensor(onp.asarray(k))
    elif isinstance(k, onp.integer):
        return int(k)
    if isinstance(k, torch.Tensor):
        # float index arrays (MXNet's default dtype) index as integers
        if k.dtype != torch.bool:
            k = k.to(torch.int64)
        return k.to(device)
    return k


def _index_key(key, device):
    """``key`` with every index array (NDArray, list, numpy array) as an
    int64 (or bool) tensor on ``device``."""
    if isinstance(key, tuple):
        return tuple(_index_item(k, device) for k in key)
    return _index_item(key, device)


def _width(k):
    """How many data axes a key item indexes."""
    if k is None or k is Ellipsis:
        return 0
    if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
        return k.dim()
    return 1


def _negative_steps(items, ndim):
    """``[(item position, data axis)]`` of the slices with a negative
    step."""
    used = sum(_width(k) for k in items)
    out, ax = [], 0
    for i, k in enumerate(items):
        if k is Ellipsis:
            ax += ndim - used
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            out.append((i, ax))
        ax += _width(k)
    return out


def _flipped_key(items, shape, neg):
    """``items`` for the data flipped along the reversed axes: each
    negative-step slice becomes the positive-step slice that takes the
    same elements in the same order from the flipped axis."""
    items = list(items)
    for i, ax in neg:
        n = shape[ax]
        r = range(*items[i].indices(n))
        items[i] = slice(n - 1 - r[0], n - r[-1], -items[i].step) if r \
            else slice(0, 0)
    return tuple(items)


def slice_key(data, key):
    """``data[key]`` for numpy keys, negative steps too: torch slices take
    only positive steps, so each reversed axis is flipped first and
    sliced ascending (a copy, where a positive step gives a view)."""
    items = key if isinstance(key, tuple) else (key,)
    neg = _negative_steps(items, data.dim())
    if not neg:
        return data[key]
    return data.flip([ax for _, ax in neg])[
        _flipped_key(items, data.shape, neg)]


def array(source_array, ctx=None, dtype=None):
    """An NDArray copy of ``source_array`` on ``ctx``. The dtype is
    ``dtype`` if given, else the source's, with float64 (and Python
    lists of floats) narrowed to float32 as in MXNet."""
    if getattr(ctx, "device_type", None) == "cpu_shared":
        return _shared_array(source_array, dtype)
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


def _shared_array(source_array, dtype):
    """``array(..., ctx=Context("cpu_shared"))``: a copy in shared memory
    (``shared_mem.to_shared``), with the JAX package's dtype rules: the
    source's dtype, float64 narrowed to float32, for arrays; float32 for
    Python lists and scalars."""
    from .shared_mem import to_shared

    if isinstance(source_array, NDArray):
        t = source_array.data.detach().cpu()
    elif isinstance(source_array, torch.Tensor):
        t = source_array.detach().cpu()
    elif isinstance(source_array, onp.ndarray):
        t = host_tensor(source_array)
    else:
        t = torch.from_numpy(onp.asarray(source_array, dtype=onp.float32))
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    elif t.dtype == torch.float64:
        t = t.to(torch.float32)
    return to_shared(t)


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


def empty(shape, ctx=None, dtype="float32"):
    """An uninitialized array (reference: ndarray.py empty)."""
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                               device=resolve_device(ctx)))


def full(shape, val, ctx=None, dtype="float32"):
    """An array of ``shape`` filled with ``val``."""
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.full(tuple(shape), val, dtype=torch_dtype(dtype),
                              device=resolve_device(ctx)))


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


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """``[start, stop)`` by ``step``, each value ``repeat`` times in a
    row."""
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=resolve_device(ctx))
    if repeat != 1:
        t = repeat_each(t, int(repeat))
    return NDArray(t)


def expand_dims(data, axis):
    with autograd._grad_mode():
        return NDArray(_own(data.data.unsqueeze(axis), (data.data,)))


def moveaxis(data, source, destination):
    """``data`` with axis ``source`` moved to ``destination``."""
    with autograd._grad_mode():
        return NDArray(_own(torch.movedim(data.data, source, destination),
                            (data.data,)))


def waitall():
    """Block until every engine op and every device's queued work is
    done (reference: Engine::WaitForAll): the engine's ``wait_all``
    first (its ops may queue work on the card), then the card's
    synchronize."""
    from .. import engine

    engine.wait_all()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def to_dlpack_for_read(data):
    """A DLPack capsule over ``data``'s memory, once its pending writes
    are done (reference: ndarray.py to_dlpack_for_read). It is also
    ``to_dlpack_for_write``: a consumer's writes land in ``data``, as in
    the reference (the JAX package hands out a copy, its buffers being
    immutable)."""
    data.wait_to_read()
    return torch.utils.dlpack.to_dlpack(data.data.detach())


to_dlpack_for_write = to_dlpack_for_read


def from_dlpack(obj):
    """An NDArray over an external DLPack tensor, without a copy: an
    object with ``__dlpack__`` (a torch tensor, a numpy array) or a
    capsule (reference: ndarray.py from_dlpack)."""
    return NDArray(torch.utils.dlpack.from_dlpack(obj))


def from_numpy(ndarray, zero_copy=True):
    """A CPU NDArray over ``ndarray``'s memory (``zero_copy``), which is
    marked read-only, as the reference marks it, so the host cannot
    change what the array holds; else (or where it cannot be shared) a
    copy on the CPU."""
    arr = onp.ascontiguousarray(ndarray)
    if not zero_copy or not arr.flags.writeable or \
            arr.dtype.name not in _TORCH_DTYPES:
        return array(arr, ctx=Context("cpu"))
    t = torch.from_numpy(arr)
    if arr is ndarray:
        arr.flags.writeable = False
    return NDArray(t)


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
    if getattr(a, "stype", "default") != "default":
        a = a.todense()  # a sparse array is saved dense, as the JAX one
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
    of (name, NDArray) pairs in the reference's binary format.

    The file write is an op of the dependency engine on its IO lane
    (reference: MXNDArraySave orders through the engine), pushed with a
    var of its own and waited for, so a write failure raises here and
    ``MXNET_ENGINE_TYPE=NaiveEngine`` writes inline. The arrays are
    copied to the host before the push: the op touches no device."""
    from .. import engine

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
    host = [_host_array(a) for a in arrays]
    eng = engine.get()
    # vars come from a free list, so the engine's var table stays bounded
    # at peak save concurrency; concurrent saves get distinct vars
    v = None
    with _SAVE_POOL_LOCK:
        while _SAVE_POOL:
            e, cand = _SAVE_POOL.pop()
            if e is eng:  # vars of a replaced engine mean nothing here
                v = cand
                break
    if v is None:
        v = eng.new_variable()
    eng.push(lambda: _write_ref_params(fname, names, host),
             mutable_vars=(v,), lane=engine.LANE_IO)
    eng.wait_for_var(v)  # a failure leaves the poisoned var unpooled
    with _SAVE_POOL_LOCK:
        _SAVE_POOL.append((eng, v))


# guards: _SAVE_POOL
_SAVE_POOL_LOCK = _locks.RankedLock("ndarray.save_pool")
_SAVE_POOL = []


def _write_ref_params(fname, names, arrays):
    import struct

    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays)))
        for arr in arrays:
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
