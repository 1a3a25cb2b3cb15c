"""Sparse NDArrays: ``row_sparse`` and ``csr`` storage over torch tensors.

The PyTorch counterpart of ``mxnet_tpu/ndarray/sparse.py`` (reference:
include/mxnet/ndarray.h:61-82 NDArrayStorageType, python/mxnet/ndarray/
sparse.py, src/operator/tensor/dot-inl.h, cast_storage-inl.h,
sparse_retain-inl.h). Each format is a pair of dense tensors on one
device, an index array and a values array, as in the JAX package:
``_data`` holds the values, so code that reads an array's dtype and
device keeps working, and the logical shape is kept apart.

The index arrays are int32, the values' dtype the JAX package's (its
arrays run without x64, so float64 values narrow to float32 and int64
to int32); ``CSRNDArray.from_host`` keeps 64-bit ids and values on the
CPU, for the DGL ops' id payloads.

The operations are plain tensor code on the arrays' device:

- ``dot(csr, dense)`` gathers the rows of ``rhs`` each stored value
  multiplies and sums them per row with ``index_add_``;
  ``dot(csr, dense, transpose_a=True)`` scatters the products into the
  columns' rows. On CUDA the sums are atomic adds, so their order, and
  the last bits of a sum, vary from run to run. Every other combination
  densifies, as the JAX package does;
- ``cast_storage`` from dense finds the stored rows or entries with
  ``torch.nonzero``, which reads its count back to the host: it cannot
  run inside a CUDA graph capture and raises there, as the JAX one
  raises under ``jit``;
- ``retain`` finds each requested row by a stable sort of the stored
  rows and ``searchsorted`` (the first stored match, zeros for a row
  not stored); the JAX one compares every id with every stored row;
- ``elemwise_add`` of two ``row_sparse`` arrays merges duplicate rows
  with ``torch.unique`` (sorted) and ``index_add_``;
- the lazy optimizer updates touch only the stored rows, in place.

Nothing here records on the autograd tape: the JAX package's sparse
functions are not registered ops either.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device
from .ndarray import NDArray, array as _dense_array, torch_dtype

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "dot",
           "retain", "zeros", "array", "add", "elemwise_add",
           "sgd_update_rsp", "adam_update_rsp", "group_adagrad_update_rsp"]

# the JAX package's arrays run without x64: 64-bit values narrow
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _values(data, device, dtype=None):
    """A values tensor on ``device`` from a tensor, an NDArray or an
    array-like, in the dtype the JAX package gives it."""
    if isinstance(data, NDArray):
        data = data._data
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(onp.array(data))  # a writable copy
    t = data.detach()
    if dtype is not None:
        t = t.to(torch_dtype(dtype))
    return t.to(device=device, dtype=_NARROW.get(t.dtype, t.dtype))


def _index(idx, device, dtype=torch.int32):
    """An index tensor (``dtype``) on ``device`` from a tensor, an NDArray
    or an array-like; float ids are truncated, as a cast does."""
    if isinstance(idx, NDArray):
        idx = idx._data
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(onp.array(idx))
    return idx.detach().to(device=device, dtype=dtype)


class BaseSparseNDArray(NDArray):
    """What both formats share (reference: sparse.py
    BaseSparseNDArray). ``_data`` holds the values; the logical shape
    is ``_sshape``."""

    __slots__ = ("_sshape",)

    @property
    def shape(self):
        return self._sshape

    @property
    def size(self):
        s = 1
        for d in self._sshape:
            s *= d
        return s

    @property
    def ndim(self):
        return len(self._sshape)

    def __len__(self):
        return self._sshape[0]

    def asnumpy(self):
        return self.todense().asnumpy()

    def asscalar(self):
        return self.todense().asscalar()

    def __repr__(self):
        return f"\n<{type(self).__name__} {self.shape} nnz={self.nnz} " \
               f"@{self.context}>"

    def __getitem__(self, key):
        raise MXNetError(f"indexing not supported on {self.stype}")

    def __setitem__(self, key, value):
        raise MXNetError(f"__setitem__ not supported on {self.stype}")

    def _binop(self, name, other, reverse=False):
        if other is None:
            return NotImplemented
        raise MXNetError(
            f"operation not supported on stype={self.stype}; call "
            ".tostype('default') first, or use nd.sparse.elemwise_add "
            "(reference: storage fallback, src/executor/"
            "attach_op_execs_pass.cc)")

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self, stype)

    def copyto(self, other):
        """Into a dense NDArray: the dense values, written in place; to a
        Context: a copy of this array there."""
        if isinstance(other, NDArray) and not isinstance(
                other, BaseSparseNDArray):
            return self.todense().copyto(other)
        from ..context import Context

        if isinstance(other, Context):
            return self.as_in_context(other)
        raise TypeError(f"copyto does not support type {type(other)}")

    def _parts(self):
        """The tensors of the format, values first."""
        raise NotImplementedError

    def _rebuild(self, parts):
        raise NotImplementedError

    def copy(self):
        """A deep copy in the same format (the dense ``copy`` would copy
        the values alone)."""
        return self._rebuild([t.clone() for t in self._parts()])

    def as_in_context(self, ctx):
        """This array on ``ctx``: itself if it is there already, else a
        copy in the same format."""
        from ..context import host_to_device

        dev = resolve_device(ctx)
        if self._data.device == dev:
            return self
        return self._rebuild([host_to_device(t, dev)
                              for t in self._parts()])

    as_in_ctx = as_in_context

    def astype(self, dtype, copy=True):
        """The same format with the values cast to ``dtype``."""
        parts = self._parts()
        vals = parts[0].to(torch_dtype(dtype), copy=copy)
        return self._rebuild([vals] + parts[1:])


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse rows (reference: sparse.py CSRNDArray; aux data
    ndarray.h:82 kIndPtr/kIdx): ``data`` the stored values in row-major
    order, ``indices`` their columns, ``indptr`` each row's first
    position (m + 1 entries). The index arrays sit on the values'
    device."""

    __slots__ = ("_indices", "_indptr")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        dev = _device_of(ctx, data)
        super().__init__(_values(data, dev))
        self._indices = _index(indices, dev)
        self._indptr = _index(indptr, dev)
        self._sshape = tuple(int(s) for s in shape)
        if len(self._sshape) != 2:
            raise ValueError("CSRNDArray must be 2-D")

    @property
    def stype(self):
        return "csr"

    @classmethod
    def from_host(cls, data, indices, indptr, shape):
        """A CSR on the CPU keeping 64-bit values and int64 ids (the DGL
        ops' edge-id payloads, exact past 2**24)."""
        return _HostCSRNDArray(data, indices, indptr, shape)

    @property
    def data(self):
        """The stored values (reference: csr.data)."""
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def indptr(self):
        return NDArray(self._indptr)

    @property
    def nnz(self):
        return int(self._indices.shape[0])

    def _parts(self):
        return [self._data, self._indices, self._indptr]

    def _rebuild(self, parts):
        return CSRNDArray(parts[0], parts[1], parts[2], self._sshape)

    def _row_ids(self):
        """Each stored value's row (int64), without a host read."""
        return _csr_row_ids(self._indptr, self.nnz)

    def todense(self):
        m, n = self._sshape
        with torch.no_grad():
            out = torch.zeros((m, n), dtype=self._data.dtype,
                              device=self._data.device)
            if self.nnz:
                # duplicate (row, column) entries add, as the JAX
                # package's scatter-add densify does
                out.index_put_((self._row_ids(), self._indices.long()),
                               self._data, accumulate=True)
        return NDArray(out)

    def slice(self, begin, end):
        """Rows ``begin:end`` as a CSR (reference: csr slicing keeps csr
        storage), through the dense rows as the JAX package does."""
        return cast_storage(NDArray(self.todense().data[begin:end]), "csr")

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.slice(key.start or 0, key.stop or self._sshape[0])
        if isinstance(key, int):
            return NDArray(self.todense().data[key].clone())
        raise MXNetError("csr supports int/slice row indexing only")


class _HostCSRNDArray(CSRNDArray):
    """``CSRNDArray.from_host``'s class: CPU tensors, the values in
    their own dtype (float64 edge ids stay float64), int64 ids."""

    __slots__ = ()

    def __init__(self, data, indices, indptr, shape):
        cpu = torch.device("cpu")
        if isinstance(data, NDArray):
            data = data.data
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(onp.ascontiguousarray(
                onp.asarray(data)))
        NDArray.__init__(self, data.detach().to(cpu))
        self._indices = _index(indices, cpu, torch.int64)
        self._indptr = _index(indptr, cpu, torch.int64)
        self._sshape = tuple(int(s) for s in shape)
        if len(self._sshape) != 2:
            raise ValueError("CSRNDArray must be 2-D")

    def _rebuild(self, parts):
        # on the CPU it stays id-exact; elsewhere an ordinary CSR
        cls = _HostCSRNDArray if parts[0].device.type == "cpu" \
            else CSRNDArray
        return cls(parts[0], parts[1], parts[2], self._sshape)

    def slice(self, begin, end):
        """Rows ``begin:end`` straight from ``indptr`` (exact ids)."""
        m = self._sshape[0]
        b, e = int(begin), int(end)
        b = b + m if b < 0 else b
        e = e + m if e < 0 else e
        b = max(0, min(b, m))
        e = max(b, min(e, m))
        lo, hi = int(self._indptr[b]), int(self._indptr[e])
        return _HostCSRNDArray(self._data[lo:hi].clone(),
                               self._indices[lo:hi],
                               self._indptr[b:e + 1] - self._indptr[b],
                               (e - b, self._sshape[1]))


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse tensor: ``data[i]`` is the slice at row ``indices[i]``
    (reference: sparse.py RowSparseNDArray, ndarray.h
    kRowSparseStorage). The storage type of sparse gradients: the store's
    sparse push and the lazy optimizer updates."""

    __slots__ = ("_indices",)

    def __init__(self, data, indices, shape, ctx=None):
        dev = _device_of(ctx, data)
        super().__init__(_values(data, dev))
        self._indices = _index(indices, dev)
        self._sshape = tuple(int(s) for s in shape)

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        return NDArray(self._data)

    @property
    def indices(self):
        return NDArray(self._indices)

    @property
    def nnz(self):
        return int(self._indices.shape[0])

    def _parts(self):
        return [self._data, self._indices]

    def _rebuild(self, parts):
        return RowSparseNDArray(parts[0], parts[1], self._sshape)

    def todense(self):
        with torch.no_grad():
            out = torch.zeros(self._sshape, dtype=self._data.dtype,
                              device=self._data.device)
            if self.nnz:
                out.index_add_(0, self._indices, self._data)
        return NDArray(out)

    def retain(self, row_ids):
        return retain(self, row_ids)

    def __getitem__(self, key):
        if isinstance(key, int):
            return NDArray(self.todense().data[key].clone())
        raise MXNetError("row_sparse supports int row indexing only")


# -- helpers ------------------------------------------------------------------

def _csr_row_ids(indptr, nnz):
    """Each stored value's row from ``indptr`` (int64), by a search, so
    nothing is read back to the host."""
    ids = torch.arange(nnz, device=indptr.device)
    return torch.searchsorted(indptr[1:].long(), ids, right=True)


def _no_capture(what):
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise MXNetError(f"{what} discovers nnz (a size read back to the "
                         "host) and cannot run inside a CUDA graph capture")


def _device_of(ctx, *arrays):
    """``ctx``'s device, else the first array's, else the current
    context's."""
    if ctx is None:
        for a in arrays:
            if isinstance(a, NDArray):
                return a._data.device
            if isinstance(a, torch.Tensor):
                return a.device
    return resolve_device(ctx)


# -- creation -----------------------------------------------------------------

def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray (reference: sparse.py csr_matrix) from ``(data,
    indices, indptr)`` and ``shape``, or from a dense array-like, on
    ``ctx`` (default: the values' device, else the current context)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            raise ValueError("shape required with (data, indices, indptr)")
        dev = _device_of(ctx, data)
        return CSRNDArray(_values(data, dev, dtype), indices, indptr, shape)
    dense = arg1 if isinstance(arg1, NDArray) else _dense_array(
        arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "csr")


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray (reference: sparse.py row_sparse_array) from
    ``(data, indices)`` and ``shape``, or from a dense array-like."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if shape is None:
            raise ValueError("shape required with (data, indices)")
        dev = _device_of(ctx, data)
        return RowSparseNDArray(_values(data, dev, dtype), indices, shape)
    dense = arg1 if isinstance(arg1, NDArray) else _dense_array(
        arg1, ctx=ctx, dtype=dtype)
    return cast_storage(dense, "row_sparse")


def zeros(stype, shape, ctx=None, dtype="float32"):
    """An empty array of ``stype`` (nothing stored), or a dense zeros."""
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(shape)
    dev = resolve_device(ctx)
    dt = torch_dtype(dtype or "float32")
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros((0,) + shape[1:], dtype=dt, device=dev),
            torch.zeros((0,), dtype=torch.int32, device=dev), shape)
    from .ndarray import zeros as _dzeros

    return _dzeros(shape, ctx, dtype)


def array(source_array, ctx=None, dtype=None):
    """``mx.nd.sparse.array``: a sparse array as it is, anything else a
    dense copy."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array
    return _dense_array(source_array, ctx, dtype)


# -- conversion ---------------------------------------------------------------

def cast_storage(arr, stype):
    """Convert between storage types (reference:
    src/operator/tensor/cast_storage-inl.h). Dense to sparse finds the
    stored rows (``row_sparse``: every row with a non-zero) or entries
    (``csr``: row-major) on the array's device; sparse to dense is a
    scatter."""
    if isinstance(arr, BaseSparseNDArray):
        if stype == "default":
            return arr.todense()
        if stype == arr.stype:
            return arr
        return cast_storage(arr.todense(), stype)
    if stype == "default":
        return arr
    t = arr.data.detach()
    if stype == "row_sparse":
        if t.dim() < 1:
            raise ValueError("row_sparse needs ndim >= 1")
        _no_capture("cast_storage to row_sparse")
        with torch.no_grad():
            nz = (t.reshape(t.shape[0], -1) != 0).any(dim=1)
            rows = torch.nonzero(nz).reshape(-1)
            return RowSparseNDArray(t.index_select(0, rows), rows,
                                    tuple(t.shape))
    if stype == "csr":
        if t.dim() != 2:
            raise ValueError("csr needs a 2-D array")
        _no_capture("cast_storage to csr")
        with torch.no_grad():
            rows, cols = torch.nonzero(t, as_tuple=True)
            indptr = torch.zeros(t.shape[0] + 1, dtype=torch.int64,
                                 device=t.device)
            torch.cumsum(torch.bincount(rows, minlength=t.shape[0]), 0,
                         out=indptr[1:])
            return CSRNDArray(t[rows, cols], cols, indptr, tuple(t.shape))
    raise ValueError(f"unknown stype {stype}")


# -- ops ----------------------------------------------------------------------

def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (reference: src/operator/tensor/dot-inl.h):
    ``csr x dense`` a gather and a per-row sum, ``csr.T x dense`` a
    scatter into the columns' rows; every other combination densifies,
    as the reference's storage fallback does."""
    with torch.no_grad():
        if isinstance(lhs, CSRNDArray) and not isinstance(
                rhs, BaseSparseNDArray):
            m, k = lhs.shape
            rhs_d = rhs.data.t() if transpose_b else rhs.data
            vals = lhs._data.unsqueeze(1)
            if transpose_a:
                prod = vals * rhs_d.index_select(0, lhs._row_ids())
                out = torch.zeros((k,) + tuple(prod.shape[1:]),
                                  dtype=prod.dtype, device=prod.device)
                return NDArray(out.index_add_(0, lhs._indices, prod))
            prod = vals * rhs_d.index_select(0, lhs._indices)  # [nnz, n]
            out = torch.zeros((m,) + tuple(prod.shape[1:]), dtype=prod.dtype,
                              device=prod.device)
            return NDArray(out.index_add_(0, lhs._row_ids(), prod))
        ld = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
        rd = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
        a = ld.data.t() if transpose_a else ld.data
        b = rd.data.t() if transpose_b else rd.data
        return NDArray(torch.matmul(a, b))


def retain(rsp, row_ids):
    """Only the rows ``row_ids`` of ``rsp``, in that order (reference:
    _retain, src/operator/tensor/sparse_retain-inl.h): the first stored
    match of each id, zeros for an id not stored. The building block of
    the store's ``row_sparse_pull``."""
    if not isinstance(rsp, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    vals = rsp._data
    rid = _index(row_ids, vals.device)
    with torch.no_grad():
        if rsp.nnz == 0:
            return RowSparseNDArray(
                torch.zeros((int(rid.shape[0]),) + tuple(vals.shape[1:]),
                            dtype=vals.dtype, device=vals.device),
                rid, rsp.shape)
        stored, order = torch.sort(rsp._indices, stable=True)
        pos = torch.searchsorted(stored, rid).clamp_(max=rsp.nnz - 1)
        found = stored[pos] == rid
        got = vals.index_select(0, order[pos])
        keep = found.reshape((-1,) + (1,) * (vals.dim() - 1))
        got = torch.where(keep, got, torch.zeros((), dtype=vals.dtype,
                                                 device=vals.device))
    return RowSparseNDArray(got, rid, rsp.shape)


def elemwise_add(lhs, rhs):
    """``row_sparse + row_sparse`` stays row-sparse, its duplicate rows
    merged (sorted, unique: what the lazy updates need); any other pair
    densifies (reference: kFComputeFallback)."""
    with torch.no_grad():
        if isinstance(lhs, RowSparseNDArray) and isinstance(
                rhs, RowSparseNDArray):
            idx = torch.cat([lhs._indices, rhs._indices.to(lhs._data.device)])
            vals = torch.cat([lhs._data, rhs._data.to(lhs._data.device)])
            uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
            merged = torch.zeros((uniq.shape[0],) + tuple(vals.shape[1:]),
                                 dtype=vals.dtype, device=vals.device)
            merged.index_add_(0, inv, vals)
            return RowSparseNDArray(merged, uniq, lhs.shape)
        ld = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
        rd = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
        return NDArray(ld.data + rd.data)


add = elemwise_add


# -- lazy optimizer rows ------------------------------------------------------
# Each touches only the gradient's stored rows and writes the weight and
# state tensors in place (the port's optimizers update in place); the rows
# must be unique, as ``cast_storage`` and ``elemwise_add`` make them.

def _grad_rows(grad_rsp, rescale_grad, clip_gradient):
    g = grad_rsp._data * rescale_grad
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return grad_rsp._indices.long(), g


def sgd_update_rsp(weight, grad_rsp, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=None):
    """Lazy SGD (reference: SGDUpdateRspImpl,
    src/operator/optimizer_op-inl.h): each stored row
    ``w * (1 - lr * wd) - lr * g``. Returns ``weight``."""
    with torch.no_grad():
        idx, g = _grad_rows(grad_rsp, rescale_grad, clip_gradient)
        w = weight.data
        rows = w.index_select(0, idx)
        w.index_copy_(0, idx, rows * (1.0 - lr * wd) - lr * g)
    return weight


def adam_update_rsp(weight, grad_rsp, mean, var, lr, beta1, beta2, epsilon,
                    wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """Lazy Adam (reference: AdamUpdateRspImpl): the moments and the
    weight move only on the stored rows; ``lr`` arrives bias-corrected.
    Returns ``(weight, mean, var)``."""
    with torch.no_grad():
        idx, g = _grad_rows(grad_rsp, rescale_grad, clip_gradient)
        w, m, v = weight.data, mean.data, var.data
        w_rows = w.index_select(0, idx)
        g = g + wd * w_rows
        m_rows = beta1 * m.index_select(0, idx) + (1 - beta1) * g
        v_rows = beta2 * v.index_select(0, idx) + (1 - beta2) * g * g
        w_rows = w_rows - lr * m_rows / (torch.sqrt(v_rows) + epsilon)
        w.index_copy_(0, idx, w_rows)
        m.index_copy_(0, idx, m_rows)
        v.index_copy_(0, idx, v_rows)
    return weight, mean, var


def group_adagrad_update_rsp(weight, grad_rsp, history, lr, epsilon=1e-5,
                             rescale_grad=1.0, clip_gradient=None):
    """Lazy GroupAdaGrad (reference: contrib/optimizer_op.cc
    GroupAdagradUpdateRspImpl): one history cell per row, the stored rows
    only. Returns ``(weight, history)``."""
    with torch.no_grad():
        idx, g = _grad_rows(grad_rsp, rescale_grad, clip_gradient)
        w, h = weight.data, history.data
        h.index_add_(0, idx, torch.mean(torch.square(g), dim=1,
                                        keepdim=True))
        div = g / torch.sqrt(h.index_select(0, idx) + epsilon)
        w.index_add_(0, idx, -lr * div)
    return weight, history
