"""Index ops: take and gather/scatter, ordering, histogram, slicing.

The PyTorch counterparts of every op of ``mxnet_tpu/ndarray/ops_index.py``
(reference: src/operator/tensor/indexing_op.h, ordering_op-inl.h,
histogram.cc, ravel.cc, matrix_op.cc's slice assignment). The JAX package
left them to XLA's gather and scatter; the port leaves them to torch's
indexing, ``gather``, ``index_put`` and ``sort``, and keeps the JAX
package's answers where torch's defaults differ:

- index-returning ops give the JAX package's dtype: ``topk`` and
  ``argsort`` float32 by default, ``histogram``'s counts and
  ``index_array`` int32 (JAX without 64-bit mode);
- ``topk`` puts the lower index first among equal values (``lax.top_k``'s
  rule), through a stable sort: ``torch.topk`` on CUDA orders ties in no
  fixed way;
- ``argsort`` is stable ascending, and ``is_ascend=False`` is the flip of
  that, so ties come out reversed;
- ``histogram`` counts on the device by an index-add (``torch.histogram``
  has no CUDA implementation), with ``jnp.histogram``'s edges;
- ``boolean_mask``, whose output shape depends on the data, syncs the
  host: inside a CUDA graph capture it raises, as the JAX op raises under
  ``jit``;
- ``pick`` clips an index outside the axis, as MXNet's ``mode="clip"``
  does (the JAX op passes ``mode`` over);
- ``scatter_nd`` adds duplicate indices (MXNet leaves them undefined).
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from .ndarray import (_flipped_key, _negative_steps, repeat_each, slice_key,
                      torch_dtype)
from .registry import register


def _long(index):
    return index.to(torch.int64)


@register()
def take(data, indices, axis=0, mode="clip"):
    """Slices of ``data`` along ``axis`` at ``indices`` (any shape, float
    allowed); an index outside the axis is clipped (``clip``, and
    ``raise``, as the JAX op does) or wrapped (``wrap``) (reference:
    indexing_op.h Take)."""
    axis = axis % data.dim()
    n = data.shape[axis]
    idx = _long(indices)
    idx = idx.clamp(0, n - 1) if mode in ("clip", "raise") \
        else torch.remainder(idx, n)
    out = torch.index_select(data, axis, idx.reshape(-1))
    return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape)
                       + tuple(data.shape[axis + 1:]))


@register()
def take_along_axis(data, indices, axis=0):
    """``data`` at per-position ``indices`` along ``axis``; the other axes
    broadcast, as ``jnp.take_along_axis``'s do; a negative index counts
    from the end."""
    axis = axis % data.dim()
    n = data.shape[axis]
    idx = _long(indices)
    idx = torch.where(idx < 0, idx + n, idx)
    shape = [max(a, b) for a, b in zip(data.shape, idx.shape)]
    dshape, ishape = list(shape), list(shape)
    dshape[axis], ishape[axis] = n, idx.shape[axis]
    return torch.gather(data.expand(dshape), axis, idx.expand(ishape))


@register()
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis``, one element per position of
    the other axes (reference: broadcast_reduce_op_index.cc pick). An
    out-of-range index is clipped (``mode="clip"``, the only mode
    ported). ``index`` may be a float array, as MXNet labels often
    are."""
    if mode != "clip":
        raise ValueError(f"pick: only mode='clip' is ported, got {mode!r}")
    axis = axis % data.dim()
    idx = _long(index).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)


def _nd_index(indices):
    """The leading axis of (M, ...) ``indices`` as a tuple of M index
    tensors."""
    idx = _long(indices)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register()
def gather_nd(data, indices):
    """``data`` at (M, ...) ``indices``, whose leading axis indexes the
    first M axes (reference: indexing_op.h GatherND)."""
    return data[_nd_index(indices)]


@register()
def scatter_nd(data, indices, shape):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (gather_nd's
    inverse; a duplicate index adds, MXNet leaves it undefined)
    (reference: indexing_op.h ScatterND)."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data, accumulate=True)


@register()
def scatter_set_nd(lhs, rhs, indices, shape=None):
    """``lhs`` with ``lhs[indices] = rhs`` (reference: indexing_op.cc
    _scatter_set_nd)."""
    return lhs.index_put(_nd_index(indices), rhs.to(lhs.dtype))


@register()
def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """``on_value`` at each index's position of ``depth``, ``off_value``
    elsewhere; an index outside ``[0, depth)`` gives a row of
    ``off_value`` (reference: indexing_op.h OneHot)."""
    cls = torch.arange(depth, device=indices.device)
    oh = (_long(indices).unsqueeze(-1) == cls).to(torch.float32)
    return (oh * on_value + (1 - oh) * off_value).to(torch_dtype(dtype))


@register()
def index_copy(old, index_vector, new_tensor):
    """``old`` with the rows at ``index_vector`` replaced by
    ``new_tensor``'s (reference: contrib/index_copy.cc)."""
    return old.index_copy(0, _long(index_vector), new_tensor.to(old.dtype))


@register(differentiable=False)
def index_array(data, axes=None):
    """Each position's index over ``axes`` (every axis by default), on a
    new last axis, int32 (int64 in the reference; the JAX package's
    without 64-bit mode) (reference: contrib/index_array.cc)."""
    axes = axes or tuple(range(data.dim()))
    grids = torch.meshgrid(*[torch.arange(n, dtype=torch.int32,
                                          device=data.device)
                             for n in data.shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1)


@register()
def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero
    (reference: contrib/boolean_mask.cc). The output's shape depends on
    the data, so the host waits for it, as in the reference; inside a
    CUDA graph capture this raises."""
    if data.is_cuda and torch.cuda.is_current_stream_capturing():
        raise MXNetError("boolean_mask: the output shape depends on the "
                         "data, which a CUDA graph capture cannot wait "
                         "for")
    if data.is_meta:
        raise MXNetError("boolean_mask: the output shape depends on the "
                         "data")
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, axis, keep)


# -- ordering ---------------------------------------------------------------

def _sorted(data, axis, descending):
    """A stable sort: equal values keep their order, lower index first,
    in either direction."""
    return torch.sort(data, dim=axis, descending=descending, stable=True)


@register()
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, equal
    values lower index first as ``lax.top_k`` gives them: values,
    indices in ``dtype``, both, or a 0/1 mask in the data's dtype
    (reference: ordering_op-inl.h TopK)."""
    vals, idx = _sorted(data, axis, not is_ascend)
    vals = vals.narrow(axis, 0, k)
    idx = idx.narrow(axis, 0, k)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx.to(torch_dtype(dtype))
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, idx, 1)
    raise ValueError(f"unknown ret_typ {ret_typ}")


@register()
def sort(data, axis=-1, is_ascend=True):
    """Values sorted along ``axis``; ``is_ascend=False`` reverses them
    (reference: ordering_op.cc sort)."""
    out = _sorted(data, axis, False).values
    return out if is_ascend else torch.flip(out, (axis,))


@register()
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    """The indices a stable ascending sort along ``axis`` gives, reversed
    for ``is_ascend=False`` (ties then come out reversed), in ``dtype``
    (reference: ordering_op.cc argsort)."""
    idx = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(torch_dtype(dtype))


@register(differentiable=False)
def shuffle(data):
    """The rows of ``data`` in a random order, drawn from the device's
    generator (reference: shuffle_op.cc): the argsort of one uniform key
    per row, so it can be captured."""
    keys = torch.rand(data.shape[0], device=data.device,
                      generator=_random.generator(data.device))
    return torch.index_select(data, 0, torch.argsort(keys))


def _linspace(lo, hi, n):
    """``jnp.linspace(lo, hi, n)``'s arithmetic: lo * (1 - t) + hi * t
    at t = i / (n - 1), the last edge ``hi`` itself."""
    t = torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / (n - 1)
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


@register(differentiable=False)
def histogram(data, bins=10, range=None, bin_cnt=None):
    """Counts of ``data`` in ``bins`` equal bins over ``range`` (the data's
    min and max for None, widened by 0.5 each way when they are equal),
    or in the bins between given edges; the last bin is closed, values
    outside are not counted. Returns the int32 counts and the edges
    (reference: src/operator/tensor/histogram.cc; ``jnp.histogram``'s
    rules). Counted on the device by an index-add."""
    x = data.reshape(-1)
    fdt = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(fdt)
    if bin_cnt is not None:
        bins = bin_cnt
    if isinstance(bins, torch.Tensor):
        edges = bins.to(fdt)
    else:
        if range is None:
            lo, hi = x.min(), x.max()
        else:
            lo = torch.full((), range[0], dtype=fdt, device=x.device)
            hi = torch.full((), range[1], dtype=fdt, device=x.device)
        same = lo == hi
        lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5,
                                                               hi)
        edges = _linspace(lo, hi, int(bins) + 1)
    nb = edges.shape[0] - 1
    pos = torch.searchsorted(edges, x, right=True)
    pos = torch.where(x == edges[-1], torch.full_like(pos, nb), pos)
    counts = torch.zeros(nb + 2, dtype=torch.int32, device=x.device)
    counts.index_add_(0, pos.clamp(0, nb + 1),
                      torch.ones_like(pos, dtype=torch.int32))
    return counts[1:nb + 1], edges


@register()
def unravel(data, shape=None):
    """Flat indices as coordinate rows for ``shape``, in ``data``'s dtype
    (reference: ravel.cc unravel_index); an index outside the array is
    clipped, as ``jnp.unravel_index`` clips it."""
    size = 1
    for n in shape:
        size *= n
    idx = _long(data)
    idx = torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)
    coords = []
    for n in reversed(shape):
        coords.append(torch.remainder(idx, n))
        idx = torch.div(idx, n, rounding_mode="floor")
    return torch.stack(coords[::-1]).to(data.dtype)


@register(differentiable=False)
def unravel_index(data, shape=None):
    """:func:`unravel` under the reference's public name."""
    return unravel(data, shape=shape)


@register()
def ravel_multi_index(data, shape=None):
    """Coordinate rows as flat indices for ``shape``, each coordinate
    clipped into its axis, in ``data``'s dtype (reference: ravel.cc
    ravel_multi_index)."""
    idx = _long(data)
    flat = torch.zeros_like(idx[0])
    for i, n in enumerate(shape):
        flat = flat * n + idx[i].clamp(0, n - 1)
    return flat.to(data.dtype)


# -- the indexing kernels behind NDArray.__getitem__ --------------------------

def _slice_take(data, key=None):
    """numpy indexing: basic keys (ints, slices with any step, None,
    ...) and index arrays (int64 or bool tensors) beside them."""
    return slice_key(data, key)


register("_slice_take")(_slice_take)
register("_static_slice")(_slice_take)


def _slices(begin, end, step):
    begin = begin or ()
    step = step or (None,) * len(begin)
    return tuple(slice(b, e, s if s not in (None, 0) else None)
                 for b, e, s in zip(begin, end or (), step))


def _assign(data, key, value):
    """``data`` with ``data[key] = value`` (a copy, on the recorded graph);
    a negative step writes into the data flipped along its axis."""
    neg = _negative_steps(key, data.dim())
    axes = [ax for _, ax in neg]
    out = data.flip(axes) if neg else data.clone()
    if neg:
        key = _flipped_key(key, data.shape, neg)
    out[key] = value.to(data.dtype)
    return out.flip(axes) if neg else out


@register()
def slice_assign(lhs, rhs, begin=None, end=None, step=None):
    """``lhs`` with ``lhs[begin:end:step] = rhs`` (reference:
    matrix_op.cc _slice_assign)."""
    return _assign(lhs, _slices(begin, end, step), rhs)


@register()
def slice_assign_scalar(data, begin=None, end=None, step=None, scalar=0.0):
    """``data`` with ``data[begin:end:step] = scalar`` (reference:
    matrix_op.cc _slice_assign_scalar)."""
    return _assign(data, _slices(begin, end, step),
                   torch.full((), scalar, dtype=data.dtype,
                              device=data.device))


@register(differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    """``start + step * i`` shaped like ``data`` (or the length of its
    ``axis``), each value ``repeat`` times in a row, float32
    (reference: init_op.cc _contrib_arange_like)."""
    n = data.numel() if axis is None else data.shape[axis]
    m = -(-n // repeat)
    seq = start + step * torch.arange(m, dtype=torch.float32,
                                      device=data.device)
    if repeat != 1:
        seq = repeat_each(seq, repeat)[:n]
    return seq.reshape(tuple(data.shape)) if axis is None else seq
