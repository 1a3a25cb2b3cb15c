"""Basic tensor ops: elementwise, scalar, broadcast, reduce, shape, matrix.

The PyTorch counterparts of every op of ``mxnet_tpu/ndarray/ops_basic.py``
(the unary table :27-42, the broadcast table :157-185, the scalar forms
:199-228, the reductions :232-330, the shape ops :333-660, the matrix
ops :664-767). The JAX package left them to XLA; the port leaves them to
torch. MXNet's conventions hold: comparisons return 0/1 in the input
dtype, a scalar op keeps a float input's dtype, reductions take
``axis``/``keepdims``/``exclude``, index-returning reductions give
float32, ``reshape`` honors the 0/-1/-2/-3/-4 codes, and
``depth_to_space`` permutes in MXNet's DCR order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ndarray import repeat_each, slice_key, torch_dtype
from .registry import register

# -- unary ---------------------------------------------------------------

_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "round": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc, "exp": torch.exp,
    "expm1": torch.expm1, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "sqrt": torch.sqrt,
    "square": torch.square,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x).pow(1.0 / 3.0),
    "reciprocal": torch.reciprocal, "negative": torch.neg,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "erf": torch.erf, "erfinv": torch.erfinv, "gammaln": torch.lgamma,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}


def _make_unary(name, fn):
    def op(data):
        return fn(data)

    op.__name__ = name
    op.__doc__ = (f"Elementwise {name} (reference: src/operator/tensor/"
                  "elemwise_unary_op_basic.cc).")
    register(name)(op)


for _n, _f in _UNARY.items():
    _make_unary(_n, _f)


@register()
def rsqrt(data):
    """Elementwise 1/sqrt(x)."""
    return torch.rsqrt(data)


@register()
def rcbrt(data):
    """Elementwise 1/cbrt(x)."""
    return 1.0 / _UNARY["cbrt"](data)


@register(name="gamma")
def _gamma_fn(data):
    """Elementwise gamma function, exp(lgamma(x))."""
    return torch.exp(torch.lgamma(data))


@register()
def relu(data):
    """max(x, 0) (reference: activation-inl.h kReLU)."""
    return torch.relu(data)


@register()
def sigmoid(data):
    """1/(1+exp(-x)) (reference: activation-inl.h kSigmoid)."""
    return torch.sigmoid(data)


@register()
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    """clip(alpha*x + beta, 0, 1)."""
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register()
def softsign(data):
    """x/(1+|x|) (reference: activation-inl.h kSoftSign)."""
    return data / (1 + torch.abs(data))


@register()
def clip(data, a_min=None, a_max=None):
    """Clamp into [a_min, a_max]."""
    return torch.clamp(data, a_min, a_max)


_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


@register()
def amp_cast(data, dtype="float32"):
    """Cast a floating input to ``dtype``; other dtypes pass through, so
    the AMP graph pass can insert it blindly (reference:
    src/operator/tensor/amp_cast.cc)."""
    if data.dtype in _FLOAT_DTYPES:
        return data.to(torch_dtype(dtype))
    return data


@register()
def amp_multicast(*data, num_outputs=0):
    """Every floating input cast to the widest floating dtype among them
    (reference: amp_cast.cc AMPMultiCast)."""
    fl = [x.dtype for x in data if x.dtype in _FLOAT_DTYPES]
    if not fl:
        return tuple(data)
    widest = max(fl, key=_FLOAT_DTYPES.index)
    return tuple(x.to(widest) if x.dtype in _FLOAT_DTYPES else x
                 for x in data)


# -- binary --------------------------------------------------------------

def _bcast_pair(name, fn):
    def op(lhs, rhs):
        if not isinstance(rhs, torch.Tensor):
            # a Python number, as the JAX package's jnp ops take one (a
            # fill on the device: a copy from the host would wait for it)
            rhs = lhs.new_full((), rhs)
        r = fn(lhs, rhs)
        if r.dtype == torch.bool:
            r = r.to(lhs.dtype)
        return r

    op.__name__ = name
    op.__doc__ = (f"Broadcasting {name} (reference: src/operator/tensor/"
                  "elemwise_binary_broadcast_op*.cc).")
    register(name)(op)


def _nonzero_pair(fn):
    return lambda a, b: fn(a != 0, b != 0)


_BINARY = {
    "broadcast_add": torch.add, "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul, "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder, "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum, "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
    "broadcast_lesser": torch.lt, "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": _nonzero_pair(torch.logical_and),
    "broadcast_logical_or": _nonzero_pair(torch.logical_or),
    "broadcast_logical_xor": _nonzero_pair(torch.logical_xor),
    # the non-broadcast spellings (the reference requires equal shapes)
    "elemwise_add": torch.add, "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul, "elemwise_div": torch.div,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "logical_and": _nonzero_pair(torch.logical_and),
    "logical_or": _nonzero_pair(torch.logical_or),
    "logical_xor": _nonzero_pair(torch.logical_xor),
}

for _n, _f in _BINARY.items():
    _bcast_pair(_n, _f)


@register()
def add_n(*args):
    """Sum of n arrays (reference: src/operator/tensor/elemwise_sum.cc)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# -- scalar --------------------------------------------------------------

def _scalar_pair(name, fn):
    def op(data, scalar=0.0, reverse=False):
        # Python operators keep the scalar a weak "wrapped number", as
        # JAX keeps a Python scalar weakly typed: a float input keeps
        # its dtype
        r = fn(scalar, data) if reverse else fn(data, scalar)
        if r.dtype == torch.bool:
            r = r.to(data.dtype)
        if r.dtype != data.dtype and data.is_floating_point():
            r = r.to(data.dtype)
        return r

    op.__name__ = name
    op.__doc__ = (f"Scalar form of {name.replace('_scalar', '')}; "
                  "``reverse`` swaps the operands (reference: "
                  "elemwise_binary_scalar_op*.cc).")
    register(name)(op)


def _extreme(pick):
    def fn(a, b):
        t, s = (a, b) if isinstance(a, torch.Tensor) else (b, a)
        return pick(t, s)
    return fn


for _n, _f in {
    "broadcast_add_scalar": lambda a, b: a + b,
    "broadcast_sub_scalar": lambda a, b: a - b,
    "broadcast_mul_scalar": lambda a, b: a * b,
    "broadcast_div_scalar": lambda a, b: a / b,
    "broadcast_mod_scalar": lambda a, b: a % b,
    "broadcast_power_scalar": lambda a, b: a ** b,
    "broadcast_equal_scalar": lambda a, b: a == b,
    "broadcast_not_equal_scalar": lambda a, b: a != b,
    "broadcast_greater_scalar": lambda a, b: a > b,
    "broadcast_greater_equal_scalar": lambda a, b: a >= b,
    "broadcast_lesser_scalar": lambda a, b: a < b,
    "broadcast_lesser_equal_scalar": lambda a, b: a <= b,
    "maximum_scalar": _extreme(torch.clamp_min),
    "minimum_scalar": _extreme(torch.clamp_max),
}.items():
    _scalar_pair(_n, _f)


# -- reduce --------------------------------------------------------------

def _axes(axis, ndim, exclude=False):
    """MXNet's ``axis`` (an int, a tuple, or None or () for every axis)
    as a tuple of non-negative axes; ``exclude`` takes the axes not
    named (every axis for None, as in the JAX package)."""
    if axis is None or (isinstance(axis, (tuple, list)) and not axis):
        return tuple(range(ndim))
    axes = tuple(a % ndim for a in ((axis,) if isinstance(axis, int)
                                    else axis))
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _over(fn, data, axis, keepdims, exclude=False):
    """``fn(data, dim=axes, keepdim=)`` over MXNet's axes; no axis left
    (every axis excluded) is the identity."""
    axes = _axes(axis, data.dim(), exclude)
    if not axes:
        return data
    return fn(data, dim=axes, keepdim=keepdims)


@register()
def sum(data, axis=None, keepdims=False, exclude=False):
    """Reference: broadcast_reduce_op_value.cc sum; ``exclude`` sums
    over the axes not named."""
    return _over(torch.sum, data, axis, keepdims, exclude)


@register()
def mean(data, axis=None, keepdims=False, exclude=False):
    """Reference: broadcast_reduce_op_value.cc mean."""
    return _over(torch.mean, data, axis, keepdims, exclude)


def _prod(data, dim, keepdim):
    """torch.prod over several axes (it takes one): the axes moved last
    and flattened into one."""
    rest = [a for a in range(data.dim()) if a not in dim]
    x = data.permute(*rest, *dim).reshape(
        [data.shape[a] for a in rest] + [-1]).prod(-1)
    if keepdim:
        x = x.reshape([1 if a in dim else n
                       for a, n in enumerate(data.shape)])
    return x


def _nanprod(data, dim, keepdim):
    return _prod(torch.where(torch.isnan(data), torch.ones_like(data),
                             data), dim, keepdim)


def _make_reduce(name, fn):
    def op(data, axis=None, keepdims=False, exclude=False):
        return _over(fn, data, axis, keepdims, exclude)

    op.__name__ = name
    op.__doc__ = (f"Reduction {name} (reference: src/operator/tensor/"
                  "broadcast_reduce_op_value.cc).")
    register(name)(op)


for _n, _f in {"prod": _prod, "nansum": torch.nansum, "nanprod": _nanprod,
               "max": torch.amax, "min": torch.amin}.items():
    _make_reduce(_n, _f)


@register()
def sum_axis(data, axis=None, keepdims=False):
    """The legacy spelling of :func:`sum` over ``axis`` (reference:
    broadcast_reduce_op sum_axis)."""
    return _over(torch.sum, data, axis, keepdims)


@register()
def mean_all(data):
    """The mean of every element, a scalar."""
    return torch.mean(data)


@register()
def norm(data, ord=2, axis=None, keepdims=False):
    """The 1-norm (``ord=1``) or else the 2-norm over ``axis``, as the
    JAX op computes them (reference: broadcast_reduce_norm_value.cc)."""
    if ord == 1:
        return _over(torch.sum, torch.abs(data), axis, keepdims)
    return torch.sqrt(_over(torch.sum, torch.square(data), axis, keepdims))


def _index_reduce(fn, data, axis, keepdims):
    if axis is None:
        r = fn(data.reshape(-1))
        if keepdims:
            r = r.reshape((1,) * data.dim())
    else:
        r = fn(data, dim=axis, keepdim=keepdims)
    return r.to(torch.float32)


@register()
def argmax(data, axis=None, keepdims=False):
    """Index of the first maximum along ``axis`` (of the flattened array
    for None), as float32 like the reference (reference:
    broadcast_reduce_op_index.cc)."""
    return _index_reduce(torch.argmax, data, axis, keepdims)


@register()
def argmin(data, axis=None, keepdims=False):
    """Index of the first minimum along ``axis``, as float32."""
    return _index_reduce(torch.argmin, data, axis, keepdims)


@register()
def argmax_channel(data):
    """argmax over axis 1, float32 (reference: broadcast_reduce_op_index.cc
    argmax_channel)."""
    return torch.argmax(data, dim=1).to(torch.float32)


@register()
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data`` over the 2-norm of each instance (every axis after the
    first), channel (axis 1) or spatial position (axes 2 on), plus
    ``eps`` under the root (reference: src/operator/l2_normalization.cc)."""
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    else:
        ax = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                       keepdim=True) + eps)


# -- shape ---------------------------------------------------------------

def reshape_target(src, shape):
    """The target shape of MXNet's ``reshape`` codes 0 (keep), -1
    (infer), -2 (copy the rest), -3 (merge two), -4 (split one in two)
    (reference: src/operator/tensor/matrix_op-inl.h InferReshapeShape)."""
    src = list(src)
    out, i, j = [], 0, 0
    shape = list(shape)
    while j < len(shape):
        d = shape[j]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(d)
            i += 1
        j += 1
    return tuple(out)


@register()
def reshape(data, shape=None, reverse=False):
    """MXNet reshape with the special codes 0/-1/-2/-3/-4."""
    if shape is None:
        return data
    return data.reshape(reshape_target(data.shape, shape))


@register()
def flatten(data):
    """Collapse every axis after the first into one (reference:
    matrix_op.cc Flatten)."""
    return data.reshape(data.shape[0], -1)


@register()
def transpose(data, axes=None):
    """Permute axes (default: reverse them) (reference: matrix_op.cc
    transpose)."""
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register()
def reshape_like(lhs, rhs, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    """``lhs`` reshaped to ``rhs``'s shape, or over axis ranges only:
    ``lhs.shape[:lhs_begin] + rhs.shape[rhs_begin:rhs_end] +
    lhs.shape[lhs_end:]`` (reference: elemwise_unary_op_basic.cc
    reshape_like)."""
    def canon(v, nd, default):
        v = default if v is None else int(v)
        return v + nd if v < 0 else v

    lb = canon(lhs_begin, lhs.dim(), 0)
    le = canon(lhs_end, lhs.dim(), lhs.dim())
    rb = canon(rhs_begin, rhs.dim(), 0)
    re_ = canon(rhs_end, rhs.dim(), rhs.dim())
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(lhs.shape[le:]))


@register()
def expand_dims(data, axis):
    """A size-1 axis inserted at ``axis`` (reference: matrix_op.cc
    expand_dims)."""
    return data.unsqueeze(axis)


@register()
def broadcast_to(data, shape):
    """``data`` broadcast to ``shape``, where 0 keeps the input's extent
    (reference: broadcast_reduce_op_value.cc broadcast_to)."""
    shape = tuple(shape)
    if len(shape) == data.dim():
        shape = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return data.expand(shape)


@register()
def broadcast_axis(data, axis=(), size=()):
    """Size-1 ``axis`` broadcast to ``size`` (reference:
    broadcast_reduce_op_value.cc broadcast_axis)."""
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    tgt = list(data.shape)
    for a, n in zip(axis, size):
        tgt[a] = n
    return data.expand(tgt)


@register()
def broadcast_axes(data, axis=(), size=()):
    """The reference's other spelling of :func:`broadcast_axis`."""
    return broadcast_axis(data, axis, size)


@register()
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    """``lhs`` broadcast to ``rhs``'s shape; with axes given, only those
    ``lhs`` axes grow to the matching ``rhs`` axes' sizes (reference:
    broadcast_reduce_op_value.cc broadcast_like)."""
    if lhs_axes is None and rhs_axes is None:
        return lhs.expand(rhs.shape)
    if lhs_axes is None or rhs_axes is None or \
            len(lhs_axes) != len(rhs_axes) or not lhs_axes:
        raise ValueError(
            "broadcast_like: lhs_axes and rhs_axes must both be given, "
            f"non-empty, and the same length; got {lhs_axes} / {rhs_axes}")
    target = list(lhs.shape)
    for li, ri in zip(lhs_axes, rhs_axes):
        target[int(li) % lhs.dim()] = rhs.shape[int(ri) % rhs.dim()]
    return lhs.expand(target)


@register(name="slice")
def _slice(data, begin, end, step=None):
    """Region slice with ``begin``/``end``/``step`` per axis, None the full
    extent, negative steps too (reference: matrix_op-inl.h Slice)."""
    key = tuple(slice(begin[i], end[i],
                               None if step is None else step[i])
                for i in range(len(begin)))
    return slice_key(data, key)


@register()
def slice_like(data, shape_like, axes=()):
    """``data`` cut to ``shape_like``'s extents along ``axes`` (every
    shared axis by default) (reference: matrix_op.cc slice_like)."""
    axes = axes or tuple(range(min(data.dim(), shape_like.dim())))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register()
def tile(data, reps):
    """The whole array repeated ``reps`` times per axis (reference:
    matrix_op.cc tile)."""
    return torch.tile(data, (reps,) if isinstance(reps, int)
                      else tuple(reps))


@register()
def repeat(data, repeats, axis=None):
    """Each element repeated ``repeats`` times along ``axis`` (of the
    flattened array for None) (reference: matrix_op.cc repeat)."""
    return repeat_each(data, int(repeats), axis)


@register()
def reverse(data, axis=0):
    """Element order reversed along ``axis`` (reference: matrix_op.cc
    reverse)."""
    return torch.flip(data, (axis,) if isinstance(axis, int)
                      else tuple(axis))


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}


@register()
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """Pad with ``pad_width`` (before and after, per axis from the first):
    ``constant`` fills with ``constant_value``, ``edge`` repeats the
    border, ``reflect`` mirrors without it; ``edge`` and ``reflect`` pad
    the spatial axes of NCW/NCHW/NCDHW data only (reference:
    src/operator/pad.cc)."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    pw += [(0, 0)] * (data.dim() - len(pw))
    tmode = _PAD_MODES[mode]
    if tmode != "constant":
        if any(pw[0]) or any(pw[1]) or data.dim() not in (3, 4, 5):
            raise ValueError(f"pad: mode {mode!r} pads the spatial axes of "
                             f"3-D to 5-D data, got {tuple(data.shape)} "
                             f"and pad_width {tuple(pad_width)}")
        pw = pw[2:]
    flat = [w for lo_hi in reversed(pw) for w in lo_hi]
    if tmode == "constant":
        return F.pad(data, flat, value=constant_value)
    return F.pad(data, flat, mode=tmode)


@register()
def diag(data, k=0):
    """The ``k``-th diagonal of the last two axes, or the matrix with a
    1-D input on it (reference: diag_op.cc)."""
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


def _int_vector(values, device):
    """An int32 vector of Python ints on ``device``, written by fills on
    the device (no copy from the host, so it can be captured)."""
    t = torch.empty(len(values), dtype=torch.int32, device=device)
    for i, v in enumerate(values):
        t[i].fill_(v)  # ``t[i] = v`` copies a host scalar to a CUDA t
    return t


@register(differentiable=False)
def shape_array(data):
    """The input's shape as an int32 vector (int64 in the reference; the
    JAX package's without 64-bit mode)."""
    return _int_vector(data.shape, data.device)


@register(differentiable=False)
def size_array(data):
    """The input's element count as a 1-element int32 vector."""
    return _int_vector([data.numel()], data.device)


@register()
def identity(data):
    """A copy of the input (reference: elemwise_unary_op_basic.cc
    _copy)."""
    return data.clone()


class _KLSparseReg(torch.autograd.Function):
    """``identity_attach_kl_sparse_reg``: a copy forward; the backward
    passes the gradient through, as the JAX op's does (the reference
    adds the KL sparsity penalty there, from a moving average the JAX
    package does not keep: it leaves the penalty to the loss)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g


@register()
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Reference: src/operator/identity_attach_KL_sparse_reg.cc
    (:class:`_KLSparseReg`)."""
    if data.is_meta:
        return torch.empty_like(data)
    return _KLSparseReg.apply(data)


@register()
def depth_to_space(data, block_size):
    """Channel blocks moved into spatial blocks, NCHW, in MXNet's DCR
    order: reshape to (n, b, b, c/b^2, h, w), transpose (0, 3, 4, 1, 5,
    2) (reference: matrix_op.cc depth_to_space; not
    ``F.pixel_shuffle``, whose CRD order permutes otherwise)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register()
def space_to_depth(data, block_size):
    """The inverse of :func:`depth_to_space` (reference: matrix_op.cc
    space_to_depth)."""
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register()
def slice_axis(data, axis, begin, end):
    """[begin, end) along one axis; ``end`` None runs to the end
    (reference: matrix_op.cc slice_axis)."""
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]



@register()
def cast(data, dtype="float32"):
    """Cast to ``dtype``, any input dtype (reference:
    elemwise_unary_op_basic.cc Cast)."""
    return data.to(torch_dtype(dtype))


@register()
def flip(data, axis=0):
    """Reverse the order along ``axis`` (an int or a tuple) (reference:
    matrix_op.cc reverse)."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, axes)


@register(differentiable=False)
def zeros_like(data):
    """Zeros of ``data``'s shape, dtype and device."""
    return torch.zeros_like(data)


@register(differentiable=False)
def ones_like(data):
    """Ones of ``data``'s shape, dtype and device."""
    return torch.ones_like(data)


@register()
def concat(*args, dim=1):
    """Join arrays along ``dim`` (reference: concat.cc Concat)."""
    return torch.cat(args, dim=dim)


@register()
def stack(*args, axis=0):
    """Stack arrays along a new ``axis`` (reference: matrix_op.cc
    stack)."""
    return torch.stack(args, dim=axis)


def _parts(parts, axis, squeeze_axis):
    return tuple(p.squeeze(axis) for p in parts) if squeeze_axis \
        else tuple(parts)


@register()
def split(data, num_outputs, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis``; ``squeeze_axis`` drops
    the axis (reference: slice_channel.cc)."""
    n = data.shape[axis]
    if n % num_outputs:
        raise ValueError(f"split: axis {axis} of length {n} does not "
                         f"divide into {num_outputs} equal parts")
    return _parts(torch.split(data, n // num_outputs, dim=axis), axis,
                  squeeze_axis)


@register()
def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    """Split into equal sections (an int) or at explicit indices
    (reference: matrix_op.cc split_v2)."""
    n = data.shape[axis]
    if isinstance(indices_or_sections, int):
        if n % indices_or_sections:
            raise ValueError(f"split_v2: axis {axis} of length {n} does not "
                             f"divide into {indices_or_sections} sections")
        sizes = [n // indices_or_sections] * indices_or_sections
    else:
        cuts = [0] + [min(int(i), n) for i in indices_or_sections] + [n]
        sizes = [max(b - a, 0) for a, b in zip(cuts, cuts[1:])]
    return _parts(torch.split(data, sizes, dim=axis), axis, squeeze_axis)


@register()
def swapaxes(data, dim1=0, dim2=1):
    """Exchange two axes (reference: swapaxis.cc SwapAxis)."""
    return data.transpose(dim1, dim2)


@register()
def squeeze(data, axis=None):
    """Drop size-1 axes, all or ``axis`` (reference: matrix_op.cc
    squeeze)."""
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return data.squeeze(tuple(a % data.dim() for a in axes))


@register()
def where(condition, x, y):
    """``x`` where ``condition`` is nonzero, else ``y`` (reference:
    control_flow_op.cc where)."""
    return torch.where(condition != 0, x, y)


class _StopGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _stop_gradient(data):
    """The identity forward whose gradient is zero (reference:
    elemwise_unary_op BlockGrad): recorded, the output stays on the graph
    and sends zeros back, as the JAX op's ``lax.stop_gradient`` does."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _StopGradient.apply(data)
    return data


register("stop_gradient")(_stop_gradient)
register("BlockGrad")(_stop_gradient)


# literal-shaped constant nodes: sym.zeros / sym.ones and the literals
# the graph optimizer's constant folding bakes in

def _sym_zeros_body(shape=None, dtype="float32"):
    """Literal-shaped zeros constant node (sym.zeros)."""
    return torch.zeros(tuple(shape), dtype=torch_dtype(dtype))


def _sym_ones_body(shape=None, dtype="float32"):
    """Literal-shaped ones constant node (sym.ones)."""
    return torch.ones(tuple(shape), dtype=torch_dtype(dtype))


def _sym_constant_body(value=None, shape=None, dtype="float32"):
    """Literal constant node made by constant folding: ``value`` is a
    nested-list literal baked into the node's kwargs."""
    return torch.tensor(value, dtype=torch_dtype(dtype)).reshape(
        tuple(shape))


register("_sym_zeros", differentiable=False, namespaces=())(_sym_zeros_body)
register("_sym_ones", differentiable=False, namespaces=())(_sym_ones_body)
register("_sym_constant", differentiable=False,
         namespaces=())(_sym_constant_body)


# -- matrix --------------------------------------------------------------

def promote(*ts):
    """The tensors (None kept) in their common dtype where they differ,
    as jnp's products promote: a bfloat16 weight under a float32 input
    computes in float32 (torch's products take one dtype)."""
    dts = {t.dtype for t in ts if t is not None}
    if len(dts) <= 1:
        return ts
    common = None
    for t in ts:
        if t is not None:
            common = t.dtype if common is None else \
                torch.promote_types(common, t.dtype)
    return tuple(None if t is None else t.to(common) for t in ts)


@register()
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: contracts lhs's last axis with rhs's first axis, after
    reversing the axes of either operand on request (reference:
    src/operator/tensor/dot-inl.h)."""
    from .ops_nn import cublas_fp32_accumulate

    lhs, rhs = promote(lhs, rhs)
    if transpose_a:
        lhs = lhs.permute(*reversed(range(lhs.dim())))
    if transpose_b:
        rhs = rhs.permute(*reversed(range(rhs.dim())))
    with cublas_fp32_accumulate(lhs.dtype):
        if lhs.dim() <= 2 and rhs.dim() <= 2:
            return torch.matmul(lhs, rhs)
        return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register(name="_matmul")
def _matmul(lhs, rhs):
    """numpy's matmul, broadcasting the batch axes (reference:
    np_matmul_op.cc); the ``@`` operator."""
    from .ops_nn import cublas_fp32_accumulate

    lhs, rhs = promote(lhs, rhs)
    with cublas_fp32_accumulate(lhs.dtype):
        return torch.matmul(lhs, rhs)


@register()
def khatri_rao(*args):
    """Column-wise Khatri-Rao product of (rows_i, C) matrices (reference:
    contrib krprod.cc)."""
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("ic,jc->ijc", out, m).reshape(-1, out.shape[-1])
    return out


@register()
def hypot(lhs, rhs):
    """sqrt(lhs^2 + rhs^2) (reference: elemwise_binary_op_extended.cc)."""
    return torch.hypot(lhs, rhs)


@register()
def ldexp(lhs, rhs):
    """lhs * 2^rhs (reference: elemwise_binary_op_extended.cc)."""
    return lhs * torch.exp2(rhs)


@register()
def digamma(data):
    """d/dx log Gamma(x) (reference: mshadow_op digamma)."""
    return torch.digamma(data)


@register()
def rnn_param_concat(*args, dim=0):
    """Concatenation that packs RNN parameters (reference: nn/concat.cc
    _rnn_param_concat): inputs of mixed rank (weights and biases) are
    flattened first."""
    if any(a.dim() != args[0].dim() for a in args):
        return torch.cat([a.reshape(-1) for a in args])
    return torch.cat(args, dim=dim)


@register()
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Batched matrix product over the leading axes, either operand's
    last two axes swapped on request (reference: dot.cc batch_dot)."""
    from .ops_nn import cublas_fp32_accumulate

    lhs, rhs = promote(lhs, rhs)
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    with cublas_fp32_accumulate(lhs.dtype):
        return torch.matmul(lhs, rhs)
