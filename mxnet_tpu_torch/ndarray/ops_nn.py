"""Neural-network ops.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_nn.py:33-87,137-191,
206-349,393,411,420,727``: dense, convolution, pooling, the activations,
softmax, the norms, embedding, dropout and the losses. The JAX package
left these to XLA, so the port leaves them to torch (``F.linear``,
``F.conv1d``-``F.conv3d``, the pooling functions, ``F.batch_norm``,
``F.layer_norm``, softmax, indexing), with one exception:
``flash_attention`` runs the hand-written CUDA kernel K1
(``kernels/flash_attention.py``), as the JAX op runs the Pallas kernel.
Signatures are the JAX ops', so symbol graphs written for the JAX
package load and run here with the same keyword arguments.
"""
from __future__ import annotations

import contextlib
import inspect
import math

import torch
import torch.nn.functional as F

from .. import autograd
from .. import random as _random
from ..base import MXNetError, getenv
from .ops_basic import promote
from .registry import register


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(v)
    return t if len(t) == n else t + t[-1:] * (n - len(t))


@register()
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """Reference: src/operator/nn/fully_connected-inl.h. ``weight`` is
    (num_hidden, input_dim) as in MXNet, which is ``F.linear``'s layout."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    data, weight, bias = promote(data, weight, None if no_bias else bias)
    with cublas_fp32_accumulate(data.dtype):
        return F.linear(data, weight, bias)


# torch versions that have the fp32_precision settings take "ieee" for
# float32 as float32; the older ones only know allow_tf32
_IEEE = {"fp32_precision": "ieee"} if "fp32_precision" in \
    inspect.signature(torch.backends.cudnn.flags).parameters else {}


def cudnn_fp32():
    """The scope the port's cuDNN work runs in, forward (``convolution``)
    and backward (``autograd.backward``): float32 stays float32 — no
    TF32, whatever torch's global ``cudnn.allow_tf32`` says (its default
    is True) — and cuDNN autotunes its algorithms as
    ``MXNET_CUDNN_AUTOTUNE_DEFAULT`` says: 0 off, 1 or 2 on (MXNet's
    default, 1). cuDNN's other flags keep their global values."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled,
        benchmark=getenv("MXNET_CUDNN_AUTOTUNE_DEFAULT", 1, int) > 0,
        deterministic=torch.backends.cudnn.deterministic,
        allow_tf32=False, **_IEEE)


class _CublasFp32Accumulate:
    __slots__ = ("_saved",)

    def __enter__(self):
        m = torch.backends.cuda.matmul
        self._saved = (m.allow_bf16_reduced_precision_reduction,
                       m.allow_fp16_reduced_precision_reduction)
        m.allow_bf16_reduced_precision_reduction = False
        m.allow_fp16_reduced_precision_reduction = False
        return self

    def __exit__(self, *exc):
        m = torch.backends.cuda.matmul
        (m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = self._saved


_NO_SCOPE = contextlib.nullcontext()
_HALF = (torch.bfloat16, torch.float16)


def cublas_fp32_accumulate(dtype=None):
    """The scope the port's products run in, forward (``fully_connected``,
    ``dot``, ``batch_dot``: for half operands, ``dtype``) and backward
    (``autograd.backward``, no ``dtype``): cuBLAS sums bfloat16 and
    float16 products in float32, split-K partial sums included, as the
    JAX package's products accumulate. torch's default
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    and its fp16 twin, True) lets cuBLAS reduce partial sums in the half
    type. Other dtypes get a no-op scope (the flags touch only half
    products)."""
    if dtype is not None and dtype not in _HALF:
        return _NO_SCOPE
    return _CublasFp32Accumulate()


# channel-last layouts: the weight rides as (O, *spatial, I/g), as in the
# JAX package (``_conv_dims``: rhs spec "O" + spatial + "I")
_CHANNEL_LAST = ("NWC", "NHWC", "NDHWC")
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register()
def convolution(data, weight, bias=None, kernel=None, stride=None, dilate=None,
                pad=None, num_filter=0, num_group=1, no_bias=False,
                layout=None):
    """Reference: src/operator/nn/convolution-inl.h. 1-D, 2-D and 3-D, in
    the channel-first layouts (NCW, NCHW, NCDHW; weight (O, I/g, *k)) or
    the channel-last ones the JAX package added (NWC, NHWC, NDHWC; weight
    (O, *k, I/g)). torch convolves channel-first, so a channel-last call
    moves the channel axis in and out; its output is contiguous in the
    channel-last layout, ready for a norm over the last axis."""
    if isinstance(kernel, int):
        kernel = (kernel,)
    nd = len(kernel) if kernel is not None else data.dim() - 2
    if nd not in _CONV or data.dim() != nd + 2:
        raise MXNetError(f"convolution: the port takes 1-D, 2-D and 3-D "
                         f"convolutions, got data {tuple(data.shape)} "
                         f"kernel {kernel}")
    channel_last = layout in _CHANNEL_LAST
    data, weight, bias = promote(data, weight, None if no_bias else bias)
    if channel_last:
        data = data.movedim(-1, 1)
        weight = weight.movedim(-1, 1)
    with cudnn_fp32():
        out = _CONV[nd](data, weight, bias,
                        _tup(stride or 1, nd), _tup(pad or 0, nd),
                        _tup(dilate or 1, nd), num_group)
    if channel_last:
        out = out.movedim(1, -1).contiguous()
    return out


# -- pooling --------------------------------------------------------------

_POOL = {"max": (F.max_pool1d, F.max_pool2d, F.max_pool3d),
         "avg": (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)}


@register()
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, layout=None):
    """Reference: src/operator/nn/pooling-inl.h; the JAX op's
    ``reduce_window`` semantics (``mxnet_tpu/ndarray/ops_nn.py:137-191``):
    ``max`` (padding is -inf), ``avg`` and ``sum`` (padding is 0; ``avg``
    divides by the window size, or with ``count_include_pad=False`` by
    the real elements in it), ``lp`` (the 2-norm of the window);
    ``global_pool`` reduces every spatial axis to size 1 by max, or else
    by the mean (for ``sum`` and ``lp`` too, as the JAX op does);
    ``pooling_convention="full"`` (ceil mode) pads the high side so the
    last partial window counts. Channel-first layouts, or NWC/NHWC/NDHWC
    (the channel axis moved in and out)."""
    channel_last = layout in _CHANNEL_LAST
    nd = data.dim() - 2
    if global_pool:
        # the JAX op's rule: max, else the mean, whatever the pool type
        axes = tuple(range(1, data.dim() - 1)) if channel_last \
            else tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    if nd not in (1, 2, 3):
        raise MXNetError(f"pooling: 1-D, 2-D or 3-D windows, got data "
                         f"{tuple(data.shape)}")
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type}")
    kernel = _tup(kernel, nd)
    stride = _tup(stride or 1, nd)
    pad = _tup(pad or 0, nd)
    x = data.movedim(-1, 1) if channel_last else data
    spatial = x.shape[2:]
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(nd):
            rem = (spatial[i] + 2 * pad[i] - kernel[i]) % stride[i]
            hi[i] += stride[i] - rem if rem else 0
    # pad explicitly (torch's own padding is symmetric and capped at half
    # a window), then pool with none
    widths = []
    for lo, h in zip(reversed(pad), reversed(hi)):
        widths += [lo, h]
    if pool_type == "max":
        fill = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = _POOL["max"][nd - 1](F.pad(x, widths, value=fill), kernel,
                                   stride)
    else:
        src = x.square() if pool_type == "lp" else x
        window = math.prod(kernel)
        mean = _POOL["avg"][nd - 1](F.pad(src, widths), kernel, stride)
        if pool_type == "avg" and count_include_pad:
            out = mean
        else:
            out = mean * window  # the window's sum
            if pool_type == "lp":
                out = out.sqrt()
            elif pool_type == "avg":
                ones = F.pad(torch.ones((1, 1) + tuple(spatial),
                                        dtype=x.dtype, device=x.device),
                             widths)
                out = out / (_POOL["avg"][nd - 1](ones, kernel, stride)
                             * window)
    if channel_last:
        out = out.movedim(1, -1).contiguous()
    return out


# -- activations ----------------------------------------------------------

def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": _softplus, "softsign": lambda x: x / (1 + torch.abs(x)),
}


@register()
def activation(data, act_type="relu"):
    """Reference: src/operator/nn/activation-inl.h: relu, sigmoid, tanh,
    softrelu (softplus) and softsign."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise ValueError(f"unknown act_type {act_type}")
    return fn(data)


SELU_ALPHA, SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register()
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """Reference: src/operator/leaky_relu-inl.h: leaky, prelu, elu,
    selu, gelu (the erf form, ``jax.nn.gelu(approximate=False)``) and
    rrelu (eval mode: the slope is the bounds' midpoint)."""
    pos = data > 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() < data.dim() and g.dim() == 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        return SELU_SCALE * torch.where(pos, data,
                                        SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(pos, data, mid * data)
    raise ValueError(f"unknown act_type {act_type}")


@register()
def softmax(data, length=None, axis=-1, temperature=None, use_length=False,
            dtype=None):
    """Reference: src/operator/nn/softmax.cc: optional ``length`` mask
    (with ``use_length=True``), ``temperature`` and output ``dtype``."""
    from .ndarray import torch_dtype

    if dtype is not None:
        data = data.to(torch_dtype(dtype))
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if length is not None and not use_length:
        raise ValueError("softmax: `length` provided without "
                         "use_length=True")
    if length is not None:
        axis = axis % data.dim()
        shape = [1] * data.dim()
        shape[axis] = data.shape[axis]
        pos = torch.arange(data.shape[axis], device=data.device)
        mask = pos.reshape(shape) < length.reshape(
            tuple(length.shape) + (1,) * (data.dim() - length.dim()))
        data = torch.where(mask, data, torch.full_like(data, float("-inf")))
        return torch.where(mask, torch.softmax(data, dim=axis),
                           torch.zeros_like(data))
    return torch.softmax(data, dim=axis)


@register()
def log_softmax(data, axis=-1):
    """log(softmax(x)) along ``axis``, computed stably (reference:
    softmax.cc log_softmax)."""
    return torch.log_softmax(data, dim=axis)


# -- norms ----------------------------------------------------------------

@register()
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Reference: src/operator/nn/layer_norm.cc — population variance,
    ``(x - mean) * rsqrt(var + eps) * gamma + beta`` over ``axis``; with
    ``output_mean_var`` also the mean and variance, the axis dropped."""
    axis = axis % data.dim()
    if axis == data.dim() - 1 and not output_mean_var:
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, unbiased=False)
    bshape = [1] * data.dim()
    bshape[axis] = data.shape[axis]
    out = (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


@register()
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, use_batch_stats=None):
    """Functional BatchNorm (reference: src/operator/nn/batch_norm.cc):
    batch statistics in training (``use_batch_stats`` None follows
    ``autograd.is_training()``; the variance is the biased one, as
    ``jnp.var``), the moving ones otherwise; statistics and arithmetic in
    float32 for half inputs, the output in the input's dtype. The
    normalization is ``F.batch_norm`` (cuDNN on the card) with the
    channel axis moved to 1; a half input with float32 parameters goes in
    as it is (cuDNN's mixed batch norm), without a float32 copy.

    With ``output_mean_var`` the batch mean and biased variance (or the
    moving ones) come back too, from the same pass: ``F.batch_norm``
    writes the batch statistics into two scratch buffers (momentum 1),
    the variance in torch's unbiased form, which ``(n - 1) / n`` turns
    into MXNet's. They carry no gradient, as MXNet's auxiliary outputs
    do not. The running-statistics write-back stays the caller's, as in
    the JAX package: its momentum means the opposite of torch's."""
    if use_batch_stats is None:
        use_batch_stats = autograd.is_training()
    axis = axis % data.dim()
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    half = data.dtype in (torch.bfloat16, torch.float16)
    sdt = torch.float32 if half else data.dtype  # statistics' dtype
    x1 = data.movedim(axis, 1) if axis != 1 else data
    if half and x1.device.type == "cpu" and x1.dtype == torch.float16:
        x1 = x1.float()  # torch's CPU kernel takes no mixed float16
    g, b = gamma.to(sdt), beta.to(sdt)
    C = x1.shape[1]
    n = x1.numel() // max(C, 1)  # values per channel
    batch = use_batch_stats and not use_global_stats
    if not batch:
        mean = moving_mean.to(sdt)
        var = moving_var.to(sdt)
        out = F.batch_norm(x1, mean, var, g, b, False, 0.0, eps)
    elif n > 1:
        stats = None
        if output_mean_var:
            # scratch running buffers at momentum 1: torch writes the
            # batch mean and the unbiased variance into them
            stats = torch.zeros((2, C), dtype=sdt, device=x1.device)
        out = F.batch_norm(x1, None if stats is None else stats[0],
                           None if stats is None else stats[1], g, b, True,
                           1.0, eps)
        if stats is not None:
            mean, var = stats[0], stats[1] * ((n - 1) / n)
    else:  # one value per channel, which torch refuses: x - mean is 0
        shape = (1, -1) + (1,) * (x1.dim() - 2)
        out = torch.zeros_like(x1, dtype=sdt) * g.reshape(shape) \
            + b.reshape(shape)
        mean = x1.detach().to(sdt).reshape(C)
        var = torch.zeros_like(mean)
    if axis != 1:
        out = out.movedim(1, axis)
    if out.dtype != data.dtype:
        out = out.to(data.dtype)
    if not output_mean_var:
        return out
    return out, mean, var


@register()
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Reference: src/operator/tensor/indexing_op.h (Embedding). Row
    lookup with the JAX package's out-of-range rule (``jnp.take``'s fill
    mode): a negative index counts from the end, and an index outside
    ``[-V, V)`` yields a row of NaN instead of raising — so a lookup
    never traps on the device."""
    V = weight.shape[0]
    idx = data.to(torch.int64)
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    out = weight[idx.clamp(0, V - 1)]
    if weight.is_floating_point():
        out = torch.where(valid.unsqueeze(-1), out,
                          torch.full_like(out, float("nan")))
    return out


@register()
def softmax_cross_entropy(data, label):
    """Summed negative log-likelihood of integer ``label`` under
    softmax(``data``) over the last axis (reference:
    src/operator/loss_binary_op.cc)."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1,
                         label.to(torch.int64).unsqueeze(-1)).sum()


@register()
def dropout(data, p=0.5, axes=()):
    """Reference: src/operator/nn/dropout-inl.h. The identity at ``p ==
    0`` or outside training, as the JAX op is; otherwise each element
    (or, with ``axes``, each slice along them) is kept with probability
    1 - p, drawn from the device's generator (``mx.random``), and scaled
    by 1 / (1 - p)."""
    if p == 0 or not autograd.is_training():
        return data
    shape = tuple(1 if i in axes else n for i, n in enumerate(data.shape))
    keep = 1.0 - p
    mask = torch.rand(shape, device=data.device,
                      generator=_random.generator(data.device)) < keep
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


@register(name="flash_attention")
def flash_attention_op(query, key, value, sm_scale=None, causal=False):
    """Blockwise attention over (B, H, S, D): the hand-written kernel K1
    on CUDA tensors, its plain version on CPU tensors; the backward is
    the q-chunk recompute (``kernels/flash_attention.py``)."""
    from ..kernels.flash_attention import flash_attention

    return flash_attention(query, key, value, sm_scale=sm_scale,
                           causal=causal)
