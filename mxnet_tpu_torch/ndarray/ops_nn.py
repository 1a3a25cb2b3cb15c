"""Neural-network ops.

The PyTorch counterparts of every op of ``mxnet_tpu/ndarray/ops_nn.py``:
dense, convolution and deconvolution, pooling (adaptive too), the
activations, softmax/log_softmax/softmin, the norms (batch, layer,
instance, group, LRN), embedding, dropout, the losses (CTC among them),
upsampling and bilinear resize, and the fused RNN. The JAX package left
these to XLA, so the port leaves them to torch (``F.linear``,
``F.conv*d``, ``F.conv_transpose*d``, the pooling functions,
``F.batch_norm``, ``F.layer_norm``, ``F.group_norm``, softmax,
indexing, cuDNN's RNN), with one exception: ``flash_attention`` runs the
hand-written CUDA kernel K1 (``kernels/flash_attention.py``), as the JAX
op runs the Pallas kernel. Signatures are the JAX ops', so symbol graphs
written for the JAX package load and run here with the same keyword
arguments.
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


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register()
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=0, num_group=1,
                  no_bias=True, target_shape=None, layout=None):
    """Transposed convolution (reference: src/operator/nn/deconvolution-
    inl.h), 1-D to 3-D, channel-first layouts only (as the JAX op):
    ``weight`` is (C_in, num_filter / num_group, *k), which is
    ``F.conv_transpose*d``'s layout; ``adj`` adds to the high side of the
    output. Runs in :func:`cudnn_fp32` as :func:`convolution` does, so
    float32 stays float32 (no TF32). ``target_shape`` is accepted and
    ignored, as the JAX op ignores it."""
    if layout in _CHANNEL_LAST:
        raise ValueError("deconvolution supports channel-first layouts "
                         "only (NCW/NCHW/NCDHW)")
    if isinstance(kernel, int):
        kernel = (kernel,)
    nd = len(kernel) if kernel is not None else data.dim() - 2
    if nd not in _DECONV or data.dim() != nd + 2:
        raise MXNetError(f"deconvolution: 1-D, 2-D and 3-D, got data "
                         f"{tuple(data.shape)} kernel {kernel}")
    data, weight, bias = promote(data, weight, None if no_bias else bias)
    with cudnn_fp32():
        return _DECONV[nd](data, weight, bias, _tup(stride or 1, nd),
                           _tup(pad or 0, nd), _tup(adj or 0, nd),
                           num_group, _tup(dilate or 1, nd))


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


@register()
def adaptive_avg_pooling2d(data, output_size=1):
    """The mean over each of ``output_size`` equal windows of an NCHW
    input whose height and width the output divides, as the JAX op takes
    it (reference: src/operator/contrib/adaptive_avg_pooling.cc)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    n, c, h, w = data.shape
    oh, ow = output_size
    return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


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
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    """log(softmax(x / temperature)) along ``axis``, computed stably, in
    ``dtype`` if given (reference: softmax.cc log_softmax)."""
    from .ndarray import torch_dtype

    if dtype is not None:
        data = data.to(torch_dtype(dtype))
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


@register()
def softmin(data, axis=-1):
    """softmax of -x along ``axis`` (reference: softmax.cc softmin)."""
    return torch.softmax(-data, dim=axis)


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
def instance_norm(data, gamma, beta, eps=1e-3):
    """Each sample's channels normalized over their spatial axes, the
    population variance, then per-channel ``gamma`` and ``beta``
    (reference: src/operator/instance_norm.cc)."""
    ax = tuple(range(2, data.dim()))
    mean = data.mean(dim=ax, keepdim=True)
    var = (data - mean).square().mean(dim=ax, keepdim=True)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)


@register()
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """``num_groups`` groups of channels normalized over their channels
    and spatial axes. ``gamma`` and ``beta`` are per group, shape
    ``(num_groups,)`` (reference: src/operator/nn/group_norm.cc,
    group_norm-inl.h:163), so they are repeated over each group's
    channels for ``F.group_norm``, which takes them per channel."""
    c = data.shape[1]
    per = c // num_groups
    from .ndarray import repeat_each

    return F.group_norm(data, num_groups, repeat_each(gamma, per),
                        repeat_each(beta, per), eps)


@register()
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across ``nsize`` channels of NCHW
    data: x / (knorm + alpha / nsize * sum of squares)^beta (reference:
    src/operator/nn/lrn.cc)."""
    half = nsize // 2
    sq = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    c = data.shape[1]
    acc = 0
    for i in range(nsize):
        acc = acc + sq[:, i:i + c]
    return data / torch.pow(knorm + alpha / nsize * acc, beta)


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


# -- the legacy loss heads ---------------------------------------------------


@register()
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Legacy SoftmaxOutput: the forward is the softmax over the last
    axis (axis 1 with ``multi_output``), and on the ``nd``/``autograd``
    path so is the gradient, as the JAX op's (``ops_nn.py:429``). A bound
    executor gives it the loss-head gradient (softmax - one_hot(label))
    instead (``executor.py``)."""
    return torch.softmax(data, dim=1 if multi_output else -1)


@register()
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Mark a value as a loss head: the identity (reference:
    make_loss.cc); a bound executor seeds its gradient with ones."""
    return data


# -- sequences ---------------------------------------------------------------


def _time_index(sequence_length, like):
    """Positions (T, B, 1, ...) and lengths (1, B, 1, ...) broadcastable
    against ``like`` (T, B, ...)."""
    shape = (1, -1) + (1,) * (like.dim() - 2)
    pos = torch.arange(like.shape[0], device=like.device).reshape(
        (-1, 1) + (1,) * (like.dim() - 2))
    return pos, sequence_length.to(torch.int64).reshape(shape)


@register()
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Positions at or past each sequence's length set to ``value``;
    time on ``axis`` 0 or 1 (reference: src/operator/sequence_mask.cc)."""
    if not use_sequence_length or sequence_length is None:
        return data
    x = data.transpose(0, 1) if axis == 1 else data
    pos, lens = _time_index(sequence_length, x)
    out = torch.where(pos < lens, x, torch.full((), value, dtype=x.dtype,
                                                device=x.device))
    return out.transpose(0, 1) if axis == 1 else out


@register()
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step (reference: sequence_last.cc)."""
    x = data.transpose(0, 1) if axis == 1 else data
    if not use_sequence_length or sequence_length is None:
        return x[-1]
    idx = (sequence_length.to(torch.int64) - 1).reshape(
        (1, -1) + (1,) * (x.dim() - 2)).expand((1,) + tuple(x.shape[1:]))
    return torch.gather(x, 0, idx)[0]


@register()
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's valid steps reversed in place, the padding kept
    (reference: sequence_reverse.cc)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    pos, lens = _time_index(sequence_length, data)
    rev = torch.where(pos < lens, lens - 1 - pos, pos)
    return torch.gather(data, 0, rev.expand(data.shape))


@register()
def slice_channel(data, num_outputs, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis`` (reference:
    slice_channel.cc SliceChannel)."""
    from .ops_basic import split

    return split(data, num_outputs, axis=axis, squeeze_axis=squeeze_axis)


# -- resampling --------------------------------------------------------------


@register()
def upsampling(data, scale=2, sample_type="nearest", num_args=1):
    """Nearest-neighbour upsampling of NCHW data by ``scale`` (reference:
    src/operator/nn/upsampling.cc); the bilinear type, which the JAX op
    does not have either, raises."""
    if sample_type != "nearest":
        raise MXNetError(f"upsampling: sample_type {sample_type!r} is not "
                         "ported (nearest only)")
    n, c, h, w = data.shape
    return data.reshape(n, c, h, 1, w, 1).expand(
        n, c, h, scale, w, scale).reshape(n, c, h * scale, w * scale)


@register()
def bilinear_resize2d(data, height=None, width=None, scale_height=None,
                      scale_width=None, mode="size", align_corners=True):
    """Bilinear resize of NCHW data to ``height`` x ``width`` (or the input
    scaled), corners aligned by default as in the reference (reference:
    src/operator/contrib/bilinear_resize.cc). The JAX op passes
    ``align_corners`` over and resizes with half-pixel centers, which is
    ``align_corners=False`` here when upsampling."""
    n, c, h, w = data.shape
    oh = height if height else int(h * scale_height)
    ow = width if width else int(w * scale_width)
    return F.interpolate(data, size=(oh, ow), mode="bilinear",
                         align_corners=bool(align_corners))


# -- CTC ---------------------------------------------------------------------

_CTC_NEG = -1e30


@register()
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification loss per sample (reference:
    src/operator/nn/ctc_loss.cc): ``data`` (T, N, C) activations (the
    softmax is taken here), ``label`` (N, L). ``blank_label="first"``
    makes class 0 the blank (labels 1..C-1, padding 0; a row of zeros
    counts as a full-length label, as in the reference), ``"last"`` class
    C-1 (padding -1). The JAX op's log-space alpha recursion, one step
    per time step, differentiated by autograd; no host sync, so it can
    be captured."""
    if blank_label not in ("first", "last"):
        raise ValueError(
            f"blank_label must be 'first' or 'last', got {blank_label!r}")
    T, N, C = data.shape
    L = label.shape[1]
    blank = 0 if blank_label == "first" else C - 1
    pad = 0 if blank_label == "first" else -1
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int64)
    valid = lab != pad
    # non-pad labels packed to the front, in order (a stable sort on the
    # pad mask), as ctc_loss-inl.h's LabelTensorToPackedVector does
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    lab = torch.gather(lab, 1, order)
    valid = torch.gather(valid, 1, order)
    ext = torch.full((N, 2 * L + 1), blank, dtype=torch.int64,
                     device=data.device)
    ext[:, 1::2] = torch.where(valid, lab, torch.full_like(lab, blank))
    same2 = torch.cat([torch.ones((N, 2), dtype=torch.bool,
                                  device=data.device),
                       ext[:, 2:] == ext[:, :-2]], dim=1)
    neg1 = torch.full((N, 1), _CTC_NEG, dtype=logp.dtype, device=data.device)
    neg2 = torch.full((N, 2), _CTC_NEG, dtype=logp.dtype, device=data.device)
    alpha = torch.full((N, 2 * L + 1), _CTC_NEG, dtype=logp.dtype,
                       device=data.device)
    first = torch.gather(logp[0], 1, ext[:, :2])
    alpha = torch.cat([first, alpha[:, 2:]], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.cat([neg1, alpha[:, :-1]], dim=1)
        a2 = torch.where(same2, _CTC_NEG,
                         torch.cat([neg2, alpha[:, :-2]], dim=1))
        m = torch.maximum(torch.maximum(a1, a2), alpha)
        alpha = m + torch.log(torch.exp(alpha - m) + torch.exp(a1 - m)
                              + torch.exp(a2 - m)) \
            + torch.gather(logp[t], 1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # (T, N, 2L+1)
    if use_data_lengths and data_lengths is not None:
        t_idx = data_lengths.to(torch.int64) - 1
    else:
        t_idx = torch.full((N,), T - 1, dtype=torch.int64, device=data.device)
    final = torch.gather(alphas, 0, t_idx.reshape(1, N, 1).expand(
        1, N, 2 * L + 1))[0]
    if use_label_lengths and label_lengths is not None:
        ll = label_lengths.to(torch.int64)
    else:
        ll = valid.to(torch.int64).sum(dim=1)
        if blank_label == "first":
            ll = torch.where(ll == 0, L, ll)
    last = torch.gather(final, 1, (2 * ll).unsqueeze(1))[:, 0]
    prev = torch.gather(final, 1, (2 * ll - 1).clamp_min(0).unsqueeze(1))[:, 0]
    # an empty target's only path is all blanks: alpha[T-1, 0] alone
    prev = torch.where(ll > 0, prev, _CTC_NEG)
    m = torch.maximum(last, prev)
    return -(m + torch.log(torch.exp(last - m) + torch.exp(prev - m)))


# -- the fused RNN op --------------------------------------------------------

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
_VF_RNN = {"lstm": "lstm", "gru": "gru", "rnn_tanh": "rnn_tanh",
           "rnn_relu": "rnn_relu"}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Length of the packed parameter vector (reference: rnn-inl.h
    GetParamSize)."""
    g, D, H = _GATES[mode], 2 if bidirectional else 1, state_size
    return sum(D * g * H * ((input_size if layer == 0 else H * D) + H + 2)
               for layer in range(num_layers))


def rnn_param_views(parameters, mode, num_layers, input_size, state_size,
                    bidirectional):
    """Views of the packed vector as ``[(W_i, W_h, b_i, b_h)]`` per layer
    and direction: per layer and direction W_i then W_h, then every bias
    (the JAX op's cuDNN-compatible layout, ``ops_nn.py:550-568``).
    Gradients through the views land in the vector, in one
    concatenation (one ``split``, not a slice per view, whose backward
    would write a zero-padded copy of the whole vector per view)."""
    g, D, H = _GATES[mode], 2 if bidirectional else 1, state_size
    want = rnn_param_size(num_layers, input_size, H, bidirectional, mode)
    if parameters.shape[0] != want:
        raise MXNetError(
            f"rnn: the parameter vector has {parameters.shape[0]} values, "
            f"the {mode} stack of {num_layers} layer(s), input {input_size} "
            f"and state {H} takes {want}")
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        shapes += [(g * H, in_sz), (g * H, H)] * D
    shapes += [(g * H,)] * (2 * num_layers * D)
    parts = [p.view(s) for p, s in zip(
        parameters.split([math.prod(s) for s in shapes]), shapes)]
    n = num_layers * D
    return [(parts[2 * i], parts[2 * i + 1], parts[2 * n + 2 * i],
             parts[2 * n + 2 * i + 1]) for i in range(n)]


def _cell_step(mode, x, h, c, wi, wh, bi, bh, clip):
    """One time step of one layer and direction, the JAX op's arithmetic
    (``ops_nn.py:570-595``)."""
    if mode == "lstm":
        gates = x @ wi.t() + bi + h @ wh.t() + bh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        if clip is not None:
            c = c.clamp(*clip)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        xr, xz, xn = (x @ wi.t() + bi).chunk(3, dim=-1)
        hr, hz, hn = (h @ wh.t() + bh).chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, c
    pre = x @ wi.t() + bi + h @ wh.t() + bh
    return (torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)), c


def _rnn_layer_plain(mode, x, h0, c0, weights, clip):
    """One layer, every direction, one time step at a time: the output
    (T, B, D*H) and the final (h, c) per direction."""
    outs, hs, cs = [], [], []
    for d, (wi, wh, bi, bh) in enumerate(weights):
        h, c = h0[d], c0[d]
        steps = range(x.shape[0]) if d == 0 else range(x.shape[0] - 1, -1, -1)
        ys = [None] * x.shape[0]
        for t in steps:
            h, c = _cell_step(mode, x[t], h, c, wi, wh, bi, bh, clip)
            ys[t] = h
        outs.append(torch.stack(ys))
        hs.append(h)
        cs.append(c)
    return torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0], hs, cs


def _rnn_layer_vf(mode, x, h0, c0, weights, bidirectional):
    """Layers through torch's fused RNN (cuDNN on the card, torch's own
    loop on the CPU), in float32 without TF32 (``cudnn_fp32``):
    ``weights`` for every layer in the call, their count the layers."""
    flat = [t for w in weights for t in w]
    nlayers = len(weights) // (2 if bidirectional else 1)
    fn = getattr(torch._VF, _VF_RNN[mode])
    # cuDNN keeps the reserve its backward reads only in training mode;
    # the op's dropout is its own, so the mode asks for nothing else
    train = torch.is_grad_enabled()
    with cudnn_fp32():
        if mode == "lstm":
            out, hn, cn = fn(x, (h0, c0), flat, True, nlayers, 0.0, train,
                             bidirectional, False)
            return out, hn, cn
        out, hn = fn(x, h0, flat, True, nlayers, 0.0, train, bidirectional,
                     False)
    return out, hn, c0


def _rnn_dropout(x, p):
    keep = 1.0 - p
    mask = torch.rand(x.shape, device=x.device,
                      generator=_random.generator(x.device)) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def rnn_plain(data, parameters, state, state_cell=None, state_size=0,
              num_layers=1, mode="lstm", bidirectional=False, p=0.0,
              state_outputs=True, lstm_state_clip_min=None,
              lstm_state_clip_max=None):
    """The plain version of :func:`rnn`: the JAX op's step arithmetic,
    one time step at a time in torch (``_cell_step``), dropout between
    layers as :func:`rnn` draws it."""
    return _rnn(data, parameters, state, state_cell, state_size, num_layers,
                mode, bidirectional, p, state_outputs, lstm_state_clip_min,
                lstm_state_clip_max, plain=True)


def _rnn(data, parameters, state, state_cell, H, num_layers, mode,
         bidirectional, p, state_outputs, clip_min, clip_max, plain):
    T, B, input_size = data.shape
    D = 2 if bidirectional else 1
    c0 = state_cell if state_cell is not None else torch.zeros_like(state)
    if data.is_meta:
        outs = [torch.empty((T, B, D * H), dtype=data.dtype, device="meta")]
    else:
        ws = rnn_param_views(parameters, mode, num_layers, input_size, H,
                             bidirectional)
        clip = None if clip_min is None else (clip_min, clip_max)
        # the JAX op clips c at every step, which torch's fused RNN
        # cannot: a clipped LSTM runs the plain step loop
        plain = plain or clip is not None
        drop = p > 0 and autograd.is_training() and num_layers > 1
        x, hs, cs = data, [], []
        # one call for the whole stack unless dropout sits between layers
        per_call = 1 if drop or plain else num_layers
        for l0 in range(0, num_layers, per_call):
            rows = slice(l0 * D, (l0 + per_call) * D)
            layer_ws = ws[rows]
            if plain:
                x, h, c = _rnn_layer_plain(mode, x, state[rows], c0[rows],
                                           layer_ws, clip)
            else:
                x, hn, cn = _rnn_layer_vf(mode, x, state[rows], c0[rows],
                                          layer_ws, bidirectional)
                h, c = list(hn.unbind(0)), list(cn.unbind(0))
            hs += h
            cs += c
            if drop and l0 + per_call < num_layers:
                x = _rnn_dropout(x, p)
        outs = [x]
    if not state_outputs:
        return outs[0]
    if data.is_meta:
        st = torch.empty((num_layers * D, B, H), dtype=data.dtype,
                         device="meta")
        return tuple(outs + [st] + ([st] if mode == "lstm" else []))
    outs.append(torch.stack(hs))
    if mode == "lstm":
        outs.append(torch.stack(cs))
    return tuple(outs)


@register()
def rnn(data, parameters, state, state_cell=None, state_size=0, num_layers=1,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=True,
        projection_size=None, sequence_length=None, use_sequence_length=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False):
    """Fused multi-layer RNN, LSTM or GRU (reference:
    src/operator/rnn-inl.h; the JAX op is a ``lax.scan`` per layer and
    direction, ``ops_nn.py:533-630``). ``data`` (T, B, I), ``state`` and
    ``state_cell`` (L*D, B, H); ``parameters`` the packed vector
    (:func:`rnn_param_views`). Runs ``torch._VF.lstm``/``gru``/
    ``rnn_tanh``/``rnn_relu`` over views of that vector — cuDNN on the
    card, in float32 without TF32, and torch's own loop on the CPU — so
    gradients flow back into the vector. cuDNN takes its weights in one
    buffer of its own layout, so torch repacks the views at every call.
    Dropout ``p`` between layers, in training only, draws from
    ``mx.random``'s device generator as the JAX op does, not from
    cuDNN's dropout state: the stack then runs one layer per call.
    ``lstm_state_clip_min``/``_max`` clip the cell state at every step,
    which torch's fused RNN cannot: such an LSTM runs the plain step
    loop (:func:`rnn_plain`). ``projection_size``, ``sequence_length``,
    ``use_sequence_length`` and ``lstm_state_clip_nan`` are accepted and
    ignored, as the JAX op ignores them. Returns the output, then (with
    ``state_outputs``) the final h, and c for an LSTM."""
    return _rnn(data, parameters, state, state_cell, state_size, num_layers,
                mode, bidirectional, p, state_outputs, lstm_state_clip_min,
                lstm_state_clip_max, plain=False)
