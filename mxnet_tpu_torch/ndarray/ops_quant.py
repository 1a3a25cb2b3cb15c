"""Quantization ops: quantize, quantize_v2, dequantize, requantize, the
int8-chain ``_contrib_quantized_*`` ops and ``calibrate_entropy``.

The PyTorch counterparts of ``mxnet_tpu/ndarray/ops_quant.py``
(reference: src/operator/quantization/: quantize.cc, quantize_v2.cc,
dequantize.cc, requantize.cc and the quantized_*.cc op files). int8
affine (symmetric) quantization: each lattice op returns its payload
with the float range ``(min, max)`` it represents, so consecutive
quantized layers never round-trip through float32.

Every range stays a device tensor: no op reads one on the host, so a
captured CUDA graph can hold them all. Each op does its float32
arithmetic in the JAX op's order, one operation at a time, and rounds
half to even (``torch.round``, as ``jnp.rint``), so the codes equal the
JAX package's bit for bit. A division is always by a tensor: torch
computes ``c / t`` for a Python scalar ``c`` as ``t.reciprocal() * c``
and, on CUDA, ``t / c`` as ``t * (1 / c)``, both of which round
differently from the division the JAX op does.

The int32-accumulating contractions (``_contrib_quantized_conv``,
``_fully_connected``, ``_batch_dot``) follow :func:`lowering`:

- ``native``: int8 operands, int32 accumulators. On a CUDA tensor the
  convolution is the hand-written kernel N2 and the products are
  ``torch._int_mm`` (``kernels/int8_conv.py``); on a CPU tensor their
  plain versions (float64, exact for every int8 sum).
- ``dequant``: the operands converted to float32 and contracted in
  float32 (no TF32), rounded back onto the int32 lattice — exact while
  the partial sums stay below 2^24.

The elementwise ops are lowering-independent.
"""
from __future__ import annotations

import contextlib
import os

import numpy as onp
import torch

from .ops_nn import _CHANNEL_LAST, _CONV, _tup, cudnn_fp32
from .registry import get_op, register

__all__ = ["lowering", "LOWERINGS"]

#: the values ``MXNET_QUANTIZE_LOWERING`` takes
LOWERINGS = ("auto", "native", "dequant")


def lowering(like=None):
    """The execution strategy of the int32-accumulating quantized ops,
    from ``MXNET_QUANTIZE_LOWERING``: ``native`` and ``dequant`` as
    given; ``auto`` (default) resolves to ``native`` when ``like`` (a
    tensor or a device) is on a CUDA device and to ``dequant``
    elsewhere — the port's reading of the JAX rule "native on TPU,
    dequant elsewhere". Any other value raises ``ValueError``."""
    mode = (os.environ.get("MXNET_QUANTIZE_LOWERING", "auto")
            or "auto").lower()
    if mode not in LOWERINGS:
        raise ValueError("MXNET_QUANTIZE_LOWERING must be auto, native "
                         f"or dequant (got {mode!r})")
    if mode != "auto":
        return mode
    dev = like.device if isinstance(like, torch.Tensor) else (
        torch.device(like) if like is not None else None)
    return "native" if dev is not None and dev.type == "cuda" else "dequant"


# -- scalar helpers ---------------------------------------------------------

def _const(v, like):
    """A float32 0-d tensor of ``v`` on ``like``'s device, made by a fill
    (no host copy, so a captured graph can hold it)."""
    return torch.full((), float(onp.float32(v)), dtype=torch.float32,
                      device=like.device)


def _f32(x, like):
    """``x`` (a tensor of any shape, or a Python number) as float32 on
    ``like``'s device, its shape kept (``jnp.asarray(x, float32)``)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return _const(x, like)


def _scalar(x, like):
    """``jnp.reshape(x, ()).astype(float32)``."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(torch.float32)
    return _const(x, like)


def _div(a, b):
    """``a / b`` as one float32 division, whatever ``b`` is."""
    if not isinstance(b, torch.Tensor):
        b = _const(b, a)
    return a / b


def _rdiv(c, t):
    """``c / t`` for a Python number ``c``: a true division (torch's
    ``c / t`` multiplies by the reciprocal)."""
    return torch.full_like(t, float(onp.float32(c))) / t


def _amax(mn, mx_):
    return torch.maximum(mn.abs(), mx_.abs())


def _floor20(x):
    """``jnp.maximum(x, 1e-20)``."""
    return torch.clamp(x, min=float(onp.float32(1e-20)))


def _codes(real, lo, hi, dtype):
    """``clip(rint(real), lo, hi).astype(dtype)``."""
    return torch.clamp(torch.round(real), lo, hi).to(dtype)


def _qparams(min_range, max_range, out_type):
    amax = _amax(min_range, max_range)
    if out_type == "int8":
        scale = _rdiv(127.0, _floor20(amax))
        return scale, -127, 127, torch.int8
    if out_type == "uint8":
        scale = _rdiv(255.0, _floor20(max_range - min_range))
        return scale, 0, 255, torch.uint8
    raise ValueError(f"unsupported out_type {out_type}")


# -- quantize / dequantize / requantize --------------------------------------

@register(differentiable=False)
def quantize(data, min_range, max_range, out_type="uint8"):
    """Reference: quantization/quantize.cc. Returns (q, min, max)."""
    mn = _scalar(min_range, data)
    mx_ = _scalar(max_range, data)
    scale, lo, hi, dt = _qparams(mn, mx_, out_type)
    if out_type == "int8":
        q = _codes(data * scale, lo, hi, dt)
        amax = _amax(mn, mx_)
        return q, -amax, amax
    q = _codes((data - mn) * scale, lo, hi, dt)
    return q, mn, mx_


@register(differentiable=False)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """Reference: quantization/quantize_v2.cc — the range comes from the
    data when no calibrated range is given. ``out_type='uint8'`` assumes
    a non-negative range (the pass selects it only post-relu) and uses
    the zero-point-free [0, max] lattice with 255 steps."""
    if min_calib_range is None or max_calib_range is None:
        mn = data.min().to(torch.float32)
        mx_ = data.max().to(torch.float32)
    else:
        mn = _f32(min_calib_range, data)
        mx_ = _f32(max_calib_range, data)
    if out_type == "uint8":
        scale = _rdiv(255.0, _floor20(mx_))
        q = _codes(data * scale, 0, 255, torch.uint8)
        return q, torch.zeros((), dtype=torch.float32,
                              device=data.device), mx_
    return get_op("quantize").fn(data, mn, mx_, out_type=out_type)


@register(differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    """Reference: quantization/dequantize.cc."""
    mn = _scalar(min_range, data)
    mx_ = _scalar(max_range, data)
    if data.dtype == torch.int8:
        return data.to(torch.float32) * _div(_amax(mn, mx_), 127.0)
    # uint8: the zero-point-free [mn (= 0), mx] lattice
    scale = _div(mx_ - mn, 255.0)
    return data.to(torch.float32) * scale + mn


@register(differentiable=False)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None, out_type="int8"):
    """Reference: quantization/requantize.cc — int32 accumulators to
    int8. The int32 data represents values on the scale
    amax / (127 * 127)."""
    mn = _scalar(min_range, data)
    mx_ = _scalar(max_range, data)
    real = data.to(torch.float32) * _div(_amax(mn, mx_), 127.0 * 127.0)
    if (min_calib_range is None) != (max_calib_range is None):
        raise ValueError("min_calib_range and max_calib_range must be "
                         "given together")
    if min_calib_range is not None:
        cmn = _f32(min_calib_range, data)
        cmx = _f32(max_calib_range, data)
    else:
        cmn, cmx = real.min(), real.max()
    return get_op("quantize").fn(real, cmn, cmx, out_type="int8")


# -- the int8-chain ops ------------------------------------------------------
# Each consumes int8 data WITH its (min, max) range and produces int8 data
# with a range (reference: quantize_graph_pass.cc's quantized regions).

def _sym_scale(mn, mx_):
    """Symmetric int8 scale of a (min, max) range."""
    return _div(_floor20(_amax(mn, mx_)), 127.0)


def _in_scale(data, mn, mx_):
    """Decode scale of a quantized input: uint8 tensors carry
    zero-point-free [0, max] ranges, int8 symmetric ones."""
    if data.dtype == torch.uint8:
        return _div(_floor20(_scalar(mx_, data).abs()), 255.0)
    return _sym_scale(_scalar(mn, data), _scalar(mx_, data))


def _to_s8_lattice(data, min_data, max_data):
    """A uint8 [0, max] tensor re-quantized onto the int8 lattice (the
    int8-only contractions consume it); int8 inputs pass through.
    Returns ``(q_s8, decode_scale)``. The conversion recomputes each
    code; it never reinterprets the bytes."""
    if data.dtype == torch.uint8:
        mx_ = _scalar(max_data, data)
        s8_scale = _div(_floor20(mx_), 127.0)
        # real = u8 * mx / 255; q_s8 = real / (mx / 127) = u8 * 127 / 255
        q = _codes(data.to(torch.float32) * (127.0 / 255.0), 0, 127,
                   torch.int8)
        return q, s8_scale
    return data, _in_scale(data, min_data, max_data)


@register(differentiable=False)
def _contrib_quantized_act(data, min_data, max_data, act_type="relu"):
    """Reference: quantization/quantized_activation.cc — relu on the int8
    lattice (zero point 0), range kept."""
    if act_type != "relu":
        raise ValueError("only act_type='relu' is quantized")
    if data.dtype == torch.uint8:  # already non-negative
        return data, _scalar(min_data, data), _scalar(max_data, data)
    return (torch.clamp(data, min=0).to(data.dtype),
            _scalar(min_data, data), _scalar(max_data, data))


@register(differentiable=False)
def _contrib_quantized_flatten(data, min_data, max_data):
    """Reference: quantization/quantized_flatten.cc."""
    return (data.reshape(data.shape[0], -1), _scalar(min_data, data),
            _scalar(max_data, data))


@register(differentiable=False)
def _contrib_quantized_pooling(data, min_data, max_data, kernel=None,
                               pool_type="max", global_pool=False,
                               stride=None, pad=None,
                               pooling_convention="valid",
                               count_include_pad=True, layout=None):
    """Reference: quantization/quantized_pooling.cc. Max pooling picks
    codes (here in float32, which holds every code exactly); avg pooling
    averages in float32 and rounds back onto the SAME scale (the range
    is unchanged either way)."""
    pool = get_op("pooling").fn
    kw = dict(kernel=kernel, pool_type=pool_type, global_pool=global_pool,
              stride=stride, pad=pad, pooling_convention=pooling_convention,
              layout=layout)
    if pool_type == "max":
        out = pool(data.to(torch.float32), **kw).to(data.dtype)
    else:
        acc = pool(data.to(torch.float32),
                   count_include_pad=count_include_pad, **kw)
        lo, hi = (0, 255) if data.dtype == torch.uint8 else (-127, 127)
        out = _codes(acc, lo, hi, data.dtype)
    return out, _scalar(min_data, data), _scalar(max_data, data)


@register(differentiable=False)
def _contrib_quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min,
                                    rhs_max):
    """Reference: quantization/quantized_elemwise_add.cc — both addends
    rescaled onto the output lattice; the output range is |l|max +
    |r|max (the exact bound of a sum)."""
    ls = _in_scale(lhs, lhs_min, lhs_max)
    rs = _in_scale(rhs, rhs_min, rhs_max)
    omax = _scalar(lhs_max, lhs).abs() + _scalar(rhs_max, lhs).abs()
    omax = torch.maximum(omax, _scalar(lhs_min, lhs).abs()
                         + _scalar(rhs_min, lhs).abs())
    os_ = _div(_floor20(omax), 127.0)
    acc = lhs.to(torch.float32) * ls + rhs.to(torch.float32) * rs
    return _codes(acc / os_, -127, 127, torch.int8), -omax, omax


@register(differentiable=False)
def _contrib_quantized_concat(*args, dim=1):
    """Reference: quantization/quantized_concat.cc. Inputs as in the
    reference: n data tensors, then n mins, then n maxes; every input is
    rescaled onto the widest range before the concatenation."""
    n = len(args) // 3
    datas, mins, maxs = args[:n], args[n:2 * n], args[2 * n:]
    like = datas[0]
    amaxs = [_amax(_scalar(mn, like), _scalar(mx_, like))
             for mn, mx_ in zip(mins, maxs)]
    omax = amaxs[0]
    for a in amaxs[1:]:
        omax = torch.maximum(omax, a)
    os_ = _div(_floor20(omax), 127.0)
    parts = [_codes(d.to(torch.float32) * _in_scale(d, mn, mx_) / os_,
                    -127, 127, torch.int8)
             for d, mn, mx_ in zip(datas, mins, maxs)]
    return torch.cat(parts, dim=dim), -omax, omax


@register(differentiable=False)
def _contrib_quantized_batch_norm(data, gamma, beta, moving_mean,
                                  moving_var, min_data, max_data, eps=1e-3,
                                  fix_gamma=False, min_calib_range=None,
                                  max_calib_range=None):
    """Reference: quantization/quantized_batch_norm.cc — inference batch
    norm folded to a per-channel affine on the dequantized lattice,
    requantized onto the calibrated output range."""
    scale = _in_scale(data, min_data, max_data)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = g / torch.sqrt(moving_var + eps)
    shp = (1, -1) + (1,) * (data.dim() - 2)
    real = data.to(torch.float32) * scale
    y = real * inv.reshape(shp) + (beta - moving_mean * inv).reshape(shp)
    if min_calib_range is None or max_calib_range is None:
        cmn, cmx = y.min(), y.max()
    else:
        cmn = _f32(min_calib_range, data)
        cmx = _f32(max_calib_range, data)
    omax = _amax(cmn, cmx)
    q = _codes(y / _div(_floor20(omax), 127.0), -127, 127, torch.int8)
    return q, -omax, omax


# -- the int32-accumulating contractions -------------------------------------

class _MatmulFp32:
    """float32 products in float32 (no TF32) for the dequant lowering,
    whatever ``torch.backends.cuda.matmul.allow_tf32`` says: TF32's
    10-bit mantissa cannot hold a product of two int8 codes."""

    __slots__ = ("_saved",)

    def __enter__(self):
        m = torch.backends.cuda.matmul
        self._saved = m.allow_tf32
        m.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._saved


def _matmul_fp32(like):
    return _MatmulFp32() if like.is_cuda else contextlib.nullcontext()


def _acc_finish(acc):
    """Accumulators onto the int32 lattice: ``native`` ones already are;
    ``dequant`` ones hold exact integers in float32 below 2^24, so a
    round and a cast reproduce them."""
    if acc.dtype == torch.int32:
        return acc
    return torch.round(acc).to(torch.int32)


def _bias_codes(bias, scale):
    """``rint(bias / scale)`` on the int32 lattice."""
    return torch.round(bias.to(torch.float32) / scale).to(torch.int32)


@register(differentiable=False)
def _contrib_quantized_conv(data, weight, min_data=None, max_data=None,
                            min_weight=None, max_weight=None, bias=None,
                            min_bias=None, max_bias=None, kernel=None,
                            stride=None, dilate=None, pad=None, num_filter=0,
                            num_group=1, no_bias=False, layout=None):
    """Reference: quantization/quantized_conv.cc — int8 x int8
    convolution accumulating int32, the bias added on the int32 lattice
    at scale s_data * s_weight. Returns int32 and the float range it
    represents; a following ``requantize`` narrows it to int8. The
    inputs follow the JAX op's order (the bias after the ranges).
    Under ``native`` on a CUDA tensor this is the kernel N2."""
    from ..kernels.int8_conv import int8_conv

    if isinstance(kernel, int):
        kernel = (kernel,)
    nd = len(kernel) if kernel is not None else data.dim() - 2
    stride_, dilate_, pad_ = (_tup(stride or 1, nd), _tup(dilate or 1, nd),
                              _tup(pad or 0, nd))
    # uint8 inputs hop onto the int8 lattice first: the contraction takes
    # int8 operands
    data, ds = _to_s8_lattice(data, min_data, max_data)
    ws = _sym_scale(_scalar(min_weight, data), _scalar(max_weight, data))
    channel_last = layout in _CHANNEL_LAST
    x, w = data, weight
    if channel_last:
        x, w = x.movedim(-1, 1), w.movedim(-1, 1)
    if lowering(x) == "native":
        acc = int8_conv(x, w, stride_, pad_, dilate_, num_group)
    else:
        with cudnn_fp32():
            acc = _acc_finish(_CONV[nd](
                x.to(torch.float32), w.to(torch.float32), None, stride_,
                pad_, dilate_, num_group))
    if channel_last:
        acc = acc.movedim(1, -1).contiguous()
    if bias is not None and not no_bias:
        bshape = ((1,) * (nd + 1) + (-1,)) if channel_last \
            else ((1, -1) + (1,) * nd)
        acc = acc + _bias_codes(bias, ds * ws).reshape(bshape)
    # the encode rule shared with ``requantize``: real = acc * amax /
    # (127 * 127), so amax = 127 * 127 * ds * ws decodes to acc * ds * ws
    omax = 127.0 * 127.0 * ds * ws
    return acc, -omax, omax


@register(differentiable=False)
def _contrib_quantized_fully_connected(data, weight, min_data=None,
                                       max_data=None, min_weight=None,
                                       max_weight=None, bias=None,
                                       min_bias=None, max_bias=None,
                                       num_hidden=0, no_bias=False,
                                       flatten=True):
    """Reference: quantization/quantized_fully_connected.cc — int8
    product accumulating int32, the bias on the int32 lattice. Under
    ``native`` on a CUDA tensor the product is ``torch._int_mm``."""
    from ..kernels.int8_conv import int8_mm

    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    data, ds = _to_s8_lattice(data, min_data, max_data)
    ws = _sym_scale(_scalar(min_weight, data), _scalar(max_weight, data))
    if lowering(data) == "native":
        lead = data.shape[:-1]
        acc = int8_mm(data.reshape(-1, data.shape[-1]), weight.t())
        acc = acc.reshape(tuple(lead) + (weight.shape[0],))
    else:
        with _matmul_fp32(data):
            acc = _acc_finish(torch.matmul(data.to(torch.float32),
                                           weight.to(torch.float32).t()))
    if bias is not None and not no_bias:
        acc = acc + _bias_codes(bias, ds * ws)
    omax = 127.0 * 127.0 * ds * ws
    return acc, -omax, omax


@register(differentiable=False)
def _contrib_quantized_batch_dot(lhs, rhs, min_lhs=None, max_lhs=None,
                                 min_rhs=None, max_rhs=None,
                                 transpose_a=False, transpose_b=False):
    """Quantized batched product (reference: the quantized_batch_dot
    MKLDNN op; float semantics of dot.cc batch_dot). Both operands are
    activations; int8 x int8 accumulating int32 under ``native`` (on a
    CUDA tensor through :func:`~mxnet_tpu_torch.kernels.int8_conv.
    int8_batch_mm`), with the conv/fc encode rule amax = 127 * 127 *
    ls * rs."""
    from ..kernels.int8_conv import int8_batch_mm

    lhs, ls = _to_s8_lattice(lhs, min_lhs, max_lhs)
    rhs, rs = _to_s8_lattice(rhs, min_rhs, max_rhs)
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    if lowering(lhs) == "native":
        acc = int8_batch_mm(lhs, rhs)
    else:
        with _matmul_fp32(lhs):
            acc = _acc_finish(torch.matmul(lhs.to(torch.float32),
                                           rhs.to(torch.float32)))
    omax = 127.0 * 127.0 * ls * rs
    return acc, -omax, omax


@register(differentiable=False)
def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """Reference: quantization/calibrate.cc (_contrib_calibrate_entropy)
    — the KL-threshold search as an op. It runs on the host (a loop that
    depends on the data) and returns (min, max) of the optimal range."""
    from ..contrib.quantization import calib_entropy

    t = calib_entropy(onp.asarray(hist.cpu()), onp.asarray(hist_edges.cpu()),
                      int(num_quantized_bins))
    return _const(-t, hist), _const(t, hist)
