"""The int8 convolution N2 and the int8 products of the quantized ops.

``_contrib_quantized_conv`` (``ndarray/ops_quant.py``) convolves int8
data with int8 weights into int32 accumulators. The JAX op leaves that to
XLA (``lax.conv_general_dilated(..., preferred_element_type=int32)``,
``mxnet_tpu/ndarray/ops_quant.py:341-346``); PyTorch has no int8 x int8
-> int32 convolution on CUDA, so here:

- :func:`int8_conv` is the wrapper of N2, ``csrc/int8_conv.cu``: an
  implicit GEMM (M = N * Ho * Wo output pixels, N = O / groups filters,
  K = C / groups * kh * kw) whose blocks gather the im2col tile and the
  weight tile into shared memory and multiply them with the int8 tensor
  cores (``mma.sync`` m16n8k32), accumulating in int32. N2 is not a port
  of a Pallas kernel: the JAX package has none on this path.
- :func:`_int8_conv_ref` is its plain version: a float64 convolution of
  the codes, rounded and cast to int32. It is exact: every partial sum
  is an integer far below 2^53.

The int8 products (``_contrib_quantized_fully_connected``,
``QuantizedDense``) go to ``torch._int_mm`` (cuBLASLt's int8 GEMM) on
CUDA tensors, through :func:`int8_mm`, which pads the operands with zero
rows and columns to the shapes ``_int_mm`` takes (more than 16 rows, K
and N multiples of 8), which is exact in integers. A batched product
(:func:`int8_batch_mm`, ``_contrib_quantized_batch_dot``) is N2 as a
grouped 1 x 1 convolution, one group per batch entry, so one launch.

Each wrapper follows the port's rule: on a CPU tensor it runs the plain
version, on a ``meta`` tensor it returns an empty int32 result (so shape
inference sees through the quantized ops), on a CUDA tensor it launches
its kernel or raises :class:`MXNetError`. None syncs with the host, so a
captured graph can hold them.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build

__all__ = ["KERNEL", "INT_MM", "int8_conv", "_int8_conv_ref", "int8_mm",
           "_int8_mm_ref", "int8_batch_mm", "conv_output_shape"]

KERNEL = "int8_conv"  # N2
#: launch-count name of the ``torch._int_mm`` calls (a library kernel)
INT_MM = "int_mm"

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def conv_output_shape(x_shape, w_shape, stride, pad, dilate):
    """(N, O, *spatial out) of a convolution of ``x_shape`` (N, C, ...)
    with ``w_shape`` (O, C/g, *k)."""
    out = [x_shape[0], w_shape[0]]
    for i, (n, k) in enumerate(zip(x_shape[2:], w_shape[2:])):
        out.append((n + 2 * pad[i] - dilate[i] * (k - 1) - 1) // stride[i]
                   + 1)
    return tuple(out)


def _int8_conv_ref(x, w, stride, pad, dilate, groups):
    """Plain version of N2: the convolution of int8 ``x`` (N, C, ...) and
    ``w`` (O, C/groups, *k) as int32, through float64 (exact)."""
    nd = x.dim() - 2
    return torch.round(_CONV[nd](x.to(torch.float64), w.to(torch.float64),
                                 None, tuple(stride), tuple(pad),
                                 tuple(dilate), groups)).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load(KERNEL).mxtt_int8_conv
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _one_device(name, *ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise MXNetError(f"{name}: inputs on several devices {devs}")
    return devs.pop()


def int8_conv(x, w, stride, pad, dilate, groups=1):
    """N2: the int32 convolution of int8 data ``x`` (N, C, H, W) — or
    (N, C, W) — with int8 weights ``w`` (O, C/groups, kh, kw), NCHW and
    OIHW, at ``stride``, ``pad`` (symmetric) and ``dilate``; the contract
    of :func:`_int8_conv_ref`.

    On CPU tensors this is the plain version; on meta tensors an empty
    result. On CUDA tensors it launches N2 on the current stream without
    synchronizing, or raises: int8 operands on one device, 1-D or 2-D,
    C and O divisible by ``groups``. Non-contiguous operands are copied;
    so are weights whose 16-byte rows (K a multiple of 16) do not start
    on a 16-byte boundary, which the kernel reads as vectors."""
    dev = _one_device("int8_conv", x, w)
    nd = x.dim() - 2
    stride, pad, dilate = tuple(stride), tuple(pad), tuple(dilate)
    if dev.type == "cpu":
        return _int8_conv_ref(x, w, stride, pad, dilate, groups)
    if dev.type == "meta":
        return torch.empty(conv_output_shape(x.shape, w.shape, stride, pad,
                                             dilate),
                           dtype=torch.int32, device=dev)
    if dev.type != "cuda":
        raise MXNetError(f"int8_conv: unsupported device {dev}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise MXNetError(f"int8_conv: N2 takes int8 data and weights, got "
                         f"{x.dtype} and {w.dtype}")
    if nd not in (1, 2) or w.dim() != x.dim():
        raise MXNetError(f"int8_conv: N2 takes 1-D and 2-D convolutions, "
                         f"got data {tuple(x.shape)}, weight "
                         f"{tuple(w.shape)}")
    if nd == 1:  # a 1-D convolution is a 2-D one of height 1
        return int8_conv(x[:, :, None], w[:, :, None], (1,) + stride,
                         (0,) + pad, (1,) + dilate, groups)[:, :, 0]
    N, C, H, W = x.shape
    O, Cg, KH, KW = w.shape
    if groups < 1 or C % groups or O % groups or Cg != C // groups:
        raise MXNetError(f"int8_conv: data {tuple(x.shape)} and weight "
                         f"{tuple(w.shape)} do not fit groups={groups}")
    out_shape = conv_output_shape(x.shape, w.shape, stride, pad, dilate)
    Ho, Wo = out_shape[2:]
    if Ho < 1 or Wo < 1:
        raise MXNetError(f"int8_conv: empty output {out_shape}")
    x = x.contiguous()
    w = w.contiguous()
    K = Cg * KH * KW
    vec_b = K % 16 == 0
    if vec_b and w.data_ptr() % 16:
        w = w.clone()
    y = torch.empty(out_shape, dtype=torch.int32, device=dev)
    if y.numel() == 0:
        return y
    with torch.cuda.device(dev):
        err = _entry()(x.data_ptr(), w.data_ptr(), y.data_ptr(), N, C, H, W,
                       O, KH, KW, Ho, Wo, stride[0], stride[1], pad[0],
                       pad[1], dilate[0], dilate[1], groups, int(vec_b),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"int8_conv: kernel launch failed with CUDA error "
                         f"{err}")
    _build.count_launch(KERNEL)
    return y


# -- the int8 products -------------------------------------------------------

def _int8_mm_ref(a, b):
    """Plain version of :func:`int8_mm`: ``a @ b`` of int8 (M, K) and
    (K, N) as int32, through float64 (exact)."""
    return torch.round(a.to(torch.float64) @ b.to(torch.float64)).to(
        torch.int32)


def _round_up(n, m):
    return -(-n // m) * m


def _int_mm_shapes(M, K, N):
    """The padded (M, K, N) that ``torch._int_mm`` takes on CUDA: more
    than 16 rows, K and N positive multiples of 8."""
    return max(_round_up(M, 8), 24), max(_round_up(K, 8), 8), \
        max(_round_up(N, 8), 8)


def int8_mm(a, b):
    """``a @ b`` of int8 ``a`` (M, K) and ``b`` (K, N) as int32.

    On CPU tensors the plain version; on meta tensors an empty result.
    On CUDA tensors one ``torch._int_mm`` on operands padded with zero
    rows and columns where its shape rules need it (exact in integers),
    the result sliced back; ``b`` is passed column-major (the layout of a
    weight's transpose)."""
    dev = _one_device("int8_mm", a, b)
    M, K = a.shape
    N = b.shape[1]
    if dev.type == "cpu":
        return _int8_mm_ref(a, b)
    if dev.type == "meta":
        return torch.empty((M, N), dtype=torch.int32, device=dev)
    if dev.type != "cuda":
        raise MXNetError(f"int8_mm: unsupported device {dev}")
    if a.dtype != torch.int8 or b.dtype != torch.int8 or b.shape[0] != K:
        raise MXNetError(f"int8_mm: int8 (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} "
                         f"{b.dtype}")
    Mp, Kp, Np = _int_mm_shapes(M, K, N)
    if (Mp, Kp) != (M, K) or not a.is_contiguous():
        a = F.pad(a, (0, Kp - K, 0, Mp - M)) if (Mp, Kp) != (M, K) \
            else a.contiguous()
    bt = b.t()  # (N, K): row-major here is column-major b
    if (Np, Kp) != (N, K) or not bt.is_contiguous():
        bt = F.pad(bt, (0, Kp - K, 0, Np - N)) if (Np, Kp) != (N, K) \
            else bt.contiguous()
    try:
        out = torch._int_mm(a, bt.t())
    except RuntimeError as e:
        raise MXNetError(f"int8_mm: torch._int_mm failed at padded "
                         f"({Mp}, {Kp}) @ ({Kp}, {Np}): {e}") from e
    _build.count_launch(INT_MM)
    return out[:M, :N] if (Mp, Np) != (M, N) else out


def int8_batch_mm(a, b):
    """``a @ b`` of int8 ``a`` (..., M, K) and ``b`` (..., K, N) as int32.

    On CPU tensors the plain version; on meta tensors an empty result.
    On CUDA tensors one launch of N2 as a grouped 1 x 1 convolution: the
    data (1, B * K, M, 1) holds each batch entry's ``a`` transposed, the
    weight (B * N, K, 1, 1) each entry's ``b`` transposed, one group per
    entry."""
    dev = _one_device("int8_batch_mm", a, b)
    lead = a.shape[:-2]
    M, K = a.shape[-2:]
    N = b.shape[-1]
    if dev.type == "cpu":
        return _int8_mm_ref(a, b)
    if dev.type == "meta":
        return torch.empty(tuple(lead) + (M, N), dtype=torch.int32,
                           device=dev)
    if dev.type != "cuda":
        raise MXNetError(f"int8_batch_mm: unsupported device {dev}")
    if b.shape[:-2] != lead or b.shape[-2] != K:
        raise MXNetError(f"int8_batch_mm: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not fit")
    B = 1
    for d in lead:
        B *= int(d)
    x = a.reshape(B, M, K).transpose(1, 2).reshape(1, B * K, M, 1)
    w = b.reshape(B, K, N).transpose(1, 2).reshape(B * N, K, 1, 1)
    y = int8_conv(x, w, (1, 1), (0, 0), (1, 1), B)  # (1, B * N, M, 1)
    return y.reshape(B, N, M).transpose(1, 2).reshape(
        tuple(lead) + (M, N))
