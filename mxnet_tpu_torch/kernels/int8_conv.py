"""The int8 convolution N2 and the int8 products of the quantized ops.

``_contrib_quantized_conv`` (``ndarray/ops_quant.py``) convolves int8
data with int8 weights into int32 accumulators. The JAX op leaves that to
XLA (``lax.conv_general_dilated(..., preferred_element_type=int32)``,
``mxnet_tpu/ndarray/ops_quant.py:341-346``); PyTorch has no int8 x int8
-> int32 convolution on CUDA, so here:

- :func:`int8_conv` is the wrapper of N2, an implicit GEMM (M = N * Ho *
  Wo output pixels, N = O / groups filters, K = C / groups * kh * kw)
  accumulating in int32, in two kernels that :func:`_int8_conv_route`
  picks between from dtypes and shapes. ``"sm90"``,
  ``csrc/int8_conv_sm90.cu``, for one group with C and O multiples of 16:
  ``wgmma`` s8 on NHWC activations and OHWI weights (K ordered (r, s,
  c)), every tile loaded by TMA through an mbarrier ring (128 consecutive
  pixels for a 1 x 1 at stride 1, else a spatial tile per tap, the
  padding read as zeros), on a persistent grid whose tiles, tile width
  and K splits :func:`_sm90_plan` sets. Its operands come from one launch
  of the same file's transpose kernel, ``int8_to_nhwc``
  (:func:`_sm90_operands`, :func:`_to_nhwc`), where x is not
  channels-last or w not 1 x 1. ``"mma"``, ``csrc/int8_conv.cu``, for the
  rest (grouped, other C, the stem's 3 channels): blocks that gather the
  NCHW im2col tile and the OIHW weight tile into shared memory and
  multiply them with ``mma.sync`` m16n8k32. N2 is not a port of a Pallas
  kernel: the JAX package has none on this path.
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

__all__ = ["KERNEL", "SM90_KERNEL", "NHWC_KERNEL", "INT_MM", "int8_conv", "_int8_conv_ref",
           "_int8_conv_route", "_sm90_plan", "_sm90_operands", "int8_mm",
           "_int8_mm_ref", "int8_batch_mm", "conv_output_shape"]

KERNEL = "int8_conv"  # N2: counts every launch, either route
SM90_KERNEL = "int8_conv_sm90"  # N2's launches on the sm90 route
NHWC_KERNEL = "int8_to_nhwc"  # the sm90 route's layout copies
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


@functools.lru_cache(maxsize=None)
def _sm90_entry():
    fn = _build.load(SM90_KERNEL).mxtt_int8_conv_sm90
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 22 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _nhwc_entry():
    fn = _build.load(SM90_KERNEL).mxtt_int8_to_nhwc
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4) * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _n_sm(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- the sm90 route: what the wrapper hands csrc/int8_conv_sm90.cu ----------

_SM90_BM = 128  # output pixels per tile
_SM90_BK = 128  # bytes of C per k-tile (one tap)
_SM90_CH = 16  # C and O multiples of this: TMA's 16-byte strides
# the sm90 plan's cost model, in bytes a block moves: a fixed cost per
# work item, and the weight of an output byte stored (atomically added
# where K is split)
_SM90_ITEM_BYTES = 16384
_SM90_STORE_WEIGHT, _SM90_ATOMIC_WEIGHT = 2, 8


def _int8_conv_route(x, w, groups, stride=(1,)):
    """Which N2 kernel takes int8 data ``x`` (N, C, ...) and weights ``w``
    (O, C/groups, ...) at ``stride`` on the card: ``"sm90"``
    (``csrc/int8_conv_sm90.cu``) for a 1-D or 2-D convolution of one group
    whose C and O are multiples of 16, with strides up to 8 (TMA's element
    strides) and sizes within the kernel's int32 indexing; ``"mma"``
    (``csrc/int8_conv.cu``) for everything else: grouped convolutions
    (``int8_batch_mm``'s included) and other C. The stem's 3 channels
    stay on "mma": padded with zero channels to 16, the sm90 kernel takes
    over six times mma's time at resnet50_v1's stem (``chip_smoke.py``
    phase 48 times both in turns; PERF.md). A variant chosen from dtypes
    and shapes, not a fallback;
    alignment is the wrapper's to give (it copies an operand that does
    not start on 16 bytes)."""
    if x.dtype != torch.int8 or w.dtype != torch.int8 or \
            x.dim() not in (3, 4) or w.dim() != x.dim() or groups != 1 or \
            max(stride) > 8:
        return "mma"
    C, O = x.shape[1], w.shape[0]
    if C % _SM90_CH or O % _SM90_CH or C < 1 or O < 1 or \
            x.numel() // C >= 2 ** 31 or w[0, 0].numel() * C >= 2 ** 17:
        return "mma"
    return "sm90"


def _sm90_channels(C):
    """C as the sm90 kernel reads it: padded with zero channels to 16."""
    return C if C % _SM90_CH == 0 else _round_up(C, _SM90_CH)


def _to_nhwc_ref(t, Cp):
    """Plain version of :func:`_to_nhwc`."""
    N, C, H, W = t.shape
    out = t.new_zeros((N, H, W, Cp))
    out[..., :C] = t.permute(0, 2, 3, 1)
    return out


def _to_nhwc(*jobs):
    """Each ``(t, Cp)`` of ``jobs`` (one or two), ``t`` a contiguous int8
    (N, C, H, W), as a fresh contiguous (N, H, W, Cp), channels C .. Cp - 1
    zero (Cp a multiple of 16). On CPU tensors the plain version; on CUDA
    tensors one launch of the transpose kernel of
    ``csrc/int8_conv_sm90.cu`` for all of them, or it raises. Returns a
    list."""
    if jobs[0][0].device.type == "cpu":
        return [_to_nhwc_ref(t, Cp) for t, Cp in jobs]
    outs = [torch.empty((t.shape[0], t.shape[2], t.shape[3], Cp),
                        dtype=torch.int8, device=t.device) for t, Cp in jobs]
    args = []
    for (t, Cp), out in zip(jobs, outs):
        N, C, H, W = t.shape
        args += [t.data_ptr(), out.data_ptr(), N, C, H * W, Cp]
    if len(jobs) == 1:
        args += [None, None, 0, 0, 0, 0]
    dev = jobs[0][0].device
    with torch.cuda.device(dev):
        err = _nhwc_entry()(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"int8_conv: NHWC copy of "
                         f"{[tuple(t.shape) for t, _ in jobs]} failed with "
                         f"CUDA error {err}")
    _build.count_launch(NHWC_KERNEL)
    return outs


def _sm90_operands(x, w):
    """The sm90 kernel's operands of ``x`` (N, C, H, W) and ``w`` (O, C,
    kh, kw): x as NHWC and w as OHWI, the (O, kh * kw * C) matrix with K
    ordered (r, s, c), C below 16 padded with zero channels in both
    (which adds nothing to any sum). A channels-last x and a 1 x 1 OIHW
    weight (which is OHWI) are read in place; anything else goes through
    one :func:`_to_nhwc`. Returns (x (N, H, W, C), w (O, kh, kw, C), C),
    both contiguous."""
    C = x.shape[1]
    KH, KW = w.shape[2:]
    Cp = _sm90_channels(C)
    ops, jobs = {}, []
    if Cp == C and x.is_contiguous(memory_format=torch.channels_last):
        ops["x"] = x.permute(0, 2, 3, 1)
    else:
        jobs.append(("x", x.contiguous()))
    if Cp == C and KH * KW == 1 and w.is_contiguous():
        ops["w"] = w.permute(0, 2, 3, 1)
    else:
        jobs.append(("w", w.contiguous()))
    if jobs:  # one launch for both copies
        ops.update(zip((k for k, _ in jobs),
                       _to_nhwc(*((t, Cp) for _, t in jobs))))
    return ops["x"], ops["w"], Cp


def _sm90_tile(N, Ho, Wo, stride):
    """The spatial pixel tile (images, rows, columns) of the sm90 kernel:
    at most 128 output pixels, up to 32 columns of an output row, as many
    rows as fit, and whole images side by side where one fits twice (the
    7 x 7 layers); its TMA box spans columns and rows times the stride,
    at most 256 each."""
    wt = min(Wo, 32, 256 // stride[1])
    ht = min(Ho, _SM90_BM // wt, 256 // stride[0])
    nt = 1
    if ht == Ho and wt == Wo:
        nt = max(1, min(N, _SM90_BM // (Ho * Wo), 256))
    return nt, ht, wt


def _sm90_plan(x_shape, w_shape, stride, pad, dilate, n_sm, bn=None,
               splits=None):
    """The launch of the sm90 kernel for a convolution of ``x_shape`` (N,
    C, H, W) with ``w_shape`` (O, C, kh, kw) on a card of ``n_sm`` SMs:

    - ``flat``: a 1 x 1 convolution at stride 1 without padding takes its
      pixel tiles as 128 consecutive pixels of the (N * H * W, C) matrix;
      every other one takes spatial tiles (``tile``: images, rows,
      columns; :func:`_sm90_tile`), A loaded per tap;
    - ``k_tiles``: kh * kw taps times the 128-byte blocks of C;
    - ``bn`` (filters per tile: 64, 128, 256) and ``splits`` (parts of K,
      1, 2 or 4, each at least 4 k-tiles, added with atomics into a zeroed
      output): the pair that minimizes a cost model of the busiest
      block, waves of work items times the bytes an item moves (its
      k-tiles' A and B boxes, its output, weighted, and a fixed cost);
    - ``grid``: one block per SM, or per work item where there are fewer.

    ``bn`` and ``splits`` may be given (tools, tests)."""
    N, C, H, W = x_shape
    O, _, KH, KW = w_shape
    _, _, Ho, Wo = conv_output_shape(x_shape, w_shape, stride, pad, dilate)
    Cp = _sm90_channels(C)
    cblocks = -(-Cp // _SM90_BK)
    k_tiles = KH * KW * cblocks
    M = N * Ho * Wo
    flat = KH == 1 and KW == 1 and tuple(stride) == (1, 1) and \
        tuple(pad) == (0, 0)
    if flat:
        tile, rows = None, _SM90_BM
        m_tiles = -(-M // _SM90_BM)
    else:
        tile = _sm90_tile(N, Ho, Wo, stride)
        nt, ht, wt = tile
        rows = nt * ht * wt
        m_tiles = -(-Wo // wt) * -(-Ho // ht) * -(-N // nt)

    def cost(b, s):
        items = m_tiles * -(-O // b) * s
        store = _SM90_STORE_WEIGHT if s == 1 else _SM90_ATOMIC_WEIGHT
        item = (-(-k_tiles // s) * (rows + b) * _SM90_BK
                + store * _SM90_BM * b * 4 + _SM90_ITEM_BYTES)
        return -(-items // n_sm) * item

    bns = [bn] if bn is not None else \
        [b for b in (64, 128, 256) if b == 64 or O > b // 2]
    sps = [splits] if splits is not None else \
        [s for s in (1, 2, 4) if s == 1 or k_tiles // s >= 4]
    if any(b not in (64, 128, 256) for b in bns) or \
            any(not 1 <= s <= k_tiles for s in sps):
        raise MXNetError(f"int8_conv: no sm90 plan with bn={bn}, "
                         f"splits={splits} at {k_tiles} k-tiles")
    bn, splits = min(((b, s) for b in bns for s in sps),
                     key=lambda bs: cost(*bs))
    items = m_tiles * -(-O // bn) * splits
    return {"C": Cp, "Ho": Ho, "Wo": Wo, "M": M, "flat": flat,
            "tile": tile, "rows": rows, "k_tiles": k_tiles,
            "m_tiles": m_tiles, "n_tiles": -(-O // bn), "bn": bn,
            "splits": splits, "items": items, "grid": min(items, n_sm)}


def _aligned(t):
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _int8_conv_sm90(x, w, stride, pad, dilate, plan=None):
    """Launch the sm90 kernel on 2-D int8 ``x``, ``w`` (the route's
    checks done); ``plan`` overrides :func:`_sm90_plan`'s (tools)."""
    dev = x.device
    N, _, H, W = x.shape
    O, _, KH, KW = w.shape
    if plan is None:
        plan = _sm90_plan(x.shape, w.shape, stride, pad, dilate,
                          _n_sm(dev.index if dev.index is not None
                                else torch.cuda.current_device()))
    xh, wh, Cp = _sm90_operands(x, w)
    xh, wh = _aligned(xh), _aligned(wh)
    shape = (N, O, plan["Ho"], plan["Wo"])
    y = torch.zeros(shape, dtype=torch.int32, device=dev) \
        if plan["splits"] > 1 else \
        torch.empty(shape, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _sm90_entry()(
            xh.data_ptr(), wh.data_ptr(), y.data_ptr(), N, Cp, H, W, O, KH,
            KW, plan["Ho"], plan["Wo"], stride[0], stride[1], pad[0],
            pad[1], dilate[0], dilate[1], plan["bn"], plan["splits"],
            int(plan["flat"]), *(plan["tile"] or (1, 1, 1)), plan["grid"],
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"int8_conv: sm90 kernel launch failed with CUDA "
                         f"error {err}")
    _build.count_launch(KERNEL)
    _build.count_launch(SM90_KERNEL)
    return y


def _one_device(name, *ts):
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise MXNetError(f"{name}: inputs on several devices {devs}")
    return devs.pop()


def int8_conv(x, w, stride, pad, dilate, groups=1, route=None):
    """N2: the int32 convolution of int8 data ``x`` (N, C, H, W) — or
    (N, C, W) — with int8 weights ``w`` (O, C/groups, kh, kw), NCHW and
    OIHW, at ``stride``, ``pad`` (symmetric) and ``dilate``; the contract
    of :func:`_int8_conv_ref`. The result is a fresh NCHW-contiguous
    int32 tensor.

    On CPU tensors this is the plain version; on meta tensors an empty
    result. On CUDA tensors it launches N2 on the current stream without
    synchronizing, or raises: int8 operands on one device, 1-D or 2-D,
    C and O divisible by ``groups``. The kernel is
    :func:`_int8_conv_route`'s choice; ``route`` (``"sm90"`` or
    ``"mma"``) names it instead, for the tests and the timing tools, and
    raises where the sm90 kernel cannot take the inputs. On the mma
    route non-contiguous operands are copied, and so are weights whose
    16-byte rows (K a multiple of 16) do not start on a 16-byte
    boundary, which the kernel reads as vectors. Every launch counts
    once under ``KERNEL``; a launch of the sm90 kernel also counts under
    ``SM90_KERNEL``."""
    dev = _one_device("int8_conv", x, w)
    nd = x.dim() - 2
    stride, pad, dilate = tuple(stride), tuple(pad), tuple(dilate)
    if route not in (None, "sm90", "mma"):
        raise MXNetError(f"int8_conv: unknown route {route!r}")
    if route == "sm90" and _int8_conv_route(x, w, groups, stride) != "sm90":
        raise MXNetError("int8_conv: route 'sm90' cannot take data "
                         f"{tuple(x.shape)} {x.dtype}, weight "
                         f"{tuple(w.shape)} {w.dtype}, groups={groups} (the "
                         "rule gives 'mma')")
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
                         (0,) + pad, (1,) + dilate, groups, route)[:, :, 0]
    N, C, H, W = x.shape
    O, Cg, KH, KW = w.shape
    if groups < 1 or C % groups or O % groups or Cg != C // groups:
        raise MXNetError(f"int8_conv: data {tuple(x.shape)} and weight "
                         f"{tuple(w.shape)} do not fit groups={groups}")
    out_shape = conv_output_shape(x.shape, w.shape, stride, pad, dilate)
    Ho, Wo = out_shape[2:]
    if Ho < 1 or Wo < 1:
        raise MXNetError(f"int8_conv: empty output {out_shape}")
    if N == 0 or O == 0:
        return torch.empty(out_shape, dtype=torch.int32, device=dev)
    if route is None:
        route = _int8_conv_route(x, w, groups, stride)
    if route == "sm90":
        return _int8_conv_sm90(x, w, stride, pad, dilate)
    x = x.contiguous()
    w = w.contiguous()
    K = Cg * KH * KW
    vec_b = K % 16 == 0
    if vec_b and w.data_ptr() % 16:
        w = w.clone()
    y = torch.empty(out_shape, dtype=torch.int32, device=dev)
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
