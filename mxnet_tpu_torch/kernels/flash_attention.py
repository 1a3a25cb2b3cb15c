"""Flash attention: the CUDA kernels K1 and K2 and their plain versions.

The PyTorch counterpart of ``mxnet_tpu/kernels/flash_attention.py``.

Training half (K1): :func:`flash_attention` is scaled dot-product
attention over (B, H, S, D) tensors, with the JAX function's contract
(``flash_attention.py:251-272``): optional bottom-right-aligned causal
mask, ``sm_scale`` defaulting to ``1/sqrt(D)``. Its forward is
:func:`_flash_fwd_cuda`, the wrapper of two hand-written ports of the
TPU kernel ``_fa_kernel`` (``flash_attention.py:48-134``), or
:func:`_flash_ref`, their plain version. Which kernel takes a call is
:func:`_flash_route`'s rule on dtypes, shapes, strides and pointers:
bf16 q, k and v at D = 64 that TMA can read go to
``csrc/flash_attention_sm90.cu`` (wgmma fed by TMA, P kept to fp32
accuracy in two bf16 passes); everything else, fp32 included, to
``csrc/flash_attention.cu`` (``mma.sync``; fp32 products in 3xTF32,
which keeps fp32's accuracy). Its backward is :func:`_flash_bwd`, the
q-chunk recompute of ``flash_attention.py:206-245`` in torch; the JAX
package has no backward kernel, so neither has the port.

Decode half (K2): one query row per (batch, head) attends against its
KV cache, masked to a per-row visible length. :func:`_decode_flash` is
the wrapper of ``csrc/decode_attention.cu`` (the port of ``_dec_kernel``,
``flash_attention.py:137-191``); :func:`_decode_flash_ref` is its plain
version. Unlike the TPU path, both take the caches in the decoder's own
layout, (B, S, H, D), so no transpose copy precedes the call. The
kernel splits each row's key sweep over several blocks as
:func:`_decode_splits` plans it, and combines their partial softmaxes.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "_flash_ref", "_flash_fwd_cuda", "_flash_bwd",
           "_flash_load_width", "_flash_route",
           "_decode_flash", "_decode_flash_ref", "_decode_splits"]

_NEG = -1e30
_MAX_D = 256
KERNEL = "decode_attention"  # K2
FLASH_KERNEL = "flash_attention"  # K1: counts every launch, either route
FLASH_SM90_KERNEL = "flash_attention_sm90"  # K1's launches on the sm90 route
_SM90_D = 64  # the head width of the sm90 route
_BWD_CHUNK = 512
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# -- training half: K1 ------------------------------------------------------

def _flash_ref(q, k, v, sm_scale, causal):
    """Plain version of K1: q (B, H, S_q, D) against k, v (B, H, S_k, D).
    The arithmetic of the JAX package's ``_ref_attention``
    (``flash_attention.py:29-45``): fp32 scores, keys masked with -1e30
    (bottom-right causal alignment: query row i sits at i + S_k - S_q),
    softmax in fp32, then the weights cast to v's dtype."""
    S_q, S_k = q.shape[2], k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * float(sm_scale)
    if causal:
        kid = torch.arange(S_k, device=q.device)[None, :]
        qid = torch.arange(S_q, device=q.device)[:, None] + (S_k - S_q)
        s = torch.where(kid <= qid, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


@functools.lru_cache(maxsize=None)
def _flash_entry():
    fn = _build.load(FLASH_KERNEL).mxtt_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _flash_load_width(k, v):
    """Bytes per copy of K1's K/V tiles into shared memory: 16 where every
    row start of k and v (base pointer and (b, h, s) strides) and the row
    length are 16-byte aligned, else 4 where they are 4-byte aligned, else
    the element size (bf16 rows of odd length or odd strides, read
    element by element). A variant chosen from dtypes, shapes and
    strides, not a fallback."""
    size = k.element_size()
    row = k.shape[3] * size
    for width in (16, 4):
        if row % width == 0 and all(
                t.data_ptr() % width == 0 and
                all(t.stride(i) * size % width == 0 for i in range(3))
                for t in (k, v)):
            return width
    return size


@functools.lru_cache(maxsize=None)
def _flash_sm90_entry():
    fn = _build.load(FLASH_SM90_KERNEL).mxtt_flash_attention_sm90_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _flash_route(q, k, v):
    """Which K1 kernel takes (q, k, v) on the card: ``"sm90"``
    (``csrc/flash_attention_sm90.cu``) for bfloat16 q, k and v with
    D = 64, contiguous in D, whose base pointers are 16-byte aligned and
    whose (b, h, s) strides are positive whole 16-byte steps: what TMA
    can read in place, the model's q/k/v views of one fused projection
    included. ``"mma"`` (``csrc/flash_attention.cu``) for everything
    else. A variant chosen from dtypes, shapes, strides and pointers,
    like :func:`_flash_load_width`; not a fallback."""
    if any(t.dtype != torch.bfloat16 or t.dim() != 4 or
           t.shape[3] != _SM90_D or t.stride(3) != 1 for t in (q, k, v)):
        return "mma"
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(
                s <= 0 or (s * 2) % 16 or s * 2 >= 2 ** 40
                for s in t.stride()[:3]):
            return "mma"
    return "sm90"


def _flash_fwd_cuda(q, k, v, sm_scale, causal, route=None):
    """K1: the attention forward, same contract as :func:`_flash_ref`;
    returns a fresh contiguous (B, H, S_q, D) tensor of q's dtype.

    On CPU tensors this is the plain version; on meta tensors an empty
    result (shape inference). On CUDA tensors it launches the K1 kernel
    on the current stream, without synchronizing, or raises: q, k and v
    must be float32 or bfloat16 alike, on one device, 4-d with matching
    (B, H, D), D <= 256 and contiguous (the other axes may be strided:
    views of one fused qkv are read in place), and ``causal`` needs
    S_q <= S_k. The kernel is :func:`_flash_route`'s choice; ``route``
    (``"sm90"`` or ``"mma"``) names it instead, for the tests and the
    timing tools, and raises where the sm90 kernel cannot take the
    inputs. On the mma route, K/V rows that are not 16-byte aligned are
    copied into shared memory in narrower pieces
    (:func:`_flash_load_width`). Every launch counts once under
    ``FLASH_KERNEL``; a launch of the sm90 kernel also counts under
    ``FLASH_SM90_KERNEL``."""
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise MXNetError(f"_flash_fwd_cuda: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return _flash_ref(q, k, v, sm_scale, causal)
    if dev.type == "meta":
        return q.new_empty(tuple(q.shape[:3]) + (v.shape[3],))
    if dev.type != "cuda":
        raise MXNetError(f"_flash_fwd_cuda: unsupported device {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise MXNetError(
            f"_flash_fwd_cuda: q, k, v must be (B, H, S, D), k and v alike; "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S_q, D = q.shape
    S_k = k.shape[2]
    if k.shape[:2] != q.shape[:2] or k.shape[3] != D:
        raise MXNetError(f"_flash_fwd_cuda: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if q.dtype not in _FLASH_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise MXNetError(
            "_flash_fwd_cuda: the kernel takes float32 or bfloat16 q, k, v "
            f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 0 < D <= _MAX_D:
        raise MXNetError(f"_flash_fwd_cuda: head dim {D} not in [1, {_MAX_D}]")
    if min(B, H, S_q, S_k) < 1 or max(B, H) > 65535:
        raise MXNetError(f"_flash_fwd_cuda: unsupported shape q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise MXNetError("_flash_fwd_cuda: the head dim (last axis) of q, k "
                         "and v must be contiguous")
    if causal and S_q > S_k:
        raise MXNetError(f"_flash_fwd_cuda: causal needs S_q <= S_k, got "
                         f"S_q={S_q} S_k={S_k}")
    chosen = _flash_route(q, k, v)
    if route is None:
        route = chosen
    elif route not in ("sm90", "mma") or (route == "sm90" and
                                          chosen != "sm90"):
        raise MXNetError(f"_flash_fwd_cuda: route {route!r} cannot take "
                         f"these inputs (the rule gives {chosen!r})")
    out = torch.empty((B, H, S_q, D), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        strides = (ctypes.c_longlong * 9)(
            *(t.stride(i) for t in (q, k, v) for i in range(3)))
        if route == "sm90":
            err = _flash_sm90_entry()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, S_q, S_k, ctypes.cast(strides, ctypes.c_void_p),
                float(sm_scale), int(bool(causal)), stream)
        else:
            err = _flash_entry()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _FLASH_DTYPES[q.dtype], B, H, S_q, S_k, D,
                ctypes.cast(strides, ctypes.c_void_p), float(sm_scale),
                int(bool(causal)), stream, _flash_load_width(k, v))
    if err:
        raise MXNetError(f"_flash_fwd_cuda: kernel launch failed with CUDA "
                         f"error {err} ({route} route)")
    _build.count_launch(FLASH_KERNEL)
    if route == "sm90":
        _build.count_launch(FLASH_SM90_KERNEL)
    return out


def _flash_bwd(q, k, v, do, sm_scale, causal):
    """Gradients (dq, dk, dv) of the attention at (q, k, v) for the
    output gradient ``do``: the JAX package's q-chunk recompute
    (``_flash_bwd``, ``flash_attention.py:206-245``) in torch. Chunks of
    ``min(512, S_q)`` query rows recompute their softmax in fp32 against
    all keys, so the extra memory is O(chunk * S_k), never S_q * S_k."""
    S_q, S_k = q.shape[2], k.shape[2]
    kf, vf = k.float(), v.float()
    chunk = min(_BWD_CHUNK, S_q)
    off = S_k - S_q  # bottom-right causal alignment
    kid = torch.arange(S_k, device=q.device)[None, :]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for c0 in range(0, S_q, chunk):
        qb = q[:, :, c0:c0 + chunk].float()
        dob = do[:, :, c0:c0 + chunk].float()
        s = torch.matmul(qb, kf.transpose(-1, -2)) * sm_scale
        if causal:
            qid = c0 + torch.arange(qb.shape[2], device=q.device)[:, None] \
                + off
            s = torch.where(kid <= qid, s, torch.full_like(s, _NEG))
        p = torch.softmax(s, dim=-1)
        dv += torch.matmul(p.transpose(-1, -2), dob)
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, :, c0:c0 + chunk] = torch.matmul(ds, kf) * sm_scale
        dk += torch.matmul(ds.transpose(-1, -2), qb) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Ties the forward (K1 or its plain version) to the recompute
    backward, as ``jax.custom_vjp`` ties ``_flash`` to ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, use_kernel):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        if use_kernel:
            return _flash_fwd_cuda(q, k, v, sm_scale, causal)
        return _flash_ref(q, k, v, sm_scale, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, do, ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, sm_scale=None, causal=False, use_kernel=None):
    """Scaled dot-product attention over (B, H, S, D) tensors,
    differentiable in q, k and v.

    ``use_kernel``: None (the default) launches K1 on CUDA tensors and
    runs the plain version on CPU tensors; True always goes through the
    K1 wrapper (which itself takes the plain version only for CPU
    tensors); False runs the plain version. The backward is always the
    recompute :func:`_flash_bwd`. ``causal`` with S_q > S_k raises
    ``ValueError``, as the JAX function does: rows with no visible key
    would come out as an unnormalized average of V."""
    if causal and q.shape[-2] > k.shape[-2]:
        raise ValueError(
            "flash_attention(causal=True) requires S_q <= S_k, got "
            f"S_q={q.shape[-2]} S_k={k.shape[-2]}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    return _FlashAttention.apply(q, k, v, float(sm_scale), bool(causal),
                                 bool(use_kernel))


# -- decode half: K2 --------------------------------------------------------


def _decode_flash_ref(q, k, v, lengths, sm_scale):
    """Plain version: q (B, H, D) against k, v (B, S, H, D), masked to
    positions ``< lengths`` (B,). The arithmetic of the JAX package's
    ``_attention_decode(impl="lax")`` (``attention.py:119-128``): fp32
    einsum, mask with -1e30, softmax, einsum."""
    B, S = k.shape[:2]
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * float(sm_scale)
    mask = torch.arange(S, device=k.device)[None, None, :] < \
        lengths.reshape(B, 1, 1)
    s = torch.where(mask, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p.to(v.dtype), v)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load(KERNEL).mxtt_decode_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
        [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


_MIN_CHUNK = 64  # keys per block of K2's split sweep, at least
_CHUNK_ALIGN = 64  # a block's eight warps take 8 keys each per step


def _decode_splits(B, H, S, n_sm):
    """K2's split of the key sweep, from shapes alone (never from
    ``lengths``, which lies on the device): ``(splits, chunk)`` such that
    block c of each (b, h) sweeps keys [c*chunk, (c+1)*chunk) of [0, S).
    It aims at B*H*splits >= 2 blocks per SM with chunks of at least 64
    keys (a multiple of 64): 16 splits at B = 1, H = 12, S = 1024 on 132
    SMs, 3 at B = 8, 1 at B = 32."""
    want = -(-2 * n_sm // (B * H))
    if want <= 1:
        return 1, S
    chunk = max(_MIN_CHUNK, -(-S // want))
    chunk = -(-chunk // _CHUNK_ALIGN) * _CHUNK_ALIGN
    splits = -(-S // chunk)
    return splits, (chunk if splits > 1 else S)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_flash(q, k, v, lengths, sm_scale):
    """One decode step of attention, same contract as
    :func:`_decode_flash_ref`; returns (B, H, D).

    On CPU tensors this is the plain version. On CUDA tensors it
    launches the K2 kernel on the current stream, without synchronizing,
    or raises: inputs must be float32 (``lengths`` int32), contiguous,
    on one device, with D <= 256. The key sweep runs in the blocks that
    :func:`_decode_splits` plans; when it is split, a second kernel
    combines the blocks' partials, and the call still counts as one
    launch of K2."""
    devs = {t.device for t in (q, k, v, lengths)}
    if len(devs) != 1:
        raise MXNetError(f"_decode_flash: inputs on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return _decode_flash_ref(q, k, v, lengths, sm_scale)
    if dev.type != "cuda":
        raise MXNetError(f"_decode_flash: unsupported device {dev}")
    if k.dim() != 4 or v.shape != k.shape:
        raise MXNetError(f"_decode_flash: k, v must be (B, S, H, D) alike, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = k.shape
    if tuple(q.shape) != (B, H, D) or tuple(lengths.shape) != (B,):
        raise MXNetError(
            f"_decode_flash: q {tuple(q.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match k {tuple(k.shape)}")
    if q.dtype != torch.float32 or k.dtype != torch.float32 or \
            v.dtype != torch.float32 or lengths.dtype != torch.int32:
        raise MXNetError(
            "_decode_flash: the kernel takes float32 q, k, v and int32 "
            f"lengths, got {q.dtype}, {k.dtype}, {v.dtype}, "
            f"{lengths.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise MXNetError("_decode_flash: inputs must be contiguous")
    if D > _MAX_D:
        raise MXNetError(f"_decode_flash: head dim {D} > {_MAX_D}")
    out = torch.empty_like(q)
    splits, chunk = _decode_splits(B, H, S, _sm_count(dev.index))
    # the blocks' partial (m, l, acc[D]) when the sweep is split
    partial = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                          device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), B, H, S, D,
                       float(sm_scale),
                       torch.cuda.current_stream(dev).cuda_stream,
                       None if partial is None else partial.data_ptr(),
                       splits, chunk)
    if err:
        raise MXNetError(f"_decode_flash: kernel launch failed with CUDA "
                         f"error {err}")
    _build.count_launch(KERNEL)
    return out
