"""Decode attention: the CUDA kernel K2 and its plain PyTorch version.

The decode half of ``mxnet_tpu/kernels/flash_attention.py``: one query
row per (batch, head) attends against its KV cache, masked to a
per-row visible length. :func:`_decode_flash` is the wrapper of the
hand-written kernel ``csrc/decode_attention.cu`` (the port of the TPU
kernel ``_dec_kernel``, ``flash_attention.py:137-191``);
:func:`_decode_flash_ref` is its plain version. The training half
(``_fa_kernel``, K1) comes with the transformer-training slice.

Unlike the TPU path, both functions take the caches in the decoder's
own layout, (B, S, H, D), so no transpose copy precedes the call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from . import _build

__all__ = ["_decode_flash", "_decode_flash_ref"]

_NEG = -1e30
_MAX_D = 256
KERNEL = "decode_attention"


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
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _decode_flash(q, k, v, lengths, sm_scale):
    """One decode step of attention, same contract as
    :func:`_decode_flash_ref`; returns (B, H, D).

    On CPU tensors this is the plain version. On CUDA tensors it
    launches the K2 kernel on the current stream, without synchronizing,
    or raises: inputs must be float32 (``lengths`` int32), contiguous,
    on one device, with D <= 256."""
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
    with torch.cuda.device(dev):
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       lengths.data_ptr(), out.data_ptr(), B, H, S, D,
                       float(sm_scale),
                       torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"_decode_flash: kernel launch failed with CUDA "
                         f"error {err}")
    _build.count_launch(KERNEL)
    return out
