"""The record decode on the card: nvJPEG and the crop kernel after it.

Where the machine has no libjpeg (``_native.decoder()`` says
``"nvjpeg"``), ``io.ImageRecordIter`` decodes each batch here: the CUDA
toolkit's nvJPEG decodes every JPEG at full size into the card's memory
(interleaved RGB), then the hand kernel ``jpeg_crop``
(``csrc/jpeg_decode.cu``) makes the (N, H, W, 3) uint8 batch with the
CPU route's resize-short, crop and mirror. Not a port of a TPU kernel:
the JAX package decodes on the host (``native/recordio.cc``).

:func:`crop_plan` computes each image's plan on the host exactly as
``decode_one`` (``csrc/recordio.cc``) does: libjpeg's DCT scale, the
resized size, the crop corner. :func:`_crop_ref` is the kernel's plain
version (the same float32 arithmetic, op by op), and :func:`jpeg_crop`
its wrapper: on CPU tensors the plain version, on a ``meta`` tensor an
empty result, on CUDA tensors the kernel (counted as :data:`KERNEL`) or
an error.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import threading

import numpy as onp
import torch

from ..base import MXNetError
from . import _build

__all__ = ["KERNEL", "SOURCE", "available", "crop_plan", "jpeg_crop",
           "_crop_ref", "decode_batch"]

KERNEL = "jpeg_crop"
SOURCE = "jpeg_decode"  # csrc/jpeg_decode.cu
_PLAN = 11  # offset, w, h, denom, sw, sh, tw, th, cy, cx, mirror


def _cuda_home():
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"


def available():
    """Whether this machine can decode on the card: a CUDA device, and
    the toolkit's ``nvjpeg.h`` and ``libnvjpeg``."""
    home = _cuda_home()
    return (torch.cuda.is_available()
            and os.path.exists(os.path.join(home, "include", "nvjpeg.h"))
            and bool(glob.glob(os.path.join(home, "lib64", "libnvjpeg.so*"))))


def crop_plan(sizes, H, W, resize_short, crops):
    """(n, 11) int64 plan rows for images of full size ``sizes`` [(w, h)]:
    [offset, w, h, denom, sw, sh, tw, th, cy, cx, mirror], the offsets
    of the images packed one after another as HWC uint8. ``crops`` rows
    are the iterator's (cy, cx, mirror): -1 for a center crop, else a
    fraction of the free space in 1/10000. Raises when an image is
    smaller than the crop."""
    plan = onp.zeros((len(sizes), _PLAN), dtype=onp.int64)
    off = 0
    for i, (w, h) in enumerate(sizes):
        denom = 1
        if resize_short > 0:
            short = min(w, h)
            while denom < 8 and short // (denom * 2) >= resize_short:
                denom *= 2
        sw, sh = -(-w // denom), -(-h // denom)
        tw, th = sw, sh
        if resize_short > 0:
            if sh < sw:
                th, tw = resize_short, sw * resize_short // sh
            else:
                tw, th = resize_short, sh * resize_short // sw
        if tw < W:
            th, tw = th * W // tw, W
        if th < H:
            tw, th = tw * H // th, H
        cy, cx, mirror = (int(v) for v in crops[i])
        cy = (th - H) // 2 if cy < 0 else cy * (th - H) // 10000
        cx = (tw - W) // 2 if cx < 0 else cx * (tw - W) // 10000
        cy, cx = min(cy, th - H), min(cx, tw - W)
        if cy < 0 or cx < 0:
            raise MXNetError(f"image {i} ({w} x {h}) is smaller than the "
                             f"crop ({W} x {H})")
        plan[i] = (off, w, h, denom, sw, sh, tw, th, cy, cx, mirror)
        off += w * h * 3
    return plan


def _scaled(img, denom, sw, sh):
    """libjpeg's 1/denom scale as the kernel takes it: the rounded mean of
    each denom x denom block (int32 sums)."""
    if denom == 1:
        return img.to(torch.float32)
    h, w = img.shape[:2]
    pad = torch.zeros((sh * denom, sw * denom, 3), dtype=torch.int32,
                      device=img.device)
    pad[:h, :w] = img.to(torch.int32)
    ones = torch.zeros((sh * denom, sw * denom), dtype=torch.int32,
                       device=img.device)
    ones[:h, :w] = 1
    s = pad.reshape(sh, denom, sw, denom, 3).sum((1, 3))
    n = ones.reshape(sh, denom, sw, denom).sum((1, 3))[..., None]
    return torch.div(s + n // 2, n, rounding_mode="floor").to(torch.float32)


def _f32(v, like):
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _crop_ref(src, plan, H, W):
    """The plain version of ``jpeg_crop``: (n, H, W, 3) uint8 from the
    packed full-size images ``src`` (uint8, flat) by ``plan`` (n, 11)."""
    rows = plan.cpu().tolist()
    out = torch.empty((len(rows), H, W, 3), dtype=torch.uint8,
                      device=src.device)
    ys = torch.arange(H, device=src.device)
    xs = torch.arange(W, device=src.device)
    for n, (off, w, h, denom, sw, sh, tw, th, cy, cx, mirror) in \
            enumerate(rows):
        img = _scaled(src[off:off + w * h * 3].view(h, w, 3), denom, sw, sh)
        oy = cy + ys
        ox = cx + ((W - 1 - xs) if mirror else xs)
        if tw == sw and th == sh:
            out[n] = img[oy][:, ox].to(torch.uint8)
            continue
        # divided by 0-d tensors: torch divides a CUDA tensor by a Python
        # number as a multiply by its reciprocal, which rounds otherwise
        fy = (oy.to(torch.float32) + 0.5) * float(sh) / _f32(th, src) - 0.5
        fx = (ox.to(torch.float32) + 0.5) * float(sw) / _f32(tw, src) - 0.5
        y0 = torch.where(fy < 0, 0, fy.to(torch.int64))
        x0 = torch.where(fx < 0, 0, fx.to(torch.int64))
        y1 = torch.clamp(y0 + 1, max=sh - 1)
        x1 = torch.clamp(x0 + 1, max=sw - 1)
        wy = torch.clamp(fy - y0.to(torch.float32), min=0)[:, None, None]
        wx = torch.clamp(fx - x0.to(torch.float32), min=0)[None, :, None]
        ay, ax = 1.0 - wy, 1.0 - wx
        v00, v01 = img[y0][:, x0], img[y0][:, x1]
        v10, v11 = img[y1][:, x0], img[y1][:, x1]
        v = v00 * ay * ax + v01 * ay * wx + v10 * wy * ax + v11 * wy * wx
        out[n] = (v + 0.5).to(torch.uint8)
    return out


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load(SOURCE)
    vp, i64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    create = lib.mxtt_njp_create
    create.restype = vp
    create.argtypes = [ctypes.POINTER(ctypes.c_int)]
    destroy = lib.mxtt_njp_destroy
    destroy.argtypes = [vp]
    info = lib.mxtt_njp_info
    info.restype = ctypes.c_int
    info.argtypes = [vp, ctypes.c_char_p, ctypes.c_int64,
                     ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    decode = lib.mxtt_njp_decode
    decode.restype = ctypes.c_int
    decode.argtypes = [vp, ctypes.c_char_p, i64p, i64p, ctypes.c_int, vp,
                       i64p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int, vp]
    crop = lib.mxtt_jpeg_crop
    crop.restype = ctypes.c_int
    crop.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp,
                     vp]
    return create, destroy, info, decode, crop


class _Decoder:
    """One nvJPEG handle and state (a state serves one thread)."""

    def __init__(self):
        status = ctypes.c_int(0)
        self._destroy = _entries()[1]
        self._h = _entries()[0](ctypes.byref(status))
        if not self._h:
            raise MXNetError(f"nvJPEG failed to start (status "
                             f"{status.value})")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._destroy(h)


_TLS = threading.local()


def _decoder():
    d = getattr(_TLS, "decoder", None)
    if d is None:
        d = _TLS.decoder = _Decoder()
    return d


def jpeg_crop(src, plan, H, W):
    """(n, H, W, 3) uint8: resize-short, crop and mirror of the packed
    full-size images ``src`` by ``plan`` (:func:`crop_plan`, as an int64
    tensor on ``src``'s device). CPU tensors: the plain version; CUDA
    tensors: one launch of the kernel on the current stream."""
    dev = src.device
    if dev.type == "cpu":
        return _crop_ref(src, plan, H, W)
    n = plan.shape[0]
    if dev.type == "meta":
        return torch.empty((n, H, W, 3), dtype=torch.uint8, device=dev)
    if dev.type != "cuda" or plan.device != dev:
        raise MXNetError(f"jpeg_crop: unsupported devices {dev}, "
                         f"{plan.device}")
    if src.dtype != torch.uint8 or plan.dtype != torch.int64 or \
            plan.shape[1:] != (_PLAN,) or not plan.is_contiguous():
        raise MXNetError("jpeg_crop takes uint8 images and an (n, 11) "
                         "contiguous int64 plan")
    out = torch.empty((n, H, W, 3), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = _entries()[4](src.data_ptr(), plan.data_ptr(), n, H, W,
                            out.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"jpeg_crop failed to launch (CUDA error {err})")
    _build.count_launch(KERNEL)
    return out


def decode_full(blobs, device):
    """nvJPEG's full-size decode of ``blobs``: (packed uint8 images on
    ``device``, their (w, h) sizes). Raises on a record nvJPEG cannot
    read."""
    create, destroy, info, decode, crop = _entries()
    dec = _decoder()
    sizes = []
    for i, b in enumerate(blobs):
        w, h = ctypes.c_int(0), ctypes.c_int(0)
        st = info(dec._h, b, len(b), ctypes.byref(w), ctypes.byref(h))
        if st != 0 or w.value <= 0 or h.value <= 0:
            raise MXNetError(f"record {i} of the batch is not a JPEG "
                             f"nvJPEG can read (status {st})")
        sizes.append((w.value, h.value))
    lens = onp.array([len(b) for b in blobs], dtype=onp.int64)
    offs = onp.concatenate([[0], onp.cumsum(lens)[:-1]]).astype(onp.int64)
    px = onp.array([w * h * 3 for w, h in sizes], dtype=onp.int64)
    dev_offs = onp.concatenate([[0], onp.cumsum(px)[:-1]]).astype(onp.int64)
    widths = onp.array([w for w, _ in sizes], dtype=onp.int32)
    src = torch.empty(int(px.sum()), dtype=torch.uint8, device=device)
    blob = b"".join(blobs)
    i64p = ctypes.POINTER(ctypes.c_int64)
    with torch.cuda.device(device):
        st = decode(dec._h, blob, offs.ctypes.data_as(i64p),
                    lens.ctypes.data_as(i64p), len(blobs), src.data_ptr(),
                    dev_offs.ctypes.data_as(i64p),
                    widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    max(1, os.cpu_count() or 1),
                    torch.cuda.current_stream(device).cuda_stream)
    if st != 0:
        raise MXNetError(f"nvJPEG failed to decode the batch (status {st})")
    return src, sizes


def decode_batch(blobs, H, W, resize_short, crops, device):
    """The nvJPEG route of ``ImageRecordIter``: (n, H, W, 3) uint8 on
    ``device``, on the current stream."""
    src, sizes = decode_full(blobs, device)
    plan = torch.from_numpy(crop_plan(sizes, H, W, resize_short, crops))
    return jpeg_crop(src, plan.to(device), H, W)
