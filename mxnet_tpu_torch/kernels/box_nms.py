"""The greedy sweep of ``box_nms`` and its CUDA kernels N1.

``box_nms`` (``ndarray/ops_contrib.py``) sorts the rows by score, then
sweeps them greedily: each row still kept clears every later row whose
IoU with it exceeds the threshold (within its class unless
``force_suppress``). The JAX op writes the sweep as a ``lax.fori_loop``
over all N rows (``mxnet_tpu/ndarray/ops_contrib.py:82-88``), one device
program under XLA. N1 is not a port of a Pallas kernel: the JAX package
has none on this path. Here the sweep is two phases
(``csrc/box_nms.cu``):

- the suppression bitmask: for each row i, 64-bit words whose bit t says
  that row j = 64 c + t (after i, before the limit, of i's class) overlaps
  row i by more than the threshold. Only the words right of the
  diagonal exist, packed as a triangle of 64-row blocks (row block r
  holds ``W - r`` words a row, ``W = ceil(limit / 64)``);
- the reduce: the rows in order, a kept row ORing its words into the
  removed bits; keep = not removed.

Two routes on the card, picked by :func:`_nms_plan`:

- ``"fused"``: one kernel, one block per image, the triangle in shared
  memory (the rule's route up to 256 rows; it takes up to 1,664 on an
  H100);
- ``"mask_reduce"``: the mask kernel across the card into a workspace
  the wrapper allocates, then the reduce kernel, one block per image,
  streaming the triangle through a ring of shared-memory stages (any
  limit whose two two-row stages fit shared memory: about 370,000 rows
  on an H100). The triangles grow as the square of the limit, so one
  pair of launches takes as many images as a quarter of the card's
  memory holds, and a larger batch takes several pairs.

Each kernel's wrapper counts its own launches (:data:`FUSED`,
:data:`MASK`, :data:`REDUCE`). The plain versions: :func:`_nms_keep_ref`
(the JAX loop in torch, a Python loop over the rows batched over the
images), and the two phases apart, :func:`_nms_mask_ref` and
:func:`_nms_reduce_ref`.

The wrappers follow the port's rule: on a CPU tensor the plain version,
on a ``meta`` tensor an empty result (so shape inference sees through
``box_nms``), on a CUDA tensor the kernels or an error. They sync nothing
with the host, so a captured graph can hold them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..base import MXNetError
from ..ndarray.ops_contrib import _corner_iou
from . import _build

__all__ = ["KERNEL", "FUSED", "MASK", "REDUCE", "ROUTE_KERNELS",
           "_nms_plan", "_nms_keep_ref", "_nms_mask_ref", "_nms_reduce_ref",
           "_nms_keep_cuda", "_nms_mask_cuda", "_nms_reduce_cuda"]

KERNEL = "box_nms"  # N1's source, csrc/box_nms.cu
FUSED, MASK, REDUCE = "box_nms_fused", "box_nms_mask", "box_nms_reduce"
ROUTE_KERNELS = {"fused": (FUSED,), "mask_reduce": (MASK, REDUCE)}

_FUSED_WORDS = 32  # the fused walk holds one word a lane
# The rule's fused route stops at 4 words (256 rows): timed in turns on an
# H100 (tools/compare_kernels.py), fused beat mask_reduce at 1, 2 and 4
# words and lost from 7 on (at (32, 400) by 7%, at (2, 1664) by 4x): one
# block per image builds the triangle on one SM, the mask kernel on all.
_FUSED_RULE_WORDS = 4
_MAX_STAGES = 8
_MAX_WORDS = 32768  # the kernels' grid arithmetic
_MAX_IMAGES = 65535  # the mask kernel's grid takes the images in z


def _words(limit):
    return -(-int(limit) // 64)


def _triangle_words(limit):
    """Words of one image's packed triangle: 64 rows a row block, row
    block r holding W - r words a row."""
    W = _words(limit)
    return 32 * W * (W + 1)


def _nms_plan(B, limit, smem_optin, route=None, workspace_cap=None):
    """N1's route for ``B`` images swept to ``limit`` rows on a card whose
    blocks may take ``smem_optin`` bytes of shared memory: a dict of
    ``route`` ("fused" for sweeps of up to 4 words, 256 rows, where one
    image's triangle, its boxes, areas and ids fit in a block's shared
    memory; else "mask_reduce"; asked for, "fused" takes up to 32 words
    that fit), ``words`` (W), ``smem`` (the shared memory of the kernel
    that walks), ``rows_per_stage`` and ``stages`` (the reduce's ring:
    stages of 64, 16, 4 or 2 rows, the most of which two fit; None when
    fused), ``images`` (swept by one launch of each kernel: as many as
    ``workspace_cap`` bytes of triangles hold, at least one),
    ``launches`` (of each kernel, ``ceil(B / images)``) and
    ``workspace_bytes`` (the triangles of one launch in device memory; 0
    when fused). ``route`` asks for one route; raises
    :class:`MXNetError` where it does not fit, or where not even two
    ring stages of two rows fit."""
    if route not in (None, "fused", "mask_reduce"):
        raise MXNetError(f"box_nms: no route {route!r}")
    B, limit = int(B), int(limit)
    W = _words(limit)
    tri = _triangle_words(limit)
    # the triangle, 64 W boxes, areas and ids, W words of removed bits
    fused_smem = tri * 8 + W * (64 * (16 + 4 + 4) + 8)
    fits = W <= _FUSED_WORDS and fused_smem <= smem_optin
    if route == "fused" and not fits:
        raise MXNetError(f"box_nms: a limit of {limit} rows does not fit "
                         f"the fused route's {smem_optin} bytes")
    if fits and (route == "fused" or
                 (route is None and W <= _FUSED_RULE_WORDS)):
        return {"route": "fused", "words": W, "smem": fused_smem,
                "rows_per_stage": None, "stages": None, "images": B,
                "launches": 1, "workspace_bytes": 0}
    # a stage holds a whole row block (64 rows), or fewer rows where two
    # such stages do not fit (an even count, so that each stage's bulk
    # copy stays a multiple of 16 bytes); S stages, their two mbarriers
    # and W words of removed bits
    for R in (64, 16, 4, 2):
        slot = R * W * 8
        S = min(_MAX_STAGES, (smem_optin - 8 * W) // (slot + 16))
        if S >= 2:
            break
    if S < 2 or W > _MAX_WORDS:
        raise MXNetError(f"box_nms: a limit of {limit} rows is past the "
                         f"card's reach: a ring of two two-row stages "
                         f"does not fit {smem_optin} bytes of shared memory")
    images = B
    if workspace_cap is not None and tri:
        images = max(1, min(B, int(workspace_cap) // (tri * 8)))
    images = max(1, min(images, _MAX_IMAGES))
    return {"route": "mask_reduce", "words": W,
            "smem": S * (slot + 16) + 8 * W,
            "rows_per_stage": R, "stages": S, "images": images,
            "launches": -(-B // images),
            "workspace_bytes": min(B, images) * tri * 8}


# -- plain versions -----------------------------------------------------------

def _nms_keep_ref(boxes, valid, ids, thresh, limit):
    """Plain version of N1: the keep mask (B, N) of the greedy sweep over
    the score-sorted corner ``boxes`` (B, N, 4). A row is kept if it is
    ``valid``, lies before ``limit`` and no earlier kept row overlaps it
    by an IoU above ``thresh``; with class ids ``ids`` (B, N), rows of
    different classes overlap by 0. Row i's IoUs are the row the JAX op
    reads from its (N, N) matrix, computed alone."""
    N = valid.shape[1]
    ar = torch.arange(N, device=valid.device)
    keep = valid & (ar < limit)[None, :]
    for i in range(limit):
        o = _corner_iou(boxes[:, i:i + 1], boxes)[:, 0]  # (B, N)
        if ids is not None:
            o = torch.where(ids[:, i:i + 1] == ids, o, 0.0)
        keep = keep & ~((o > thresh) & keep[:, i:i + 1] & (ar > i)[None, :])
    return keep


def _pack(bits):
    """(..., 64) bool → (...) int64 words, bit t from bits[..., t]."""
    shifts = torch.arange(64, device=bits.device, dtype=torch.int64)
    return (bits.to(torch.int64) << shifts).sum(-1)


def _nms_mask_ref(boxes, ids, thresh, limit):
    """Plain version of the mask kernel: (B, 32 W (W + 1)) int64, each
    image's triangle of suppression words. Word c - r of row i of row
    block r = i // 64 (its rows one after another, W - r words each) has
    bit t set when j = 64 c + t satisfies i < j < ``limit`` and
    ``_corner_iou(i, j) > thresh`` (0 across classes when ``ids`` is
    given); rows at or past ``limit`` are zero words."""
    B = boxes.shape[0]
    L, W = int(limit), _words(limit)
    Lp = 64 * W
    dev = boxes.device
    b = boxes.new_zeros((B, Lp, 4))
    b[:, :L] = boxes[:, :L]
    cid = None
    if ids is not None:
        cid = ids.new_zeros((B, Lp))
        cid[:, :L] = ids[:, :L]
    ar = torch.arange(Lp, device=dev)
    out = []
    for r in range(W):
        rows = slice(64 * r, 64 * r + 64)
        o = _corner_iou(b[:, rows], b[:, 64 * r:])  # (B, 64, Lp - 64 r)
        if cid is not None:
            o = torch.where(cid[:, rows, None] == cid[:, None, 64 * r:], o,
                            0.0)
        i, j = ar[rows, None], ar[None, 64 * r:]
        bits = (o > thresh) & ((j > i) & (j < L) & (i < L))[None]
        out.append(_pack(bits.reshape(B, 64, W - r, 64)).reshape(B, -1))
    if not out:
        return torch.zeros((B, 0), dtype=torch.int64, device=dev)
    return torch.cat(out, 1)


def _unpack_keep(removed, N):
    """(B, W) int64 removed words → the keep mask (B, N) bool."""
    B, W = removed.shape
    shifts = torch.arange(64, device=removed.device, dtype=torch.int64)
    gone = ((removed[..., None] >> shifts) & 1).bool().reshape(B, 64 * W)
    keep = torch.zeros((B, N), dtype=torch.bool, device=removed.device)
    n = min(N, 64 * W)
    keep[:, :n] = ~gone[:, :n]
    return keep


def _nms_reduce_ref(mask, valid, limit):
    """Plain version of the reduce kernel: the keep mask (B, N) from the
    triangles ``mask`` (:func:`_nms_mask_ref`'s layout) and ``valid``
    (B, N). The removed bits start as not valid, rows at or past
    ``limit`` removed; each row in order, if not removed, ORs its words
    into them."""
    B, N = valid.shape
    L, W = int(limit), _words(limit)
    Lp = 64 * W
    start = torch.ones((B, Lp), dtype=torch.bool, device=valid.device)
    start[:, :L] = ~valid[:, :L]
    removed = _pack(start.reshape(B, W, 64))
    base = 0
    for r in range(W):
        n = W - r
        for t in range(min(64, L - 64 * r)):
            row = mask[:, base + t * n:base + (t + 1) * n]
            kept = ((removed[:, r] >> t) & 1) == 0
            removed[:, r:] |= torch.where(kept[:, None], row, 0)
        base += 64 * n
    return _unpack_keep(removed, N)


# -- the kernels' wrappers ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load(KERNEL)
    fused = lib.mxtt_box_nms_fused
    fused.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    mask = lib.mxtt_box_nms_mask
    mask.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    reduce = lib.mxtt_box_nms_reduce
    reduce.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    optin = lib.mxtt_box_nms_smem_optin
    optin.argtypes = [ctypes.POINTER(ctypes.c_int)]
    for fn in (fused, mask, reduce, optin):
        fn.restype = ctypes.c_int
    return fused, mask, reduce, optin


@functools.lru_cache(maxsize=None)
def _smem_optin(index):
    with torch.cuda.device(index):
        out = ctypes.c_int(0)
        _check(_entries()[3](ctypes.byref(out)), "cudaDeviceGetAttribute")
    return out.value


def _check(err, what):
    if err:
        raise MXNetError(f"_nms_keep_cuda: {what} failed with CUDA error "
                         f"{err}")


def _device_of(ts):
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise MXNetError(f"_nms_keep_cuda: inputs on several devices {devs}")
    return devs.pop()


def _checked(boxes, valid, ids, limit):
    """The card's inputs, checked (boxes copied if not 16-byte aligned);
    ``valid`` may be None (the mask kernel reads none)."""
    shape = tuple(boxes.shape[:2]) if valid is None else tuple(valid.shape)
    ts = [t for t in (boxes, valid, ids) if t is not None]
    if len(shape) != 2 or tuple(boxes.shape) != shape + (4,) \
            or (ids is not None and tuple(ids.shape) != shape):
        raise MXNetError(
            "_nms_keep_cuda: boxes must be (B, N, 4), valid and ids (B, N); "
            f"got {tuple(boxes.shape)}, {shape}, "
            f"{None if ids is None else tuple(ids.shape)}")
    if boxes.dtype != torch.float32 or \
            (valid is not None and valid.dtype != torch.bool) or \
            (ids is not None and ids.dtype != torch.float32):
        raise MXNetError(
            "_nms_keep_cuda: the kernel takes float32 boxes and ids and a "
            f"bool mask, got {boxes.dtype}, "
            f"{None if valid is None else valid.dtype}, "
            f"{None if ids is None else ids.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise MXNetError("_nms_keep_cuda: inputs must be contiguous")
    if not 0 <= limit <= shape[1]:
        raise MXNetError(f"_nms_keep_cuda: limit {limit} not in "
                         f"[0, {shape[1]}]")
    if boxes.data_ptr() % 16:
        # a contiguous view at an odd offset (a slice of a one-row
        # array): the kernels read a box as one 16-byte load
        boxes = boxes.clone()
    return boxes


def _ptr(t):
    return None if t is None else t.data_ptr()


def _nms_mask_cuda(boxes, ids, thresh, limit):
    """The mask kernel: the triangles of :func:`_nms_mask_ref`, (B,
    32 W (W + 1)) int64. On CPU tensors the plain version; on CUDA
    tensors one launch on the current stream."""
    dev = _device_of((boxes, ids))
    if dev.type == "cpu":
        return _nms_mask_ref(boxes, ids, thresh, limit)
    if dev.type != "cuda":
        raise MXNetError(f"_nms_mask_cuda: unsupported device {dev}")
    boxes = _checked(boxes, None, ids, limit)
    B, N = boxes.shape[:2]
    out = torch.empty((B, _triangle_words(limit)), dtype=torch.int64,
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _entries()[1](boxes.data_ptr(), _ptr(ids), out.data_ptr(), B,
                            N, int(limit), float(thresh),
                            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "the mask kernel's launch")
    _build.count_launch(MASK)
    return out


def _nms_reduce_cuda(mask, valid, limit, plan):
    """The reduce kernel: the keep mask (B, N) bool from the triangles
    ``mask`` (:func:`_nms_mask_cuda`) and ``valid``, its ring as ``plan``
    (:func:`_nms_plan`, route "mask_reduce") sets it. On CPU tensors the
    plain version; on CUDA tensors one launch on the current stream."""
    dev = _device_of((mask, valid))
    if dev.type == "cpu":
        return _nms_reduce_ref(mask, valid, limit)
    if dev.type != "cuda":
        raise MXNetError(f"_nms_reduce_cuda: unsupported device {dev}")
    B, N = valid.shape
    if tuple(mask.shape) != (B, _triangle_words(limit)) or \
            mask.dtype != torch.int64 or valid.dtype != torch.bool or \
            not mask.is_contiguous() or not valid.is_contiguous() or \
            mask.data_ptr() % 16 or not 0 <= limit <= N:
        raise MXNetError(
            "_nms_reduce_cuda: mask must be the contiguous, 16-byte aligned "
            f"(B, {_triangle_words(limit)}) int64 triangles and valid a "
            f"contiguous (B, N) bool, 0 <= limit <= N; got "
            f"{tuple(mask.shape)} {mask.dtype}, {tuple(valid.shape)} "
            f"{valid.dtype}, limit {limit}")
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    if B == 0 or N == 0:
        return keep
    with torch.cuda.device(dev):
        err = _entries()[2](mask.data_ptr(), valid.data_ptr(),
                            keep.data_ptr(), B, N, int(limit),
                            plan["rows_per_stage"], plan["stages"],
                            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "the reduce kernel's launch")
    _build.count_launch(REDUCE)
    return keep


@functools.lru_cache(maxsize=None)
def _workspace_cap(index):
    """The triangles one launch may take: a quarter of the card's memory."""
    return torch.cuda.get_device_properties(index).total_memory // 4


def _card_plan(dev, B, limit, route=None):
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return _nms_plan(B, limit, _smem_optin(index), route,
                     _workspace_cap(index))


def _nms_keep_cuda(boxes, valid, ids, thresh, limit, route=None):
    """N1: the keep mask (B, N) bool of the greedy sweep; the contract of
    :func:`_nms_keep_ref`.

    On CPU tensors this is the plain version; on meta tensors an empty
    mask. On CUDA tensors it launches N1's kernels on the current stream,
    without synchronizing, or raises: boxes (B, N, 4) float32, valid
    (B, N) bool and ids (B, N) float32 or None, contiguous, on one
    device, with 0 <= limit <= N (boxes not 16-byte aligned are copied
    first). The route is :func:`_nms_plan`'s, or ``route`` ("fused" or
    "mask_reduce") where it fits the card."""
    dev = _device_of((boxes, valid, ids))
    if dev.type == "cpu":
        return _nms_keep_ref(boxes, valid, ids, thresh, limit)
    if dev.type == "meta":
        return torch.empty(valid.shape, dtype=torch.bool, device=dev)
    if dev.type != "cuda":
        raise MXNetError(f"_nms_keep_cuda: unsupported device {dev}")
    boxes = _checked(boxes, valid, ids, limit)
    B, N = valid.shape
    if B == 0 or N == 0:
        return torch.empty((B, N), dtype=torch.bool, device=dev)
    plan = _card_plan(dev, B, limit, route)
    if plan["route"] == "mask_reduce":
        n = plan["images"]
        parts = [_nms_reduce_cuda(
            _nms_mask_cuda(boxes[b:b + n], None if ids is None else
                           ids[b:b + n], thresh, limit),
            valid[b:b + n], limit, plan) for b in range(0, B, n)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    keep = torch.empty((B, N), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = _entries()[0](boxes.data_ptr(), valid.data_ptr(), _ptr(ids),
                            keep.data_ptr(), B, N, int(limit), float(thresh),
                            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "the fused kernel's launch")
    _build.count_launch(FUSED)
    return keep
