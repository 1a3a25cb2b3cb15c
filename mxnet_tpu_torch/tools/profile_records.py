"""The host runtime and the record pipeline on the card: measurements.

What ``chip_smoke.py`` phases 59-62 run, also runnable alone:

    python3 -m mxnet_tpu_torch.tools.profile_records [--steps 20]

- :func:`engine_check`: pushes through both lanes of the dependency
  engine, a poisoned var raised again at ``wait_for_var``, an op that
  works on the card finished when ``nd.waitall()`` returns, and the cost
  of a push (native engine and ``NaiveEngine``);
- :func:`decode_check`: which decoder the machine has, the nvJPEG
  route's crop kernels against their plain version and their first
  design (:func:`pixel_crop`, bitwise) and the decoded batch against the
  Python twin (PIL); the kernels and the first design timed in turns on
  the nvJPEG batch and on a resize shape (:func:`resize_batch`), beside
  a ``copy_`` of the same output bytes and ``torch.take`` of the crops;
- :func:`iter_rate`: ``ImageRecordIter`` alone, images/s;
- :func:`resize_launches`: which crop kernels ``ImageRecordIter`` with
  a resize launches;
- :func:`train_from_records`: ResNet-50 v1 trained from the .rec through
  ``DeviceFeed`` (the example twin's helpers), the same step fed from
  tensors already on the card beside it, and the device's idle share.

Every function needs a CUDA device; each result names the card.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys
import statistics
import subprocess
import tempfile
import time

import numpy as onp
import torch

__all__ = ["card", "write_records", "engine_check", "resize_batch",
           "crop_source_bytes", "crop_bound_ms", "pixel_crop", "crop_turns",
           "decode_check", "iter_rate", "resize_launches",
           "train_from_records"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
IMAGE, STORED, CLASSES = 224, 252, 1000
# the resize shape: ImageNet's most common image size, resized short
# side 256 and cropped 224 as train_imagenet.py's augmentation does
RESIZE_W, RESIZE_H, RESIZE_SHORT = 500, 375, 256
PIXEL_SOURCE = "jpeg_crop_pixel"  # csrc/jpeg_crop_pixel.cu
# ~200 us at the H100's 1.98 GHz boost clock: longer than a launch's
# host cost, so a kernel time is the device's alone
BUSY_CYCLES = 400_000
CROP_REPS = 25
# nvJPEG's pixels against PIL's (libjpeg-turbo: the ISLOW integer IDCT
# and "fancy" triangle-filter chroma upsampling) on the same records, in
# uint8 levels of 255. Two causes, measured apart on the card:
# - the IDCT's rounding, alone in 4:4:4 JPEGs (no chroma upsampling):
#   DECODE_444_MEAN / DECODE_444_MAX;
# - the chroma upsampling of 4:2:0 JPEGs (PIL's default, the .rec's): the
#   two decoders interpolate the half-resolution Cb and Cr differently,
#   which on the example's noise images moves R and B by tens of levels
#   at single pixels; the luma (Y) keeps the IDCT's small difference:
#   DECODE_LUMA_MEAN, and the RGB bounds DECODE_420_MEAN / _MAX.
# The crop kernel itself is bitwise its plain version, so every level
# here is the decoders'.
DECODE_444_MEAN, DECODE_444_MAX = 1.5, 48
DECODE_LUMA_MEAN = 3.0
DECODE_420_MEAN, DECODE_420_MAX = 20.0, 160


def _note(msg):
    print(f"  [profile_records] {msg}", file=sys.stderr, flush=True)


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def write_records(path, n, side=STORED, classes=CLASSES, seed=0):
    """The example twin's synthetic .rec (64 seeded JPEGs, repeated)."""
    from ..examples.train_imagenet_rec import synth_rec

    return synth_rec(path, n, side, classes, seed)


def _events_ms(fn, reps=20):
    """Median device ms of ``fn`` over ``reps`` runs, CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_ms(fn, flush, reps=CROP_REPS):
    """Median device ms of ``fn`` over ``reps`` launches, each timed alone
    with CUDA events after ``flush`` evicts the 50 MB L2, the stream kept
    busy for BUSY_CYCLES first so that the launch's host cost is not
    counted."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(BUSY_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _push_us(eng, n=20000):
    """Host µs a push of an empty op onto one var, waited at the end."""
    from .. import engine

    v = eng.new_variable()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.push(lambda: None, mutable_vars=(v,), lane=engine.LANE_COMPUTE)
    eng.wait_for_var(v)
    return (time.perf_counter() - t0) * 1e6 / n


def engine_check():
    """The engine's contract on the card; raises on a broken one."""
    from .. import engine, nd

    _note("engine: lanes")
    eng = engine.get()
    if not isinstance(eng, engine.Engine):
        raise RuntimeError(f"the process engine is {type(eng).__name__}, "
                           "not the native engine")
    # both lanes: each var's ops in push order, versions counted
    seen = {engine.LANE_COMPUTE: [], engine.LANE_IO: []}
    vs = {lane: eng.new_variable() for lane in seen}
    for i in range(200):
        for lane in seen:
            eng.push(lambda lane=lane, i=i: seen[lane].append(i),
                     mutable_vars=(vs[lane],), lane=lane)
    for lane, v in vs.items():
        eng.wait_for_var(v)
        if seen[lane] != list(range(200)) or eng.var_version(v) != 200:
            raise RuntimeError(f"lane {lane}: effects {seen[lane][:5]}..., "
                               f"version {eng.var_version(v)}")
    # a poisoned var, and the op that reads it, raise at their waits
    bad, after = eng.new_variable(), eng.new_variable()

    def boom():
        raise ValueError("poisoned on purpose")

    eng.push(boom, mutable_vars=(bad,), lane=engine.LANE_IO)
    eng.push(lambda: None, const_vars=(bad,), mutable_vars=(after,))
    for v in (bad, after):
        try:
            eng.wait_for_var(v)
        except ValueError as e:
            if "poisoned on purpose" not in str(e):
                raise
        else:
            raise RuntimeError("a poisoned var did not raise at its wait")
    _note("engine: an op on the card, then nd.waitall()")
    # an op that works on the card: finished when nd.waitall() returns
    dev = torch.device("cuda", 0)
    x = torch.randn(4096, 4096, device=dev)
    out = torch.empty_like(x)
    v = eng.new_variable()

    def device_work():
        y = x
        for _ in range(30):
            y = y @ x * (1.0 / 64)
        out.copy_(y)

    eng.push(device_work, mutable_vars=(v,), lane=engine.LANE_IO,
             device=dev)
    nd.waitall()
    _, done = eng._device_events[v.id]
    if not done.query():
        raise RuntimeError("nd.waitall() returned before the op's device "
                           "work was done")
    ref = x
    for _ in range(30):
        ref = ref @ x * (1.0 / 64)
    err = (out - ref).abs().max().item()
    if not err <= 1e-3 * max(ref.abs().max().item(), 1.0):
        raise RuntimeError(f"the engine op's device result is off by {err}")
    _note("engine: push cost")
    return {"lanes_ok": True, "poison_ok": True, "waitall_ok": True,
            "push_us_native": _push_us(eng),
            "push_us_naive": _push_us(engine.NaiveEngine())}


def _first_batch(rec, batch):
    from .. import recordio

    r = recordio.MXIndexedRecordIO(rec + ".idx", rec, "r")
    try:
        return [recordio.unpack(r.read_idx(k))[1] for k in r.keys[:batch]]
    finally:
        r.close()


def _first_batch_444(rec, n, side=STORED, seed=0):
    """The first ``n`` images of :func:`write_records`' seed, encoded as
    4:4:4 JPEGs (no chroma subsampling) at the same quality."""
    from io import BytesIO

    from PIL import Image

    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = Image.fromarray(rng.randint(0, 255, (side, side, 3), "uint8"))
        buf = BytesIO()
        img.save(buf, format="JPEG", quality=90, subsampling=0)
        out.append(buf.getvalue())
    return out


def _levels(a, b):
    """How far two uint8 HWC batches are, in levels of 255: RGB and luma
    (Y = 0.299 R + 0.587 G + 0.114 B)."""
    d = a.astype(onp.int32) - b.astype(onp.int32)
    w = onp.array([0.299, 0.587, 0.114])
    dy = onp.abs(a.astype(onp.float64) @ w - b.astype(onp.float64) @ w)
    return {"max_levels": int(onp.abs(d).max()),
            "mean_levels": float(onp.abs(d).mean()),
            "share_exact": float((d == 0).mean()),
            "luma_mean_levels": float(dy.mean()),
            "luma_max_levels": float(dy.max())}


def _taps(o0, n, s, t):
    """The source indices that decode_one's bilinear step reads for
    outputs ``o0 .. o0 + n - 1`` of ``t`` from ``s`` (float32, op by op):
    each output's two taps, the second clamped at the edge."""
    f32 = onp.float32
    f = (onp.arange(o0, o0 + n).astype(f32) + f32(0.5)) * f32(s) / f32(t) \
        - f32(0.5)
    i0 = onp.where(f < 0, 0, f.astype(onp.int64))
    return onp.union1d(i0, onp.minimum(i0 + 1, s - 1))


def crop_source_bytes(row, H, W):
    """The full-size source bytes that one image's crop (a
    :func:`crop_plan` row) must read: the crop's own pixels with no
    resize; with one, the scaled rows and columns its taps reach, each
    scaled pixel a denom x denom block of full-size pixels, cut at the
    image's edges."""
    _, w, h, denom, sw, sh, tw, th, cy, cx, _ = (int(v) for v in row)
    if (tw, th) == (sw, sh):
        ys, xs = onp.arange(cy, cy + H), onp.arange(cx, cx + W)
    else:
        ys, xs = _taps(cy, H, sh, th), _taps(cx, W, sw, tw)

    def full(idx, size):  # full-size lines under the scaled lines idx
        return int((onp.minimum((idx + 1) * denom, size) - idx * denom).sum())

    return full(ys, h) * full(xs, w) * 3


def crop_bound_ms(plan, H, W):
    """Least ms of ``jpeg_crop`` for ``plan`` at the card's memory rate:
    the output written once, the source bytes the crops need
    (:func:`crop_source_bytes`) and the plan read once."""
    nbytes = plan.size * 8 + sum(H * W * 3 + crop_source_bytes(r, H, W)
                                 for r in plan)
    return nbytes / HBM_BYTES_PER_S * 1e3


def resize_batch(n=128, size=IMAGE, seed=0, device="cuda"):
    """The crop kernel's resize shape, made on the card from ``seed``
    with no JPEG: ``n`` random images of RESIZE_W x RESIZE_H packed as
    ``decode_full`` packs them, resized short side RESIZE_SHORT, random
    crops of ``size``, mirrored at random. Returns (src, plan), the plan
    :func:`crop_plan`'s rows on the host."""
    from ..kernels import jpeg_decode as jd

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [(RESIZE_W, RESIZE_H)] * n
    _, nbytes = jd.decode_layout(sizes)
    src = torch.randint(0, 256, (nbytes,), generator=gen, device=device,
                        dtype=torch.uint8)
    rs = onp.random.RandomState(seed)
    crops = onp.stack([rs.randint(0, 10001, n), rs.randint(0, 10001, n),
                       rs.randint(0, 2, n)], 1).astype(onp.int32)
    return src, jd.crop_plan(sizes, size, size, RESIZE_SHORT, crops)


@functools.lru_cache(maxsize=None)
def _pixel_entry():
    from ..kernels import _build

    fn = _build.load(PIXEL_SOURCE).mxtt_jpeg_crop_pixel
    vp = ctypes.c_void_p
    fn.restype = ctypes.c_int
    fn.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp]
    return fn


def pixel_crop(src, plan, H, W):
    """The crop kernels' first design (``csrc/jpeg_crop_pixel.cu``: a
    thread an output pixel) on the card, for comparisons: (n, H, W, 3)
    uint8 from ``src`` by ``plan`` (:func:`crop_plan`'s rows as an int64
    tensor on the card), one launch on the current stream, not
    counted."""
    dev = src.device
    out = torch.empty((plan.shape[0], H, W, 3), dtype=torch.uint8,
                      device=dev)
    with torch.cuda.device(dev):
        err = _pixel_entry()(src.data_ptr(), plan.data_ptr(), plan.shape[0],
                             H, W, out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"the first design failed to launch (CUDA "
                           f"error {err})")
    return out


def _take_index(plan, H, W, device):
    """The flat source index of every output byte of crops with no
    resize at scale 1: ``torch.take(src, index)`` is ``jpeg_crop``."""
    p = torch.from_numpy(plan).to(device)[:, :, None, None, None]
    off, w, cy, cx, mirror = p[:, 0], p[:, 1], p[:, 8], p[:, 9], p[:, 10]
    y = torch.arange(H, device=device)[None, :, None, None]
    x = torch.arange(W, device=device)[None, None, :, None]
    c = torch.arange(3, device=device)
    x = torch.where(mirror.bool(), W - 1 - x, x)
    return off + ((cy + y) * w + cx + x) * 3 + c


def crop_turns(src, plan, size, flush):
    """``jpeg_crop`` (as ``decode_batch`` calls it) and its first design
    (:func:`pixel_crop`) on the same inputs, each against the plain
    version bit for bit; then the kernels alone, the plan already on the
    card, timed in turns with the first design: pixel, band, band, pixel.
    Raises when an output differs."""
    from ..kernels import jpeg_decode as jd

    on_card = torch.from_numpy(plan).to(src.device)
    plain = jd._crop_ref(src, torch.from_numpy(plan), size, size)
    band = jd.jpeg_crop(src, plan, size, size)
    pixel = pixel_crop(src, on_card, size, size)
    torch.cuda.synchronize()
    err = {"band": (band.int() - plain.int()).abs().max().item(),
           "pixel": (pixel.int() - plain.int()).abs().max().item()}
    if err["band"] != 0 or err["pixel"] != 0 or not torch.equal(band, pixel):
        raise RuntimeError(f"jpeg_crop or its first design differs from "
                           f"the plain version: {err} levels")
    kinds = jd.crop_kinds(plan)
    run = {"band": lambda: jd._launch(src, on_card, kinds, size, size, band),
           "pixel": lambda: pixel_crop(src, on_card, size, size)}
    turns = {"band": [], "pixel": []}
    for route in ("pixel", "band", "band", "pixel"):
        turns[route].append(_kernel_ms(run[route], flush))
    return turns, err["band"]


def decode_check(rec, batch=128, size=IMAGE, seed=0):
    """The decoder probe's answer and, on the nvJPEG route, the crop
    kernels against their plain version and their first design and the
    batch against the Python twin, with times: ``kernel`` the copy
    kernel's row (the nvJPEG batch, no resize), ``scaled_kernel`` the
    scaled kernel's (the resize shape). Raises when a check fails."""
    from PIL import __version__ as pil_version

    from .. import _native
    from ..io.image_record import _decode_batch_python
    from ..kernels import jpeg_decode as jd

    out = {"decoder": _native.decoder(),
           "jpeglib_h": bool(_native.io_lib().rio_has_jpeg()),
           "nvjpeg": jd.available(), "pil": pil_version,
           "cores": os.cpu_count()}
    blobs = _first_batch(rec, batch)
    rs = onp.random.RandomState(seed)
    crops = onp.stack([rs.randint(0, 10001, batch), rs.randint(0, 10001, batch),
                       rs.randint(0, 2, batch)], 1).astype(onp.int32)
    twin = _decode_batch_python(blobs, size, size, 0,
                                [tuple(int(v) for v in c) for c in crops])
    t0 = time.perf_counter()
    _decode_batch_python(blobs, size, size, 0,
                         [tuple(int(v) for v in c) for c in crops])
    out["python_twin_ms"] = (time.perf_counter() - t0) * 1e3
    if out["decoder"] != "nvjpeg":
        return out
    dev = torch.device("cuda", 0)
    _note("decode: nvJPEG's full-size decode")
    src, sizes = jd.decode_full(blobs, dev)
    plan = jd.crop_plan(sizes, size, size, 0, crops)
    _note("decode: jpeg_crop against its plain version and first design")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    turns, kernel_err = crop_turns(src, plan, size, flush)
    got = jd.jpeg_crop(src, plan, size, size)
    out["vs_python_twin"] = _levels(got.cpu().numpy(), twin)
    # the IDCT alone: the same seeded pixels as 4:4:4 JPEGs
    blobs444 = _first_batch_444(rec, 32)
    crops444 = crops[:32]
    src444, sizes444 = jd.decode_full(blobs444, dev)
    got444 = jd.jpeg_crop(src444, jd.crop_plan(sizes444, size, size, 0,
                                               crops444), size, size)
    out["vs_python_twin_444"] = _levels(
        got444.cpu().numpy(), _decode_batch_python(
            blobs444, size, size, 0,
            [tuple(int(v) for v in c) for c in crops444]))
    print("  " + json.dumps({k: out[k] for k in (
        "vs_python_twin", "vs_python_twin_444")}), flush=True)
    t420, t444 = out["vs_python_twin"], out["vs_python_twin_444"]
    if t444["mean_levels"] > DECODE_444_MEAN or \
            t444["max_levels"] > DECODE_444_MAX or \
            t420["luma_mean_levels"] > DECODE_LUMA_MEAN or \
            t420["mean_levels"] > DECODE_420_MEAN or \
            t420["max_levels"] > DECODE_420_MAX:
        raise RuntimeError(f"the nvJPEG route is off the Python twin: "
                           f"4:2:0 {t420}, 4:4:4 {t444}")
    _note("decode: jpeg_crop on the resize shape")
    rsrc, rplan = resize_batch(batch, size, seed)
    rturns, rerr = crop_turns(rsrc, rplan, size, flush)
    _note("decode: times")
    # the practical ceiling: a copy of the output's bytes on the card
    a = torch.empty_like(got)
    copy_ms = _kernel_ms(lambda: a.copy_(got), flush)
    # the library call: torch.take on an index made outside its timing
    index = _take_index(plan, size, size, dev)
    if not torch.equal(torch.take(src, index), got):
        raise RuntimeError("torch.take of the crops differs from jpeg_crop")
    take_ms = _kernel_ms(lambda: torch.take(src, index), flush)
    del index
    bound = crop_bound_ms(plan, size, size)
    rbound = crop_bound_ms(rplan, size, size)
    ms = statistics.median(turns["band"])
    rms = statistics.median(rturns["band"])
    plan_t, rplan_t = torch.from_numpy(plan), torch.from_numpy(rplan)
    out["kernel"] = {
        "ms": ms, "turns_ms": turns,
        "plain_ms": _events_ms(lambda: jd._crop_ref(src, plan_t, size, size),
                               reps=3),
        "bound_ms": bound, "bound_by": "bytes", "bound_share": bound / ms,
        "library_ms": take_ms, "max_abs_err": float(kernel_err),
        "copy_ms": copy_ms, "copy_bytes": 2 * got.numel(),
        "shape": f"{batch} x {size} x {size} x 3 uint8 from "
                 f"{sizes[0][0]} x {sizes[0][1]} JPEGs, no resize"}
    out["scaled_kernel"] = {
        "ms": rms, "turns_ms": rturns,
        "plain_ms": _events_ms(
            lambda: jd._crop_ref(rsrc, rplan_t, size, size), reps=3),
        "bound_ms": rbound, "bound_by": "bytes",
        "bound_share": rbound / rms, "library_ms": None,
        "max_abs_err": float(rerr),
        "shape": f"{batch} x {size} x {size} x 3 uint8 from "
                 f"{RESIZE_W} x {RESIZE_H} images, resize_short "
                 f"{RESIZE_SHORT}, random crops and mirrors"}
    print("  jpeg_crop: " + json.dumps({k: out[k] for k in (
        "kernel", "scaled_kernel")}), flush=True)
    out["nvjpeg_decode_ms"] = _events_ms(
        lambda: jd.decode_full(blobs, dev), reps=5)
    out["decode_batch_ms"] = _events_ms(
        lambda: jd.decode_batch(blobs, size, size, 0, crops, dev), reps=5)
    return out


def iter_rate(rec, batch=128, size=IMAGE, batches=16, threads=None):
    """``ImageRecordIter`` alone (its example settings): images/s over
    ``batches`` batches after the first, each batch's data read on the
    consuming stream."""
    from ..examples.train_imagenet_rec import record_iter

    threads = threads or os.cpu_count() or 1
    _note("iter: ImageRecordIter alone")
    it = record_iter(rec, batch, size, threads)
    try:
        def pull():
            try:
                return it.next()
            except StopIteration:
                it.reset()
                return it.next()

        first = pull()
        x0 = first.data[0]
        if x0.shape != (batch, 3, size, size) or \
                not bool(torch.isfinite(x0.data).all()):
            raise RuntimeError(f"ImageRecordIter gave {x0.shape}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batches):
            b = pull()
            b.data[0].data.sum().item()  # the batch is ready to read
        dt = time.perf_counter() - t0
    finally:
        it.close()
    rate = batches * batch / dt
    return {"decoder": it.decoder, "threads": threads, "batch": batch,
            "images_per_s": rate, "images_per_s_per_core": rate / threads,
            "ms_per_batch": dt * 1e3 / batches}


def resize_launches(rec, batch=128, size=IMAGE, batches=2, threads=None):
    """``ImageRecordIter`` as the example makes it but with
    ``resize=RESIZE_SHORT`` (the .rec's images scaled up before the
    crop): ``batches`` batches pulled, and the crop kernels' launches
    from the iterator's start to its close."""
    from .. import io as mxio
    from ..kernels import _build
    from ..kernels import jpeg_decode as jd

    _note("iter: ImageRecordIter with a resize")
    _build.reset_launch_counts()
    it = mxio.ImageRecordIter(
        rec, data_shape=(3, size, size), batch_size=batch,
        path_imgidx=rec + ".idx", shuffle=True, rand_crop=True,
        rand_mirror=True, resize=RESIZE_SHORT,
        preprocess_threads=threads or os.cpu_count() or 1, prefetch_buffer=1)
    try:
        for _ in range(batches):
            x = it.next().data[0]
            if x.shape != (batch, 3, size, size) or \
                    not bool(torch.isfinite(x.data).all()):
                raise RuntimeError(f"ImageRecordIter with a resize gave "
                                   f"{x.shape}")
    finally:
        it.close()
    counts = _build.launch_counts()
    return {"decoder": it.decoder, "batches": batches,
            "resize": RESIZE_SHORT,
            "jpeg_crop_launches": counts.get(jd.KERNEL, 0),
            "jpeg_crop_scaled_launches": counts.get(jd.SCALED_KERNEL, 0)}


def train_from_records(rec, steps=20, batch=128, profile_steps=5):
    """ResNet-50 v1, bf16 NHWC hybridized under AMP, trained ``steps``
    steps from the .rec through ``DeviceFeed``, then the same step fed
    from one batch already on the card; the device's idle share over
    ``profile_steps`` more record-fed steps. Returns the numbers and the
    K4 and crop kernel launches of the timed record-fed steps."""
    from .. import gpu, nd
    from ..contrib import amp
    from ..examples import train_imagenet_rec as ex
    from ..kernels import _build
    from ..kernels import jpeg_decode as jd
    from . import profile_resnet as pr

    ctx = gpu(0)
    net = ex.build(ctx, CLASSES, layout="NHWC")
    trainer = ex.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    net.hybridize()
    # the captures first, on a batch already on the card: a CUDA graph
    # capture must not share the card with the decode threads' work
    rs = onp.random.RandomState(0)
    x = nd.array(rs.standard_normal((batch, IMAGE, IMAGE, 3)).astype("f"),
                 ctx=ctx)
    y = nd.array(rs.randint(0, CLASSES, batch).astype("f"), ctx=ctx)
    _note("train: captures on a device batch")
    for _ in range(2):
        pr.train_step(net, trainer, x, y)
    torch.cuda.synchronize()
    it = ex.record_iter(rec, batch, IMAGE, os.cpu_count() or 1)
    batches = ex.fed_batches(it, ctx, "NHWC")
    try:
        _note("train: record-fed steps")
        ex.train(batches, net, trainer, 1)  # the feed's first batch
        _build.reset_launch_counts()
        losses, secs, waits = ex.train(batches, net, trainer, steps)
        counts = _build.launch_counts()

        def fed_step():
            xb, yb, _ = next(batches)
            pr.train_step(net, trainer, xb, yb)

        _note("train: record-fed steps profiled")
        prof = pr.profile_steps(fed_step, profile_steps)
    finally:
        batches.close()
        it.close()

    def device_step():
        pr.train_step(net, trainer, x, y)

    try:
        _note("train: device-fed steps")
        t0 = time.perf_counter()
        for _ in range(steps):
            device_step()
        torch.cuda.synchronize()
        device_ms = (time.perf_counter() - t0) * 1e3 / steps
        prof_dev = pr.profile_steps(device_step, profile_steps)
    finally:
        amp.disable()
    step_ms = 1e3 * statistics.mean(secs)
    return {"steps": steps, "batch": batch, "losses": losses,
            "step_ms": step_ms, "step_ms_median":
                1e3 * statistics.median(secs),
            "images_per_s": batch * 1e3 / step_ms,
            "feed_wait_ms": 1e3 * statistics.mean(waits),
            "device_fed_step_ms": device_ms,
            "idle_share": prof["device_idle_share"],
            "idle_share_device_fed": prof_dev["device_idle_share"],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "k4_launches": counts.get(pr.FWD_KERNEL, 0)
            + counts.get(pr.BWD_KERNEL, 0),
            "jpeg_crop_launches": counts.get(jd.KERNEL, 0),
            "jpeg_crop_scaled_launches": counts.get(jd.SCALED_KERNEL, 0),
            "decoder": it.decoder}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--images", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_records: needs a CUDA device")
    out = {"card": card()}
    with tempfile.TemporaryDirectory(prefix="profile_records_") as d:
        rec = write_records(os.path.join(d, "train.rec"), args.images)
        out["engine"] = engine_check()
        out["decode"] = decode_check(rec)
        out["iter"] = iter_rate(rec)
        out["iter_resize"] = resize_launches(rec)
        out["train"] = train_from_records(rec, args.steps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
