"""The host runtime and the record pipeline on the card: measurements.

What ``chip_smoke.py`` phases 59-62 run, also runnable alone:

    python3 -m mxnet_tpu_torch.tools.profile_records [--steps 20]

- :func:`engine_check`: pushes through both lanes of the dependency
  engine, a poisoned var raised again at ``wait_for_var``, an op that
  works on the card finished when ``nd.waitall()`` returns, and the cost
  of a push (native engine and ``NaiveEngine``);
- :func:`decode_check`: which decoder the machine has, the nvJPEG
  route's crop kernel against its plain version (bitwise) and the
  decoded batch against the Python twin (PIL), with times;
- :func:`iter_rate`: ``ImageRecordIter`` alone, images/s;
- :func:`train_from_records`: ResNet-50 v1 trained from the .rec through
  ``DeviceFeed`` (the example twin's helpers), the same step fed from
  tensors already on the card beside it, and the device's idle share.

Every function needs a CUDA device; each result names the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import statistics
import subprocess
import tempfile
import time

import numpy as onp
import torch

__all__ = ["card", "write_records", "engine_check", "decode_check",
           "iter_rate", "train_from_records"]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
IMAGE, STORED, CLASSES = 224, 252, 1000
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


def crop_bound_ms(plan, H, W):
    """Least ms of ``jpeg_crop`` for ``plan``: the output written once,
    the source pixels it needs read once (the crop without a resize, the
    scaled image with one), the plan read once."""
    nbytes = plan.size * 8
    for (_, w, h, denom, sw, sh, tw, th, *_rest) in plan.tolist():
        nbytes += H * W * 3
        nbytes += H * W * 3 if (tw, th) == (sw, sh) and denom == 1 \
            else w * h * 3
    return nbytes / HBM_BYTES_PER_S * 1e3


def decode_check(rec, batch=128, size=IMAGE, seed=0):
    """The decoder probe's answer and, on the nvJPEG route, the crop
    kernel against its plain version and the batch against the Python
    twin, with times. Raises when a check fails."""
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
    plan_np = jd.crop_plan(sizes, size, size, 0, crops)
    plan = torch.from_numpy(plan_np).to(dev)
    _note("decode: jpeg_crop against its plain version")
    got = jd.jpeg_crop(src, plan, size, size)
    plain = jd._crop_ref(src, plan, size, size)
    torch.cuda.synchronize()
    kernel_err = (got.int() - plain.int()).abs().max().item()
    if kernel_err != 0:
        raise RuntimeError(f"jpeg_crop differs from its plain version by "
                           f"{kernel_err} levels")
    out["vs_python_twin"] = _levels(got.cpu().numpy(), twin)
    # the IDCT alone: the same seeded pixels as 4:4:4 JPEGs
    blobs444 = _first_batch_444(rec, 32)
    crops444 = crops[:32]
    src444, sizes444 = jd.decode_full(blobs444, dev)
    got444 = jd.jpeg_crop(src444, torch.from_numpy(jd.crop_plan(
        sizes444, size, size, 0, crops444)).to(dev), size, size)
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
    _note("decode: times")
    out["kernel"] = {
        "ms": _events_ms(lambda: jd.jpeg_crop(src, plan, size, size)),
        "plain_ms": _events_ms(lambda: jd._crop_ref(src, plan, size, size),
                               reps=3),
        "bound_ms": crop_bound_ms(plan_np, size, size), "bound_by": "bytes",
        "library_ms": None, "max_abs_err": float(kernel_err),
        "shape": f"{batch} x {size} x {size} x 3 uint8 from "
                 f"{sizes[0][0]} x {sizes[0][1]} JPEGs, no resize"}
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


def train_from_records(rec, steps=20, batch=128, profile_steps=5):
    """ResNet-50 v1, bf16 NHWC hybridized under AMP, trained ``steps``
    steps from the .rec through ``DeviceFeed``, then the same step fed
    from one batch already on the card; the device's idle share over
    ``profile_steps`` more record-fed steps. Returns the numbers and the
    K4 and jpeg_crop launches of the timed record-fed steps."""
    from .. import gpu, nd
    from ..contrib import amp
    from ..examples import train_imagenet_rec as ex
    from ..kernels import _build
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
            "jpeg_crop_launches": counts.get("jpeg_crop", 0),
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
        out["train"] = train_from_records(rec, args.steps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
