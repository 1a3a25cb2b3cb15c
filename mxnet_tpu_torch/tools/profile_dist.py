"""ResNet-50 v1 trained data-parallel by ranks of a process group.

The ``dist_sync`` path of the port (MXNet's ``train_imagenet.py
--kv-store dist_sync``): every rank, started by
``mxnet_tpu_torch.tools.launch``, trains ``resnet50_v1`` at its
published widths with the fp32 step of ``tools/profile_resnet.py`` —
Xavier weights from ``--seed`` (the same on every rank), one synthetic
batch of ``--batch`` images a rank drawn from ``--seed`` plus the rank,
``autograd.record``, K4's ``rtc_softmax`` head, ``backward``, and
``gluon.Trainer(..., kvstore="dist_sync")`` with SGD (0.1, 0.9, 1e-4),
whose ``step`` sums the gradients over the ranks (the bucketed reducer
of ``pipeline/grad_sync.py`` started the sums during ``backward``)
before the fused step:

  python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local \\
      python3 -m mxnet_tpu_torch.tools.profile_dist --check

Per timed step each rank reports the step's wall ms and img/s, the host
ms inside ``Trainer.allreduce_grads`` (the part of the all-reduce not
overlapped with backward), the bytes reduced, the reducer's buckets
dispatched during backward, K4's launches and the peak memory. With
``--check`` every timed step also holds:

- the reduced gradient, bitwise, to the sum of the ranks' gradients
  saved before the reduction (gathered to the host; with two ranks the
  sum is one float32 add);
- the parameters, bitwise equal on every rank;

and the loss at step ``--loss-step`` (untimed steps after the timed
ones) below the first. Other legs, each from the weights of the start;
the two compared runs take cuDNN's deterministic algorithms
(``cudnn.deterministic``):

- ``--compare-sync K``: K steps with ``MXNET_ASYNC_GRAD_SYNC=1`` and K
  with ``=0``, bitwise equal parameters;
- ``--compare-device K``: K steps under ``--kvstore`` and K under
  ``kvstore="device"`` (meant for one rank: the collective of one rank
  changes nothing), bitwise equal;
- ``--compression K``: K steps with 2-bit compression (threshold
  0.5, MXNet's default); each
  parameter's packed codes and residual for that step's gradient, made
  on the rank's device, equal to the CPU port's for the same gradient
  and residual, and to the residual the trainer kept;
- ``--bandwidth SIZES``: ``tools/bandwidth.py``'s rates at those sizes
  (``--bw-iters`` calls each, after one).

Each rank prints one JSON object and, with ``--out DIR``, writes it to
``DIR/rank<r>.json``. ``--cpu`` with ``MXNET_DIST_DEVICE=cpu`` runs the
same on the CPU (``--model``, ``--image``, ``--classes`` shrink it).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as onp
import torch

from .. import autograd, gluon, initializer, nd, pipeline
from .. import _rendezvous as rdv
from .. import random as mxrandom
from ..base import MXNetError
from ..gluon.model_zoo import vision
from . import profile_resnet as pr

__all__ = ["build", "batch", "make_trainer", "step", "main"]

GC_THRESHOLD = 0.5  # MXNet's default 2-bit threshold


def build(model, ctx, seed, classes, image):
    """The model with Xavier weights from ``seed`` on ``ctx``; every rank
    draws the same."""
    mxrandom.seed(seed)
    net = vision.get_model(model, classes=classes)
    net.initialize(initializer.Xavier(), ctx=ctx)
    with autograd.pause():
        net(nd.zeros((1, 3, image, image), ctx=ctx))
    return net


def batch(n, ctx, seed, classes, image):
    """This rank's fixed batch: N(0, 1) images and float class labels
    from ``seed`` plus the rank, made with numpy."""
    rs = onp.random.RandomState(seed + rdv.rank())
    x = rs.standard_normal((n, 3, image, image)).astype("float32")
    y = rs.randint(0, classes, n).astype("float32")
    return nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)


def make_trainer(net, kvstore="dist_sync", compression_params=None):
    return gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": pr.LR, "momentum": pr.MOMENTUM,
                          "wd": pr.WD}, kvstore=kvstore,
                         compression_params=compression_params)


def _forward_backward(net, x, y):
    with autograd.record():
        logits = net(x)
        p = pr.rtc_softmax(logits, y)
    p.backward()
    return pr.cross_entropy(logits, y)


def _global_batch(x):
    return x.shape[0] * rdv.world_size()


def step(net, trainer, x, y):
    """One step: record, the ``rtc_softmax`` head, backward, then
    ``trainer.step`` over the ranks' whole batch (the all-reduce sums
    their gradients, so the update follows their mean, as one process
    at the whole batch would). Returns the rank's batch's cross-entropy
    (an NDArray, not synchronized)."""
    loss = _forward_backward(net, x, y)
    trainer.step(_global_batch(x))
    return loss


def _trained(net):
    return [p for p in net.collect_params().values() if p.grad_req != "null"]


def _flat(tensors):
    with torch.no_grad():
        return torch.cat([t.detach().reshape(-1) for t in tensors])


def _gather_host(t):
    """Every rank's copy of ``t``, on the host, in rank order."""
    import torch.distributed as dist

    if rdv.world_size() == 1:
        return [t.detach().cpu()]
    # NCCL gathers device tensors, gloo host ones
    src = t.detach() if rdv.backend() == "nccl" else t.detach().cpu()
    out = [torch.empty_like(src) for _ in range(rdv.world_size())]
    dist.all_gather(out, src)
    return [o.cpu() for o in out]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _snapshot(net):
    return [p.data().data.detach().clone()
            for p in net.collect_params().values()]


def _restore(net, snap):
    with torch.no_grad():
        for p, v in zip(net.collect_params().values(), snap):
            p.data().data.copy_(v)


def train(net, x, y, dev, args):
    """The timed steps (with ``--check`` the per-step checks) and the
    untimed ones up to ``--loss-step``."""
    from ..kernels import _build

    trainer = make_trainer(net, args.kvstore)
    ar_ms = []
    orig = trainer.allreduce_grads

    def timed_allreduce():
        t0 = time.perf_counter()
        orig()
        ar_ms.append((time.perf_counter() - t0) * 1e3)

    trainer.allreduce_grads = timed_allreduce
    losses = []
    for _ in range(args.warmup):
        losses.append(float(step(net, trainer, x, y).asscalar()))
    _sync(dev)
    params = _trained(net)
    grad_bytes = sum(p.grad().data.numel() * p.grad().data.element_size()
                     for p in params)
    _build.reset_launch_counts()
    pipeline.reset_pipeline_counters()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_ms, checks = [], []
    del ar_ms[:]
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss = _forward_backward(net, x, y)
        if args.check:  # one device copy, inside the step's time
            local = _flat([p.grad().data for p in params])
        trainer.step(_global_batch(x))
        losses.append(float(loss.asscalar()))
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if args.check:
            reduced = _flat([p.grad().data for p in params]).cpu()
            parts = _gather_host(local)
            expect = parts[0].clone()
            for q in parts[1:]:
                expect += q
            ws = _gather_host(_flat([p.data().data for p in params]))
            checks.append({
                "step": args.warmup + i + 1,
                "reduced_is_sum": bool(torch.equal(reduced, expect)),
                "params_equal": all(torch.equal(ws[0], w) for w in ws[1:])})
            del local, parts, expect, ws, reduced
        step_ms.append(ms)
    counts = _build.launch_counts()
    counters = pipeline.pipeline_counters()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    timed_ar = list(ar_ms)
    while len(losses) < args.loss_step:
        losses.append(float(step(net, trainer, x, y).asscalar()))
    _sync(dev)
    trainer.allreduce_grads = orig
    del trainer
    return {
        "step_ms": step_ms, "img_per_s": [x.shape[0] * 1e3 / m
                                          for m in step_ms],
        "allreduce_ms": timed_ar, "grad_bytes_per_step": grad_bytes,
        "buckets_in_backward": counters["grad_buckets"],
        "flush_buckets": counters["grad_flush_buckets"],
        "stale_discards": counters["grad_stale_discards"],
        "k4_launches": counts, "k4_launches_per_step": {
            k: v / args.steps for k, v in counts.items()},
        "peak_gb": None if peak is None else peak / 1e9,
        "checks": checks, "losses": losses,
        "loss_falls": losses[-1] < losses[0]}


def _deterministic_run(net, snap, x, y, steps, kvstore, sync):
    """``steps`` steps from the weights ``snap`` with a new trainer; the
    parameters after them."""
    _restore(net, snap)
    os.environ["MXNET_ASYNC_GRAD_SYNC"] = sync
    trainer = make_trainer(net, kvstore)
    for _ in range(steps):
        step(net, trainer, x, y)
    del trainer
    return _flat([p.data().data for p in net.collect_params().values()])


def compare_runs(net, snap, x, y, steps, a, b):
    """Two deterministic runs of ``steps`` steps, ``a`` and ``b`` each a
    (kvstore, MXNET_ASYNC_GRAD_SYNC) pair: bitwise equal?"""
    old = os.environ.get("MXNET_ASYNC_GRAD_SYNC")
    flag = torch.backends.cudnn.deterministic
    # cuDNN's deterministic algorithms; with benchmark on, the first run
    # times them once and the second reuses its picks (the cache is keyed
    # by the flag too)
    torch.backends.cudnn.deterministic = True
    try:
        wa = _deterministic_run(net, snap, x, y, steps, *a)
        wb = _deterministic_run(net, snap, x, y, steps, *b)
    finally:
        torch.backends.cudnn.deterministic = flag
        if old is None:
            os.environ.pop("MXNET_ASYNC_GRAD_SYNC", None)
        else:
            os.environ["MXNET_ASYNC_GRAD_SYNC"] = old
    return {"runs": [list(a), list(b)], "steps": steps,
            "bitwise_equal": bool(torch.equal(wa, wb)),
            "max_abs_diff": float((wa - wb).abs().max())}


def compression_check(net, snap, x, y, steps, kvstore, threshold):
    """``steps`` steps with 2-bit compression from the weights ``snap``;
    for each, every parameter's codes and residual on the device against
    the CPU port's for the same gradient and residual."""
    from ..gradient_compression import GradientCompression

    _restore(net, snap)
    trainer = make_trainer(net, kvstore, {"type": "2bit",
                                          "threshold": threshold})
    gc, host_gc = trainer._compression, GradientCompression("2bit",
                                                             threshold)
    params = _trained(net)
    out = []
    for s in range(steps):
        _forward_backward(net, x, y)
        grads = [p.grad().data.detach().clone() for p in params]
        before = [trainer._residuals.get(i) for i in range(len(params))]
        before = [None if r is None else r.clone() for r in before]
        trainer.step(_global_batch(x))
        codes_equal = res_equal = kept_equal = True
        nonzero = 0
        for i, g in enumerate(grads):
            flat = g.reshape(-1).to(torch.float32)
            r0 = torch.zeros_like(flat) if before[i] is None else before[i]
            pk, rk = gc.quantize(flat, r0)
            ph, rh = host_gc.quantize(flat.cpu(), r0.cpu())
            codes_equal &= torch.equal(pk.cpu(), ph)
            res_equal &= torch.equal(rk.cpu(), rh)
            kept_equal &= torch.equal(trainer._residuals[i], rk)
            nonzero += int((gc.dequantize(pk, flat.numel()) != 0).sum())
        out.append({"step": s + 1, "codes_equal": bool(codes_equal),
                    "residuals_equal": bool(res_equal),
                    "kept_residual_equal": bool(kept_equal),
                    "nonzero_codes": nonzero})
    del trainer
    return {"threshold": threshold, "steps": out}


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50_v1")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image", type=int, default=pr.IMAGE)
    ap.add_argument("--classes", type=int, default=pr.CLASSES)
    ap.add_argument("--seed", type=int, default=pr.SEED)
    ap.add_argument("--kvstore", default="dist_sync")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--loss-step", type=int, default=0,
                    help="train untimed up to this step for the loss check")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--compare-sync", type=int, default=0)
    ap.add_argument("--compare-device", type=int, default=0)
    ap.add_argument("--compression", type=int, default=0)
    ap.add_argument("--bandwidth", default="")
    ap.add_argument("--bw-iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not rdv.is_initialized():
        raise SystemExit("profile_dist: run under mxnet_tpu_torch.tools.launch")
    ctx = rdv.device()
    if (ctx.device_type == "cpu") != args.cpu:
        raise MXNetError(f"profile_dist: the rank's device is {ctx}; pass "
                         "--cpu exactly when MXNET_DIST_DEVICE=cpu")
    dev = ctx.torch_device
    if dev.type == "cuda":
        # full float32 and cuDNN's timed picks, as tools/profile_resnet.py
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
    marks = [("start", time.perf_counter())]
    net = build(args.model, ctx, args.seed, args.classes, args.image)
    x, y = batch(args.batch, ctx, args.seed, args.classes, args.image)
    snap = _snapshot(net)
    ws = _gather_host(_flat(snap))
    res = {"rank": rdv.rank(), "ranks": rdv.world_size(),
           "backend": rdv.backend(), "device": str(ctx),
           "card": _card() if dev.type == "cuda" else None,
           "model": args.model, "batch": args.batch, "image": args.image,
           "kvstore": args.kvstore,
           "async_grad_sync": pipeline.async_grad_sync_enabled(),
           "bucket_kb": pipeline.grad_bucket_bytes() // 1024,
           "start_weights_equal": all(torch.equal(ws[0], w)
                                      for w in ws[1:])}
    del ws
    marks.append(("build", time.perf_counter()))
    if args.steps:
        res["train"] = train(net, x, y, dev, args)
        marks.append(("train", time.perf_counter()))
    if args.compare_sync:
        res["compare_sync"] = compare_runs(
            net, snap, x, y, args.compare_sync, (args.kvstore, "1"),
            (args.kvstore, "0"))
        marks.append(("compare_sync", time.perf_counter()))
    if args.compare_device:
        res["compare_device"] = compare_runs(
            net, snap, x, y, args.compare_device, (args.kvstore, "1"),
            ("device", "1"))
        marks.append(("compare_device", time.perf_counter()))
    if args.compression:
        res["compression"] = compression_check(
            net, snap, x, y, args.compression, args.kvstore, GC_THRESHOLD)
        marks.append(("compression", time.perf_counter()))
    if args.bandwidth:
        from . import bandwidth

        del net, snap
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res["bandwidth"] = [bandwidth.measure(float(s), args.bw_iters, 1)
                            for s in args.bandwidth.split(",")]
        marks.append(("bandwidth", time.perf_counter()))
    # the host seconds of each leg
    res["seconds"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    line = json.dumps(res)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"rank{rdv.rank()}.json"), "w") as f:
            f.write(line)
    print(line, flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
