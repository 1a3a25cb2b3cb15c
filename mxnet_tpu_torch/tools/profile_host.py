"""The port's host-bound paths, timed on the card with telemetry off.

Four measurements, each where the host's time per operation shows:

- ``dispatch``: microseconds per eager ``a + b`` of two 4-element
  NDArrays on the card (10,000 calls and one synchronize, per repeat);
- ``decode_eager``: 8 streams of ``DecoderBlockLM`` at GPT-2-small
  widths through ``DynamicBatcher`` over an eager session (no CUDA
  graphs, about 600 launches a step), closed loop, ms per round;
- ``decode``: the same model with one captured graph per occupancy
  bucket, fed ``chip_smoke.py`` phase 18's open-loop traffic (32 paged
  streams of 16-256 tokens, arrivals 25 ms apart on average):
  tokens/s, decode steps and the mean host-timed step, per run;
- ``resnet``: ``resnet50_v1`` trained eagerly in float32 at batch 128
  (phase 16's setup), median step ms.

Weights come from a seed. It imports only what the port had before its
telemetry, so it times any checkout of the port: put that checkout first
on ``PYTHONPATH`` and run this file by its path. Two commits compare on
one card in one call, in turns A, B, B, A::

    PYTHONPATH=<checkout> MXNET_TELEMETRY=0 \\
        python3 <this file> [--only dispatch,decode_eager,decode,resnet]
        [--runs 3]

Prints the card's name and power limit, then one JSON object whose
``package`` names the checkout that was timed. Needs one NVIDIA GPU and
no network, and writes nothing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from concurrent.futures import FIRST_COMPLETED, wait

import numpy as onp
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, serving
from mxnet_tpu_torch.models import DecoderBlockLM
from mxnet_tpu_torch.tools import profile_decode as pd
from mxnet_tpu_torch.tools import profile_resnet as pr

SEED = 20240917
GPT2_SMALL = pd.GPT2_SMALL
# chip_smoke.py phase 18's traffic and paged store
STREAMS, MIN_TOKENS, MAX_TOKENS, GAP_S = 32, 16, 256, 0.025
PAGE_TOKENS, BUCKETS, BUDGET = 16, [1, 2, 4, 8, 16, 32], 2 ** 30
EAGER_ROWS, EAGER_WARMUP, EAGER_ROUNDS = 8, 5, 40
RESNET_B, RESNET_WARMUP, RESNET_STEPS = 128, 3, 10


def dispatch(repeats=7, calls=10000):
    """Per repeat, µs per eager ``a + b`` on the card."""
    a = nd.ones((4,), ctx=mx.gpu(0))
    b = nd.ones((4,), ctx=mx.gpu(0))
    for _ in range(1000):
        a + b
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            a + b
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / calls * 1e6)
    return out


def _batcher(sess, rows):
    return serving.DynamicBatcher(sess, max_batch_size=rows,
                                  max_latency_ms=2.0, timeout_ms=600000,
                                  admission=False)


def _mean_step_ms():
    hist = serving.METRICS.exec_latency
    return hist.sum / max(hist.total, 1) * 1e3


def decode_eager(net):
    """8 streams, closed loop, through an eager session: ms per round
    (one token of every stream) and decode steps per round."""
    store, sess = pd.build(net, EAGER_ROWS, PAGE_TOKENS, graphs=False)
    bat = _batcher(sess, EAGER_ROWS)
    toks = onp.random.RandomState(SEED).randint(
        GPT2_SMALL["vocab_size"], size=EAGER_ROWS).tolist()
    ms = []
    try:
        for r in range(EAGER_WARMUP + EAGER_ROUNDS):
            if r == EAGER_WARMUP:
                serving.METRICS.reset()
            t0 = time.perf_counter()
            futs = [bat.submit(onp.array([[t]], "int32"),
                               session_id=f"e{i}", slo_class="standard")
                    for i, t in enumerate(toks)]
            toks = [int(onp.asarray(f.result()).argmax()) for f in futs]
            if r >= EAGER_WARMUP:
                ms.append((time.perf_counter() - t0) * 1e3)
        steps = serving.METRICS.snapshot()["decode_steps"]
    finally:
        bat.close()
        sess.close()
        store.close()
    return {"ms_per_round": ms, "median_ms": statistics.median(ms),
            "steps_per_round": steps / EAGER_ROUNDS}


def _traffic(bat, run, lengths, arrivals, first):
    """Phase 18's open loop: stream i arrives at ``arrivals[i]``; each
    step's argmax is its next token until it has ``lengths[i]``."""
    n = len(lengths)
    sids = [f"{run}-{i}" for i in range(n)]
    count = dict.fromkeys(sids, 0)
    pending, started = {}, 0

    def submit(sid, tok):
        pending[bat.submit(onp.array([[tok]], "int32"), session_id=sid,
                           slo_class="standard")] = sid
        count[sid] += 1

    t0 = time.perf_counter()
    while pending or started < n:
        now = time.perf_counter() - t0
        while started < n and arrivals[started] <= now:
            submit(sids[started], first[started])
            started += 1
        wait_s = arrivals[started] - now if started < n else 600
        done, _ = wait(pending, timeout=max(wait_s, 0.0),
                       return_when=FIRST_COMPLETED)
        if not done and started == n:
            raise RuntimeError("decode stalled: no step resolved in 600 s")
        for fut in done:
            sid = pending.pop(fut)
            logits = onp.asarray(fut.result())
            if not onp.isfinite(logits).all():
                raise RuntimeError(f"{sid}: non-finite logits")
            if count[sid] < lengths[sids.index(sid)]:
                submit(sid, int(logits.argmax()))
    return time.perf_counter() - t0, sids


def decode(net, runs):
    """Phase 18's traffic ``runs`` times after a warm-up run: per run
    tokens/s, decode steps and the mean host-timed step."""
    store, sess = pd.build(net, STREAMS, PAGE_TOKENS, BUCKETS, budget=BUDGET)
    rs = onp.random.RandomState(SEED + 18)
    lengths = [int(n) for n in rs.randint(MIN_TOKENS, MAX_TOKENS + 1,
                                          STREAMS)]
    arrivals = onp.cumsum(rs.exponential(GAP_S, STREAMS))
    first = [int(rs.randint(GPT2_SMALL["vocab_size"]))
             for _ in range(STREAMS)]
    bat = _batcher(sess, BUCKETS[-1])
    out = []
    try:
        for run in range(runs + 1):
            serving.METRICS.reset()
            wall, sids = _traffic(bat, f"r{run}", lengths, arrivals, first)
            snap = serving.METRICS.snapshot()
            if snap["responses:standard"] != sum(lengths) or \
                    snap["failures"]:
                raise RuntimeError(f"not every step resolved: {snap}")
            if run:
                out.append({"tokens_per_s": sum(lengths) / wall,
                            "wall_s": wall,
                            "decode_steps": snap["decode_steps"],
                            "mean_step_ms": _mean_step_ms()})
            for sid in sids:
                store.evict(sid, reason="run done")
    finally:
        bat.close()
        sess.close()
        store.close()
    return out


def resnet():
    """ResNet-50 v1 eager float32 at batch 128: median step ms."""
    torch.backends.cudnn.benchmark = True
    ctx = mx.gpu(0)
    net = pr.build_resnet50(ctx, seed=SEED)
    trainer = pr.make_trainer(net)
    x, y = pr.synthetic_batch(RESNET_B, ctx, seed=SEED)
    for _ in range(RESNET_WARMUP):
        pr.train_step(net, trainer, x, y)
    torch.cuda.synchronize()
    ms = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss = pr.train_step(net, trainer, x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if not onp.isfinite(loss.asscalar()):
        raise RuntimeError("non-finite ResNet-50 loss")
    return {"step_ms": ms, "median_ms": statistics.median(ms)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="dispatch,decode_eager,decode,resnet")
    ap.add_argument("--runs", type=int, default=3,
                    help="timed runs of phase 18's traffic")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_host needs a CUDA device")
    print(pd._card(), flush=True)
    which = args.only.split(",")
    out = {"package": mx.__file__}
    if "dispatch" in which:
        out["dispatch_us"] = dispatch()
    if "decode_eager" in which or "decode" in which:
        mx.random.seed(SEED)
        net = DecoderBlockLM(**GPT2_SMALL)
        net.initialize(ctx=mx.gpu(0))
        if "decode_eager" in which:
            out["decode_eager"] = decode_eager(net)
        if "decode" in which:
            out["decode"] = decode(net, args.runs)
        del net
        torch.cuda.empty_cache()
    if "resnet" in which:
        out["resnet"] = resnet()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
