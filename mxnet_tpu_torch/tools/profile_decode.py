"""Where one batched decode step's time goes, on the card.

Builds ``DecoderBlockLM`` at GPT-2-small widths (random weights from a
seed) behind a ``SessionStateStore`` and an ``InferenceSession``, opens
``--rows`` sessions, and runs the batcher's step body — gather, step,
scatter, read the logits back — for ``--steps`` steps under
``torch.profiler``. Prints one JSON object: host wall ms per step, device
busy ms per step (the sum of CUDA kernel and copy times), the device's
idle share, kernel launches per step, and the device time per step of
the heaviest kernels. Run on a machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_decode [--rows 8]

It needs no network and writes nothing unless ``--trace PATH`` is given
(a Chrome trace of the profiled window).
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as onp
import torch

from .. import gpu, random as mxrandom, serving
from ..models import DecoderBlockLM

GPT2_SMALL = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                  num_heads=12, ffn_dim=3072, max_len=1024)


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8,
                    help="live sessions in every step (default 8)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=20240917)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = gpu(0)
    mxrandom.seed(args.seed)
    net = DecoderBlockLM(**GPT2_SMALL)
    net.initialize(ctx=ctx)
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(),
        max_sessions=args.rows, byte_budget=0, ttl_s=0, ctx=ctx)
    buckets = sorted({1, 2, 4, 8, args.rows})
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=buckets, ctx=ctx)
    sids = [f"s{i}" for i in range(args.rows)]
    for sid in sids:
        store.open(sid)
    rs = onp.random.RandomState(args.seed)
    bucket = sess._bucket_for(args.rows)

    def one_step():
        recs = [store.acquire(sid) for sid in sids]
        toks = rs.randint(GPT2_SMALL["vocab_size"],
                          size=(args.rows, 1)).astype("int32")
        states = store.gather(recs, pad_to=bucket)
        outs, news = sess._run_step([toks], states, args.rows, adopted=True)
        store.scatter(recs, news)
        logits = outs[0].cpu().numpy()  # waits for the step
        for rec in recs:
            store.release(rec)
        return logits

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    if args.trace:
        prof.export_chrome_trace(args.trace)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.device_time if hasattr(ev, "device_time") else \
                ev.cuda_time
            by_name[ev.name][0] += dur
            by_name[ev.name][1] += 1
            busy_us += dur
    busy_ms = busy_us / 1e3 / args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    cpu_top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    cpu_ops = {e.key[:60]: {"self_ms": e.self_cpu_time_total / 1e3
                            / args.steps, "per_step": e.count / args.steps}
               for e in cpu_top[:10]}
    print(json.dumps({
        "card": _card(), "rows": args.rows, "bucket": bucket,
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                              if wall_ms else None),
        "device_ops_per_step": sum(c for _, c in by_name.values())
        / args.steps,
        "top_device_ms_per_step": {
            name[:80]: {"ms": us / 1e3 / args.steps,
                        "per_step": cnt / args.steps}
            for name, (us, cnt) in top},
        "top_host_self_ms_per_step": cpu_ops}))
    sess.close()
    store.close()


if __name__ == "__main__":
    main()
