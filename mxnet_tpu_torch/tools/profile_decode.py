"""Where one batched decode step's time goes, on the card.

Builds ``DecoderBlockLM`` at GPT-2-small widths (random weights from a
seed) behind a ``SessionStateStore`` (row-slot, or paged with
``--paged PAGE_TOKENS``) and an ``InferenceSession`` whose step runs as
one captured CUDA graph per occupancy bucket (``--graphs``, the
default) or eagerly (``--eager``); ``--both`` measures the two, eager
then graphs, on one card. It opens ``--rows`` sessions and runs the
batcher's step body — acquire, gather, step, scatter, read the logits
back, release — for ``--steps`` steps under ``torch.profiler``. Prints
one JSON object per mode: host wall ms per step, device busy ms per
step (the sum of CUDA kernel and copy times), the device's idle share,
device operations and host launch calls (kernels, or one graph) per
step, and the heaviest kernels. Run on a machine
with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_decode [--rows 8]
        [--paged 16] [--graphs | --eager | --both]

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
# the runtime calls that put work on the device: a kernel, or a whole graph
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cudaGraphLaunch")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build(net, rows, page_tokens=0, buckets=None, graphs=True, budget=0,
          kv_int8=False):
    """A store of ``rows`` sessions (paged when ``page_tokens`` > 0, its
    page pool capped at ``budget`` bytes when > 0, int8 pages with
    ``kv_int8``) and a session over ``net`` on ``gpu(0)``; returns
    ``(store, session)``."""
    ctx = gpu(0)
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=rows,
        byte_budget=budget, ttl_s=0, pageable=net.state_row_pageable(),
        page_tokens=page_tokens, kv_int8=kv_int8, ctx=ctx)
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=buckets or sorted({1, 2, 4, 8, rows}),
        graphs=graphs, ctx=ctx)
    return store, sess


def profile_steps(store, sess, sids, steps, seed, trace=None):
    """Profile ``steps`` batched decode steps of the live sessions
    ``sids`` (three warm-up steps first) as the batcher runs them.
    Returns the per-step numbers as a dict."""
    rs = onp.random.RandomState(seed)
    vocab = sess._block.embed.weight.shape[0]

    def one_step():
        recs = [store.acquire(sid) for sid in sids]
        toks = rs.randint(vocab, size=(len(sids), 1)).astype("int32")
        try:
            logits = sess._run_store_step([toks], recs)[0]
        finally:
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
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    if trace:
        prof.export_chrome_trace(trace)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.device_time if hasattr(ev, "device_time") else \
                ev.cuda_time
            by_name[ev.name][0] += dur
            by_name[ev.name][1] += 1
            busy_us += dur
    busy_ms = busy_us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    cpu_top = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)
    host_launches = sum(e.count for e in cpu_top if e.key in _LAUNCH_CALLS)
    return {
        "rows": len(sids), "bucket": sess._bucket_for(len(sids)),
        "graphs": sess.graphs, "paged": store.paged,
        "page_tokens": store.page_tokens, "steps": steps,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                              if wall_ms else None),
        "device_ops_per_step": sum(c for _, c in by_name.values()) / steps,
        "host_launches_per_step": host_launches / steps,
        "top_device_ms_per_step": {
            name[:80]: {"ms": us / 1e3 / steps, "per_step": cnt / steps}
            for name, (us, cnt) in top},
        "top_host_self_ms_per_step": {
            e.key[:60]: {"self_ms": e.self_cpu_time_total / 1e3 / steps,
                         "per_step": e.count / steps}
            for e in cpu_top[:10]}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8,
                    help="live sessions in every step (default 8)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--paged", type=int, default=0, metavar="PAGE_TOKENS",
                    help="store KV caches as pages of this many tokens "
                         "(default 0: row slots)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--graphs", dest="modes", action="store_const",
                      const=(True,), help="one CUDA graph per bucket "
                                          "(default)")
    mode.add_argument("--eager", dest="modes", action="store_const",
                      const=(False,), help="the step run eagerly")
    mode.add_argument("--both", dest="modes", action="store_const",
                      const=(False, True), help="eager, then graphs")
    ap.add_argument("--seed", type=int, default=20240917)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    mxrandom.seed(args.seed)
    net = DecoderBlockLM(**GPT2_SMALL)
    net.initialize(ctx=gpu(0))
    card = _card()
    for graphs in args.modes or (True,):
        store, sess = build(net, args.rows, args.paged, graphs=graphs)
        sids = [f"s{i}" for i in range(args.rows)]
        for sid in sids:
            store.open(sid)
        row = profile_steps(store, sess, sids, args.steps, args.seed,
                            trace=args.trace)
        print(json.dumps({"card": card, **row}))
        sess.close()
        store.close()
        del store, sess
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
