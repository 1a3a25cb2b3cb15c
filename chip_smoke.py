#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Drives the port's main path — stateful decode serving of
``DecoderBlockLM`` at GPT-2-small widths through ``InferenceSession``,
``SessionStateStore`` and ``DynamicBatcher`` — and holds its
hand-written CUDA kernel (K2, decode attention) against the plain
PyTorch version. Run from the root of a checkout, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls;
2. build: compile every ``mxnet_tpu_torch/csrc/*.cu`` with nvcc;
3. kernel check: K2 against ``_decode_flash_ref`` on the card, within
   rtol = atol = 1e-5, at the serving shapes and at other head dims;
4. kernel times: K2, its plain version and
   ``scaled_dot_product_attention`` (a yardstick only; the port never
   calls it) at B in {1, 32}, S = 1024, L2 flushed before each launch,
   beside the bound (the bytes of the visible K and V, q and out at
   3.35 TB/s);
5. serving: 8 greedy-decode streams of 8-48 tokens through the batcher;
   every future resolves, K2 launches = layers x decode steps, and the
   three longest streams' final logits match the session's own
   explicit-state step loop within rtol = atol = 1e-4;
6. report: one JSON line of kernels, then the device line last.

Needs no network; imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import FIRST_COMPLETED, wait

import numpy as onp
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.kernels import _build  # noqa: E402
from mxnet_tpu_torch.kernels.flash_attention import (  # noqa: E402
    KERNEL, _decode_flash, _decode_flash_ref)
from mxnet_tpu_torch.models import DecoderBlockLM  # noqa: E402

SEED = 20240917
# GPT-2 small (n_embd 768, n_head 12, n_layer 12, n_positions 1024,
# vocab_size 50257, FFN 4 x 768) in the block's own architecture
GPT2_SMALL = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                  num_heads=12, ffn_dim=3072, max_len=1024)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNEL_RTOL = KERNEL_ATOL = 1e-5
SERVE_RTOL = SERVE_ATOL = 1e-4
REPS = 25


def phase(name):
    print(f"== {name}", flush=True)


def device_phase():
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("float32 matmuls in full float32: "
          "torch.backends.cuda.matmul.allow_tf32 = False")
    return smi


def build_phase():
    phase("2 build")
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"built {sorted(report) or 'nothing (up to date)'} from "
          f"{_build.CSRC_DIR} in {time.perf_counter() - t0:.2f} s")
    for name, rec in report.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def attention_inputs(gen, B, H, S, D, lengths):
    dev = torch.device("cuda")
    q = torch.randn(B, H, D, device=dev, generator=gen)
    k = torch.randn(B, S, H, D, device=dev, generator=gen)
    v = torch.randn(B, S, H, D, device=dev, generator=gen)
    n = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, n


def kernel_check_phase(gen):
    phase("3 kernel check")
    S, H, D = GPT2_SMALL["max_len"], GPT2_SMALL["num_heads"], 64
    cases = [
        (8, H, S, D, [1, 7, S, 333, 512, 2, S - 1, 64]),
        (1, H, S, D, [S]),
        (2, H, S, D, [49, 1]),
        (4, H, S, D, [8, 48, 17, 30]),
        (32, H, S, D, [S] * 32),
        (2, 3, 40, 8, [1, 40]),
        (3, 2, 100, 24, [5, 100, 61]),
        (2, 4, 77, 128, [77, 3]),
        (2, 2, 50, 256, [50, 17]),
    ]
    worst = 0.0
    for B, H_, S_, D_, lengths in cases:
        q, k, v, n = attention_inputs(gen, B, H_, S_, D_, lengths)
        scale = D_ ** -0.5
        got = _decode_flash(q, k, v, n, scale)
        want = _decode_flash_ref(q, k, v, n, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        print(f"  B={B} H={H_} S={S_} D={D_} lengths={lengths[:4]}"
              f"{'...' if len(lengths) > 4 else ''}: max_abs_err={err:.3e}")
        if not ok:
            raise RuntimeError(f"K2 disagrees with its plain version at "
                               f"B={B} H={H_} S={S_} D={D_}: {err}")
        worst = max(worst, err)
    print(f"K2 matches _decode_flash_ref within rtol=atol={KERNEL_RTOL}; "
          f"worst max_abs_err {worst:.3e}")
    return worst


def time_ms(fn, flush):
    """Median device ms of ``fn`` over REPS launches, each timed alone
    with CUDA events after ``flush`` evicts the 50 MB L2 — a decode step
    reaches attention with its caches cold."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(B, H, D, lengths):
    """Least ms for one decode-attention call: the larger of the bytes it
    must move (visible K and V, q, lengths in; out) over the memory rate
    and its flops (q.k and p.v, 2 each per element) over the fp32 rate."""
    visible = sum(int(n) for n in lengths)
    nbytes = visible * H * D * 4 * 2 + 2 * B * H * D * 4 + B * 4
    flops = 4 * visible * H * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_times_phase(gen):
    phase("4 kernel times")
    S, H, D = GPT2_SMALL["max_len"], GPT2_SMALL["num_heads"], 64
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = []
    for B in (1, 32):
        q, k, v, n = attention_inputs(gen, B, H, S, D, [S] * B)
        scale = D ** -0.5
        mask = (torch.arange(S, device="cuda")[None, :]
                < n[:, None])[:, None, None, :]  # (B, 1, 1, S)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale)[:, :, 0, :]

        lib_err = (library() - _decode_flash_ref(q, k, v, n, scale)) \
            .abs().max().item()
        row = {"B": B, "H": H, "S": S, "D": D, "visible": S,
               "ms": time_ms(lambda: _decode_flash(q, k, v, n, scale),
                             flush),
               "plain_ms": time_ms(
                   lambda: _decode_flash_ref(q, k, v, n, scale), flush),
               "library_ms": time_ms(library, flush),
               "library_max_abs_err": lib_err}
        row["bound_ms"], row["bound_by"] = attention_bound(B, H, D, [S] * B)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("  " + json.dumps(row))
        rows.append(row)
    del flush
    return rows


def serving_phase():
    phase("5 serving")
    cfg = GPT2_SMALL
    ctx = mx.gpu(0)
    mx.random.seed(SEED)
    net = DecoderBlockLM(**cfg)
    net.initialize(ctx=ctx)
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=8,
        byte_budget=0, ttl_s=0, ctx=ctx)
    t0 = time.perf_counter()
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=[1, 2, 4, 8], ctx=ctx)
    n_params = sum(p.data().size for p in net.collect_params().values())
    print(f"DecoderBlockLM {cfg}: {n_params} parameters, "
          f"{store.bytes_per_session} state bytes per session; session "
          f"built and warmed in {time.perf_counter() - t0:.2f} s")
    bat = serving.DynamicBatcher(sess, max_batch_size=8, max_latency_ms=2.0,
                                 timeout_ms=120000, admission=False)
    rs = onp.random.RandomState(SEED)
    lengths = [8, 48] + [int(x) for x in rs.randint(9, 48, size=6)]
    sids = [f"stream{i}" for i in range(len(lengths))]
    toks = {sid: [int(rs.randint(cfg["vocab_size"]))] for sid in sids}
    final = {}
    try:
        _build.reset_launch_counts()
        serving.METRICS.reset()
        t0 = time.perf_counter()
        pending = {bat.submit(onp.array([[toks[sid][0]]], "int32"),
                              session_id=sid): sid for sid in sids}
        while pending:
            done, _ = wait(pending, timeout=600, return_when=FIRST_COMPLETED)
            if not done:
                raise RuntimeError("serving stalled: no step resolved in "
                                   "600 s")
            for fut in done:
                sid = pending.pop(fut)
                logits = onp.asarray(fut.result())
                final[sid] = logits
                if len(toks[sid]) < lengths[sids.index(sid)]:
                    nxt = int(logits.argmax())  # greedy decode
                    toks[sid].append(nxt)
                    pending[bat.submit(onp.array([[nxt]], "int32"),
                                       session_id=sid)] = sid
        wall = time.perf_counter() - t0
        launches = _build.launch_counts().get(KERNEL, 0)
        snap = serving.METRICS.snapshot()
    finally:
        bat.close()
    n_tokens = sum(lengths)
    steps = snap["decode_steps"]
    print(f"{len(sids)} streams, lengths {lengths}: {n_tokens} tokens in "
          f"{steps} decode steps, {wall:.3f} s")
    if snap["responses"] != n_tokens or snap["failures"]:
        raise RuntimeError(f"not every request resolved: {snap}")
    if launches != cfg["num_layers"] * steps:
        raise RuntimeError(f"K2 launched {launches} times in {steps} decode "
                           f"steps of {cfg['num_layers']} layers")
    print(f"K2 launches {launches} = {cfg['num_layers']} layers x {steps} "
          "decode steps")
    for sid, logits in final.items():
        if logits.shape != (1, cfg["vocab_size"]) or \
                not onp.isfinite(logits).all():
            raise RuntimeError(f"{sid}: bad logits {logits.shape}")
    # the oracle: the session's own explicit-state loop, one stream at a
    # time (batch 1, so cuBLAS may sum in another order: tolerance)
    worst = 0.0
    for sid in sorted(sids, key=lambda s: -len(toks[s]))[:3]:
        states = [onp.zeros((1,) + s, dt) for s, dt in
                  zip(net.state_row_shapes(), net.state_row_dtypes())]
        for tok in toks[sid]:
            out, states = sess.step(onp.array([[tok]], "int32"),
                                    states=states)
        ref = out.asnumpy()
        err = float(onp.abs(ref - final[sid]).max())
        worst = max(worst, err)
        if not onp.allclose(final[sid], ref, rtol=SERVE_RTOL,
                            atol=SERVE_ATOL):
            raise RuntimeError(f"{sid}: batcher logits differ from the "
                               f"explicit step loop by {err}")
    print(f"three longest streams match the explicit step loop within "
          f"rtol=atol={SERVE_RTOL}; worst max_abs_err {worst:.3e}")
    # the state copies each batched step pays: gather + scatter of 8 slots
    recs = [store.acquire(sid) for sid in sids]
    times = []
    try:
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            store.scatter(recs, store.gather(recs, pad_to=8))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    finally:
        for rec in recs:
            store.release(rec, stepped=False)
    copy_ms = statistics.median(times)
    copy_bytes = 2 * len(recs) * store.bytes_per_session
    result = {"tokens_per_s": n_tokens / wall,
              "decode_steps": steps,
              "mean_step_ms": snap["exec_mean_s"] * 1e3,
              "mean_rows_per_step": snap["true_rows"] / max(steps, 1),
              "padded_rows": snap["padded_rows"],
              "gather_scatter_ms_at_8": copy_ms,
              "gather_scatter_bytes_at_8": copy_bytes,
              "gather_scatter_bound_ms_at_8":
                  copy_bytes * 2 / HBM_BYTES_PER_S * 1e3,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("serving " + json.dumps(result))
    sess.close()
    store.close()
    return launches, result


def main():
    smi = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = kernel_check_phase(gen)
    rows = kernel_times_phase(gen)
    launches, _ = serving_phase()
    phase("6 report")
    big = rows[-1]
    print(json.dumps({"kernels": [{
        "name": KERNEL,
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/decode_attention.cu",
        "replaces": "mxnet_tpu/kernels/flash_attention.py:137",
        "launches": launches,
        "max_abs_err": worst,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "shape": f"B={big['B']} H={big['H']} S={big['S']} D={big['D']} "
                 f"visible={big['visible']} fp32",
        "card": smi}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
