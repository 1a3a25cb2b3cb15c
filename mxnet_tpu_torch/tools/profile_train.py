"""Where one TransformerLM training step's time goes, on the card.

Builds ``TransformerLM`` at GPT-2-small widths and depth (the
configuration ``chip_smoke.py`` trains: vocab 50257, E 768, 12 layers,
12 heads, FFN 3072, max_len 1024, tied embedding, fp32, Xavier weights
from a seed), and runs ``--steps`` training steps of one fixed batch
(8 x 1024 numpy-seeded tokens; record, softmax cross-entropy,
backward, Adam ``Trainer.step``, the fused step unless
``MXNET_FUSED_STEP=0``) under ``torch.profiler``, after two warm-up
steps; with ``--amp`` under ``amp.init("bfloat16")`` with a loss scaler
(``amp.init_trainer``, ``amp.scale_loss``). Prints one JSON object:
host wall ms per step, device busy ms per step (the sum of the CUDA
kernel and copy times), the device's idle share, device operations per
step, K1's launches per step (all, and those of its wgmma kernel for
bf16 at D = 64) and share of device time, the matrix
products' (cuBLAS/CUTLASS ``gemm`` kernels) time and launches per step,
the device time by kind (GEMM, K1, dtype casts and copies, softmax and
layer norm, the optimizer's multi-tensor passes, elementwise and other)
and the device time per step of the heaviest operations. Run on a
machine with one NVIDIA GPU:

    python3 -m mxnet_tpu_torch.tools.profile_train [--steps 3] [--amp] \
        [--hybridize]

``--hybridize`` captures the LM's forward and backward as CUDA graphs
(``HybridBlock.hybridize``); K1's launches are then counted per replay.

It needs no network and writes nothing.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as onp
import torch

from .. import autograd, gluon, gpu, initializer, nd, random as mxrandom
from ..contrib import amp
from ..kernels import _build
from ..kernels.flash_attention import FLASH_KERNEL, FLASH_SM90_KERNEL
from ..models import TransformerLM

GPT2_SMALL = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                  num_heads=12, ffn_dim=3072, max_len=1024,
                  tie_weights=True)
BATCH, SEQ, SEED = 8, 1024, 20240917


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


# K1's two kernels: the mma.sync one and the wgmma one for bf16 at D = 64
K1_NAMES = ("flash_fwd_kernel", "flash_fwd_sm90")


def _kind(name):
    """The layer a device operation belongs to, from its kernel name."""
    if any(k in name for k in K1_NAMES):
        return "k1_flash_attention"
    if "gemm" in name or "xmma" in name:
        return "gemm"
    if "multi_tensor_apply" in name or "foreach" in name or \
            "non_finite_check" in name:
        return "optimizer"
    if "softmax" in name.lower():
        return "softmax"
    if "layer_norm" in name.lower() or "LayerNorm" in name:
        return "layer_norm"
    if "copy_kernel" in name or "Memcpy" in name or "Memset" in name:
        return "cast_and_copy"
    return "elementwise_and_other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--amp", action="store_true",
                    help="train under amp.init('bfloat16') with a loss "
                    "scaler")
    ap.add_argument("--hybridize", action="store_true",
                    help="hybridize the LM: its forward and backward run "
                    "as captured CUDA graphs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = gpu(0)
    mxrandom.seed(SEED)
    net = TransformerLM(**GPT2_SMALL)
    net.initialize(initializer.Xavier(), ctx=ctx)
    vocab = GPT2_SMALL["vocab_size"]
    toks = nd.array(onp.random.RandomState(SEED).randint(
        0, vocab, (BATCH, SEQ)).astype("int32"), ctx=ctx)
    labels = toks[:, 1:].reshape(-1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 3e-4})
    if args.amp:
        amp.init("bfloat16")
        amp.init_trainer(trainer)
    if args.hybridize:
        net.hybridize()

    def one_step():
        # next-token loss, as tests/test_attention.py's training test
        with autograd.record():
            logits = net(toks)
            loss = loss_fn(logits[:, :-1].reshape(-1, vocab), labels).mean()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        trainer.step(BATCH)
        return loss

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    counts = _build.launch_counts()
    k1_launches = counts.get(FLASH_KERNEL, 0)
    sm90_launches = counts.get(FLASH_SM90_KERNEL, 0)
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
    k1_us = sum(us for name, (us, _) in by_name.items()
                if any(k in name for k in K1_NAMES))
    gemm = [(us, cnt) for name, (us, cnt) in by_name.items()
            if "gemm" in name]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    by_kind = collections.defaultdict(lambda: [0.0, 0])
    for name, (us, cnt) in by_name.items():
        by_kind[_kind(name)][0] += us
        by_kind[_kind(name)][1] += cnt
    print(json.dumps({
        "card": _card(), "config": GPT2_SMALL, "batch": BATCH,
        "amp": "bfloat16" if args.amp else None,
        "hybridize": args.hybridize, "cached_op": gluon.cached_op_stats(),
        "seq": SEQ, "tokens_per_step": BATCH * SEQ,
        "steps": args.steps, "last_loss": float(loss.asscalar()),
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                              if wall_ms else None),
        "device_ops_per_step": sum(c for _, c in by_name.values())
        / args.steps,
        "k1_launches_per_step": k1_launches / args.steps,
        "k1_sm90_launches_per_step": sm90_launches / args.steps,
        "k1_ms_per_step": k1_us / 1e3 / args.steps,
        "k1_share_of_device_time": k1_us / busy_us if busy_us else None,
        "gemm_ms_per_step": sum(us for us, _ in gemm) / 1e3 / args.steps,
        "gemm_launches_per_step": sum(c for _, c in gemm) / args.steps,
        "device_ms_per_step_by_kind": {
            kind: {"ms": us / 1e3 / args.steps, "per_step": cnt / args.steps,
                   "share": us / busy_us if busy_us else None}
            for kind, (us, cnt) in sorted(by_kind.items(),
                                          key=lambda kv: -kv[1][0])},
        "top_device_ms_per_step": {
            name: {"ms": us / 1e3 / args.steps, "per_step": cnt / args.steps}
            for name, (us, cnt) in top}}))


if __name__ == "__main__":
    main()
