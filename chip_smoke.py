#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Drives the port's main paths and holds their hand-written CUDA
kernels against the plain PyTorch versions:

- stateful decode serving of ``DecoderBlockLM`` at GPT-2-small widths
  through ``InferenceSession``, ``SessionStateStore`` and
  ``DynamicBatcher``, with the decode-attention kernel K2;
- training ``TransformerLM`` at GPT-2 small's published widths and
  depth (``autograd.record``, softmax cross-entropy, ``backward``,
  Adam ``Trainer``), with the flash-attention forward kernel K1;
- serving an exported symbol graph, wav2vec2-large-lv60 CTC at its
  published widths and depth, through ``InferenceSession.load`` under
  ``MXNET_GRAPH_OPT=1``: the fusion pass lowers its seven
  LayerNorm→GELU pairs onto the fused LayerNorm→activation kernel K3 and
  its 24 attentions onto K1;
- training ``resnet50_v1`` at its published widths and depth
  (``autograd.record``, SGD-momentum ``Trainer``) with a custom-op loss
  head, ``rtc_softmax``, whose forward and backward are CUDA C kernels
  that the runtime-kernel launcher K4 (``rtc.CudaModule``) compiles with
  NVRTC and launches;
- decode serving as the JAX package serves it: the paged KV store, one
  captured CUDA graph per occupancy bucket (K2 inside each), SLO
  classes through the batcher, and a ``ModelServer`` over a
  ``ModelRepository`` on a local port, with a canary promote that
  migrates live streams;
- training ResNet-50 v1 (with K4's head) and the GPT-2-small LM (with
  K1's bf16 kernel for Hopper, ``csrc/flash_attention_sm90.cu``: wgmma
  fed by TMA from a producer warp) in bf16 AMP: ``amp.init("bfloat16")``,
  ``amp.init_trainer`` (a dynamic loss scaler), ``amp.scale_loss`` and
  the Trainer's fused step, captured as one CUDA graph;
- both training paths hybridized (``HybridBlock.hybridize``: the
  network's forward and backward captured as CUDA graphs, one pair per
  signature, with K1 inside the LM's captured forward and K4's head
  eager), held bitwise against their eager runs, and ResNet-50 fed by
  ``gluon.data`` (``ArrayDataset``, a ``DataLoader`` of thread workers
  into pinned memory) through ``pipeline.DeviceFeed``;
- symbolic training: ``sym`` → ``simple_bind`` → the Executor, whose
  forward and backward are captured CUDA graphs, under ``Module.fit``
  (the MNIST MLP), the LSTM word-LM through ``Module`` and the fused
  ``sym.RNN`` (cuDNN), ``BucketingModule`` over ``rnn.LSTMCell.unroll``,
  and the same word-LM as a hybridized ``gluon.rnn.LSTM``;
- the NDArray and op surface: ResNet-50 trained through a hand-written
  SGD loop on the in-place operators (no ``Trainer``), and every op of
  the surface on the card against the CPU port, in one CUDA graph, with
  the random ops drawing under a registered generator.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result). Every kernel
time is the median of 25 launches timed alone with CUDA events, each
after a write that evicts the L2 and a ~200 us spin that keeps the
stream busy until the launch is enqueued, so it is the device's time:

1. device: require CUDA, print the card's name and power limit, turn
   TF32 off for float32 matmuls (torch's default too); cuDNN's global
   flags stay at torch's defaults: the port scopes its own convolutions
   to float32;
2. build: compile every ``mxnet_tpu_torch/csrc/*.cu`` with nvcc, one
   process per source, all started together;
3. K2 check: K2 against ``_decode_flash_ref`` on the card, within
   rtol = atol = 1e-5, at the serving shapes, at other head dims, and
   where the key sweep is split: B = 1 at lengths 0, 1, 63, 64, 65, 1000
   and S, the seven in one batch of 7, a length past S; each case prints
   its ``(splits, chunk)``;
4. K2 times: K2, its plain version and ``scaled_dot_product_attention``
   (a yardstick only; the port never calls it) at B in {1, 8, 32},
   S = 1024, beside the bound (the bytes of the visible K and V, q and
   out at 3.35 TB/s) and the splits;
5. serving: 8 greedy-decode streams of 8-48 tokens through the batcher
   (row-slot store, buckets 1-8, one graph per bucket); every future
   resolves, K2 launches = layers x decode steps (counted through graph
   replays), and the three longest streams' final logits match the
   session's own explicit-state step loop within rtol = atol = 1e-4;
6. K1 check: K1 against ``_flash_ref`` on the card within rtol = atol =
   1e-5 in float32 at the training shape (8, 12, 1024, 1024, 64,
   causal), the JAX tests' shapes, D in {128, 256}, a strided view and
   the fusion route's (128, 1, 499, 499, 64); within two bfloat16 ulps
   in bfloat16; rows that are not 16-byte aligned (bf16 rows of 40 and
   42 bytes, fp32 rows of 12 bytes, an odd s-stride in fp32 and bf16),
   each case printing the bytes per K/V copy its load path took;
   dq/dk/dv through the ``autograd.Function`` against autograd of
   ``_flash_ref`` within 1e-4;
7. K1 times: K1, ``_flash_ref`` and ``scaled_dot_product_attention(
   is_causal=True)`` (a yardstick only) at the training shape, L2
   flushed before each launch, beside two bounds: its flops at the fp32
   rate of 67 TFLOP/s, and three times its flops at the TF32 rate of
   495 TFLOP/s (K1's 3xTF32 products);
8. training: ``TransformerLM`` at GPT-2 small's widths and depth, tied
   embedding, Xavier weights from a seed, one fixed batch of 8 x 1024
   tokens, Adam at 3e-4: 2 warm-up and 10 timed steps; every loss
   finite and the last below the first, every gradient finite after
   step 1, K1 launches = 12 layers x 10 timed steps, the fused step one
   captured graph replayed every step; tokens/s, step ms,
   forward/backward/optimizer ms and peak memory; then 5 steps of the
   eager loop (``MXNET_FUSED_STEP=0``), whose step and optimizer ms
   print beside;
9. training against the CPU: one record/backward at 1 x 128 tokens,
   full width, on the card (through K1) and on the CPU (the plain path)
   from the same weights; the loss and three gradients agree within
   rtol 1e-3;
10. K3 check: K3 against ``_norm_act_ref`` on the card within rtol =
    atol = 1e-5 in float32 at the seven LayerNorm→GELU shapes of a
    bucket-8 forward of 10 s clips, a ragged row count, C in {100, 768,
    1024, 1030, 4096}, every activation code, and within one bfloat16
    ulp in bfloat16;
11. K3 times: K3, its plain version and ``F.layer_norm`` then
    ``F.gelu`` (two PyTorch calls, a yardstick only) at the seven path
    shapes, L2 flushed before each launch, beside the bound (input read
    and output written once at 3.35 TB/s);
12. K1 on the fusion route: K1 against ``_flash_ref`` at (128, 1, 499,
    64), not causal, within 1e-5, and its times and bounds as in phase 7;
13. symbolic serving: wav2vec2-large-lv60 CTC exported with ``sym.save``
    and ``nd.save``, loaded by ``InferenceSession.load`` with buckets 1,
    2, 4, 8; every bucket's optimized graph holds 7 ``_fused_norm_act``
    and 24 ``_fused_attention`` nodes at ``impl="cuda"``; requests of 1,
    3, 8, 5 and 2 clips of 10 s; K3 launches = 7 and K1 launches = 24
    per bucket execution; one bucket's logits within 1e-4 (of the
    largest logit) of the same export served under ``MXNET_FUSION=0``,
    and a 1 s clip within rtol 1e-3 of the CPU port;
14. K4 check: ``rtc.CudaModule`` compiles (NVRTC, ``sm_90a``) the
    ``double`` kernel of ``tests/test_quant_custom.py`` and an ``axpy``
    with a scalar argument, which equal torch's ``x * 2`` and ``y + a *
    x`` exactly on 2^26 elements; the ``rtc_softmax`` forward and
    backward match their plain versions within rtol = atol = 1e-6 at
    (128, 1000), (128, 1001) and (64, 4097); a compile error raises with
    NVRTC's log, a dtype mismatch and a CPU context raise;
15. K4 times: the softmax forward (against ``torch.softmax``, a
    yardstick only) and backward (against
    ``torch._softmax_backward_data``) at (128, 1000) and ``double`` at 2^26
    (against ``x * 2``), L2 flushed before each launch, beside the bound
    (bytes at 3.35 TB/s); the host microseconds per ``launch`` call;
16. ResNet-50 training: ``resnet50_v1`` (25.6 M parameters), batch 128
    of 224 x 224 fp32 images and labels from a seed, Xavier weights from
    a seed, SGD lr 0.1, momentum 0.9, wd 1e-4, the ``rtc_softmax`` head:
    2 warm-up and 10 timed steps, then 28 more on the same batch; every
    loss finite and the 40th below the first, every gradient finite,
    every running statistic moved, K4 launches = 2 x 10 timed steps, the
    fused step one graph replayed every step; img/s, step ms (forward,
    backward, optimizer), peak memory, the eval forward's img/s at batch
    128, and the eager loop's step and optimizer ms beside;
17. ResNet-50 against the CPU: one record/backward at batch 2 on the
    card (K4) and on the CPU (the plain head) from the same fresh
    weights: the loss and three gradients within rtol 1e-3 in eval mode
    (the stem, a mid-network convolution, the classifier), and the loss
    and the classifier's gradients in training mode, whose deeper
    gradients at batch 2 are float32-ill-conditioned (see the phase);
    and head against head on the card at
    batch 128 with the trained weights: ``rtc_softmax``'s gradients
    against ``SoftmaxCrossEntropyLoss``'s within 1e-4 of the largest
    entry;
18. paged decode serving: GPT-2 small on a paged store (16-token pages),
    buckets 1-32 captured as graphs; 32 greedy streams of 16-256 tokens
    arriving open-loop (seeded exponential gaps) through the stateful
    batcher as SLO class ``standard``: tokens/s, mean step ms, p50/p99
    per-token latency from the serving histograms, pages at the peak
    against the row-slot bytes of the same sessions, captures and
    replays per bucket, K2 launches = layers x steps; then 8 of the
    streams rerun on a row-slot store, step for step at the buckets
    they ran at, give bitwise-equal logits;
19. graph against eager at 8 rows: one step from the same random
    states through a captured graph and eagerly, bitwise or within
    1e-5; each mode's host ms per step, device busy ms, idle share and
    launches per step (``tools/profile_decode.py``'s measure, 10
    profiled steps);
20. HTTP: a ``ModelServer`` over a ``ModelRepository`` serves the
    decoder on a local port; 4 streams with ``X-Session-Id``; v2 (the
    same weights) deployed and promoted while a round is in flight; the
    streams' logits bitwise equal to a run with no promote,
    ``resumed_sessions`` = 4; under ``faults.inject("serving_admission",
    every=1)`` best_effort gets 503 with ``Retry-After`` and critical
    200; ``/metrics`` carries the ``slo_class`` families;
21. convolution at torch's default flags: phase 17's eval- and
    training-mode comparison rerun with ``cudnn.allow_tf32`` and
    ``cudnn.benchmark`` at torch's defaults, each deviation logged
    against rtol 1e-3;
22. K4's launch floor: an empty kernel through ``rtc.CudaModule``,
    timed as every kernel here (median of 25 launches, CUDA events, the
    stream kept busy);
23. K1 in bfloat16 at the LM's shape (8, 12, 1024, 1024, 64, causal):
    the rule (``_flash_route``) sends it to the sm90 kernel, on
    contiguous inputs, on the LM's strided qkv views, at a ragged S, at
    S_q < S_k and not causal, each within two bf16 ulps of the plain
    version in float32 rounded once; its time on both layouts beside
    the mma.sync kernel's (``route="mma"``, the route of earlier slices)
    at the same shape, the plain version's,
    ``scaled_dot_product_attention`` in bf16 (a yardstick only) and two
    bounds: the function's (bytes at 3.35 TB/s, flops at 989 TFLOP/s)
    and the design's two-pass arithmetic (P.V twice);
24. ResNet-50 in bf16 AMP, as phase 16 (batch 128, SGD, the
    ``rtc_softmax`` head on the logits cast to float32, with the loss
    scale as its ``grad_scale``), in NCHW and in NHWC: 2 warm-up, 10
    timed and 28 more steps; the loss finite and the 40th below the
    first, K4 launches = 2 x 10, one graph capture and a replay per
    step; img/s, step ms, peak memory, skipped steps; the faster layout
    is the headline;
25. the GPT-2-small LM in bf16 AMP, as phase 8 (Adam, ``scale_loss``):
    the loss falls, the logits are bf16, K1 launches = 12 x 10 (on bf16
    q, k, v), every one on the sm90 kernel, one graph and a replay per
    step; tokens/s, step ms, peak memory;
26. AMP on the card against the CPU port: ResNet-50 at batch 2 (eval
    mode, fresh weights) and the LM at 1 x 128 tokens, one
    record/backward each in bf16 and in float32 on both: the card's bf16
    deviation from its float32 (L2 of the logits and of the gradients)
    within 1.5 x the CPU's plus 1e-3, and the bf16 losses within rtol
    2e-2 (``tests/test_torch_amp_training.py``'s bounds); the LM also
    at torch's default cuBLAS flags (the port's fp32-accumulation scope
    replaced by a no-op), whose deviations are reported;
27. a poisoned bf16 step: an inf in one gradient; ``Trainer.step``
    under ``torch.cuda.set_sync_debug_mode("error")`` (any host sync
    raises) skips it on the device: weights and momenta bitwise
    unchanged, the scale halved, one more skipped step;
28. ResNet-50 hybridized against eager: phase 24's NHWC setup, the net
    hybridized; 2 warm-up and 10 timed steps in each mode from the same
    weights and batch. With cuDNN held to deterministic algorithms, the
    12 steps' logits and every final weight, gradient and running
    statistic are bitwise equal; then, at torch's flags, each mode's
    step ms, img/s, peak memory, K4 launches (2 x 10) and the cache's
    counters (one capture, a replay per step);
29. the LM hybridized against eager: phase 25's setup, 2 + 10 steps in
    each mode; the last position's logits of every step and every final
    weight and gradient bitwise equal; K1 launches = 12 x 10 counted per
    replay, all on sm90; step ms, tokens/s, peak memory;
30. ResNet-50 fed by ``gluon.data``: 768 uint8 NHWC images and labels
    made from a seed and held in host memory, ``ArrayDataset``,
    ``DataLoader(batch_size=128, num_workers=4, pin_memory=True,
    last_batch="discard")``, ``DeviceFeed``, normalized and cast on the
    card, the hybridized net; two passes (2 + 10 steps): step ms, img/s
    and ``prefetch_stall_s`` per step;
31. a capture that must fail: a block whose forward calls ``asnumpy()``
    raises ``MXNetError`` naming the block and the signature when
    hybridized, and the card computes correctly afterwards;
32. the MNIST MLP through ``Module`` (784-128-64-10, ``SoftmaxOutput``,
    SGD lr 0.3, momentum 0.9, batch 128, ``examples/train_mnist_mlp.py``
    on its synthetic data from a seed): one pass of 14 steps on the card
    and on the CPU port from the same weights and batches, per-step
    losses and final weights within rtol 1e-3; then ``Module.fit`` for 8
    epochs, with the accuracy metric and without: step ms, validation
    accuracy before and after (it must rise by 0.2), the captured
    training signature replayed every step;
33. the LSTM word-LM through ``Module`` and the fused ``sym.RNN`` at
    Zaremba et al.'s medium widths (vocabulary 10,000, 650 wide, 2
    layers, dropout 0.5, tied decoder, BPTT 35, batch 20; SGD lr 0.25,
    each gradient element clipped at 0.1; token ids from a seeded Markov
    chain): cuDNN's LSTM against the
    op's plain version on the card within 2e-5 of the largest value
    (float32, not TF32); the captured executor against the eager one,
    bitwise, for 3 steps at p = 0; 3 steps against the CPU port within
    rtol 1e-3; each mode timed (2 + 20 steps, Perplexity metric) and
    profiled (5 steps: idle share, device time by kind), peak memory,
    5 steps without the metric; the perplexity of 10 batches
    falls over 30 more steps; the device time of the rnn op's forward
    and backward on views against ``torch.nn.LSTM``'s flattened weights
    (cuDNN's repack), in turns;
34. ``BucketingModule`` over ``rnn.LSTMCell.unroll`` at the same widths
    (one layer), buckets 10, 20, 30 and 35, ``BucketSentenceIter`` over
    200 Markov sentences, one epoch of ``fit``: one captured signature
    per bucket, replayed (forward and backward) once per batch of it;
35. the word-LM in Gluon: ``gluon.rnn.LSTM`` under an ``Embedding``
    whose weight the decoder shares, hybridized (``CachedOp`` with the
    states as inputs), SGD through the Trainer's fused step: 2 + 20
    steps, step ms beside the Module's;
36. K3 and K1 on a training bind: ``layer_norm → gelu`` and an
    attention at ``MXNET_GRAPH_OPT=2`` against 0, one training step on
    the card: the gradients within 1e-4, K3 not launched in the
    training step (``replay_needs_grad``), launched in an inference
    forward, K1 launched under its ``autograd.Function``;
37. ResNet-50 through a hand-written SGD loop: ``resnet50_v1`` at
    phase 16's configuration, the batch drawn on the card by
    ``nd.random.uniform`` and the labels by ``nd.random.randint``, the
    loss ``-nd.pick(nd.log_softmax(out), y).mean()``, per parameter
    ``m *= 0.9; m -= lr * (g + wd * w); w += m`` on ``p.data()``; one
    hand update against the Trainer's fused sgd step from the same
    weights and gradients within 1e-6 of each parameter's largest value;
    after a hand update the hybridized net's captured forward bitwise
    equal to its eager forward and different from before; 20 logged
    steps (loss, top-1 from ``argmax``, top-5 from ``nd.topk``, the
    global gradient norm from ``nd.norm`` read with ``float()``), the
    loss at step 40 below the first; the hand loop's step ms beside the
    Trainer loop's on the same loss;
38. the op sweep (``tools/op_sweep.py``): every case of the surface's
    ops on the card against the CPU port, forward and backward (exact
    outputs bitwise, the rest within rtol 1e-5 and atol 1e-6, CTC rtol
    1e-4); every deterministic case but ``boolean_mask`` (a
    data-dependent shape) captured in one CUDA graph, whose replay
    equals the eager calls bitwise; the random ops captured with the
    device's generator registered, drawing anew per replay and repeating
    after ``mx.random.seed``; the JAX opperf suite's times
    (``benchmark/opperf.py``);
39. report: one JSON line of kernels, then the device line last.

Each phase prints the seconds it took.

Needs no network; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import FIRST_COMPLETED, wait

import numpy as onp
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import autograd, convert, gluon, nd, rtc, serving  # noqa: E402
from mxnet_tpu_torch.contrib import amp  # noqa: E402
from mxnet_tpu_torch.gluon import fused_step  # noqa: E402
from mxnet_tpu_torch.kernels import _build, _nvrtc  # noqa: E402
from mxnet_tpu_torch.kernels.flash_attention import (  # noqa: E402
    FLASH_KERNEL, FLASH_SM90_KERNEL, KERNEL, _decode_flash, _decode_flash_ref,
    _decode_splits, _flash_fwd_cuda, _flash_load_width, _flash_ref,
    _flash_route, flash_attention)
from mxnet_tpu_torch.ndarray import ops_nn  # noqa: E402
from mxnet_tpu_torch.kernels.norm_act import (  # noqa: E402
    KERNEL as NORM_ACT_KERNEL, _norm_act_cuda, _norm_act_ref)
from mxnet_tpu_torch.models import DecoderBlockLM, TransformerLM  # noqa: E402
from mxnet_tpu_torch.tools.profile_predict import (  # noqa: E402
    SAMPLE_RATE, WAV2VEC2_LARGE_LV60, export_wav2vec2, frames)
from mxnet_tpu_torch.benchmark import opperf  # noqa: E402
from mxnet_tpu_torch.tools import op_sweep  # noqa: E402
from mxnet_tpu_torch.tools import profile_module as pm  # noqa: E402
from mxnet_tpu_torch.tools import profile_resnet as pr  # noqa: E402
from mxnet_tpu_torch.tools.profile_decode import (  # noqa: E402
    build as decode_stack, profile_steps)
from mxnet_tpu_torch.gluon.model_zoo import vision  # noqa: E402
from mxnet_tpu_torch.resilience import faults  # noqa: E402

SEED = 20240917
# GPT-2 small (n_embd 768, n_head 12, n_layer 12, n_positions 1024,
# vocab_size 50257, FFN 4 x 768) in the block's own architecture
GPT2_SMALL = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                  num_heads=12, ffn_dim=3072, max_len=1024)
# TransformerLM at the same published widths and depth, with GPT-2's tied
# embedding; dropout 0.0 (the JAX default) instead of GPT-2's 0.1, so the
# run is deterministic: the one cut
GPT2_SMALL_LM = dict(vocab_size=50257, embed_dim=768, num_layers=12,
                     num_heads=12, ffn_dim=3072, max_len=1024,
                     tie_weights=True, dropout=0.0)
TRAIN_B, TRAIN_S, TRAIN_LR = 8, 1024, 3e-4
WARMUP_STEPS, TIMED_STEPS = 2, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bfloat16 on the tensor cores, dense
TF32_FLOPS = 495e12  # H100 SXM TF32 on the tensor cores, dense
# ~200 us at the H100's 1.98 GHz boost clock: longer than a kernel
# wrapper's host cost, so every kernel time below is the device's alone
BUSY_CYCLES = 400_000
KERNEL_RTOL = KERNEL_ATOL = 1e-5
SERVE_RTOL = SERVE_ATOL = 1e-4
# K1 in bfloat16 against the plain version in float32 from the same
# bfloat16 inputs: the kernel rounds once, at the output; two ulps
BF16_RTOL = 2.0 ** -6
# dq/dk/dv: the recompute backward against autograd through the plain
# version, two different fp32 computations over up to 1024 keys
GRAD_TOL = 1e-4
# float32 through different summation orders over 12 layers and a
# 50257-way softmax: the card's cuBLAS and K1 against the CPU's BLAS and
# plain attention
CPU_RTOL = 1e-3
REPS = 25
# the eager per-parameter loop (MXNET_FUSED_STEP=0) timed beside the
# fused step in the same call: this many steps after one warm-up step
EAGER_STEPS = 5
# bf16 AMP on the card against the CPU port, as tests/
# test_torch_amp_training.py holds the port against the JAX package: the
# card's bf16 deviation from its own float32 run within 1.5 x the CPU's
# plus 1e-3 (L2 over the logits and over every gradient), and the bf16
# losses within rtol 2e-2 of each other
AMP_DEV_FACTOR, AMP_DEV_FLOOR, AMP_LOSS_RTOL = 1.5, 1e-3, 2e-2


_PHASE = {"name": None, "t": None}


def phase(name):
    """Print the phase's heading, and the seconds the previous phase
    took."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"   ({_PHASE['name']}: {now - _PHASE['t']:.1f} s)", flush=True)
    _PHASE["name"], _PHASE["t"] = name, now
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
    print("float32 matmuls in full float32: "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}; cuDNN's global flags "
          f"at torch's defaults: torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32} (the port scopes its "
          "convolutions to float32)")
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
    phase("3 K2 check")
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
    # the split sweep's edges: an empty row, one key, a chunk's edges, a
    # long and a full cache, alone and all in one batch; a length past S
    edges = [0, 1, 63, 64, 65, 1000, S]
    cases += [(1, H, S, D, [n]) for n in edges]
    cases += [(7, H, S, D, edges), (2, H, S, D, [S + 500, 700])]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for B, H_, S_, D_, lengths in cases:
        q, k, v, n = attention_inputs(gen, B, H_, S_, D_, lengths)
        scale = D_ ** -0.5
        got = _decode_flash(q, k, v, n, scale)
        want = _decode_flash_ref(q, k, v, n, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        splits, chunk = _decode_splits(B, H_, S_, n_sm)
        print(f"  B={B} H={H_} S={S_} D={D_} lengths={lengths[:4]}"
              f"{'...' if len(lengths) > 4 else ''} splits={splits} "
              f"chunk={chunk}: max_abs_err={err:.3e}")
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
    reaches attention with its caches cold. The stream is then kept busy
    for BUSY_CYCLES (``torch.cuda._sleep``), so the host has enqueued
    ``fn`` before the start event runs and a launch's host cost is not
    counted as device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
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
    phase("4 K2 times")
    S, H, D = GPT2_SMALL["max_len"], GPT2_SMALL["num_heads"], 64
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for B in (1, 8, 32):
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
               "splits": _decode_splits(B, H, S, n_sm)[0],
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
    print(f"graphs per bucket: {sess.graph_stats()}")
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
              "mean_step_ms": mean_step_ms(),
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


def mean_step_ms():
    """Mean host-timed step of the serving registry's execution
    histogram, ms."""
    hist = serving.METRICS.exec_latency
    return hist.sum / max(hist.total, 1) * 1e3


def flash_inputs(gen, B, H, S_q, S_k, D, dtype=torch.float32):
    dev = torch.device("cuda")
    q = torch.randn(B, H, S_q, D, device=dev, generator=gen)
    k = torch.randn(B, H, S_k, D, device=dev, generator=gen)
    v = torch.randn(B, H, S_k, D, device=dev, generator=gen)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def k1_check_phase(gen):
    phase("6 K1 check")
    H, S = GPT2_SMALL_LM["num_heads"], TRAIN_S
    # (B, H, S_q, S_k, D, causal): the training shape; the JAX tests'
    # (tests/test_attention.py:26-78); causal S_q < S_k; D 128 and 256
    cases = [
        (TRAIN_B, H, S, S, 64, True),
        (2, 3, 64, 64, 16, False),
        (2, 3, 64, 64, 16, True),
        (1, 2, 100, 70, 24, False),
        (1, 2, 1, 40, 8, True),
        (2, 4, 100, 300, 64, True),
        (2, 4, 333, 333, 128, True),
        (2, 4, 200, 200, 256, True),
        (128, 1, 499, 499, 64, False),  # the fusion route's shape
        (1, 1, 5, 9, 3, False),  # 12-byte rows: 4-byte copies
    ]
    worst = 0.0
    for B, H_, S_q, S_k, D, causal in cases:
        q, k, v = flash_inputs(gen, B, H_, S_q, S_k, D)
        got = _flash_fwd_cuda(q, k, v, D ** -0.5, causal)
        want = _flash_ref(q, k, v, D ** -0.5, causal)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"  B={B} H={H_} S_q={S_q} S_k={S_k} D={D} causal={causal} "
              f"copies={_flash_load_width(k, v)} B: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1 disagrees with its plain version at "
                               f"{(B, H_, S_q, S_k, D, causal)}: {err}")
        worst = max(worst, err)
    # the model's own layout: q, k, v strided views of one projection
    qkv = torch.randn(2, S, 3, H, 64, device="cuda", generator=gen)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    got = _flash_fwd_cuda(q, k, v, 0.125, True)
    want = _flash_ref(q.contiguous(), k.contiguous(), v.contiguous(), 0.125,
                      True)
    err = (got - want).abs().max().item()
    print(f"  strided views of (2, {S}, 3, {H}, 64) copies="
          f"{_flash_load_width(k, v)} B: max_abs_err={err:.3e}")
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"K1 disagrees on strided views: {err}")
    worst = max(worst, err)
    # an odd s-stride (65 elements): 4-byte copies in float32, element
    # loads in bfloat16
    for dtype in (torch.float32, torch.bfloat16):
        base = torch.randn(3, 2, 3, 90, 65, device="cuda",
                           generator=gen).to(dtype)
        q, k, v = (base[i, ..., :64] for i in range(3))
        got = _flash_fwd_cuda(q, k, v, 0.125, True).float()
        want = _flash_ref(q.float(), k.float(), v.float(), 0.125, True)
        tol = KERNEL_RTOL if dtype == torch.float32 else BF16_RTOL
        want = want.to(dtype).float()
        err = (got - want).abs().max().item()
        print(f"  {str(dtype)[6:]} s-stride {k.stride(2)} (2, 3, 90, 90, 64) "
              f"causal copies={_flash_load_width(k, v)} B: "
              f"max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=tol, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1 disagrees at an odd s-stride in {dtype}: "
                               f"{err}")
        if dtype == torch.float32:
            worst = max(worst, err)
    q, k, v = flash_inputs(gen, 2, H, 512, 512, 64, torch.bfloat16)
    got = _flash_fwd_cuda(q, k, v, 0.125, True).float()
    want = _flash_ref(q.float(), k.float(), v.float(), 0.125, True)
    bf_err = (got - want.to(torch.bfloat16).float()).abs().max().item()
    print(f"  bfloat16 (2, {H}, 512, 512, 64): max_abs_err={bf_err:.3e} "
          f"against the float32 plain version rounded to bfloat16")
    if not torch.allclose(got, want.to(torch.bfloat16).float(),
                          rtol=BF16_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"K1 in bfloat16 is off by {bf_err}")
    # bfloat16 rows that are not 16-byte aligned: 40 bytes (4-byte
    # copies) and 42 bytes (element loads)
    for B, H_, S_q, S_k, D, causal in ((1, 2, 77, 77, 20, False),
                                       (1, 2, 33, 50, 21, True)):
        q, k, v = flash_inputs(gen, B, H_, S_q, S_k, D, torch.bfloat16)
        got = _flash_fwd_cuda(q, k, v, D ** -0.5, causal).float()
        want = _flash_ref(q.float(), k.float(), v.float(), D ** -0.5,
                          causal).to(torch.bfloat16).float()
        err = (got - want).abs().max().item()
        print(f"  bfloat16 B={B} H={H_} S_q={S_q} S_k={S_k} D={D} "
              f"causal={causal} copies={_flash_load_width(k, v)} B: "
              f"max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=BF16_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1 in bfloat16 is off by {err} at "
                               f"{(B, H_, S_q, S_k, D, causal)}")
    q, k, v = flash_inputs(gen, 2, H, S, S, 64)
    do = torch.randn(q.shape, device="cuda", generator=gen)
    grads = []
    for fn in (lambda a, b, c: flash_attention(a, b, c, causal=True),
               lambda a, b, c: _flash_ref(a, b, c, 0.125, True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(do)
        grads.append([t.grad for t in leaves])
    gerr = max((a - b).abs().max().item() for a, b in zip(*grads))
    print(f"  dq/dk/dv at (2, {H}, {S}, {S}, 64) causal: max_abs_err="
          f"{gerr:.3e} against autograd of _flash_ref")
    if not all(torch.allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)
               for a, b in zip(*grads)):
        raise RuntimeError(f"K1's gradients are off by {gerr}")
    print(f"K1 matches _flash_ref within rtol=atol={KERNEL_RTOL} in float32; "
          f"worst max_abs_err {worst:.3e}")
    return worst


def flash_bound(B, H, S_q, S_k, D, causal, itemsize=4):
    """Least ms for one K1 call: the larger of its bytes (q, k, v read,
    out written) over the memory rate and its flops (2*D for q.k and
    2*D for p.v per visible query-key pair) over the fp32 rate."""
    if causal:  # row i sees keys 0 .. i + S_k - S_q
        pairs = S_q * (S_q + 1) // 2 + S_q * (S_k - S_q)
    else:
        pairs = S_q * S_k
    flops = 4 * D * B * H * pairs
    nbytes = (2 * B * H * S_q * D + 2 * B * H * S_k * D) * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def add_k1_rates(row):
    """The 3xTF32 bound (three TF32 products per fp32 product, at 495
    TFLOP/s, or the bytes if larger), both bounds' shares and the
    achieved fp32-equivalent TFLOP/s of a phase-7 or -12 row."""
    row["bound_3xtf32_ms"] = max(row["bytes"] / HBM_BYTES_PER_S,
                                 3 * row["flops"] / TF32_FLOPS) * 1e3
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["bound_3xtf32_share"] = row["bound_3xtf32_ms"] / row["ms"]
    row["achieved_tflops"] = row["flops"] / row["ms"] / 1e9


def k1_times_phase(gen):
    phase("7 K1 times")
    B, H, S, D = TRAIN_B, GPT2_SMALL_LM["num_heads"], TRAIN_S, 64
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    q, k, v = flash_inputs(gen, B, H, S, S, D)
    scale = D ** -0.5

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)

    lib_err = (library() - _flash_ref(q, k, v, scale, True)).abs().max()
    row = {"B": B, "H": H, "S_q": S, "S_k": S, "D": D, "causal": True,
           "ms": time_ms(lambda: _flash_fwd_cuda(q, k, v, scale, True),
                         flush),
           "plain_ms": time_ms(lambda: _flash_ref(q, k, v, scale, True),
                               flush),
           "library_ms": time_ms(library, flush),
           "library_max_abs_err": lib_err.item()}
    row["bound_ms"], row["bound_by"], row["flops"], row["bytes"] = \
        flash_bound(B, H, S, S, D, True)
    add_k1_rates(row)
    print("  " + json.dumps(row))
    del flush
    return row


def eager_step_ms(step):
    """The eager per-parameter loop (``MXNET_FUSED_STEP=0``) timed beside
    the fused step in the same call: ``step(events)`` runs one training
    step recording four CUDA events (forward, backward, optimizer); one
    warm-up, then EAGER_STEPS host-timed steps. Returns the mean step ms
    and the mean optimizer ms."""
    os.environ["MXNET_FUSED_STEP"] = "0"
    try:
        step(None)
        torch.cuda.synchronize()
        step_ms, opt_ms = [], []
        for _ in range(EAGER_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t0 = time.perf_counter()
            step(ev)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            opt_ms.append(ev[2].elapsed_time(ev[3]))
    finally:
        os.environ.pop("MXNET_FUSED_STEP", None)
    return statistics.mean(step_ms), statistics.mean(opt_ms)


def check_fused(trainer, steps):
    """The fused step ran as one captured CUDA graph replayed every step."""
    st = fused_step.fused_step_stats()
    if trainer._fused is None or trainer._fused["graph"] is None or \
            st["captures"] != 1 or st["replays"] != steps:
        raise RuntimeError(f"the fused step did not run as one graph "
                           f"replayed {steps} times: {st}")
    return st


def training_phase():
    phase("8 training")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    mx.random.seed(SEED)
    net = TransformerLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    toks = nd.array(onp.random.RandomState(SEED).randint(
        0, vocab, (TRAIN_B, TRAIN_S)).astype("int32"), ctx=ctx)
    labels = toks[:, 1:].reshape(-1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})

    def step(ev=None):
        ev = ev or [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with autograd.record():
            logits = net(toks)
            # next-token loss, as tests/test_attention.py's training test
            loss = loss_fn(logits[:, :-1].reshape(-1, vocab), labels).mean()
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.step(TRAIN_B)
        ev[3].record()
        return loss, ev

    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_STEPS):
        loss, _ = step()
        losses.append(loss.asscalar())
        if i == 0:
            bad = [name for name, p in net.collect_params().items()
                   if not torch.isfinite(p.grad().data).all()]
            if bad:
                raise RuntimeError(f"non-finite gradients after step 1: "
                                   f"{bad[:5]}")
    torch.cuda.synchronize()
    n_params = sum(p.data().size for p in net.collect_params().values())
    print(f"TransformerLM {cfg}: {n_params} parameters; batch {TRAIN_B} x "
          f"{TRAIN_S} tokens, Adam lr {TRAIN_LR}; {WARMUP_STEPS} warm-up "
          f"steps done")
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss, ev = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    launches = counts.get(FLASH_KERNEL, 0)
    sm90 = counts.get(FLASH_SM90_KERNEL, 0)
    print(f"losses {[round(x, 4) for x in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training did not go down: {losses}")
    want = cfg["num_layers"] * TIMED_STEPS
    if launches != want:
        raise RuntimeError(f"K1 launched {launches} times in {TIMED_STEPS} "
                           f"steps of {cfg['num_layers']} layers")
    print(f"K1 launches {launches} = {cfg['num_layers']} layers x "
          f"{TIMED_STEPS} timed steps")
    stats = check_fused(trainer, WARMUP_STEPS + TIMED_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    peak = torch.cuda.max_memory_allocated() / 1e9
    eager_ms, eager_opt = eager_step_ms(step)
    result = {"tokens_per_s": TRAIN_B * TRAIN_S * TIMED_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0], "last_loss": losses[-1],
              "peak_memory_gb": peak, "fused_step": stats,
              "eager_loop_mean_step_ms": eager_ms,
              "eager_loop_optimizer_ms": eager_opt}
    print("training " + json.dumps(result))
    return net, launches, result


def training_vs_cpu_phase(net):
    phase("9 training against the CPU")
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    arrays = {name: p.data().asnumpy()
              for name, p in net._collect_params_with_prefix().items()}
    cpu_net = convert.params_from_numpy(TransformerLM(**cfg), arrays,
                                        ctx=mx.cpu())
    toks = onp.random.RandomState(SEED + 1).randint(0, vocab, (1, 128))
    watched = ["embed.weight",
               f"blocks.{cfg['num_layers'] // 2}.attn.qkv.weight",
               "ln_f.gamma"]
    results = []
    for model, ctx in ((net, mx.gpu(0)), (cpu_net, mx.cpu())):
        t = nd.array(toks.astype("int32"), ctx=ctx)
        _build.reset_launch_counts()
        with autograd.record():
            logits = model(t)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                logits[:, :-1].reshape(-1, vocab),
                t[:, 1:].reshape(-1)).mean()
        loss.backward()
        params = model._collect_params_with_prefix()
        results.append((loss.asscalar(),
                        {n: params[n].grad().asnumpy() for n in watched},
                        _build.launch_counts().get(FLASH_KERNEL, 0)))
    (gl, gg, glaunch), (cl, cg, claunch) = results
    if glaunch != cfg["num_layers"] or claunch != 0:
        raise RuntimeError(f"K1 launches: card {glaunch}, CPU {claunch}")
    print(f"loss card {gl:.6f} cpu {cl:.6f}")
    if not onp.isclose(gl, cl, rtol=CPU_RTOL, atol=0):
        raise RuntimeError(f"loss differs: card {gl}, CPU {cl}")
    worst = {}
    for n in watched:
        # rtol against the gradient's own scale: entries near zero keep
        # no relative precision through the reordered sums
        scale = float(onp.abs(cg[n]).max())
        err = float(onp.abs(gg[n] - cg[n]).max())
        worst[n] = err / scale
        print(f"  grad {n}: max_abs_err {err:.3e}, {err / scale:.3e} of its "
              f"largest entry {scale:.3e}")
        if not onp.allclose(gg[n], cg[n], rtol=CPU_RTOL,
                            atol=CPU_RTOL * scale):
            raise RuntimeError(f"gradient of {n} differs from the CPU's")
    print(f"card matches CPU within rtol {CPU_RTOL}")
    return {"loss_card": gl, "loss_cpu": cl, "grad_rel_err": worst}


# -- the symbolic-serving path: K3 and K1 behind the fusion pass ----------

W2V_CFG = WAV2VEC2_LARGE_LV60
W2V_SECONDS = 10
W2V_BUCKETS = (1, 2, 4, 8)
W2V_REQUESTS = (1, 3, 8, 5, 2)  # clips per request
# activation codes of csrc/norm_act.cu and the slope each takes
K3_ACTS = {"relu": (0, 0.0), "sigmoid": (1, 0.0), "tanh": (2, 0.0),
           "softrelu": (3, 0.0), "softsign": (4, 0.0), "leaky": (5, 0.25),
           "elu": (6, 1.0), "selu": (7, 0.0), "gelu": (8, 0.0),
           "rrelu": (9, (0.125 + 0.334) / 2)}
GELU = K3_ACTS["gelu"]
LN_EPS = W2V_CFG["layer_norm_eps"]
# one bfloat16 ulp (8 significant bits) at the output's scale
BF16_ULP = 2.0 ** -7
# float32 logits through ~700 reordered ops: the fused graph (K3's and
# K1's sums) against the unfused one on the card, scaled by the largest
# logit
FUSION_TOL = 1e-4


def k3_path_shapes():
    """(rows, C) of the seven K3 launches of one bucket-8 forward."""
    b = W2V_BUCKETS[-1]
    return [(b * t, c) for t, c in zip(frames(W2V_CFG, W2V_SECONDS *
                                              SAMPLE_RATE),
                                       W2V_CFG["conv_dim"])]


def k3_inputs(gen, rows, C, dtype=torch.float32):
    dev = torch.device("cuda")
    x = torch.randn(rows, C, device=dev, generator=gen) * 2 + 0.5
    g = 1 + 0.1 * torch.randn(C, device=dev, generator=gen)
    b = 0.1 * torch.randn(C, device=dev, generator=gen)
    return x.to(dtype), g.to(dtype), b.to(dtype)


def k3_check_phase(gen):
    phase("10 K3 check")
    cases = [(rows, C, "gelu") for rows, C in k3_path_shapes()]
    cases += [(1001, 512, "gelu"), (3, 100, "gelu"), (517, 768, "gelu"),
              (64, 1024, "gelu"), (33, 1030, "gelu"), (250, 4096, "gelu")]
    cases += [(999, C, act) for act in K3_ACTS for C in (512, 100, 4096)]
    worst = 0.0
    for rows, C, act in cases:
        code, slope = K3_ACTS[act]
        x, g, b = k3_inputs(gen, rows, C)
        got = _norm_act_cuda(x, g, b, LN_EPS, code, slope)
        want = _norm_act_ref(x, g, b, LN_EPS, code, slope)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if act == "gelu" or C == 512:
            print(f"  rows={rows} C={C} {act}: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K3 disagrees with its plain version at "
                               f"rows={rows} C={C} {act}: {err}")
        worst = max(worst, err)
    for rows, C in ((8 * 499, 512), (999, 100), (77, 4096)):
        x, g, b = k3_inputs(gen, rows, C, torch.bfloat16)
        got = _norm_act_cuda(x, g, b, LN_EPS, *GELU).float()
        want = _norm_act_ref(x, g, b, LN_EPS, *GELU).float()
        err = (got - want).abs().max().item()
        print(f"  bfloat16 rows={rows} C={C} gelu: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=BF16_ULP, atol=KERNEL_ATOL):
            raise RuntimeError(f"K3 in bfloat16 is off by {err} at "
                               f"rows={rows} C={C}")
    print(f"K3 matches _norm_act_ref within rtol=atol={KERNEL_RTOL} in "
          f"float32 over {len(cases)} cases; worst max_abs_err {worst:.3e}")
    return worst


def k3_bound(rows, C, itemsize=4):
    """Least ms for one K3 call: x read and out written once, gamma and
    beta once (bytes at 3.35 TB/s), against ~12 fp32 operations per
    element at 67 TFLOP/s."""
    nbytes = 2 * rows * C * itemsize + 2 * C * itemsize
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 12 * rows * C / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def k3_times_phase(gen):
    phase("11 K3 times")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    F = torch.nn.functional
    rows_out = []
    for rows, C in k3_path_shapes():
        x, g, b = k3_inputs(gen, rows, C)

        def library():
            return F.gelu(F.layer_norm(x, (C,), g, b, LN_EPS))

        row = {"rows": rows, "C": C,
               "ms": time_ms(lambda: _norm_act_cuda(x, g, b, LN_EPS, *GELU),
                             flush),
               "plain_ms": time_ms(
                   lambda: _norm_act_ref(x, g, b, LN_EPS, *GELU), flush),
               "library_ms": time_ms(library, flush)}
        row["bound_ms"], row["bound_by"], row["bytes"] = k3_bound(rows, C)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("  " + json.dumps(row))
        rows_out.append(row)
        del x, g, b
    total = {k: sum(r[k] for r in rows_out)
             for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes")}
    print("  seven launches of one bucket-8 forward: " + json.dumps(total))
    del flush
    return rows_out, total


def k1_route_phase(gen):
    phase("12 K1 on the fusion route")
    B, S = W2V_BUCKETS[-1] * W2V_CFG["num_attention_heads"], \
        frames(W2V_CFG, W2V_SECONDS * SAMPLE_RATE)[-1]
    D = W2V_CFG["hidden_size"] // W2V_CFG["num_attention_heads"]
    q, k, v = flash_inputs(gen, B, 1, S, S, D)
    scale = D ** -0.5
    got = _flash_fwd_cuda(q, k, v, scale, False)
    want = _flash_ref(q, k, v, scale, False)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"  B={B} H=1 S={S} D={D} not causal: max_abs_err={err:.3e}")
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"K1 disagrees with its plain version on the "
                           f"fusion route: {err}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, scale=scale)

    lib_err = (library() - want).abs().max().item()
    row = {"B": B, "H": 1, "S_q": S, "S_k": S, "D": D, "causal": False,
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "ms": time_ms(lambda: _flash_fwd_cuda(q, k, v, scale, False),
                         flush),
           "plain_ms": time_ms(lambda: _flash_ref(q, k, v, scale, False),
                               flush),
           "library_ms": time_ms(library, flush)}
    row["bound_ms"], row["bound_by"], row["flops"], row["bytes"] = \
        flash_bound(B, 1, S, S, D, False)
    add_k1_rates(row)
    print("  " + json.dumps(row))
    del flush
    return row


def _fused_nodes(block, batch):
    g = block._optimized_outputs(nd.zeros(
        (batch, W2V_SECONDS * SAMPLE_RATE, 1), ctx=mx.gpu(0)))
    out = {}
    for s in g._walk():
        if s._op in ("_fused_norm_act", "_fused_attention"):
            out.setdefault(s._op, []).append(s._kwargs["impl"])
    return out


def symbolic_phase():
    phase("13 symbolic serving")
    os.environ["MXNET_GRAPH_OPT"] = "1"
    cfg = W2V_CFG
    samples = W2V_SECONDS * SAMPLE_RATE
    n_layers = cfg["num_hidden_layers"]
    n_ln_act = len(cfg["conv_dim"])
    print(f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, "
          f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "wav2vec2-large-lv60")
        t0 = time.perf_counter()
        n_params = export_wav2vec2(prefix, mx.sym, nd, cfg, SEED)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess = serving.InferenceSession.load(
            prefix, input_shapes=[(1, samples, 1)], buckets=list(W2V_BUCKETS),
            ctx=mx.gpu(0))
        t_load = time.perf_counter() - t0
        print(f"wav2vec2-large-lv60 CTC {cfg}: {n_params} parameters "
              f"({n_params * 4 / 1e9:.3f} GB fp32); exported in "
              f"{t_export:.2f} s, loaded and warmed at buckets "
              f"{list(W2V_BUCKETS)} in {t_load:.2f} s")
        for b in W2V_BUCKETS:
            fused = _fused_nodes(sess._block, b)
            na = fused.get("_fused_norm_act", [])
            att = fused.get("_fused_attention", [])
            if len(na) != n_ln_act or len(att) != n_layers or \
                    set(na + att) != {"cuda"}:
                raise RuntimeError(f"bucket {b}: optimized graph holds "
                                   f"norm_act {na}, attention {att}")
        print(f"every bucket's optimized graph: {n_ln_act} _fused_norm_act "
              f"and {n_layers} _fused_attention, all impl='cuda'")
        rng = onp.random.default_rng(SEED)
        reqs = [rng.standard_normal((n, samples, 1), dtype=onp.float32)
                for n in W2V_REQUESTS]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        serving.METRICS.reset()
        torch.cuda.reset_peak_memory_stats()
        outs, req_ms = [], []
        t_all = time.perf_counter()
        for x in reqs:
            t0 = time.perf_counter()
            outs.append(sess.predict(x).asnumpy())
            req_ms.append((time.perf_counter() - t0) * 1e3)
        wall = time.perf_counter() - t_all
        counts = _build.launch_counts()
        snap = serving.METRICS.snapshot()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        execs = snap["bucket_execs"]
        k3 = counts.get(NORM_ACT_KERNEL, 0)
        k1 = counts.get(FLASH_KERNEL, 0)
        if k3 != n_ln_act * execs or k1 != n_layers * execs:
            raise RuntimeError(f"K3 launched {k3}, K1 {k1} times in {execs} "
                               "bucket executions")
        print(f"K3 launches {k3} = {n_ln_act} x {execs} bucket executions; "
              f"K1 launches {k1} = {n_layers} x {execs}")
        T = frames(cfg, samples)[-1]
        for n, o in zip(W2V_REQUESTS, outs):
            if o.shape != (n, T, cfg["vocab_size"]) or \
                    not onp.isfinite(o).all():
                raise RuntimeError(f"bad logits {o.shape} for {n} clips")
        buckets = [min(b for b in W2V_BUCKETS if b >= n)
                   for n in W2V_REQUESTS]
        clips = sum(W2V_REQUESTS)
        result = {"clips_per_s": clips / wall,
                  "audio_seconds_per_s": clips * W2V_SECONDS / wall,
                  "mean_request_ms": statistics.mean(req_ms),
                  "request_ms": dict(zip(
                      [f"{n} clips (bucket {b})"
                       for n, b in zip(W2V_REQUESTS, buckets)], req_ms)),
                  "bucket_execs": execs, "padded_rows": snap["padded_rows"],
                  "true_rows": snap["true_rows"],
                  "peak_memory_gb": peak_gb}
        print("symbolic serving " + json.dumps(result))
        # the same export with the fusion pass off: every node 1:1
        big = W2V_REQUESTS.index(W2V_BUCKETS[-1])
        os.environ["MXNET_FUSION"] = "0"
        try:
            plain = sess.predict(reqs[big]).asnumpy()
        finally:
            del os.environ["MXNET_FUSION"]
        scale = float(onp.abs(plain).max())
        ferr = float(onp.abs(outs[big] - plain).max())
        print(f"fused against MXNET_FUSION=0 at bucket {W2V_BUCKETS[-1]}: "
              f"max_abs_err {ferr:.3e}, {ferr / scale:.3e} of the largest "
              f"logit {scale:.3e}")
        if ferr > FUSION_TOL * scale:
            raise RuntimeError(f"fused logits differ from the unfused graph "
                               f"by {ferr}")
        # one 1 s clip on the card and on the CPU port, same export
        short = SAMPLE_RATE
        clip = rng.standard_normal((1, short, 1), dtype=onp.float32)
        card = serving.InferenceSession(
            sess._block, input_shapes=[(1, short, 1)], buckets=[1],
            ctx=mx.gpu(0)).predict(clip).asnumpy()
        cpu = serving.InferenceSession.load(
            prefix, input_shapes=[(1, short, 1)], buckets=[1],
            ctx=mx.cpu()).predict(clip).asnumpy()
    cscale = float(onp.abs(cpu).max())
    cerr = float(onp.abs(card - cpu).max())
    print(f"1 s clip, card against the CPU port: max_abs_err {cerr:.3e}, "
          f"{cerr / cscale:.3e} of the largest logit {cscale:.3e}")
    if not onp.allclose(card, cpu, rtol=CPU_RTOL, atol=CPU_RTOL * cscale):
        raise RuntimeError(f"card logits differ from the CPU's by {cerr}")
    result.update(n_params=n_params, fused_rel_err=ferr / scale,
                  cpu_rel_err=cerr / cscale, k3_launches=k3, k1_launches=k1)
    return result


# -- K4: rtc.CudaModule, and the ResNet-50 training path it serves -------

# the double kernel of tests/test_quant_custom.py:162-172 in CUDA C, and an
# axpy with a scalar argument; compiled with --fmad=false so y + a * x
# rounds twice, as torch's two ops do
K4_SRC = r"""
extern "C" __global__ void double_kernel(const float* x, float* y,
                                         long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}
extern "C" __global__ void axpy(const float* x, float* y, float a,
                                long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += a * x[i];
}
"""
K4_N = 2 ** 26
# the softmax kernels against their plain versions: the same fp32
# arithmetic, the row sums in another order
SOFTMAX_TOL = 1e-6
SOFTMAX_SHAPE = (128, 1000)  # the ResNet-50 head's (batch, classes)
RESNET_B, RESNET_WARMUP, RESNET_STEPS = 128, 2, 10
# SGD at lr 0.1 with momentum 0.9 and no warm-up overshoots on the fixed
# batch for about its first 20 steps: at step 12 the loss stands above
# its start in about half the runs on an H100, since cuDNN's algorithms
# sum in an order that varies from run to run and the overshoot
# amplifies it. From about step 20 it falls steadily in every run. So
# the falling-loss check reads the loss after this many steps in all;
# those after the timed ones are not timed
RESNET_FALL_STEPS = 40
# the rtc_softmax head's gradient against SoftmaxCrossEntropyLoss's, both
# p - onehot, through the same network on the card, relative to the
# largest gradient entry of the model
HEAD_TOL = 1e-4


def _launch_1d(kernel, args, n):
    kernel.launch(args, mx.gpu(0), ((n + 255) // 256, 1, 1), (256, 1, 1))


def k4_check_phase(gen):
    phase("14 K4 check")
    print(f"NVRTC {'.'.join(map(str, _nvrtc.nvrtc_version()))} from "
          f"{_nvrtc.nvrtc_path()}; modules compiled for {rtc.ARCH}")
    t0 = time.perf_counter()
    mod = rtc.CudaModule(K4_SRC, options=["--fmad=false"])
    print(f"double/axpy module compiled in {time.perf_counter() - t0:.3f} s")
    double = mod.get_kernel("double_kernel",
                            "const float* x, float* y, int64_t n")
    axpy = mod.get_kernel("axpy", "const float* x, float* y, float a, "
                                  "int64_t n")
    x = torch.randn(K4_N, device="cuda", generator=gen)
    y = torch.empty_like(x)
    _launch_1d(double, [x, y, K4_N], K4_N)
    if not torch.equal(y, x * 2):
        raise RuntimeError("K4 double_kernel differs from x * 2")
    y0 = torch.randn(K4_N, device="cuda", generator=gen)
    y = y0.clone()
    _launch_1d(axpy, [nd.NDArray(x), nd.NDArray(y), 0.75, K4_N], K4_N)
    if not torch.equal(y, y0 + 0.75 * x):
        raise RuntimeError("K4 axpy differs from y + 0.75 * x")
    print(f"double and axpy on {K4_N} fp32 elements equal torch's x * 2 and "
          "y + 0.75 * x exactly")
    worst = 0.0
    for B, C in (SOFTMAX_SHAPE, (128, 1001), (64, 4097)):
        x = torch.randn(B, C, device="cuda", generator=gen) * 4
        label = torch.randint(0, C, (B,), device="cuda",
                              generator=gen).float()
        p = torch.zeros_like(x)
        pr.softmax_fwd(x, p)
        dx = torch.zeros_like(x)
        pr.softmax_bwd(label, p, dx)
        torch.cuda.synchronize()
        for what, got, want in (("forward", p, pr.softmax_fwd_plain(x)),
                                ("backward", dx,
                                 pr.softmax_bwd_plain(label, p))):
            err = (got - want).abs().max().item()
            print(f"  rtc_softmax {what} B={B} C={C}: max_abs_err={err:.3e}")
            if not torch.allclose(got, want, rtol=SOFTMAX_TOL,
                                  atol=SOFTMAX_TOL):
                raise RuntimeError(f"rtc_softmax {what} disagrees with its "
                                   f"plain version at B={B} C={C}: {err}")
            worst = max(worst, err)
    try:
        rtc.CudaModule('extern "C" __global__ void f(float* x) '
                       '{ x[0] = undefined_name; }')
        raise RuntimeError("a source that does not compile was accepted")
    except mx.MXNetError as e:
        if "undefined_name" not in str(e):
            raise RuntimeError(f"the compile error lacks NVRTC's log: {e}")
    refusals = (
        ("dtype", lambda: _launch_1d(double, [x.double(), y, 8], 8),
         "float64"),
        ("cpu ctx", lambda: double.launch([x, y, 8], mx.cpu(), (1, 1, 1),
                                          (32, 1, 1)), "GPU context"))
    for what, fn, msg in refusals:
        try:
            fn()
            raise RuntimeError(f"K4 launch with a wrong {what} was accepted")
        except mx.MXNetError as e:
            if msg not in str(e):
                raise
    print("a compile error raises with NVRTC's log; a dtype mismatch and a "
          "CPU context raise MXNetError")
    print(f"rtc_softmax matches its plain versions within rtol=atol="
          f"{SOFTMAX_TOL}; worst max_abs_err {worst:.3e}")
    return worst, double


def k4_bound(nbytes):
    """Least ms for a memory-bound launch moving ``nbytes`` (each input
    read once, each output written once) at 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def k4_times_phase(gen, double):
    phase("15 K4 times")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    B, C = SOFTMAX_SHAPE
    x = torch.randn(B, C, device="cuda", generator=gen) * 4
    label = torch.randint(0, C, (B,), device="cuda", generator=gen).float()
    p, dx = torch.zeros_like(x), torch.zeros_like(x)
    pr.softmax_fwd(x, p)

    def t(fn):
        return time_ms(fn, flush)

    fwd = {"B": B, "C": C, "ms": t(lambda: pr.softmax_fwd(x, p)),
           "plain_ms": t(lambda: pr.softmax_fwd_plain(x)),
           "library_ms": t(lambda: torch.softmax(x, -1)),
           "bound_ms": k4_bound(2 * B * C * 4), "bound_by": "bytes"}
    # the library call: softmax's backward, torch._softmax_backward_data,
    # which gives p * (g - sum(g * p)) = p - onehot(label) for the head
    # gradient g = 1 - onehot / p (made outside the timing)
    onehot = (torch.arange(C, device="cuda")
              == label.to(torch.int64)[:, None]).float()
    g_head = 1.0 - onehot / p
    lib = torch._softmax_backward_data(g_head, p, -1, torch.float32)
    lib_dev = float((lib - pr.softmax_bwd_plain(label, p)).abs().max())
    bwd = {"B": B, "C": C, "ms": t(lambda: pr.softmax_bwd(label, p, dx)),
           "plain_ms": t(lambda: pr.softmax_bwd_plain(label, p)),
           "library_ms": t(lambda: torch._softmax_backward_data(
               g_head, p, -1, torch.float32)),
           "library_call": "torch._softmax_backward_data",
           "library_max_abs_dev": lib_dev,
           "bound_ms": k4_bound(2 * B * C * 4 + B * 4), "bound_by": "bytes"}
    xd = torch.randn(K4_N, device="cuda", generator=gen)
    yd = torch.empty_like(xd)
    dbl = {"n": K4_N,
           "ms": t(lambda: _launch_1d(double, [xd, yd, K4_N], K4_N)),
           "plain_ms": t(lambda: xd * 2),
           "bound_ms": k4_bound(2 * K4_N * 4), "bound_by": "bytes"}
    for row in (fwd, bwd, dbl):
        row["bound_share"] = row["bound_ms"] / row["ms"]
    dbl["achieved_tb_per_s"] = 2 * K4_N * 4 / dbl["ms"] / 1e9
    # host cost of one launch call: argument checks, context, stream and
    # cuLaunchKernel, for a one-block kernel
    small = torch.zeros(256, device="cuda")
    for _ in range(100):
        _launch_1d(double, [small, small, 256], 256)
    torch.cuda.synchronize()
    n_calls = 2000
    t0 = time.perf_counter()
    for _ in range(n_calls):
        _launch_1d(double, [small, small, 256], 256)
    host_us = (time.perf_counter() - t0) / n_calls * 1e6
    torch.cuda.synchronize()
    dbl["host_us_per_launch"] = host_us
    for name, row in (("rtc_softmax_fwd", fwd), ("rtc_softmax_bwd", bwd),
                      ("double_kernel", dbl)):
        print(f"  {name} " + json.dumps(row))
    del flush, xd, yd
    return fwd, bwd, dbl


def _grads(net):
    return {n: p.grad().asnumpy()
            for n, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def resnet_phase():
    phase("16 ResNet-50 training")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    # cuDNN times its convolution algorithms at first use of a shape, as
    # MXNet does by default (MXNET_CUDNN_AUTOTUNE_DEFAULT=1); TF32 stays off
    torch.backends.cudnn.benchmark = True
    print(f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cudnn."
          f"benchmark = {torch.backends.cudnn.benchmark}")
    t0 = time.perf_counter()
    net = pr.build_resnet50(ctx, seed=SEED)
    params = net._collect_params_with_prefix()
    n_params = sum(p.data().size for p in params.values()
                   if p.grad_req != "null")
    trainer = pr.make_trainer(net)
    x, y = pr.synthetic_batch(RESNET_B, ctx, seed=SEED)
    print(f"resnet50_v1: {n_params} trainable parameters; batch {RESNET_B} "
          f"x 3 x {pr.IMAGE} x {pr.IMAGE} fp32, {pr.CLASSES} classes, SGD "
          f"lr {pr.LR} momentum {pr.MOMENTUM} wd {pr.WD}; built in "
          f"{time.perf_counter() - t0:.2f} s")
    stats0 = {n: p.data().asnumpy() for n, p in params.items()
              if n.endswith(("running_mean", "running_var"))}
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(RESNET_WARMUP):
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
        if i == 0:
            bad = [n for n, g in _grads(net).items()
                   if not onp.isfinite(g).all()]
            if bad:
                raise RuntimeError(f"non-finite gradients after step 1: "
                                   f"{bad[:5]}")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(RESNET_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        loss = pr.train_step(net, trainer, x, y, events=ev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    while len(losses) < RESNET_FALL_STEPS:
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
    print(f"losses {[round(v, 4) for v in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"ResNet-50 training did not go down in "
                           f"{len(losses)} steps: {losses}")
    bad = [n for n, g in _grads(net).items() if not onp.isfinite(g).all()]
    if bad:
        raise RuntimeError(f"non-finite gradients: {bad[:5]}")
    moved = [n for n, v in stats0.items()
             if not onp.array_equal(params[n].data().asnumpy(), v)]
    if len(moved) != len(stats0):
        raise RuntimeError(f"running statistics that never moved: "
                           f"{sorted(set(stats0) - set(moved))[:5]}")
    fwd_n, bwd_n = counts.get(pr.FWD_KERNEL, 0), counts.get(pr.BWD_KERNEL, 0)
    if fwd_n != RESNET_STEPS or bwd_n != RESNET_STEPS:
        raise RuntimeError(f"K4 launched forward {fwd_n}, backward {bwd_n} "
                           f"times in {RESNET_STEPS} steps")
    print(f"K4 launches {fwd_n + bwd_n} = 2 x {RESNET_STEPS} steps "
          f"({pr.FWD_KERNEL} {fwd_n}, {pr.BWD_KERNEL} {bwd_n}); all "
          f"{len(stats0)} running statistics moved; every gradient finite")
    stats = check_fused(trainer, RESNET_FALL_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    eager_ms, eager_opt = eager_step_ms(
        lambda ev: pr.train_step(net, trainer, x, y, events=ev))
    # scoring: the eval forward at the same batch (BASELINE's other fp32
    # configuration)
    for _ in range(2):
        net(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        out = net(x)
    torch.cuda.synchronize()
    score_s = (time.perf_counter() - t0) / RESNET_STEPS
    if out.shape != (RESNET_B, pr.CLASSES) or \
            not torch.isfinite(out.data).all():
        raise RuntimeError(f"bad scoring output {out.shape}")
    result = {"img_per_s": RESNET_B * RESNET_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0],
              "timed_last_loss": losses[RESNET_WARMUP + RESNET_STEPS - 1],
              "last_loss": losses[-1], "steps": len(losses),
              "peak_memory_gb": peak_gb,
              "scoring_img_per_s": RESNET_B / score_s,
              "scoring_ms": score_s * 1e3, "n_params": n_params,
              "fused_step": stats, "eager_loop_mean_step_ms": eager_ms,
              "eager_loop_optimizer_ms": eager_opt}
    print("resnet training " + json.dumps(result))
    return net, (fwd_n, bwd_n), result


def resnet_cpu_compare():
    """One record/backward of ResNet-50 at batch 2 on the card (K4) and
    on the CPU (the plain head) from the same fresh weights, in eval and
    training mode: the loss and the watched gradients within rtol 1e-3.
    Returns each watched value's deviation relative to its largest
    entry."""
    # fresh weights from the seed (running statistics at their initial
    # values), on the card and, carried across, on the CPU
    fresh = pr.build_resnet50(mx.gpu(0), seed=SEED + 1)
    arrays = {n: p.data().asnumpy()
              for n, p in fresh._collect_params_with_prefix().items()}
    cpu_net = convert.params_from_numpy(vision.resnet50_v1(), arrays,
                                        ctx=mx.cpu())
    rs = onp.random.RandomState(SEED + 1)
    xb = rs.standard_normal((2, 3, pr.IMAGE, pr.IMAGE)).astype("float32")
    yb = rs.randint(0, pr.CLASSES, 2).astype("float32")
    # eval mode first, where batch norm is linear: the loss and the
    # gradients of the stem, a mid-network convolution and the
    # classifier. Then training mode: the loss and the classifier's
    # gradients. The other training-mode gradients at batch 2 carry the
    # float32 rounding of batch statistics taken over few, nearly equal
    # values, which batch norm multiplies by 1/sigma (the card sums them
    # in float32, torch's CPU kernels in float64): on these weights the
    # last BatchNorm's gamma already differs by 3.5%, and the JAX
    # package's own eager and compiled runs differ by up to 26% on such
    # inputs
    cases = (("eval", False, ["features.0.weight",
                              "features.5.0.body.3.weight",
                              "output.weight"]),
             ("train", True, ["output.weight", "output.bias"]))
    report = {}
    for mode, train, watched in cases:
        runs = []
        for model, ctx in ((fresh, mx.gpu(0)), (cpu_net, mx.cpu())):
            xs, ys = nd.array(xb, ctx=ctx), nd.array(yb, ctx=ctx)
            _build.reset_launch_counts()
            with autograd.record(train_mode=train):
                logits = model(xs)
                p = pr.rtc_softmax(logits, ys)
            p.backward()
            params = model._collect_params_with_prefix()
            runs.append((pr.cross_entropy(logits, ys).asscalar(),
                         {n: params[n].grad().asnumpy() for n in watched},
                         sum(_build.launch_counts().values())))
        (gl, gg, gk), (cl, cg, ck) = runs
        if gk != 2 or ck != 0:
            raise RuntimeError(f"K4 launches: card {gk}, CPU {ck}")
        print(f"  {mode} mode: loss card {gl:.6f} cpu {cl:.6f}")
        if not onp.isclose(gl, cl, rtol=CPU_RTOL, atol=0):
            raise RuntimeError(f"{mode} loss differs: card {gl}, CPU {cl}")
        for n in watched:
            scale = float(onp.abs(cg[n]).max())
            err = float(onp.abs(gg[n] - cg[n]).max())
            report[f"{mode}:{n}"] = err / scale
            print(f"    grad {n}: max_abs_err {err:.3e}, {err / scale:.3e} "
                  f"of its largest entry {scale:.3e}")
            if not onp.allclose(gg[n], cg[n], rtol=CPU_RTOL,
                                atol=CPU_RTOL * scale):
                raise RuntimeError(f"{mode} gradient of {n} differs from the "
                                   "CPU's")
        report[f"{mode}:loss"] = (gl, cl)
    del fresh, cpu_net
    print(f"card matches CPU within rtol {CPU_RTOL}")
    return report


def resnet_vs_cpu_phase(net):
    phase("17 ResNet-50 against the CPU, and head against head")
    report = resnet_cpu_compare()
    # head against head on the card, at the training batch
    x, y = pr.synthetic_batch(RESNET_B, mx.gpu(0), seed=SEED + 2)
    heads = []
    for head in ("rtc_softmax", "SoftmaxCrossEntropyLoss"):
        with autograd.record():
            out = net(x)
            h = pr.rtc_softmax(out, y) if head == "rtc_softmax" else \
                gluon.loss.SoftmaxCrossEntropyLoss()(out, y)
        h.backward()
        heads.append(_grads(net))
    scale = max(float(onp.abs(g).max()) for g in heads[1].values())
    herr = max(float(onp.abs(heads[0][n] - g).max())
               for n, g in heads[1].items())
    print(f"rtc_softmax head against SoftmaxCrossEntropyLoss at batch "
          f"{RESNET_B}: worst gradient difference {herr:.3e}, "
          f"{herr / scale:.3e} of the largest gradient entry {scale:.3e}")
    if herr > HEAD_TOL * scale:
        raise RuntimeError(f"the two heads' gradients differ by {herr}")
    report["head_rel_err"] = herr / scale
    return report


# -- slice 5: decode serving as the JAX package serves it -------------------

PAGE_TOKENS = 16
PAGED_BUCKETS = [1, 2, 4, 8, 16, 32]
PAGED_STREAMS, PAGED_MIN, PAGED_MAX = 32, 16, 256
PAGED_GAP_S = 0.025  # mean gap between stream arrivals (open loop)
PAGED_BUDGET = 2 ** 30  # KV page pool, bytes: 910 pages of 16 tokens
RERUN_STREAMS = 8
# one eager step against one replayed step of the same states: the same
# kernels, so bitwise unless cuBLAS picks another algorithm under capture
GRAPH_TOL = 1e-5
HTTP_STREAMS, HTTP_STEPS, HTTP_PROMOTE_AT = 4, 12, 6


def decode_net():
    mx.random.seed(SEED)
    net = DecoderBlockLM(**GPT2_SMALL)
    net.initialize(ctx=mx.gpu(0))
    return net


def paged_serving_phase(net):
    phase("18 paged decode serving")
    cfg = GPT2_SMALL
    t0 = time.perf_counter()
    store, sess = decode_stack(net, PAGED_STREAMS, PAGE_TOKENS,
                               PAGED_BUCKETS, budget=PAGED_BUDGET)
    capture_s = time.perf_counter() - t0
    print(f"paged store: {store.num_pages} pages of {PAGE_TOKENS} tokens, "
          f"{store.stats()['page_bytes']} bytes each; {len(PAGED_BUCKETS)} "
          f"buckets captured in {capture_s:.2f} s")
    rs = onp.random.RandomState(SEED + 18)
    lengths = [int(n) for n in rs.randint(PAGED_MIN, PAGED_MAX + 1,
                                          PAGED_STREAMS)]
    arrivals = onp.cumsum(rs.exponential(PAGED_GAP_S, PAGED_STREAMS))
    sids = [f"p{i}" for i in range(PAGED_STREAMS)]
    first = {sid: int(rs.randint(cfg["vocab_size"])) for sid in sids}
    rerun = set(sids[:RERUN_STREAMS])
    # the step log, for the row-slot rerun: per step its sessions, its
    # bucket, its tokens and the rerun streams' logits
    log = []
    run_store_step = sess._run_store_step

    def logged(arrs, recs, bucket=None):
        host = run_store_step(arrs, recs, bucket)
        ids = [r.sid for r in recs]
        log.append((ids, sess._bucket_for(len(recs)), arrs[0].copy(),
                    {i: host[0][i].copy() for i, sid in enumerate(ids)
                     if sid in rerun}))
        return host

    sess._run_store_step = logged
    bat = serving.DynamicBatcher(sess, max_batch_size=PAGED_BUCKETS[-1],
                                 max_latency_ms=2.0, timeout_ms=600000,
                                 admission=False)
    toks = {sid: [first[sid]] for sid in sids}
    try:
        _build.reset_launch_counts()
        serving.METRICS.reset()
        pending, started = {}, 0
        t0 = time.perf_counter()
        while pending or started < PAGED_STREAMS:
            now = time.perf_counter() - t0
            while started < PAGED_STREAMS and arrivals[started] <= now:
                sid = sids[started]
                pending[bat.submit(onp.array([[first[sid]]], "int32"),
                                   session_id=sid,
                                   slo_class="standard")] = sid
                started += 1
            wait_s = (arrivals[started] - now if started < PAGED_STREAMS
                      else 600)
            done, _ = wait(pending, timeout=max(wait_s, 0.0),
                           return_when=FIRST_COMPLETED)
            if not done and started == PAGED_STREAMS:
                raise RuntimeError("paged serving stalled: no step "
                                   "resolved in 600 s")
            for fut in done:
                sid = pending.pop(fut)
                logits = onp.asarray(fut.result())
                if logits.shape != (1, cfg["vocab_size"]) or \
                        not onp.isfinite(logits).all():
                    raise RuntimeError(f"{sid}: bad logits {logits.shape}")
                if len(toks[sid]) < lengths[sids.index(sid)]:
                    nxt = int(logits.argmax())
                    toks[sid].append(nxt)
                    pending[bat.submit(onp.array([[nxt]], "int32"),
                                       session_id=sid,
                                       slo_class="standard")] = sid
        wall = time.perf_counter() - t0
        launches = _build.launch_counts().get(KERNEL, 0)
        snap = serving.METRICS.snapshot()
        stats = store.stats()
        graphs = sess.graph_stats()
        step_ms = mean_step_ms()
    finally:
        bat.close()
        sess._run_store_step = run_store_step
    n_tokens = sum(lengths)
    steps = snap["decode_steps"]
    if snap["responses:standard"] != n_tokens or snap["failures"] or \
            snap["evictions"]:
        raise RuntimeError(f"not every step resolved cleanly: {snap}")
    if launches != cfg["num_layers"] * steps:
        raise RuntimeError(f"K2 launched {launches} times in {steps} decode "
                           f"steps of {cfg['num_layers']} layers")
    replays = sum(g["replays"] for g in graphs.values())
    if not all(g["graph"] for g in graphs.values()) or replays != steps:
        raise RuntimeError(f"steps did not all replay graphs: {graphs}, "
                           f"{steps} steps")
    result = {
        "streams": PAGED_STREAMS, "tokens": n_tokens, "wall_s": wall,
        "tokens_per_s": n_tokens / wall, "decode_steps": steps,
        "mean_rows_per_step": snap["true_rows"] / max(steps, 1),
        "mean_step_ms": step_ms,
        "token_latency_p50_ms": snap["latency_p50_ms"],
        "token_latency_p99_ms": snap["latency_p99_ms"],
        "pages_used_peak": stats["pages_used"],
        "kv_bytes_peak": stats["pages_used"] * stats["page_bytes"],
        "row_slot_bytes": PAGED_STREAMS * store.bytes_per_session,
        "graphs": {str(b): g for b, g in graphs.items()},
        "capture_s": capture_s, "k2_launches": launches}
    result["kv_bytes_share"] = result["kv_bytes_peak"] / \
        result["row_slot_bytes"]
    print("paged serving " + json.dumps(result))
    print(f"K2 launches {launches} = {cfg['num_layers']} layers x {steps} "
          f"graph replays")
    sess.close()
    store.close()
    del sess, store
    torch.cuda.empty_cache()
    # the rerun: the first 8 streams on a row-slot store, each logged step
    # restricted to them and run at the bucket it ran at
    rstore, rsess = decode_stack(net, RERUN_STREAMS, 0, PAGED_BUCKETS)
    worst, compared = 0.0, 0
    for ids, bucket, tok, want in log:
        rows = [i for i, sid in enumerate(ids) if sid in rerun]
        if not rows:
            continue
        recs = []
        for i in rows:
            if not rstore.has(ids[i]):
                rstore.open(ids[i])
            recs.append(rstore.acquire(ids[i]))
        try:
            got = rsess._run_store_step([tok[rows]], recs, bucket)[0]
        finally:
            for rec in recs:
                rstore.release(rec)
        for k, i in enumerate(rows):
            err = float(onp.abs(got[k] - want[i]).max())
            worst = max(worst, err)
            compared += 1
            if not onp.array_equal(got[k], want[i]):
                raise RuntimeError(
                    f"{ids[i]}: the row-slot rerun differs from the paged "
                    f"run at bucket {bucket} by {err}")
    print(f"{RERUN_STREAMS} streams rerun on a row-slot store: {compared} "
          f"steps' logits bitwise equal (max_abs_err {worst})")
    rsess.close()
    rstore.close()
    torch.cuda.empty_cache()
    result["rerun_bitwise_steps"] = compared
    return launches, result


def graph_vs_eager_phase(net):
    phase("19 graph against eager")
    rows = 8
    rs = onp.random.RandomState(SEED + 19)
    states = []
    for s, dt in zip(net.state_row_shapes(), net.state_row_dtypes()):
        if dt == "int32":  # positions inside the cache
            states.append(rs.randint(0, GPT2_SMALL["max_len"] - 1,
                                     (rows,) + s).astype(dt))
        else:
            states.append(rs.standard_normal((rows,) + s).astype(dt))
    tok = rs.randint(GPT2_SMALL["vocab_size"], size=(rows, 1)).astype("int32")
    out, numbers = {}, {}
    for graphs in (False, True):
        store, sess = decode_stack(net, rows, PAGE_TOKENS, [1, 2, 4, 8],
                                   graphs=graphs)
        logits, news = sess.step(tok, states=states)
        out[graphs] = [logits.asnumpy()] + [n.asnumpy() for n in news]
        sids = [f"g{i}" for i in range(rows)]
        for sid in sids:
            store.open(sid)
        numbers["graphs" if graphs else "eager"] = profile_steps(
            store, sess, sids, 10, SEED)
        sess.close()
        store.close()
        del sess, store
        torch.cuda.empty_cache()
    errs = [float(onp.abs(a.astype("float64") - b).max())
            for a, b in zip(out[False], out[True])]
    bitwise = all(onp.array_equal(a, b) for a, b in zip(out[False],
                                                          out[True]))
    print(f"one step at {rows} rows, eager against replayed graph: "
          f"{'bitwise equal' if bitwise else 'not bitwise'}; max_abs_err "
          f"logits {errs[0]:.3e}, states {max(errs[1:]):.3e}")
    if not all(onp.isfinite(a).all() for a in out[True]) or \
            not max(errs) <= GRAPH_TOL:
        raise RuntimeError(f"graph replay differs from the eager step by "
                           f"{max(errs)} (> {GRAPH_TOL})")
    for mode, row in numbers.items():
        print(f"  {mode} " + json.dumps({
            k: row[k] for k in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "device_ops_per_step",
                "host_launches_per_step")}))
    return {"bitwise": bitwise, "max_abs_err": max(errs), **numbers}


def _http(port, method, path, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _http_step(port, sid, tok, slo_class="standard"):
    code, hdr, body = _http(
        port, "POST", "/models/lm/predict",
        json.dumps({"data": [[int(tok)]]}).encode(),
        {"Content-Type": "application/json", "X-Session-Id": sid,
         "X-SLO-Class": slo_class, "X-Request-Id": f"{sid}-{tok}"})
    return code, hdr, body


def _http_round(port, streams, k):
    """Step k of every stream, concurrently over HTTP; returns
    {sid: logits}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(streams)) as ex:
        futs = {sid: ex.submit(_http_step, port, sid, toks[k])
                for sid, toks in streams.items()}
        out = {}
        for sid, f in futs.items():
            code, hdr, body = f.result()
            if code != 200:
                raise RuntimeError(f"{sid} step {k}: HTTP {code} {body!r}")
            out[sid] = onp.asarray(json.loads(body)["outputs"][0],
                                   "float32")
    return out


def http_phase(net):
    phase("20 HTTP")
    rs = onp.random.RandomState(SEED + 20)
    streams = {f"h{i}": [int(t) for t in rs.randint(
        GPT2_SMALL["vocab_size"], size=HTTP_STEPS)]
        for i in range(HTTP_STREAMS)}

    def version():
        # one bucket: every step runs the same shapes whichever streams
        # share it, so the two runs are comparable bit for bit
        return decode_stack(net, HTTP_STREAMS, PAGE_TOKENS,
                            [HTTP_STREAMS])[1]

    # the admission controllers' latency signal reads each version's p99
    # against this SLO; the shed checked here is the forced one
    os.environ["MXNET_SERVING_SLO_MS"] = "10000"
    runs = {}
    for promote in (False, True):
        repo = serving.ModelRepository(max_latency_ms=2.0,
                                       timeout_ms=300000,
                                       canary_min_requests=10 ** 9)
        repo.deploy("lm", version())
        srv = serving.ModelServer(repository=repo, port=0).start()
        try:
            got = {sid: [] for sid in streams}
            for k in range(HTTP_STEPS):
                if promote and k == HTTP_PROMOTE_AT:
                    repo.deploy("lm", version())
                    serving.METRICS.reset()
                    # promote while this round is in flight: it waits
                    # for the incumbent's accepted steps, then migrates
                    import threading

                    t = threading.Thread(target=repo.promote, args=("lm",))
                    t.start()
                    step = _http_round(srv.port, streams, k)
                    t.join(300)
                    resumed = serving.METRICS.snapshot()["resumed_sessions"]
                else:
                    step = _http_round(srv.port, streams, k)
                for sid, v in step.items():
                    got[sid].append(v)
            if promote:
                with faults.inject("serving_admission", every=1):
                    shed = _http_step(srv.port, "shed-me", 1, "best_effort")
                    kept = _http_step(srv.port, "keep-me", 1, "critical")
                code, _, body = _http(srv.port, "GET", "/metrics")
                metrics = body.decode()
                _, _, health = _http(srv.port, "GET", "/healthz")
                states = repo.model_states()["lm"]
        finally:
            srv.stop()
        runs[promote] = got
    del os.environ["MXNET_SERVING_SLO_MS"]
    for sid in streams:
        for k, (a, b) in enumerate(zip(runs[False][sid], runs[True][sid])):
            if not onp.array_equal(a, b):
                raise RuntimeError(
                    f"{sid} step {k}: logits after the promote differ from "
                    f"the run without one by {onp.abs(a - b).max()}")
    if resumed != HTTP_STREAMS or states["active_version"] != 2:
        raise RuntimeError(f"promote migrated {resumed} sessions, active "
                           f"v{states['active_version']}")
    print(f"{HTTP_STREAMS} streams x {HTTP_STEPS} steps over HTTP; v2 "
          f"promoted at step {HTTP_PROMOTE_AT} with a round in flight: "
          f"resumed_sessions {resumed}, every logit bitwise equal to the "
          "run without a promote")
    code, hdr, body = shed
    if code != 503 or float(hdr.get("Retry-After", 0)) <= 0:
        raise RuntimeError(f"best_effort under an admission fault: HTTP "
                           f"{code} {hdr}")
    if kept[0] != 200:
        raise RuntimeError(f"critical under an admission fault: HTTP "
                           f"{kept[0]} {kept[2]!r}")
    print(f"under faults.inject('serving_admission', every=1): best_effort "
          f"HTTP {code}, Retry-After {hdr['Retry-After']}; critical HTTP "
          f"{kept[0]}")
    fams = sorted({line.split("{")[0] for line in metrics.splitlines()
                   if 'slo_class="' in line})
    if not fams:
        raise RuntimeError("/metrics carries no slo_class family")
    print(f"/metrics slo_class families: {fams}")
    print(f"/healthz: {json.loads(health)['status']}")
    torch.cuda.empty_cache()
    return {"resumed_sessions": resumed, "shed_status": code,
            "critical_status": kept[0], "slo_class_families": len(fams)}


def conv_default_flags_phase():
    phase("21 convolution at torch's default flags")
    # torch's defaults, whatever an earlier phase set: the port must hold
    # float32 convolutions to float32 on its own
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    print(f"torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cudnn."
          f"benchmark = {torch.backends.cudnn.benchmark}")
    report = resnet_cpu_compare()
    worst = max(v for k, v in report.items() if not k.endswith(":loss"))
    print(f"worst gradient deviation {worst:.3e} of its largest entry "
          f"(allowed rtol {CPU_RTOL})")
    return report


def k4_floor_phase():
    phase("22 K4 launch floor")
    mod = rtc.CudaModule('extern "C" __global__ void mxtt_empty() {}')
    kernel = mod.get_kernel("mxtt_empty", "")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")

    def launch():
        kernel.launch([], mx.gpu(0), (1, 1, 1), (32, 1, 1))

    ms = time_ms(launch, flush)
    del flush
    row = {"ms": ms, "bound_ms": 0.0, "bound_by": "bytes",
           "note": "an empty kernel: the device time of one launch"}
    print("  empty rtc kernel " + json.dumps(row))
    return row


# -- slice 6: bf16 AMP and the fused step ------------------------------------

def k1_bf16_phase(gen):
    phase("23 K1 in bfloat16 at the LM's shape")
    B, H, S, D = TRAIN_B, GPT2_SMALL_LM["num_heads"], TRAIN_S, 64
    scale = D ** -0.5
    q, k, v = flash_inputs(gen, B, H, S, S, D, torch.bfloat16)
    # the LM's own layout: q, k, v strided views of one fused projection
    qkv = torch.randn(B, S, 3, H, D, device="cuda", generator=gen).to(
        torch.bfloat16)
    vq, vk, vv = qkv.permute(2, 0, 3, 1, 4)
    cases = [("training shape, contiguous", q, k, v, True),
             ("training shape, the LM's qkv views", vq, vk, vv, True)]
    # a ragged S (not a multiple of the 128-row tiles) and a causal
    # offset (S_q < S_k), not causal beside it
    for B_, H_, S_q, S_k, causal in ((2, H, 1000, 1000, True),
                                     (3, 4, 300, 777, True),
                                     (2, 5, 333, 555, False)):
        cases.append((f"B={B_} H={H_} S_q={S_q} S_k={S_k} causal={causal}",
                      *flash_inputs(gen, B_, H_, S_q, S_k, D,
                                    torch.bfloat16), causal))
    worst = 0.0
    for name, q_, k_, v_, causal in cases:
        route = _flash_route(q_, k_, v_)
        if route != "sm90":
            raise RuntimeError(f"K1's rule sends {name} to {route!r}")
        got = _flash_fwd_cuda(q_, k_, v_, scale, causal).float()
        # the plain version in float32 from the same bf16 inputs, rounded
        # to bf16 once: the kernel rounds once too, at its output
        want = _flash_ref(q_.float(), k_.float(), v_.float(), scale,
                          causal).to(torch.bfloat16).float()
        err = (got - want).abs().max().item()
        print(f"  sm90 route, {name}: max_abs_err={err:.3e}")
        if not torch.allclose(got, want, rtol=BF16_RTOL, atol=KERNEL_ATOL):
            raise RuntimeError(f"K1's sm90 kernel is off by {err} at {name}")
        worst = max(worst, err)
    want = _flash_ref(q.float(), k.float(), v.float(), scale, True).to(
        torch.bfloat16).float()
    mma_err = (_flash_fwd_cuda(q, k, v, scale, True, route="mma").float()
               - want).abs().max().item()

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)

    lib_err = (library().float() - want).abs().max().item()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    pairs = S * (S + 1) // 2
    flops = 4 * D * B * H * pairs
    nbytes = 4 * B * H * S * D * 2  # q, k, v read and out written, bf16
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    row = {"B": B, "H": H, "S_q": S, "S_k": S, "D": D, "causal": True,
           "dtype": "bfloat16", "max_abs_err": worst,
           "ms": time_ms(lambda: _flash_fwd_cuda(q, k, v, scale, True),
                         flush),
           "views_ms": time_ms(
               lambda: _flash_fwd_cuda(vq, vk, vv, scale, True), flush),
           "mma_route_ms": time_ms(
               lambda: _flash_fwd_cuda(q, k, v, scale, True, route="mma"),
               flush),
           "mma_route_max_abs_err": mma_err,
           "plain_ms": time_ms(lambda: _flash_ref(q, k, v, scale, True),
                               flush),
           "library_ms": time_ms(library, flush),
           "library_max_abs_err": lib_err,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           # the design's own arithmetic: P.V twice (P_hi and P_lo)
           "bound_two_pass_ms": max(t_bytes, 1.5 * t_ops) * 1e3,
           "flops": flops, "bytes": nbytes}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["bound_two_pass_share"] = row["bound_two_pass_ms"] / row["ms"]
    row["speedup_over_mma_route"] = row["mma_route_ms"] / row["ms"]
    del flush
    print(f"  K1 bf16 (sm90 route) within two bf16 ulps of the plain "
          f"version: worst max_abs_err={worst:.3e}; the mma route's "
          f"{mma_err:.3e}; SDPA's {lib_err:.3e}")
    print("  " + json.dumps(row))
    return row


def _amp_grads_finite(net):
    bad = [n for n, p in net._collect_params_with_prefix().items()
           if p.grad_req != "null" and
           not torch.isfinite(p.grad().data).all()]
    if bad:
        raise RuntimeError(f"non-finite gradients after step 1: {bad[:5]}")


def resnet_amp_run(layout):
    """ResNet-50 v1 in bf16 AMP at one layout, as phase 16 in fp32: 2
    warm-up and 10 timed steps, then 28 more; the fused step with a loss
    scaler. Returns (net, trainer, x, y, result)."""
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    net = pr.build_resnet50(ctx, seed=SEED, layout=layout)
    trainer = pr.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    x, y = pr.synthetic_batch(RESNET_B, ctx, seed=SEED, layout=layout)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    for i in range(RESNET_WARMUP):
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
        if i == 0:
            _amp_grads_finite(net)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_build
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(RESNET_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        loss = pr.train_step(net, trainer, x, y, events=ev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    while len(losses) < RESNET_FALL_STEPS:
        losses.append(pr.train_step(net, trainer, x, y).asscalar())
    print(f"  {layout} losses {[round(v, 4) for v in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"bf16 ResNet-50 ({layout}) did not go down in "
                           f"{len(losses)} steps: {losses}")
    fwd_n, bwd_n = counts.get(pr.FWD_KERNEL, 0), counts.get(pr.BWD_KERNEL, 0)
    if fwd_n != RESNET_STEPS or bwd_n != RESNET_STEPS:
        raise RuntimeError(f"K4 launched forward {fwd_n}, backward {bwd_n} "
                           f"times in {RESNET_STEPS} bf16 steps")
    stats = check_fused(trainer, RESNET_FALL_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    result = {"layout": layout, "img_per_s": RESNET_B * RESNET_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0], "last_loss": losses[-1],
              "steps": len(losses), "peak_memory_gb": peak_gb,
              "warmup_s": warm_s, "k4_launches": fwd_n + bwd_n,
              "skipped_steps": trainer._fused_skipped_steps(),
              "loss_scale": trainer._amp_loss_scaler.loss_scale,
              "fused_step": stats}
    print(f"  resnet bf16 {layout} " + json.dumps(result))
    amp.disable()
    return net, trainer, x, y, result


def resnet_amp_phase():
    phase("24 ResNet-50 in bf16 AMP")
    torch.backends.cudnn.benchmark = True
    runs = {}
    for layout in ("NCHW", "NHWC"):
        runs[layout] = resnet_amp_run(layout)
        if layout == "NCHW":  # the NHWC run keeps its net for phase 27
            runs[layout] = runs[layout][4:]
            torch.cuda.empty_cache()
    head = min(("NCHW", "NHWC"), key=lambda k: runs[k][-1]["mean_step_ms"])
    print(f"headline layout {head}: "
          f"{runs[head][-1]['img_per_s']:.1f} img/s against "
          f"{runs['NCHW' if head == 'NHWC' else 'NHWC'][-1]['img_per_s']:.1f}")
    net, trainer, x, y, _ = runs["NHWC"]
    return (net, trainer, x, y), {k: v[-1] for k, v in runs.items()}, head


def lm_amp_phase():
    phase("25 LM in bf16 AMP")
    ctx = mx.gpu(0)
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    fused_step.reset_fused_step_cache()
    mx.random.seed(SEED)
    net = TransformerLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    toks = nd.array(onp.random.RandomState(SEED).randint(
        0, vocab, (TRAIN_B, TRAIN_S)).astype("int32"), ctx=ctx)
    labels = toks[:, 1:].reshape(-1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    dtypes = set()

    def step(ev=None):
        ev = ev or [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with autograd.record():
            logits = net(toks)
            loss = loss_fn(logits[:, :-1].reshape(-1, vocab), labels).mean()
            ev[1].record()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        ev[2].record()
        trainer.step(TRAIN_B)
        ev[3].record()
        dtypes.add(str(logits.dtype))
        return loss, ev

    losses = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_STEPS):
        losses.append(step()[0].asscalar())
        if i == 0:
            _amp_grads_finite(net)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    step_ms, parts = [], []
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss, ev = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.asscalar())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    launches = counts.get(FLASH_KERNEL, 0)
    sm90 = counts.get(FLASH_SM90_KERNEL, 0)
    print(f"losses {[round(x, 4) for x in losses]}")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"bf16 LM training did not go down: {losses}")
    if dtypes != {"bfloat16"}:
        raise RuntimeError(f"the LM's logits came out {dtypes} under AMP")
    want = cfg["num_layers"] * TIMED_STEPS
    if launches != want or sm90 != want:
        raise RuntimeError(f"K1 launched {launches} times, {sm90} of them "
                           f"on its sm90 kernel, in {TIMED_STEPS} bf16 "
                           f"steps of {cfg['num_layers']} layers")
    print(f"K1 (bf16) launches {launches} = {cfg['num_layers']} layers x "
          f"{TIMED_STEPS} timed steps, all {sm90} on the sm90 kernel")
    stats = check_fused(trainer, WARMUP_STEPS + TIMED_STEPS)
    fwd, bwd, opt = (statistics.mean(p[i] for p in parts) for i in range(3))
    result = {"tokens_per_s": TRAIN_B * TRAIN_S * TIMED_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt,
              "first_loss": losses[0], "last_loss": losses[-1],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "skipped_steps": trainer._fused_skipped_steps(),
              "loss_scale": trainer._amp_loss_scaler.loss_scale,
              "fused_step": stats}
    print("bf16 LM training " + json.dumps(result))
    amp.disable()
    del net, trainer
    torch.cuda.empty_cache()
    return launches, sm90, result


def _l2(parts):
    return float(onp.sqrt(sum(float((p.astype("float64") ** 2).sum())
                              for p in parts)))


def _amp_record(model, ctx, x, y, loss_of, use_amp, train):
    """One record/backward of ``model`` on ``ctx``: (loss, logits,
    {name: grad}) as float32 host arrays."""
    if use_amp:
        amp.init("bfloat16")
    try:
        with autograd.record(train_mode=train):
            logits, loss = loss_of(model, nd.array(x, ctx=ctx),
                                   nd.array(y, ctx=ctx))
        loss.backward()
    finally:
        amp.disable()
    grads = {n: p.grad().asnumpy().astype("float32")
             for n, p in model._collect_params_with_prefix().items()
             if p.grad_req != "null"}
    return (float(loss.asnumpy().astype("float32").reshape(-1)[0]),
            logits.asnumpy().astype("float32"), grads)


def _amp_dev(amp_run, fp32_run):
    (_, oa, ga), (_, of, gf) = amp_run, fp32_run
    return {"logits": _l2([oa - of]) / _l2([of]),
            "grads": _l2([ga[k] - gf[k] for k in gf]) /
            _l2([gf[k] for k in gf])}


def _amp_compare(name, make, x, y, loss_of, train):
    """bf16 against float32 on the card and on the CPU port, from the
    same weights: each side's deviation, and the card's held to the
    CPU's as the CPU test holds the port to the JAX package."""
    runs = {}
    for side, ctx in (("gpu", mx.gpu(0)), ("cpu", mx.cpu())):
        model = make(ctx)
        for use_amp in (True, False):
            runs[side, use_amp] = _amp_record(model, ctx, x, y, loss_of,
                                              use_amp, train)
        del model
    dev = {side: _amp_dev(runs[side, True], runs[side, False])
           for side in ("gpu", "cpu")}
    losses = {side: runs[side, True][0] for side in ("gpu", "cpu")}
    print(f"  {name}: bf16 deviation from float32 card {dev['gpu']}, "
          f"cpu {dev['cpu']}; bf16 loss card {losses['gpu']:.6f} cpu "
          f"{losses['cpu']:.6f}")
    return dev, losses


def _check_amp_compare(name, dev, losses):
    for what in ("logits", "grads"):
        if dev["gpu"][what] > AMP_DEV_FACTOR * dev["cpu"][what] + \
                AMP_DEV_FLOOR:
            raise RuntimeError(f"{name}: the card's bf16 {what} deviate "
                               f"{dev['gpu'][what]} from float32, the "
                               f"CPU's {dev['cpu'][what]}")
    if not onp.isclose(losses["gpu"], losses["cpu"], rtol=AMP_LOSS_RTOL,
                       atol=0):
        raise RuntimeError(f"{name}: bf16 loss card {losses['gpu']}, CPU "
                           f"{losses['cpu']}")


def amp_vs_cpu_phase():
    phase("26 AMP on the card against the CPU port")
    report = {}
    # ResNet-50 at batch 2, 224 x 224, eval mode with fresh weights (batch
    # norm linear, its statistics the initial ones: phase 17's
    # well-conditioned case)
    src = pr.build_resnet50(mx.cpu(), seed=SEED + 3)
    arrays = {n: p.data().asnumpy()
              for n, p in src._collect_params_with_prefix().items()}
    del src
    rs = onp.random.RandomState(SEED + 3)
    xb = rs.standard_normal((2, 3, pr.IMAGE, pr.IMAGE)).astype("float32")
    yb = rs.randint(0, pr.CLASSES, 2).astype("float32")

    def resnet(ctx):
        return convert.params_from_numpy(vision.resnet50_v1(), arrays,
                                         ctx=ctx)

    def resnet_loss(model, xs, ys):
        out = model(xs)
        return out, gluon.loss.SoftmaxCrossEntropyLoss()(out, ys).mean()

    dev, losses = _amp_compare("resnet50 eval", resnet, xb, yb, resnet_loss,
                               False)
    _check_amp_compare("resnet50", dev, losses)
    report["resnet50"] = {"dev": dev, "bf16_loss": losses}
    # the LM at 1 x 128 tokens, full width, at both cuBLAS settings: the
    # port's scope (bf16 products summed in float32) and torch's default
    # (split-K partial sums in bf16)
    cfg = GPT2_SMALL_LM
    mx.random.seed(SEED + 4)
    src = TransformerLM(**cfg)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    toks = onp.random.RandomState(SEED + 4).randint(
        0, cfg["vocab_size"], (1, 128)).astype("float32")
    with autograd.pause():
        src(nd.array(toks, ctx=mx.cpu()))
    lm_arrays = {n: p.data().asnumpy()
                 for n, p in src._collect_params_with_prefix().items()}
    del src

    def lm(ctx):
        return convert.params_from_numpy(TransformerLM(**cfg), lm_arrays,
                                         ctx=ctx)

    def lm_loss(model, t, _):
        logits = model(t)
        V = cfg["vocab_size"]
        return logits, gluon.loss.SoftmaxCrossEntropyLoss()(
            logits[:, :-1].reshape(-1, V), t[:, 1:].reshape(-1)).mean()

    dev, losses = _amp_compare("LM 1 x 128", lm, toks, toks, lm_loss, True)
    _check_amp_compare("LM", dev, losses)
    report["lm"] = {"dev": dev, "bf16_loss": losses}
    # the same at torch's default cuBLAS flags (split-K partial sums of
    # bf16 products reduced in bf16): the port's scope replaced by a
    # no-op for this measurement, whose deviations are reported
    scope = ops_nn.cublas_fp32_accumulate
    ops_nn.cublas_fp32_accumulate = \
        lambda dtype=None: contextlib.nullcontext()
    try:
        dev, losses = _amp_compare("LM 1 x 128, torch's default cuBLAS "
                                   "flags", lm, toks, toks, lm_loss, True)
    finally:
        ops_nn.cublas_fp32_accumulate = scope
    report["lm_torch_default_cublas_flags"] = {"dev": dev,
                                               "bf16_loss": losses}
    print("amp against cpu " + json.dumps(report))
    return report


def poisoned_step_phase(net, trainer, x, y):
    phase("27 a poisoned bf16 step on the card")
    amp.init("bfloat16")
    try:
        with amp.scale_loss(nd.ones((1,), ctx=x.context), trainer) as scale:
            pass
        with autograd.record():
            logits = net(x)
            p = pr.rtc_softmax(logits.astype("float32"), y, grad_scale=scale)
        p.backward()
    finally:
        amp.disable()
    params = [q for q in net.collect_params().values()
              if q.grad_req != "null"]
    params[0].grad().data.fill_(float("inf"))
    weights = [q.data().data.clone() for q in params]
    states = [s.data.clone() for s in trainer._states if s is not None]
    scale0 = trainer._amp_loss_scaler.loss_scale
    skipped0 = trainer._fused_skipped_steps()
    replays0 = fused_step.fused_step_stats()["replays"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in step raises
    try:
        trainer.step(x.shape[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    same = all(torch.equal(a, q.data().data) for a, q in zip(weights, params))
    same_states = all(torch.equal(a, s.data) for a, s in
                      zip(states, [s for s in trainer._states
                                   if s is not None]))
    scale1 = trainer._amp_loss_scaler.loss_scale
    skipped1 = trainer._fused_skipped_steps()
    replays1 = fused_step.fused_step_stats()["replays"]
    result = {"weights_bitwise_unchanged": same,
              "states_bitwise_unchanged": same_states,
              "loss_scale_before": scale0, "loss_scale_after": scale1,
              "skipped_before": skipped0, "skipped_after": skipped1,
              "replays": replays1 - replays0, "host_syncs_in_step": 0}
    print("poisoned step " + json.dumps(result))
    if not (same and same_states and scale1 == scale0 / 2
            and skipped1 == skipped0 + 1 and replays1 == replays0 + 1):
        raise RuntimeError(f"the poisoned step was not skipped on the "
                           f"device: {result}")
    return result


# -- slice 7: hybridize as captured CUDA graphs, and the data pipeline --------

HYB_WARMUP, HYB_STEPS = 2, 10
# images held in host memory for the DataLoader-fed run: 6 batches of 128,
# two passes
FEED_BATCHES, FEED_EPOCHS, FEED_WORKERS = 6, 2, 4


def _fresh_peak():
    """Free what earlier runs left (blocks and parameters hold each other
    in cycles that only the collector breaks) and restart the peak
    count; returns the GB still allocated."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def _state_to_host(net):
    """Weights, gradients and running statistics as host tensors."""
    state = {}
    for k, p in net._collect_params_with_prefix().items():
        state[k] = p.data().data.detach().cpu()
        if p.grad_req != "null":
            state[k + ".grad"] = p.grad().data.detach().cpu()
    return state


def _compare_runs(what, eager, hyb):
    """Bitwise comparison of two runs' per-step outputs and final state;
    returns the count of tensors compared. Raises on any difference,
    naming the worst ones."""
    (lo_e, st_e), (lo_h, st_h) = eager, hyb
    bad = []
    for i, (a, b) in enumerate(zip(lo_e, lo_h)):
        if not torch.equal(a, b):
            bad.append((f"outputs of step {i + 1}",
                        float((a.float() - b.float()).abs().max())))
    for k in st_e:
        if not torch.equal(st_e[k], st_h[k]):
            bad.append((k, float((st_e[k].float() - st_h[k].float())
                                 .abs().max())))
    if bad:
        raise RuntimeError(f"{what}: hybridized differs from eager in "
                           f"{len(bad)} tensors: {bad[:8]}")
    return len(lo_e) + len(st_e)


def _hyb_resnet_run(hybridize, record_state, x=None, y=None):
    """ResNet-50 v1 in bf16 AMP, NHWC, batch 128, as phase 24, eager or
    hybridized: 2 warm-up and 10 timed steps. Returns (result, per-step
    logits, final state or None)."""
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    net = pr.build_resnet50(ctx, seed=SEED, layout="NHWC")
    trainer = pr.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    if hybridize:
        net.hybridize()
    if x is None:
        x, y = pr.synthetic_batch(RESNET_B, ctx, seed=SEED, layout="NHWC")
    logits, losses, step_ms = [], [], []
    resident = _fresh_peak()
    for _ in range(HYB_WARMUP):
        out = []
        losses.append(pr.train_step(net, trainer, x, y, outputs=out))
        logits.append(out[0].data.detach().cpu())
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_all = time.perf_counter()
    for _ in range(HYB_STEPS):
        out = []
        t0 = time.perf_counter()
        losses.append(pr.train_step(net, trainer, x, y, outputs=out))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out[0].data.detach().cpu())
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    losses = [v.asscalar() for v in losses]
    if not all(onp.isfinite(losses)):
        raise RuntimeError(f"ResNet-50 (hybridize={hybridize}) losses "
                           f"{losses}")
    cached = gluon.cached_op_stats()
    k4 = counts.get(pr.FWD_KERNEL, 0) + counts.get(pr.BWD_KERNEL, 0)
    if k4 != 2 * HYB_STEPS:
        raise RuntimeError(f"K4 launched {counts} in {HYB_STEPS} steps")
    steps = HYB_WARMUP + HYB_STEPS
    if hybridize and (cached["captures"] != 1 or cached["replays"] != steps
                      or cached["backward_replays"] != steps):
        raise RuntimeError(f"hybridized ResNet-50: {cached} in {steps} "
                           "steps (want one capture, a replay per step)")
    result = {"hybridize": hybridize, "img_per_s":
              RESNET_B * HYB_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "resident_before_gb": resident,
              "k4_launches": k4, "cached_op": cached,
              "first_loss": losses[0], "last_loss": losses[-1]}
    state = _state_to_host(net) if record_state else None
    amp.disable()
    del net, trainer
    torch.cuda.empty_cache()
    return result, logits, state


def resnet_hybrid_phase():
    phase("28 ResNet-50 hybridized against eager")
    torch.backends.cudnn.benchmark = True
    # equality: the same weights and batch through 12 steps in each mode,
    # with cuDNN held to deterministic algorithms, so that two eager runs
    # would agree bitwise too (cudnn.benchmark may pick algorithms that
    # sum with atomics, whose order varies from run to run)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=True):
        _, lo_e, st_e = _hyb_resnet_run(False, True)
        _, lo_h, st_h = _hyb_resnet_run(True, True)
    n = _compare_runs("ResNet-50 bf16 NHWC", (lo_e, st_e), (lo_h, st_h))
    print(f"  bitwise equal: {n} tensors (12 steps' logits, every weight, "
          "gradient and running statistic), cuDNN deterministic")
    del lo_e, st_e, lo_h, st_h
    # timing at torch's flags (cuDNN may pick any algorithm), as phase 24
    runs = {}
    for hyb in (False, True):
        runs[hyb] = _hyb_resnet_run(hyb, False)[0]
        print("  resnet bf16 NHWC " + json.dumps(runs[hyb]))
    print(f"  step ms eager {runs[False]['mean_step_ms']:.2f}, hybridized "
          f"{runs[True]['mean_step_ms']:.2f}; img/s "
          f"{runs[False]['img_per_s']:.1f} -> {runs[True]['img_per_s']:.1f}; "
          f"peak GB {runs[False]['peak_memory_gb']:.2f} -> "
          f"{runs[True]['peak_memory_gb']:.2f}")
    return runs


def _hyb_lm_run(hybridize):
    """The GPT-2-small LM in bf16 AMP, 8 x 1024 tokens, as phase 25, eager
    or hybridized: 2 warm-up and 10 timed steps. Returns (result,
    per-step logits, final state)."""
    ctx = mx.gpu(0)
    cfg = GPT2_SMALL_LM
    vocab = cfg["vocab_size"]
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    mx.random.seed(SEED)
    net = TransformerLM(**cfg)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    toks = nd.array(onp.random.RandomState(SEED).randint(
        0, vocab, (TRAIN_B, TRAIN_S)).astype("int32"), ctx=ctx)
    labels = toks[:, 1:].reshape(-1)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": TRAIN_LR})
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    if hybridize:
        net.hybridize()
    logits_seen, losses, step_ms = [], [], []

    def step():
        with autograd.record():
            logits = net(toks)
            loss = loss_fn(logits[:, :-1].reshape(-1, vocab), labels).mean()
            with amp.scale_loss(loss, trainer) as scaled:
                scaled.backward()
        trainer.step(TRAIN_B)
        # a digest of the logits (all 8 x 1024 x 50257 would be 823 MB a
        # step): the last position of every row, bitwise
        logits_seen.append(logits.data[:, -1].detach().cpu())
        return loss

    resident = _fresh_peak()
    for _ in range(WARMUP_STEPS):
        losses.append(step())
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_all = time.perf_counter()
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_all
    counts = _build.launch_counts()
    losses = [v.asscalar() for v in losses]
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"LM (hybridize={hybridize}) losses {losses}")
    k1, sm90 = counts.get(FLASH_KERNEL, 0), counts.get(FLASH_SM90_KERNEL, 0)
    want = cfg["num_layers"] * TIMED_STEPS
    if k1 != want or sm90 != want:
        raise RuntimeError(f"K1 launched {k1} times, {sm90} on sm90, in "
                           f"{TIMED_STEPS} steps (hybridize={hybridize})")
    cached = gluon.cached_op_stats()
    steps = WARMUP_STEPS + TIMED_STEPS
    if hybridize and (cached["captures"] != 1 or cached["replays"] != steps):
        raise RuntimeError(f"hybridized LM: {cached} in {steps} steps")
    result = {"hybridize": hybridize,
              "tokens_per_s": TRAIN_B * TRAIN_S * TIMED_STEPS / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "resident_before_gb": resident,
              "k1_launches": k1, "k1_sm90_launches": sm90,
              "cached_op": cached, "first_loss": losses[0],
              "last_loss": losses[-1]}
    if hybridize:
        ent = next(iter(net._cached_op.entries.values()))
        result["k1_launches_per_replay"] = dict(ent.fwd_launches)
    state = _state_to_host(net)
    amp.disable()
    del net, trainer
    torch.cuda.empty_cache()
    return result, logits_seen, state


def lm_hybrid_phase():
    phase("29 LM hybridized against eager")
    runs, seen = {}, {}
    for hyb in (False, True):
        runs[hyb], lo, st = _hyb_lm_run(hyb)
        seen[hyb] = (lo, st)
        print("  LM bf16 " + json.dumps(runs[hyb]))
    n = _compare_runs("the LM bf16", seen[False], seen[True])
    print(f"  bitwise equal: {n} tensors (12 steps' last-position logits, "
          "every weight and gradient)")
    print(f"  K1 launches {runs[True]['k1_launches']} = "
          f"{GPT2_SMALL_LM['num_layers']} x {TIMED_STEPS} counted per replay, "
          f"all {runs[True]['k1_sm90_launches']} on sm90; step ms eager "
          f"{runs[False]['mean_step_ms']:.2f}, hybridized "
          f"{runs[True]['mean_step_ms']:.2f}; tokens/s "
          f"{runs[False]['tokens_per_s']:.0f} -> "
          f"{runs[True]['tokens_per_s']:.0f}; peak GB "
          f"{runs[False]['peak_memory_gb']:.2f} -> "
          f"{runs[True]['peak_memory_gb']:.2f}")
    return runs


def fed_resnet_phase():
    phase("30 ResNet-50 fed by gluon.data")
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.pipeline import (DeviceFeed, pipeline_counters,
                                          reset_pipeline_counters)

    ctx = mx.gpu(0)
    n = FEED_BATCHES * RESNET_B
    rs = onp.random.RandomState(SEED)
    images = rs.randint(0, 256, (n, pr.IMAGE, pr.IMAGE, 3), dtype=onp.uint8)
    labels = rs.randint(0, pr.CLASSES, n).astype("float32")
    loader = DataLoader(ArrayDataset(images, labels), batch_size=RESNET_B,
                        num_workers=FEED_WORKERS, pin_memory=True,
                        last_batch="discard")
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    net = pr.build_resnet50(ctx, seed=SEED, layout="NHWC")
    trainer = pr.make_trainer(net)
    amp.init("bfloat16")
    amp.init_trainer(trainer)
    net.hybridize()
    # ImageNet's channel statistics, in 0-255 units, on the card
    mean = nd.array(onp.array([123.68, 116.78, 103.94], "f"), ctx=ctx)
    std = nd.array(onp.array([58.40, 57.12, 57.38], "f"), ctx=ctx)
    reset_pipeline_counters()
    resident = _fresh_peak()
    feed = DeviceFeed(loader)
    step_ms, stall_s, losses, k4 = [], [], [], 0
    steps = 0
    t_all = None
    stalled = 0.0  # the counter after the last step
    for _ in range(FEED_EPOCHS):
        for xb, yb in feed:
            # the wait for this batch: the stall since the last step ended
            waited = pipeline_counters()["prefetch_stall_s"] - stalled
            if steps == HYB_WARMUP:
                _build.reset_launch_counts()
                t_all = time.perf_counter() - waited
            t0 = time.perf_counter()
            x = (xb.astype("float32") - mean) / std  # normalize on the card
            losses.append(pr.train_step(net, trainer, x, yb))
            torch.cuda.synchronize()
            if steps >= HYB_WARMUP:
                step_ms.append((time.perf_counter() - t0) * 1e3)
                stall_s.append(waited)
            stalled = pipeline_counters()["prefetch_stall_s"]
            steps += 1
    wall = time.perf_counter() - t_all
    feed.close()
    counts = _build.launch_counts()
    k4 = counts.get(pr.FWD_KERNEL, 0) + counts.get(pr.BWD_KERNEL, 0)
    timed = steps - HYB_WARMUP
    losses = [v.asscalar() for v in losses]
    cached = gluon.cached_op_stats()
    if steps != FEED_BATCHES * FEED_EPOCHS or not all(onp.isfinite(losses)):
        raise RuntimeError(f"fed run: {steps} steps, losses {losses}")
    if k4 != 2 * timed or cached["captures"] != 1 or \
            cached["replays"] != steps:
        raise RuntimeError(f"fed run: K4 {counts}, {cached}")
    pc = pipeline_counters()
    result = {"steps_timed": timed, "img_per_s": RESNET_B * timed / wall,
              "mean_step_ms": statistics.mean(step_ms),
              "median_step_ms": statistics.median(step_ms),
              "prefetch_stall_s_per_step": statistics.mean(stall_s),
              "prefetch_stall_s_by_step": stall_s,
              "prefetch_stall_s_max": max(stall_s),
              "prefetch_hits": pc["prefetch_hits"],
              "prefetch_stalls": pc["prefetch_stalls"],
              "workers": FEED_WORKERS, "k4_launches": k4,
              "cached_op": cached, "peak_memory_gb":
              torch.cuda.max_memory_allocated() / 1e9,
              "resident_before_gb": resident,
              "first_loss": losses[0], "last_loss": losses[-1]}
    print("  fed resnet bf16 NHWC " + json.dumps(result))
    amp.disable()
    del net, trainer, feed, loader, images
    torch.cuda.empty_cache()
    return result


class _HostSync(gluon.HybridBlock):
    """A forward that reads a value back to the host: not capturable."""

    def hybrid_forward(self, F, x):
        return x * float(x.asnumpy().sum() > 0)


def failing_capture_phase():
    phase("31 a capture that must fail")
    blk = _HostSync()
    blk.hybridize()
    try:
        blk(nd.ones((4,), ctx=mx.gpu(0)))
    except mx.MXNetError as e:
        msg = str(e)
        if "_HostSync" not in msg or "signature" not in msg:
            raise RuntimeError(f"the capture error does not name the block "
                               f"and the signature: {msg}") from e
        print(f"  raised as expected: {msg[:200]}...")
    else:
        raise RuntimeError("a forward that calls asnumpy() was captured")
    if (nd.ones((3,), ctx=mx.gpu(0)) * 2).asnumpy().tolist() != [2.0] * 3:
        raise RuntimeError("the card computes wrongly after a failed capture")


# -- slice 7 of ROADMAP A: symbolic training and the LSTM word-LM ------------

# the MLP against the CPU port: one pass over the 14 training batches from
# the same weights; per-step losses and final weights relative to their
# largest value (float32 sums in another order, through 14 SGD steps)
MLP_CPU_RTOL = 1e-3
MLP_EPOCHS = 8
# the word-LM: steps timed per mode, steps that check the falling
# perplexity, steps against the CPU port and the captured-vs-eager steps
WLM_WARMUP, WLM_STEPS, WLM_FALL, WLM_CPU, WLM_BITWISE = 2, 20, 40, 3, 3
WLM_PROFILED = 5
# cuDNN's LSTM against the op's plain version (the JAX step arithmetic,
# one time step at a time) in float32 on the card, relative to the largest
# value: two float32 computations in different orders over 35 steps and
# 650-wide products; TF32 would miss it by two orders of magnitude
RNN_FP32_RTOL = 2e-5
# the word-LM on the card against the CPU port, three steps from the same
# weights and batches at p = 0, relative to the largest value
WLM_CPU_RTOL = 1e-3
BUCKETS = (10, 20, 30, 35)
BUCKET_SENTENCES = 200


def _ce(probs, labels):
    """Mean cross-entropy of host ``labels`` under host ``probs``."""
    p = probs[onp.arange(len(labels)), labels.astype(int)]
    return float(-onp.log(onp.maximum(p, 1e-30)).mean())


def _rel(a, b):
    """max |a - b| over max |a| (numpy or tensors)."""
    a = onp.asarray(a, dtype=onp.float64)
    b = onp.asarray(b, dtype=onp.float64)
    return float(onp.abs(a - b).max() / max(onp.abs(a).max(), 1e-30))


def _params_host(mod):
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _mlp_module(ctx, arg_params=None):
    mod = mx.mod.Module(pm.mlp_symbol(mx.sym, **pm.MLP), context=ctx)
    mod.bind([("data", (pm.MLP["batch"], pm.MLP["features"]))],
             [("softmax_label", (pm.MLP["batch"],))])
    mx.random.seed(SEED)
    if arg_params is None:
        mod.init_params(mx.init.Xavier())
    else:
        mod.init_params(arg_params={k: nd.array(v, ctx=ctx)
                                    for k, v in arg_params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(pm.MLP_OPT))
    return mod


def mlp_phase():
    phase("32 MNIST MLP through Module.fit")
    ctx = mx.gpu(0)
    B = pm.MLP["batch"]
    X, y = pm.mlp_data(2048, seed=SEED)
    Xt, yt, Xv, yv = X[:1792], y[:1792], X[1792:], y[1792:]

    def train_iter(shuffle=False):
        return mx.io.NDArrayIter(Xt, yt, batch_size=B, shuffle=shuffle,
                                 label_name="softmax_label")

    val = mx.io.NDArrayIter(Xv, yv, batch_size=B, label_name="softmax_label")
    # against the CPU port: one pass, the same weights and batches
    gpu_mod = _mlp_module(ctx)
    w0 = _params_host(gpu_mod)
    before = dict(gpu_mod.score(val, "acc"))["accuracy"]
    cpu_mod = _mlp_module(mx.cpu(), w0)
    worst_loss = 0.0
    for batch in train_iter():
        losses = []
        for mod in (gpu_mod, cpu_mod):
            mod.forward_backward(batch)
            mod.update()
            losses.append(_ce(mod.get_outputs()[0].asnumpy(),
                              batch.label[0].asnumpy()))
        worst_loss = max(worst_loss, abs(losses[0] - losses[1])
                         / max(abs(losses[1]), 1e-30))
    wg, wc = _params_host(gpu_mod), _params_host(cpu_mod)
    worst_w = max(_rel(wc[k], wg[k]) for k in wc)
    print(f"  14 steps against the CPU port: per-step loss within "
          f"{worst_loss:.3e}, final weights within {worst_w:.3e} "
          f"(allowed {MLP_CPU_RTOL})")
    if worst_loss > MLP_CPU_RTOL or worst_w > MLP_CPU_RTOL:
        raise RuntimeError("the MLP on the card departs from the CPU port")
    # fit: accuracy before and after, step ms with and without the metric
    res = {}
    for metric in ("acc", None):
        mod = mx.mod.Module(pm.mlp_symbol(mx.sym, **pm.MLP), context=ctx)
        onp.random.seed(SEED)
        it = train_iter(shuffle=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, eval_data=val if metric else None, eval_metric=metric,
                optimizer="sgd", optimizer_params=dict(pm.MLP_OPT),
                num_epoch=MLP_EPOCHS,
                arg_params={k: nd.array(v, ctx=ctx) for k, v in w0.items()})
        torch.cuda.synchronize()
        steps = MLP_EPOCHS * (len(Xt) // B)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        after = dict(mod.score(val, "acc"))["accuracy"]
        res["metric" if metric else "no_metric"] = {
            "step_ms": step_ms, "val_acc_before": float(before),
            "val_acc_after": float(after),
            "graphs": mod._exec.graph_info()}
        print(f"  fit ({'acc metric' if metric else 'no metric'}): "
              f"{step_ms:.3f} ms per step over {steps} steps (binding, "
              f"the graphs' capture and the evaluation passes included), "
              f"validation accuracy {before:.3f} -> {after:.3f}")
        if after <= before + 0.2:
            raise RuntimeError("the MLP's validation accuracy did not rise")
    g = res["metric"]["graphs"]
    print(f"  captured signatures: {[(s['is_train'], s['replays'], s['backward_replays']) for s in g]}")
    if not any(s["is_train"] and s["replays"] >= steps for s in g):
        raise RuntimeError("the MLP's training step was not replayed")
    return res


def rnn_fp32_phase(gen):
    """cuDNN's LSTM inside cudnn_fp32() against the op's plain version on
    the card, at the word-LM's shapes, forward and gradients."""
    cfg = pm.WORD_LM
    T, N, H, L, E = (cfg["bptt"], cfg["batch"], cfg["hidden"],
                     cfg["layers"], cfg["embed"])
    size = ops_nn.rnn_param_size(L, E, H, False, "lstm")
    x = torch.randn(T, N, E, device="cuda", generator=gen)
    w = (torch.rand(size, device="cuda", generator=gen) - 0.5) * 0.2
    h = torch.randn(L, N, H, device="cuda", generator=gen) * 0.5
    c = torch.randn(L, N, H, device="cuda", generator=gen) * 0.5
    cot = [torch.randn(T, N, H, device="cuda", generator=gen),
           torch.randn(L, N, H, device="cuda", generator=gen),
           torch.randn(L, N, H, device="cuda", generator=gen)]
    def run(fn, scope):
        ins = [t.clone().requires_grad_(True) for t in (x, w, h, c)]
        outs = fn(*ins, state_size=H, num_layers=L, mode="lstm")
        # the backward in the scope the port's backward runs in
        # (autograd.backward, the executor's, CachedOp's), or at torch's
        # default cuDNN flags (allow_tf32 True)
        with scope:
            grads = torch.autograd.grad(outs, ins, cot)
        return [o.detach() for o in outs] + list(grads)

    plain = run(ops_nn.rnn_plain, ops_nn.cudnn_fp32())
    names = ["out", "h", "c", "dx", "dw", "dh", "dc"]
    res = {}
    for label, scope in (("cudnn_fp32", ops_nn.cudnn_fp32()),
                         ("torch_default_flags", contextlib.nullcontext())):
        got = run(ops_nn.rnn, scope)
        res[label] = {n: _rel(b.cpu(), a.cpu())
                      for n, a, b in zip(names, plain, got)}
    worst = max(res["cudnn_fp32"].values())
    print(f"  cuDNN LSTM (T={T}, N={N}, {E}->{H}, {L} layers) against the "
          f"plain version on the card, the backward in the port's scope: "
          f"{res['cudnn_fp32']}; worst {worst:.3e} (allowed "
          f"{RNN_FP32_RTOL}: float32, not TF32)")
    print(f"  the same backward at torch's default cuDNN flags (TF32): "
          f"{res['torch_default_flags']}")
    if worst > RNN_FP32_RTOL:
        raise RuntimeError("cuDNN's LSTM is not float32-accurate")
    return worst, res


def _wlm_batches(n, seed=SEED):
    cfg = pm.WORD_LM
    toks = pm.markov_tokens(cfg["bptt"] * cfg["batch"] * n + 1,
                            cfg["vocab"], seed)
    return pm.bptt_batches(toks, cfg["bptt"], cfg["batch"])


def _check_mode(mod, graphs, steps, eager_before):
    """``mod``'s executor captured one training signature replayed
    ``steps`` times (``graphs``), or captured nothing and ran ``steps``
    eager forwards since ``executor_stats()`` read ``eager_before``."""
    info = mod._exec.graph_info()
    eager = mx.executor.executor_stats()["eager_forwards"] - eager_before
    if graphs:
        ok = len(info) == 1 and info[0]["replays"] == steps == \
            info[0]["backward_replays"]
    else:
        ok = info == [] and eager == steps
    if not ok:
        raise RuntimeError(f"the {'captured' if graphs else 'eager'} "
                           f"word-LM ran in the wrong mode: signatures "
                           f"{info}, {eager} eager forwards in {steps} steps")


def _wlm_run(cfg, batches, graphs, arg_params=None, ctx=None, metric=None):
    ctx = ctx or mx.gpu(0)
    with pm.bind_mode(mx, graphs):
        mod = pm.word_lm_module(mx, cfg, ctx, arg_params=arg_params)
    eager_before = mx.executor.executor_stats()["eager_forwards"]
    outs = []
    states = None
    for b in batches:
        _, states = pm.word_lm_train(mx, mod, [b], cfg, ctx, metric=metric,
                                     states=states)
        outs.append(mod.get_outputs()[0].asnumpy())
    if ctx.device_type == "gpu":
        _check_mode(mod, graphs, len(batches), eager_before)
    return mod, outs


def word_lm_phase(gen):
    phase("33 LSTM word-LM through Module and the fused sym.RNN")
    ctx = mx.gpu(0)
    cfg = pm.WORD_LM
    tokens = cfg["bptt"] * cfg["batch"]
    worst, devs = rnn_fp32_phase(gen)
    res = {"config": cfg, "rnn_fp32_worst": worst, "rnn_devs": devs}
    batches = _wlm_batches(2 * (WLM_WARMUP + WLM_STEPS + 2 * WLM_PROFILED)
                           + WLM_FALL + WLM_BITWISE)
    det = dict(cfg, dropout=0.0)
    # captured against eager, bitwise, at p = 0 (deterministic cuDNN)
    w0 = _params_host(pm.word_lm_module(mx, det, ctx))
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        eager, e_out = _wlm_run(det, batches[:WLM_BITWISE], False, w0)
        capt, c_out = _wlm_run(det, batches[:WLM_BITWISE], True, w0)
    bad = [i for i, (a, b) in enumerate(zip(e_out, c_out))
           if not onp.array_equal(a, b)]
    we, wc = _params_host(eager), _params_host(capt)
    bad += [k for k in we if not onp.array_equal(we[k], wc[k])]
    print(f"  captured against eager, {WLM_BITWISE} steps at p = 0: "
          f"{'bitwise equal' if not bad else bad} ({len(e_out)} outputs, "
          f"{len(we)} parameters)")
    if bad:
        raise RuntimeError(f"the captured executor departs from eager: {bad}")
    # three steps against the CPU port at p = 0
    cpu, p_out = _wlm_run(det, batches[:WLM_CPU], False, w0, ctx=mx.cpu())
    worst_out = max(_rel(a, b) for a, b in zip(p_out, c_out))
    wp = _params_host(cpu)
    worst_w = max(_rel(wp[k], wc[k]) for k in wp)
    print(f"  {WLM_CPU} steps against the CPU port: softmax outputs within "
          f"{worst_out:.3e}, weights within {worst_w:.3e} (allowed "
          f"{WLM_CPU_RTOL})")
    if max(worst_out, worst_w) > WLM_CPU_RTOL:
        raise RuntimeError("the word-LM on the card departs from the CPU")
    del eager, capt, cpu
    # timed: eager and captured in this call, p = 0.5, Perplexity metric
    _build.reset_launch_counts()
    rest = batches[WLM_BITWISE:]
    for graphs in (False, True):
        _fresh_peak()
        with pm.bind_mode(mx, graphs):
            mod = pm.word_lm_module(mx, cfg, ctx)
        eager_before = mx.executor.executor_stats()["eager_forwards"]
        metric = mx.metric.Perplexity()
        _, states = pm.word_lm_train(mx, mod, rest[:WLM_WARMUP], cfg, ctx,
                                     metric=metric)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, states = pm.word_lm_train(
            mx, mod, rest[WLM_WARMUP:WLM_WARMUP + WLM_STEPS], cfg, ctx,
            metric=metric, states=states)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / WLM_STEPS
        it = iter(rest[WLM_WARMUP + WLM_STEPS:])
        box = {"states": states}

        def step(metric=metric):
            _, box["states"] = pm.word_lm_train(
                mx, mod, [next(it)], cfg, ctx, metric=metric,
                states=box["states"])

        prof = pm.profile_steps(step, WLM_PROFILED)
        key = "captured" if graphs else "eager"
        # the metric's copy to the host: the same steps without it
        t0 = time.perf_counter()
        _, box["states"] = pm.word_lm_train(
            mx, mod, [next(it) for _ in range(WLM_PROFILED)], cfg, ctx,
            states=box["states"])
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t0) * 1e3 / WLM_PROFILED
        _check_mode(mod, graphs, WLM_WARMUP + WLM_STEPS + 2 * WLM_PROFILED,
                    eager_before)
        res[key] = {"step_ms": ms, "tokens_per_s": tokens / ms * 1e3,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "profile": prof, "no_metric_step_ms": bare}
        print(f"  {key}: {ms:.3f} ms per step, {tokens / ms * 1e3:,.0f} "
              f"tokens/s, peak {res[key]['peak_gb']:.2f} GB; profiled "
              f"{prof['wall_ms_per_step']:.3f} ms, device busy "
              f"{prof['device_busy_ms_per_step']:.3f} ms, idle "
              f"{prof['device_idle_share']:.1%}, "
              f"{prof['device_ops_per_step']:.0f} device operations")
        print(f"    by kind: " + json.dumps(
            {k: round(v["ms"], 4) for k, v in
             prof["device_ms_per_step_by_kind"].items()}))
        print(f"    without the metric: {bare:.3f} ms per step (the "
              f"Perplexity update copies "
              f"{tokens * cfg['vocab'] * 4 / 1e6:.0f} MB of softmax to the "
              "host each step)")
    # the perplexity falls
    first, last = mx.metric.Perplexity(), mx.metric.Perplexity()
    fall = [next(it) for _ in range(WLM_FALL)]
    _, box["states"] = pm.word_lm_train(mx, mod, fall[:10], cfg, ctx,
                                        metric=first, states=box["states"])
    _, box["states"] = pm.word_lm_train(mx, mod, fall[10:-10], cfg, ctx,
                                        states=box["states"])
    pm.word_lm_train(mx, mod, fall[-10:], cfg, ctx, metric=last,
                     states=box["states"])
    p0, p1 = first.get()[1], last.get()[1]
    print(f"  perplexity over 10 batches: {p0:.1f} -> {p1:.1f} after "
          f"{WLM_FALL - 10} more steps")
    if not (onp.isfinite(p1) and p1 < p0 and p1 < cfg["vocab"]):
        raise RuntimeError("the word-LM's perplexity did not fall below "
                           "the vocabulary's size")
    counts = _build.launch_counts()
    res["k1_k3_launches"] = {"k1": counts.get(FLASH_KERNEL, 0)
                             + counts.get(FLASH_SM90_KERNEL, 0),
                             "k3": counts.get(NORM_ACT_KERNEL, 0)}
    info = mod._exec.graph_info()
    print(f"  captured signatures: {[(s['is_train'], s['replays'], s['backward_replays'], s['launches_per_replay']) for s in info]}; "
          f"K1/K3 launches on this path: {res['k1_k3_launches']}")
    port_ms, flat_ms = pm.repack_ms(cfg, torch.device("cuda", 0))
    res["rnn_fwd_bwd_ms"] = {"port_views": port_ms,
                             "torch_flat_weights": flat_ms}
    print(f"  cuDNN weight repack: the rnn op's forward+backward takes "
          f"{port_ms:.3f} ms of device time on views of the packed vector "
          f"against {flat_ms:.3f} ms for torch.nn.LSTM with flattened "
          f"weights (medians of turns port, flat, flat, port)")
    res["perplexity"] = [p0, p1]
    return res


def bucketing_phase():
    phase("34 BucketingModule over rnn.LSTMCell.unroll")
    ctx = mx.gpu(0)
    cfg = pm.WORD_LM
    B = cfg["batch"]
    sents = pm.sentences(BUCKET_SENTENCES, cfg["vocab"], 5, max(BUCKETS),
                         SEED)
    it = mx.rnn.BucketSentenceIter(sents, B, buckets=list(BUCKETS),
                                   invalid_label=0)
    mod = mx.mod.BucketingModule(
        pm.bucketing_sym_gen(mx, cfg["vocab"], cfg["hidden"], B),
        default_bucket_key=it.default_bucket_key, context=ctx)
    mx.random.seed(SEED)
    metric = mx.metric.Perplexity()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the example's optimizer: Adam at 0.01
    mod.fit(it, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": 0.01}, num_epoch=1,
            initializer=mx.init.Uniform(0.1))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    info = mod.graph_info()
    per_bucket = {k: [(s["is_train"], s["replays"], s["backward_replays"])
                      for s in v] for k, v in sorted(info.items())}
    print(f"  {len(it.idx)} batches over buckets {sorted(info)} in "
          f"{secs:.1f} s (captures included); perplexity "
          f"{metric.get()[1]:.1f}")
    print(f"  per bucket (is_train, replays, backward replays): "
          f"{per_bucket}")
    counts = {it.buckets[i]: 0 for i in range(len(it.buckets))}
    for i, _ in it.idx:
        counts[it.buckets[i]] += 1
    for k, n in counts.items():
        if n == 0:
            continue
        sigs = per_bucket.get(k, [])
        if len(sigs) != 1 or sigs[0][1] != n or sigs[0][2] != n:
            raise RuntimeError(f"bucket {k}: expected one captured "
                               f"signature replayed {n} times, got {sigs}")
    if not onp.isfinite(metric.get()[1]):
        raise RuntimeError("the bucketed LM's perplexity is not finite")
    return {"batches_per_bucket": counts, "graphs": per_bucket,
            "seconds": secs}


def gluon_word_lm_phase(module_ms):
    phase("35 the word-LM in Gluon, hybridized")
    ctx = mx.gpu(0)
    cfg = pm.WORD_LM
    T, N = cfg["bptt"], cfg["batch"]
    GluonWordLM = pm.gluon_word_lm(mx)
    # against the CPU port: WLM_CPU steps from the same weights at p = 0
    det = dict(cfg, dropout=0.0)
    runs = []
    for c in (ctx, mx.cpu()):
        net = GluonWordLM(**det)
        mx.random.seed(SEED)
        net.initialize(mx.init.Uniform(pm.WORD_LM_INIT), ctx=c)
        net.hybridize()
        if runs:
            for p, q in zip(net.collect_params().values(), runs[0][0]):
                p.set_data(nd.array(q, ctx=c))
        w0 = [p.data().asnumpy() for p in net.collect_params().values()]
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                dict(pm.WORD_LM_OPT))
        losses, _ = pm.gluon_word_lm_train(
            mx, net, trainer, _wlm_batches(WLM_CPU, seed=SEED + 1), det, c)
        runs.append((w0, [float(v.asscalar()) for v in losses],
                     [p.data().asnumpy()
                      for p in net.collect_params().values()]))
    (_, g_loss, g_w), (_, c_loss, c_w) = runs
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    worst_w = max(_rel(b, a) for a, b in zip(g_w, c_w))
    print(f"  {WLM_CPU} steps against the CPU port at p = 0: losses within "
          f"{worst_loss:.3e}, weights within {worst_w:.3e} (allowed "
          f"{WLM_CPU_RTOL})")
    if max(worst_loss, worst_w) > WLM_CPU_RTOL:
        raise RuntimeError("the Gluon word-LM on the card departs from the "
                           "CPU port")
    # timed, p = 0.5
    net = GluonWordLM(**cfg)
    mx.random.seed(SEED)
    net.initialize(mx.init.Uniform(pm.WORD_LM_INIT), ctx=ctx)
    net.hybridize()
    gluon.reset_cached_op_stats()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            dict(pm.WORD_LM_OPT))
    batches = _wlm_batches(WLM_WARMUP + WLM_STEPS + WLM_FALL, seed=SEED + 1)
    warm, states = pm.gluon_word_lm_train(mx, net, trainer,
                                          batches[:WLM_WARMUP], cfg, ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, states = pm.gluon_word_lm_train(
        mx, net, trainer, batches[WLM_WARMUP:WLM_WARMUP + WLM_STEPS], cfg,
        ctx, states=states)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / WLM_STEPS
    # the loss falls: WLM_FALL more steps
    more, _ = pm.gluon_word_lm_train(
        mx, net, trainer, batches[WLM_WARMUP + WLM_STEPS:], cfg, ctx,
        states=states)
    vals = [float(v.asscalar()) / (T * N) for v in warm + timed + more]
    first, last = float(onp.mean(vals[:5])), float(onp.mean(vals[-5:]))
    stats = gluon.cached_op_stats()
    print(f"  hybridized: {ms:.3f} ms per step, "
          f"{T * N / ms * 1e3:,.0f} tokens/s (the Module's captured step: "
          f"{module_ms:.3f} ms); mean loss over the first 5 of "
          f"{len(vals)} steps {first:.3f}, over the last 5 {last:.3f} (ln V = "
          f"{onp.log(cfg['vocab']):.3f}); cached op {stats}")
    if not all(onp.isfinite(vals)) or stats["captures"] < 1 or \
            stats["replays"] < WLM_STEPS:
        raise RuntimeError("the Gluon word-LM did not train through its "
                           "captured graphs")
    if not last < min(first, onp.log(cfg["vocab"])):
        raise RuntimeError("the Gluon word-LM's loss did not fall below "
                           "its start and ln(vocabulary)")
    return {"step_ms": ms, "tokens_per_s": T * N / ms * 1e3,
            "losses": [first, last], "cpu_rel": [worst_loss, worst_w],
            "cached_op": stats}


def training_bind_fusion_phase():
    phase("36 K3 and K1 on a training bind")
    ctx = mx.gpu(0)
    sym = mx.sym
    x = sym.Variable("data")
    y = sym.LayerNorm(x, sym.Variable("ln_gamma"), sym.Variable("ln_beta"),
                      name="ln")
    y = sym.LeakyReLU(y, act_type="gelu", name="act")
    q = sym.FullyConnected(y, num_hidden=64, flatten=False, name="q")
    s = sym.softmax(sym.batch_dot(q, q, transpose_b=True), axis=-1)
    out = sym.make_loss(sym.sum(sym.batch_dot(s, q)), name="loss")
    rs = onp.random.RandomState(SEED)
    feed = {"data": rs.randn(4, 128, 64).astype("f"),
            "ln_gamma": 1 + 0.1 * rs.randn(64).astype("f"),
            "ln_beta": 0.1 * rs.randn(64).astype("f"),
            "q_weight": 0.1 * rs.randn(64, 64).astype("f"),
            "q_bias": 0.1 * rs.randn(64).astype("f")}
    grads, counts = {}, {}
    old = os.environ.get("MXNET_GRAPH_OPT")
    try:
        for level in ("0", "2"):
            os.environ["MXNET_GRAPH_OPT"] = level
            ex = out.simple_bind(ctx=ctx, data=(4, 128, 64))
            ex.copy_params_from({k: nd.array(v, ctx=ctx) for k, v in
                                 feed.items() if k != "data"})
            mx.kernels.reset_counters()
            _build.reset_launch_counts()
            ex.forward(is_train=True, data=nd.array(feed["data"], ctx=ctx))
            ex.backward()
            train = _build.launch_counts()
            grads[level] = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
            ex.forward(is_train=False)
            infer = _build.launch_counts()
            counts[level] = {"train": train, "after_inference": infer,
                             "fusion": mx.kernels.counters()}
    finally:
        if old is None:
            os.environ.pop("MXNET_GRAPH_OPT", None)
        else:
            os.environ["MXNET_GRAPH_OPT"] = old
    worst = max(_rel(grads["0"][k], grads["2"][k]) for k in grads["0"])
    c2 = counts["2"]
    print(f"  gradients at MXNET_GRAPH_OPT=2 against 0: within {worst:.3e}; "
          f"K3 launches in the training step "
          f"{c2['train'].get(NORM_ACT_KERNEL, 0)}, after an inference "
          f"forward {c2['after_inference'].get(NORM_ACT_KERNEL, 0)}; "
          f"K1 in the training step {c2['train'].get(FLASH_KERNEL, 0)}; "
          f"fusion counters {c2['fusion']}")
    if worst > 1e-4 or c2["train"].get(NORM_ACT_KERNEL, 0) != 0 or \
            c2["after_inference"].get(NORM_ACT_KERNEL, 0) < 1 or \
            c2["fusion"].get("replay_needs_grad", 0) < 1:
        raise RuntimeError("a training bind lost gradients or ran K3 on a "
                           "graph that needs one")
    return {"worst": worst, "counts": c2}


# -- ROADMAP A1: the NDArray and op surface ------------------------------------

# the hand update against the Trainer's fused SGD step from the same weights
# and gradients: two fp32 orderings of one formula, relative to each
# parameter's largest magnitude
HAND_VS_TRAINER = 1e-6
# the hand loop's logged and timed steps; the falling-loss check reads step
# RESNET_FALL_STEPS, as phase 16's does (the loss overshoots early)
HAND_STEPS = 20
# the loss is the batch mean, so its gradients are scaled already: the
# Trainer's rescale_grad, 1 / step's batch_size, is 1
HAND_RESCALE = 1.0


def _hand_backward(net, x, y):
    """The tutorials' loss, -mean log softmax at the label, recorded and
    differentiated; returns the logits and the loss."""
    with autograd.record():
        out = net(x)
        loss = -nd.pick(nd.log_softmax(out), y).mean()
    loss.backward()
    return out, loss


def _hand_update(params, moms):
    """SGD with momentum as the from-scratch tutorials write it, through
    the in-place operators on each Parameter's data (its registered
    leaf): m *= 0.9; m -= lr * (g + wd * w); w += m."""
    for p, m in zip(params, moms):
        w = p.data()
        g = p.grad() * HAND_RESCALE
        m *= pr.MOMENTUM
        m -= pr.LR * (g + pr.WD * w)
        w += m


def _hand_log(out, y, loss, params):
    """The step's loss, top-1 and top-5 accuracy, and the global gradient
    norm from ``nd.norm``, each read with ``float()``."""
    top1 = float((out.argmax(axis=1) == y).mean())
    top5 = float((nd.topk(out, k=5) == y.reshape((-1, 1))).sum(axis=1)
                 .mean())
    norms = [nd.norm(p.grad()) for p in params]
    gnorm = float(nd.add_n(*[n * n for n in norms]) ** 0.5)
    return {"loss": float(loss), "top1": top1, "top5": top5,
            "grad_norm": gnorm}


def _restore(params, weights, moms):
    with torch.no_grad():
        for p, w in zip(params, weights):
            p.data().data.copy_(w)
        for m in moms:
            m.data.zero_()


def hand_loop_phase():
    phase("37 ResNet-50 through a hand-written SGD loop")
    ctx = mx.gpu(0)
    fused_step.reset_fused_step_cache()
    gluon.reset_cached_op_stats()
    torch.backends.cudnn.benchmark = True
    net = pr.build_resnet50(ctx, seed=SEED)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    mx.random.seed(SEED)
    x = nd.random.uniform(-1, 1, shape=(RESNET_B, 3, pr.IMAGE, pr.IMAGE),
                          ctx=ctx)
    y = nd.random.randint(0, pr.CLASSES, shape=(RESNET_B,),
                          ctx=ctx).astype("float32")
    moms = [nd.zeros(p.shape, ctx=ctx) for p in params]
    leaves = [p.data().data for p in params]
    w0 = [t.detach().clone() for t in leaves]
    # 1. the same update as the Trainer's fused step, from the same
    # weights and gradients
    _hand_backward(net, x, y)
    _hand_update(params, moms)
    kept = all(p.data().data is t for p, t in zip(params, leaves))
    hand = [t.detach().clone() for t in leaves]
    moved = sum(not torch.equal(a, b) for a, b in zip(hand, w0))
    _restore(params, w0, moms)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": pr.LR, "momentum": pr.MOMENTUM,
                             "wd": pr.WD})
    trainer.step(1)
    worst = max(float((t.detach() - h).abs().max()
                      / h.abs().max().clamp_min(1e-30))
                for t, h in zip(leaves, hand))
    print(f"  hand update: every parameter kept its leaf: {kept}; "
          f"{moved}/{len(params)} parameters moved; against the Trainer's "
          f"fused sgd step: {worst:.3g} of each parameter's largest "
          f"magnitude (bound {HAND_VS_TRAINER})")
    if not kept or moved != len(params) or not worst <= HAND_VS_TRAINER:
        raise RuntimeError("the hand-written SGD update did not reach the "
                           "parameters, or differs from the Trainer's")
    # 2. the in-place writes reach the captured forward: same gradients,
    # fresh momenta, the forward captured before the update
    _restore(params, w0, moms)
    with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                    deterministic=True):
        net.hybridize()
        before = net(x).data.detach().clone()
        _hand_update(params, moms)
        captured = net(x).data.detach().clone()
        cached = gluon.cached_op_stats()
        net.hybridize(False)
        eager = net(x).data.detach().clone()
    same = torch.equal(captured, eager)
    changed = not torch.equal(captured, before)
    print(f"  after a hand update: captured forward bitwise equal to eager: "
          f"{same}; differs from before the update: {changed}; cached op "
          f"{cached}")
    if not same or not changed or cached["captures"] != 1 or \
            cached["replays"] != 2:
        raise RuntimeError("the in-place update did not reach the captured "
                           "graph")
    # 3. training: the hand loop timed and logged, then untimed to the
    # falling-loss step; the Trainer loop on the same loss timed beside
    _restore(params, w0, moms)
    logs, step_ms = [], []
    for i in range(RESNET_FALL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, loss = _hand_backward(net, x, y)
        _hand_update(params, moms)
        if i < HAND_STEPS:
            logs.append(_hand_log(out, y, loss, params))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        elif i == RESNET_FALL_STEPS - 1:
            logs.append(_hand_log(out, y, loss, params))
    for i, row in enumerate(logs[:HAND_STEPS]):
        print(f"  step {i + 1}: " + json.dumps(row))
    print(f"  step {RESNET_FALL_STEPS}: " + json.dumps(logs[-1]))
    losses = [r["loss"] for r in logs]
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"the hand-written loop did not train: {losses}")
    _restore(params, w0, moms)
    trainer_ms = []
    for i in range(RESNET_WARMUP + RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, loss = _hand_backward(net, x, y)
        trainer.step(1)
        _hand_log(out, y, loss, params)
        torch.cuda.synchronize()
        if i >= RESNET_WARMUP:
            trainer_ms.append((time.perf_counter() - t0) * 1e3)
    result = {"hand_step_ms": statistics.mean(step_ms[RESNET_WARMUP:]),
              "hand_first_step_ms": step_ms[0],
              "trainer_step_ms": statistics.mean(trainer_ms),
              "hand_vs_trainer": worst,
              "first_loss": losses[0], "last_loss": losses[-1]}
    print("hand loop " + json.dumps(result))
    del net, trainer
    torch.cuda.empty_cache()
    return result


def op_sweep_phase():
    phase("38 the op sweep")
    dev = torch.device("cuda", 0)
    rows = op_sweep.card_sweep(dev)
    exact = sum(r["exact_outputs"] for r in rows)
    worst = max(rows, key=lambda r: r["worst"])
    print(f"  {len(rows)} cases on the card against the CPU port, forward "
          f"and backward: {exact} outputs bitwise, the worst float "
          f"deviation {worst['worst']:.3g} of its bound ({worst['case']})")
    n_captured = op_sweep.capture_check(dev)
    print(f"  {n_captured} cases in one CUDA graph, the replay bitwise equal "
          f"to the eager calls; not captured (output shapes that depend on "
          f"the data): {list(op_sweep.DATA_DEPENDENT)}")
    n_random = op_sweep.random_capture_check(dev)
    print(f"  {n_random} random draws in one CUDA graph under the registered "
          "generator: each replay draws anew, and repeats after "
          "mx.random.seed")
    suite = opperf.run_op_suite(ctx=mx.gpu(0))
    for r in suite:
        print("  opperf " + json.dumps(r))
    return {"cases": len(rows), "bitwise_outputs": exact,
            "captured": n_captured, "random_captured": n_random,
            "opperf": suite}


def kernel_entry(name, source, replaces, launches, worst, row, shape, smi,
                 **extra):
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": worst, "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"],
             "shape": shape, "card": smi}
    entry.update(extra)
    return entry


def main():
    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k2_worst = kernel_check_phase(gen)
    k2_rows = kernel_times_phase(gen)
    k2_launches, _ = serving_phase()
    k1_worst = k1_check_phase(gen)
    k1_row = k1_times_phase(gen)
    net, k1_training, _ = training_phase()
    training_vs_cpu_phase(net)
    del net
    k3_worst = k3_check_phase(gen)
    k3_rows, k3_total = k3_times_phase(gen)
    route = k1_route_phase(gen)
    sym_result = symbolic_phase()
    k4_worst, double = k4_check_phase(gen)
    k4_fwd, k4_bwd, k4_double = k4_times_phase(gen, double)
    net, (k4_fwd_n, k4_bwd_n), _ = resnet_phase()
    resnet_vs_cpu_phase(net)
    del net
    torch.cuda.empty_cache()
    net = decode_net()
    k2_paged_launches, _ = paged_serving_phase(net)
    graph_vs_eager_phase(net)
    http_phase(net)
    del net
    torch.cuda.empty_cache()
    conv_default_flags_phase()
    k4_floor = k4_floor_phase()
    k1_bf16 = k1_bf16_phase(gen)
    (net, trainer, x, y), resnet_amp, head = resnet_amp_phase()
    k1_bf16_launches, sm90_launches, _ = lm_amp_phase()
    amp_vs_cpu_phase()
    poisoned_step_phase(net, trainer, x, y)
    del net, trainer
    torch.cuda.empty_cache()
    resnet_hyb = resnet_hybrid_phase()
    lm_hyb = lm_hybrid_phase()
    fed = fed_resnet_phase()
    failing_capture_phase()
    mlp = mlp_phase()
    wlm = word_lm_phase(gen)
    bucketing = bucketing_phase()
    gluon_wlm = gluon_word_lm_phase(wlm["captured"]["step_ms"])
    fusion_bind = training_bind_fusion_phase()
    hand = hand_loop_phase()
    sweep = op_sweep_phase()
    bind_counts = fusion_bind["counts"]
    # the counts after the inference forward hold the training step's too
    k1_bind = bind_counts["after_inference"].get(FLASH_KERNEL, 0)
    k3_bind = bind_counts["after_inference"].get(NORM_ACT_KERNEL, 0)
    k1_hyb = lm_hyb[True]["k1_sm90_launches"] + \
        lm_hyb[False]["k1_sm90_launches"]
    k4_hyb = {"resnet_bf16_hybrid_eager": resnet_hyb[False]["k4_launches"] // 2,
              "resnet_bf16_hybridized": resnet_hyb[True]["k4_launches"] // 2,
              "resnet_bf16_fed": fed["k4_launches"] // 2}
    k4_amp = {f"resnet_bf16_{k}": v["k4_launches"] // 2
              for k, v in resnet_amp.items()}
    big = k2_rows[-1]
    k3_big = k3_rows[0]
    kernels = [
        kernel_entry(
            KERNEL, "mxnet_tpu_torch/csrc/decode_attention.cu",
            "mxnet_tpu/kernels/flash_attention.py:137",
            k2_launches + k2_paged_launches, k2_worst, big,
            f"B={big['B']} H={big['H']} S={big['S']} "
            f"D={big['D']} visible={big['visible']} fp32", smi,
            splits=big["splits"], by_batch=k2_rows,
            launches_by_path={"serving": k2_launches,
                              "paged_serving": k2_paged_launches}),
        # K1's headline numbers are the training shape's; the fusion
        # route's shape has its own row under "fusion_route". Its launches
        # are the mma.sync kernel's; the bf16 LM's go to the sm90 kernel
        kernel_entry(
            FLASH_KERNEL, "mxnet_tpu_torch/csrc/flash_attention.cu",
            "mxnet_tpu/kernels/flash_attention.py:48",
            k1_training + sym_result["k1_launches"] + k1_bf16_launches
            - sm90_launches + wlm["k1_k3_launches"]["k1"] + k1_bind,
            max(k1_worst, route["max_abs_err"]), k1_row,
            f"B={k1_row['B']} H={k1_row['H']} S_q={k1_row['S_q']} "
            f"S_k={k1_row['S_k']} D={k1_row['D']} causal fp32", smi,
            bound_3xtf32_ms=k1_row["bound_3xtf32_ms"],
            launches_by_path={"training": k1_training,
                              "symbolic_serving": sym_result["k1_launches"],
                              "training_bf16": k1_bf16_launches
                              - sm90_launches,
                              "word_lm_module": wlm["k1_k3_launches"]["k1"],
                              "training_bind": k1_bind},
            fusion_route=route, bf16_mma_route_ms=k1_bf16["mma_route_ms"]),
        # K1 in bf16 at D = 64: the wgmma kernel the LM takes under AMP
        kernel_entry(
            FLASH_SM90_KERNEL, "mxnet_tpu_torch/csrc/flash_attention_sm90.cu",
            "mxnet_tpu/kernels/flash_attention.py:48", sm90_launches + k1_hyb,
            k1_bf16["max_abs_err"], k1_bf16,
            f"B={k1_bf16['B']} H={k1_bf16['H']} S_q={k1_bf16['S_q']} "
            f"S_k={k1_bf16['S_k']} D={k1_bf16['D']} causal bf16", smi,
            bound_two_pass_ms=k1_bf16["bound_two_pass_ms"],
            views_ms=k1_bf16["views_ms"],
            mma_route_ms=k1_bf16["mma_route_ms"],
            launches_by_path={
                "training_bf16": sm90_launches,
                "training_bf16_hybrid_eager":
                    lm_hyb[False]["k1_sm90_launches"],
                "training_bf16_hybridized":
                    lm_hyb[True]["k1_sm90_launches"]},
            launches_per_replay=lm_hyb[True]["k1_launches_per_replay"]),
        kernel_entry(
            NORM_ACT_KERNEL, "mxnet_tpu_torch/csrc/norm_act.cu",
            "mxnet_tpu/kernels/norm_act.py:45",
            sym_result["k3_launches"] + wlm["k1_k3_launches"]["k3"]
            + k3_bind,
            k3_worst, k3_big, f"rows={k3_big['rows']} C={k3_big['C']} gelu "
            "fp32 (bucket 8, feature layer 1)", smi,
            library_calls="F.layer_norm then F.gelu", per_forward=k3_total,
            launches_by_path={"symbolic_serving": sym_result["k3_launches"],
                              "word_lm_module": wlm["k1_k3_launches"]["k3"],
                              "training_bind_inference": k3_bind,
                              "training_bind_train": bind_counts["train"]
                              .get(NORM_ACT_KERNEL, 0)}),
        # K4: the launcher and the two kernels it compiles on the ResNet-50
        # path; the double kernel of the launcher's own check rides along
        kernel_entry(
            pr.FWD_KERNEL, "mxnet_tpu_torch/tools/profile_resnet.py "
            "(FWD_SRC, via mxnet_tpu_torch/rtc.py)", "mxnet_tpu/rtc.py:19",
            k4_fwd_n + sum(k4_amp.values()) + sum(k4_hyb.values()),
            k4_worst, k4_fwd,
            f"B={k4_fwd['B']} C={k4_fwd['C']} fp32", smi,
            route_detail="NVRTC sm_90a, cuLaunchKernel",
            library_calls="torch.softmax", launcher=k4_double,
            launch_floor=k4_floor,
            launches_by_path={"resnet_fp32": k4_fwd_n, **k4_amp,
                              **k4_hyb}),
        kernel_entry(
            pr.BWD_KERNEL, "mxnet_tpu_torch/tools/profile_resnet.py "
            "(BWD_SRC, via mxnet_tpu_torch/rtc.py)", "mxnet_tpu/rtc.py:19",
            k4_bwd_n + sum(k4_amp.values()) + sum(k4_hyb.values()),
            k4_worst, k4_bwd,
            f"B={k4_bwd['B']} C={k4_bwd['C']} fp32", smi,
            route_detail="NVRTC sm_90a, cuLaunchKernel",
            library_calls="torch._softmax_backward_data",
            launches_by_path={"resnet_fp32": k4_bwd_n, **k4_amp,
                              **k4_hyb}),
    ]
    phase("39 report")
    print(f"bf16 ResNet-50 headline layout: {head}")
    print("hybridized: " + json.dumps({
        "resnet50_bf16_nhwc_step_ms": [resnet_hyb[False]["mean_step_ms"],
                                       resnet_hyb[True]["mean_step_ms"]],
        "lm_bf16_step_ms": [lm_hyb[False]["mean_step_ms"],
                            lm_hyb[True]["mean_step_ms"]],
        "fed_step_ms": fed["mean_step_ms"],
        "fed_prefetch_stall_s_per_step": fed["prefetch_stall_s_per_step"]}))
    print("symbolic training: " + json.dumps({
        "mlp_step_ms": mlp["metric"]["step_ms"],
        "mlp_step_ms_no_metric": mlp["no_metric"]["step_ms"],
        "mlp_val_acc": [mlp["metric"]["val_acc_before"],
                        mlp["metric"]["val_acc_after"]],
        "word_lm_step_ms": {"eager": wlm["eager"]["step_ms"],
                            "captured": wlm["captured"]["step_ms"],
                            "eager_no_metric":
                                wlm["eager"]["no_metric_step_ms"],
                            "captured_no_metric":
                                wlm["captured"]["no_metric_step_ms"],
                            "gluon_hybridized": gluon_wlm["step_ms"]},
        "word_lm_tokens_per_s": {"eager": wlm["eager"]["tokens_per_s"],
                                 "captured": wlm["captured"]["tokens_per_s"],
                                 "gluon_hybridized":
                                     gluon_wlm["tokens_per_s"]},
        "word_lm_idle_share": {
            k: wlm[k]["profile"]["device_idle_share"]
            for k in ("eager", "captured")},
        "word_lm_peak_gb": {k: wlm[k]["peak_gb"]
                            for k in ("eager", "captured")},
        "word_lm_perplexity": wlm["perplexity"],
        "rnn_fwd_bwd_ms": wlm["rnn_fwd_bwd_ms"],
        "bucketing_batches": bucketing["batches_per_bucket"]}))
    print("NDArray and op surface: " + json.dumps({
        "hand_step_ms": hand["hand_step_ms"],
        "trainer_step_ms": hand["trainer_step_ms"],
        "hand_vs_trainer": hand["hand_vs_trainer"],
        "sweep_cases": sweep["cases"], "captured": sweep["captured"],
        "opperf_fwd_ms": {r["op"]: r["fwd_ms"] for r in sweep["opperf"]}}))
    print(f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
