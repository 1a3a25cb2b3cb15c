"""The port on the card: the CUDA kernels K1 (flash-attention forward),
K2 (decode attention) and K3 (fused LayerNorm→activation), the
runtime-kernel launcher K4 (``rtc.CudaModule`` over NVRTC) with the
``rtc_softmax`` loss head it compiles, and the paths that launch them:
decode serving, one TransformerLM training step, a served predict of an
exported wav2vec2 graph and ResNet training steps with the custom head.
Every test here needs an NVIDIA GPU and skips without one.

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch for CUDA. From the repo root:

    python -m pytest --noconftest -p no:cacheprovider \
        -o "markers=cuda: needs a CUDA device" -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX.) K1's sm90 kernel
(bf16 at D = 64) is held to the same two bf16 ulps as K1 in bfloat16
below, reruns bitwise, and its SASS holds bf16 HGMMA and no TF32 HMMA.
K2 is held against
its plain version within rtol = atol = 1e-5, and so is K1 in float32:
the bound the JAX package puts on its Pallas kernels against the lax
path; both sum the softmax in fp32, in different orders. K1 in bfloat16
is held within two bfloat16 ulps (rtol 2**-6) of the plain version
computed in float32 from the same bfloat16 inputs: the kernel rounds
once, at the output. K3 is held against its plain version within 1e-5
in float32 and one bfloat16 ulp in bfloat16 (both compute in float32
and round once). K4's ``double`` and ``axpy`` match torch exactly (one
rounding each, the same one); the ``rtc_softmax`` kernels match their
plain versions within rtol = atol = 1e-6 (the same fp32 arithmetic,
sums in another order).
"""
import os
import re
import shutil
import subprocess

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, rtc, serving
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (
    FLASH_KERNEL, FLASH_SM90_KERNEL, KERNEL, _decode_flash, _decode_flash_ref,
    _decode_splits, _flash_fwd_cuda, _flash_load_width, _flash_ref,
    _flash_route, flash_attention)
from mxnet_tpu_torch.kernels.norm_act import (
    KERNEL as NORM_ACT_KERNEL, MAX_C, _norm_act_cuda, _norm_act_ref)
from mxnet_tpu_torch.models import DecoderBlockLM, TransformerLM
from mxnet_tpu_torch.tools.profile_predict import (
    SAMPLE_RATE, WAV2VEC2_LARGE_LV60, export_wav2vec2, frames)
from mxnet_tpu_torch.tools import profile_resnet as pr
from mxnet_tpu_torch.gluon.model_zoo import vision

pytestmark = pytest.mark.cuda

TOL = 1e-5
SMALL = dict(vocab_size=32, embed_dim=16, num_layers=2, num_heads=2,
             max_len=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, B, S, H, D, lengths, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, D, device=dev, generator=gen)
    k = torch.randn(B, S, H, D, device=dev, generator=gen)
    v = torch.randn(B, S, H, D, device=dev, generator=gen)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


# (B, S, H, D, lengths): the JAX attention tests' D = 24; D = 8 with an
# empty row (every key masked: the plain version then weighs all keys
# alike); a length past S (clamped); D = 256, the largest; D = 100, not
# a multiple of the 32 lanes
@pytest.mark.parametrize("B,S,H,D,lengths", [
    (3, 100, 2, 24, [1, 51, 100]),
    (2, 40, 3, 8, [0, 40]),
    (2, 64, 4, 64, [64, 200]),
    (1, 33, 1, 256, [33]),
    (2, 17, 2, 100, [5, 17]),
])
def test_kernel_on_card_matches_plain(cuda, B, S, H, D, lengths):
    q, k, v, n = _inputs(cuda, B, S, H, D, lengths)
    _build.reset_launch_counts()
    got = _decode_flash(q, k, v, n, D ** -0.5)
    want = _decode_flash_ref(q, k, v, n, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {KERNEL: 1}
    assert got.shape == (B, H, D) and got.device == cuda
    assert torch.allclose(got, want, rtol=TOL, atol=TOL)


def test_kernel_ignores_keys_past_the_length(cuda):
    """Garbage past each row's length leaves the output bitwise equal."""
    q, k, v, n = _inputs(cuda, 2, 50, 2, 32, [7, 30])
    base = _decode_flash(q, k, v, n, 0.2)
    k[0, 7:], v[0, 7:] = 1e4, -1e4
    k[1, 30:], v[1, 30:] = float("nan"), float("nan")
    assert torch.equal(_decode_flash(q, k, v, n, 0.2), base)


def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    q, k, v, n = _inputs(cuda, 2, 8, 2, 8, [3, 8])
    bad = [
        (q.double(), k, v, n),                      # not float32
        (q, k, v, n.long()),                        # lengths not int32
        (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, n),
        (q.cpu(), k, v, n),                         # two devices
        (q[:1], k, v, n),                           # q does not match k
    ]
    big = _inputs(cuda, 1, 4, 1, 264, [4])
    _build.reset_launch_counts()
    for args in bad + [big]:
        with pytest.raises(mx.MXNetError, match="_decode_flash"):
            _decode_flash(*args, 0.5)
    assert _build.launch_counts() == {}


def _n_sm(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


# the split sweep: batch 1 at GPT-2 widths at each edge length (an empty
# row, one key, a chunk's edges, a long and a full cache); the seven in one
# batch of 7; a length past S; a short cache of two chunks; D = 24
_K2_EDGE = [0, 1, 63, 64, 65, 1000, 1024]


@pytest.mark.parametrize("B,S,H,D,lengths", [
    *[(1, 1024, 12, 64, [n]) for n in _K2_EDGE],
    (7, 1024, 12, 64, _K2_EDGE),
    (2, 1024, 12, 64, [1500, 700]),
    (1, 65, 12, 64, [65]),
    (3, 300, 2, 24, [-3, 130, 400]),
])
def test_k2_split_sweep_matches_plain(cuda, B, S, H, D, lengths):
    splits, chunk = _decode_splits(B, H, S, _n_sm(cuda))
    assert splits > 1
    q, k, v, n = _inputs(cuda, B, S, H, D, lengths, seed=B + S)
    _build.reset_launch_counts()
    got = _decode_flash(q, k, v, n, D ** -0.5)
    want = _decode_flash_ref(q, k, v, n, D ** -0.5)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {KERNEL: 1}  # two kernels, one call
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=TOL, atol=TOL)


def _carried_net(impl, ctx):
    """A small DecoderBlockLM with weights drawn once on the CPU and
    carried onto ``ctx``, so every instance holds the same weights."""
    mx.random.seed(3)
    src = DecoderBlockLM(**SMALL)
    src.initialize(ctx=mx.cpu())
    with mx.autograd.pause():  # one step finishes the deferred shapes
        src(mx.nd.zeros((1, 1), ctx=mx.cpu(), dtype="int32"),
            *[mx.nd.zeros((1,) + s, ctx=mx.cpu(), dtype=dt) for s, dt in
              zip(src.state_row_shapes(), src.state_row_dtypes())])
    arrays = {k: p.data().asnumpy()
              for k, p in src._collect_params_with_prefix().items()}
    net = DecoderBlockLM(**SMALL, impl=impl)
    return convert.params_from_numpy(net, arrays, ctx=ctx)


def test_decoder_on_card_launches_k2_and_matches_plain(cuda):
    ctx = mx.gpu(0)
    assert DecoderBlockLM(**SMALL)._impl is None  # picks cuda on the card
    outs = {}
    rs = onp.random.RandomState(5)
    toks = rs.randint(0, SMALL["vocab_size"], size=(6, 3, 1)).astype("int32")
    for impl in (None, "torch"):
        net = _carried_net(impl, ctx)
        states = [mx.nd.zeros((3,) + s, ctx=ctx, dtype=dt) for s, dt in
                  zip(net.state_row_shapes(), net.state_row_dtypes())]
        _build.reset_launch_counts()
        logits = []
        with mx.autograd.pause():
            for tok in toks:
                out, *states = net(mx.nd.array(tok, ctx=ctx), *states)
                logits.append(out.asnumpy())
        launches = _build.launch_counts().get(KERNEL, 0)
        assert launches == (SMALL["num_layers"] * len(toks)
                            if impl is None else 0)
        outs[impl] = onp.stack(logits)
    onp.testing.assert_allclose(outs[None], outs["torch"], rtol=TOL, atol=TOL)


def test_batcher_on_card_matches_step_loop(cuda):
    ctx = mx.gpu(0)
    net = _carried_net(None, ctx)
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=4,
        byte_budget=0, ttl_s=0, ctx=ctx)
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=[1, 2, 4], ctx=ctx)
    bat = serving.DynamicBatcher(sess, max_batch_size=4, max_latency_ms=2.0,
                                 timeout_ms=120000, admission=False)
    rs = onp.random.RandomState(9)
    streams = {sid: [rs.randint(0, SMALL["vocab_size"], size=(1, 1))
                     .astype("int32") for _ in range(n)]
               for sid, n in (("a", 3), ("b", 9), ("c", 6))}
    try:
        _build.reset_launch_counts()
        serving.METRICS.reset()
        futs = {sid: [bat.submit(t, session_id=sid) for t in toks]
                for sid, toks in streams.items()}
        got = {sid: [onp.asarray(f.result(timeout=300)) for f in fs]
               for sid, fs in futs.items()}
        snap = serving.METRICS.snapshot()
        launches = _build.launch_counts().get(KERNEL, 0)
    finally:
        bat.close()
    assert snap["failures"] == 0
    assert launches == SMALL["num_layers"] * snap["decode_steps"] > 0
    for sid, toks in streams.items():
        states = [onp.zeros((1,) + s, dt) for s, dt in
                  zip(net.state_row_shapes(), net.state_row_dtypes())]
        for tok, g in zip(toks, got[sid]):
            out, states = sess.step(tok, states=states)
            onp.testing.assert_allclose(g, out.asnumpy(), rtol=TOL, atol=TOL)
    sess.close()
    store.close()


# -- K1: the flash-attention forward ----------------------------------------

def _qkv(dev, B, H, S_q, S_k, D, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, S_q, D, device=dev, generator=gen)
    k = torch.randn(B, H, S_k, D, device=dev, generator=gen)
    v = torch.randn(B, H, S_k, D, device=dev, generator=gen)
    return q.to(dtype), k.to(dtype), v.to(dtype)


# (B, H, S_q, S_k, D, causal): the D sweep up to 256 (one per tile
# configuration, and 100, not a multiple of 32); the JAX tests' ragged
# 100 x 70 at D = 24 and S_q = 1 decode alignment; causal S_q < S_k
@pytest.mark.parametrize("B,H,S_q,S_k,D,causal", [
    (2, 3, 64, 64, 16, False),
    (2, 3, 64, 64, 16, True),
    (1, 2, 100, 70, 24, False),
    (1, 2, 1, 40, 8, True),
    (2, 2, 37, 130, 64, True),
    (1, 2, 200, 200, 64, True),
    (1, 2, 77, 77, 100, True),
    (1, 2, 90, 90, 128, False),
    (1, 2, 70, 70, 256, True),
])
def test_k1_on_card_matches_plain(cuda, B, H, S_q, S_k, D, causal):
    q, k, v = _qkv(cuda, B, H, S_q, S_k, D)
    _build.reset_launch_counts()
    got = _flash_fwd_cuda(q, k, v, D ** -0.5, causal)
    want = _flash_ref(q, k, v, D ** -0.5, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {FLASH_KERNEL: 1}
    assert got.shape == (B, H, S_q, D) and got.is_contiguous()
    assert torch.allclose(got, want, rtol=TOL, atol=TOL)


def test_k1_reads_strided_views_in_place(cuda):
    """q, k, v as the model makes them: views of one fused (B, S, 3, H, D)
    projection, strided in every axis but D."""
    B, S, H, D = 2, 150, 3, 32
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn(B, S, 3, H, D, device=cuda, generator=gen)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous()
    got = _flash_fwd_cuda(q, k, v, 0.3, True)
    want = _flash_ref(q.contiguous(), k.contiguous(), v.contiguous(), 0.3,
                      True)
    assert torch.allclose(got, want, rtol=TOL, atol=TOL)


def test_k1_bfloat16_within_two_ulps(cuda):
    q, k, v = _qkv(cuda, 2, 4, 130, 130, 64, dtype=torch.bfloat16)
    got = _flash_fwd_cuda(q, k, v, 0.125, True)
    want = _flash_ref(q.float(), k.float(), v.float(), 0.125, True)
    assert got.dtype == torch.bfloat16
    assert torch.allclose(got.float(), want.to(torch.bfloat16).float(),
                          rtol=2 ** -6, atol=1e-5)


def test_k1_gradients_match_autograd_of_plain(cuda):
    """dq/dk/dv through the autograd.Function (K1 forward, recompute
    backward) against torch autograd through the plain version; 1e-4:
    two different fp32 backward computations over 130 keys."""
    q, k, v = _qkv(cuda, 1, 2, 100, 130, 32)
    do = torch.randn(1, 2, 100, 32, device=cuda)
    grads = []
    for fn in (lambda a, b, c: flash_attention(a, b, c, causal=True),
               lambda a, b, c: _flash_ref(a, b, c, 32 ** -0.5, True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(do)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_k1_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    q, k, v = _qkv(cuda, 1, 2, 8, 8, 16)
    bad = [
        (q.double(), k.double(), v.double(), False),  # not f32 / bf16
        (q, k.to(torch.bfloat16), v, False),          # mixed dtypes
        (q.cpu(), k, v, False),                       # two devices
        (q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
         False),                                      # D strided
        (torch.cat([q, q], 2), k, v, True),           # causal S_q > S_k
        (*_qkv(cuda, 1, 1, 4, 4, 264), False),        # D > 256
    ]
    _build.reset_launch_counts()
    for q_, k_, v_, causal in bad:
        with pytest.raises(mx.MXNetError, match="_flash_fwd_cuda"):
            _flash_fwd_cuda(q_, k_, v_, 0.25, causal)
    assert _build.launch_counts() == {}


# the second load path: rows that are not 16-byte aligned. (B, H, S_q,
# S_k, D, causal, dtype, bytes per copy); the route's shape beside them
@pytest.mark.parametrize("B,H,S_q,S_k,D,causal,dtype,width", [
    (128, 1, 499, 499, 64, False, torch.float32, 16),
    (1, 2, 77, 77, 20, False, torch.bfloat16, 4),    # 40-byte rows
    (1, 2, 33, 50, 21, True, torch.bfloat16, 2),     # 42-byte rows
    (1, 1, 5, 9, 3, False, torch.float32, 4),        # 12-byte rows
    (2, 3, 64, 64, 32, True, torch.bfloat16, 16),
])
def test_k1_load_paths_match_plain(cuda, B, H, S_q, S_k, D, causal, dtype,
                                   width):
    q, k, v = _qkv(cuda, B, H, S_q, S_k, D, dtype=dtype, seed=D)
    assert _flash_load_width(k, v) == width
    got = _flash_fwd_cuda(q, k, v, D ** -0.5, causal)
    want = _flash_ref(q.float(), k.float(), v.float(), D ** -0.5, causal)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert torch.allclose(got, want, rtol=TOL, atol=TOL)
    else:
        assert torch.allclose(got.float(), want.to(dtype).float(),
                              rtol=2 ** -6, atol=TOL)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 4),
                                         (torch.bfloat16, 2)])
def test_k1_reads_an_odd_s_stride(cuda, dtype, width):
    """q, k, v with an s-stride of 65 elements: 4-byte copies in fp32,
    element loads in bf16."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    base = torch.randn(3, 2, 3, 90, 65, device=cuda,
                       generator=gen).to(dtype)
    q, k, v = (base[i, ..., :64] for i in range(3))
    assert k.stride(2) == 65 and _flash_load_width(k, v) == width
    got = _flash_fwd_cuda(q, k, v, 0.125, True)
    want = _flash_ref(q.float(), k.float(), v.float(), 0.125, True)
    tol = TOL if dtype == torch.float32 else 2 ** -6
    assert torch.allclose(got.float(), want.to(dtype).float(), rtol=tol,
                          atol=TOL)


def test_k1_sass_holds_tf32_tensor_core_products(cuda):
    """The built library issues its products as TF32 HMMA instructions."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        pytest.skip("the CUDA toolkit here has no cuobjdump")
    _build.load(FLASH_KERNEL)
    sass = subprocess.run([tool, "-sass", _build._library_path(FLASH_KERNEL)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    assert re.search(r"HMMA\.\S*TF32", sass), "no TF32 HMMA in K1's SASS"


# -- K1's sm90 kernel: bf16 at D = 64, wgmma fed by TMA ----------------------

def _within_bf16_gate(got, q, k, v, scale, causal):
    """Two bf16 ulps (rtol 2^-6, atol 1e-5) of the plain version in float32
    from the same bf16 inputs, rounded once; returns the largest error."""
    want = _flash_ref(q.float(), k.float(), v.float(), scale, causal).to(
        torch.bfloat16).float()
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.allclose(got.float(), want, rtol=2 ** -6, atol=TOL)
    return (got.float() - want).abs().max().item()


# (B, H, S_q, S_k, causal): ragged S_q and S_k, causal and not, S_q < S_k,
# a single query row; 1 x 1 x 100 gives one work item (fewer than the
# SMs), 8 x 12 x 1024 gives 768 (more than the SMs: each block walks
# several)
@pytest.mark.parametrize("B,H,S_q,S_k,causal", [
    (1, 1, 100, 100, True),
    (2, 3, 130, 130, True),
    (2, 3, 130, 257, False),
    (1, 2, 499, 499, False),
    (2, 2, 100, 300, True),
    (1, 2, 1, 40, True),
    (3, 5, 700, 900, True),
    (8, 12, 1024, 1024, True),
])
def test_sm90_kernel_on_card_within_the_gate(cuda, B, H, S_q, S_k, causal):
    q, k, v = _qkv(cuda, B, H, S_q, S_k, 64, dtype=torch.bfloat16, seed=S_k)
    assert _flash_route(q, k, v) == "sm90"
    _build.reset_launch_counts()
    got = _flash_fwd_cuda(q, k, v, 0.125, causal)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {FLASH_KERNEL: 1, FLASH_SM90_KERNEL: 1}
    _within_bf16_gate(got, q, k, v, 0.125, causal)


def test_sm90_kernel_reads_the_lm_views_in_place(cuda):
    """q, k, v as the LM makes them under AMP: views of one fused
    (B, S, 3, H, D) bf16 projection, read through their strides."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(2, 1024, 3, 12, 64, device=cuda,
                      generator=gen).bfloat16()
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous() and _flash_route(q, k, v) == "sm90"
    got = _flash_fwd_cuda(q, k, v, 0.125, True)
    _within_bf16_gate(got, q, k, v, 0.125, True)
    same = _flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                           0.125, True)
    assert torch.equal(got, same)


def test_sm90_kernel_reruns_bitwise(cuda):
    q, k, v = _qkv(cuda, 8, 12, 1024, 1024, 64, dtype=torch.bfloat16,
                   seed=3)
    first = _flash_fwd_cuda(q, k, v, 0.125, True)
    for _ in range(3):
        assert torch.equal(_flash_fwd_cuda(q, k, v, 0.125, True), first)


def test_sm90_and_mma_routes_agree_within_the_gate(cuda):
    """The same bf16 inputs through both kernels: each within the gate,
    and an impossible route raises before any launch."""
    q, k, v = _qkv(cuda, 2, 4, 300, 300, 64, dtype=torch.bfloat16, seed=9)
    for route in ("sm90", "mma"):
        _within_bf16_gate(_flash_fwd_cuda(q, k, v, 0.125, True,
                                          route=route), q, k, v, 0.125, True)
    odd = torch.zeros(1, 2, 64, 65, dtype=torch.bfloat16,
                      device=cuda)[..., :64]
    _build.reset_launch_counts()
    with pytest.raises(mx.MXNetError, match="route"):
        _flash_fwd_cuda(odd, odd, odd, 0.125, True, route="sm90")
    assert _build.launch_counts() == {}


def test_sm90_sass_holds_bf16_wgmma_and_no_tf32(cuda):
    """The sm90 library issues its products as bf16 HGMMA, never as TF32
    HMMA."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        pytest.skip("the CUDA toolkit here has no cuobjdump")
    _build.load(FLASH_SM90_KERNEL)
    sass = subprocess.run(
        [tool, "-sass", _build._library_path(FLASH_SM90_KERNEL)],
        capture_output=True, text=True, timeout=300, check=True).stdout
    assert re.search(r"HGMMA\.64x128x16\.F32\.BF16", sass)
    assert re.search(r"HGMMA\.64x64x16\.F32\.BF16", sass)
    assert not re.search(r"HMMA\.\S*TF32", sass)


def test_transformer_training_step_on_card_launches_k1(cuda):
    """One record/backward/Adam step of a small TransformerLM on the card
    against the same step on the CPU from the same weights: K1 launches
    once per layer, the loss and every gradient agree within 1e-4 (fp32
    matmuls summed in other orders), and the update keeps each
    parameter's tensor."""
    cfg = dict(vocab_size=64, embed_dim=64, num_layers=2, num_heads=4,
               max_len=128, tie_weights=True)
    mx.random.seed(5)
    src = TransformerLM(**cfg)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    toks = onp.random.RandomState(6).randint(0, 64, (2, 100))
    with mx.autograd.pause():
        src(mx.nd.array(toks, ctx=mx.cpu()))
    arrays = {k: p.data().asnumpy()
              for k, p in src._collect_params_with_prefix().items()}
    runs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        net = convert.params_from_numpy(TransformerLM(**cfg), arrays,
                                        ctx=ctx)
        t = mx.nd.array(toks.astype("int32"), ctx=ctx)
        tensors = {n: p.data().data for n, p in net.collect_params().items()}
        _build.reset_launch_counts()
        with mx.autograd.record():
            logits = net(t)
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                logits[:, :-1].reshape(-1, 64), t[:, 1:].reshape(-1)).mean()
        loss.backward()
        launches = _build.launch_counts().get(FLASH_KERNEL, 0)
        grads = {n: p.grad().asnumpy()
                 for n, p in net._collect_params_with_prefix().items()}
        mx.gluon.Trainer(net.collect_params(), "adam",
                         {"learning_rate": 1e-3}).step(2)
        assert all(p.data().data is tensors[n]
                   for n, p in net.collect_params().items())
        runs[ctx.device_type] = (loss.asscalar(), grads, launches)
    assert runs["gpu"][2] == cfg["num_layers"] and runs["cpu"][2] == 0
    onp.testing.assert_allclose(runs["gpu"][0], runs["cpu"][0], rtol=1e-4)
    for name, want in runs["cpu"][1].items():
        onp.testing.assert_allclose(runs["gpu"][1][name], want, rtol=1e-4,
                                    atol=1e-4, err_msg=name)


# -- K3 and the symbolic-serving path ----------------------------------------

def _k3_inputs(dev, rows, C, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, C, device=dev, generator=gen) * 2 + 0.5
    g = 1 + 0.1 * torch.randn(C, device=dev, generator=gen)
    b = 0.1 * torch.randn(C, device=dev, generator=gen)
    return x.to(dtype), g.to(dtype), b.to(dtype)


# the seven LayerNorm->GELU shapes of a bucket-8 forward of 10 s clips at
# wav2vec2-large-lv60's widths, then ragged rows and widths on each of
# the kernel's paths (scalar loads, a warp per row, a block per row)
_K3_SHAPES = [(8 * t, 512) for t in frames(WAV2VEC2_LARGE_LV60,
                                           10 * SAMPLE_RATE)] + [
    (1, 1), (3, 100), (517, 768), (64, 1024), (33, 1030), (250, MAX_C)]


@pytest.mark.parametrize("rows,C", _K3_SHAPES)
def test_k3_on_card_matches_plain(cuda, rows, C):
    x, g, b = _k3_inputs(cuda, rows, C)
    got = _norm_act_cuda(x, g, b, 1e-5, 8, 0.0)
    want = _norm_act_ref(x, g, b, 1e-5, 8, 0.0)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("code,slope", [(c, 0.3) for c in range(10)])
def test_k3_every_activation_code(cuda, code, slope):
    x, g, b = _k3_inputs(cuda, 301, 200)
    got = _norm_act_cuda(x, g, b, 1e-3, code, slope)
    want = _norm_act_ref(x, g, b, 1e-3, code, slope)
    assert torch.allclose(got, want, rtol=TOL, atol=TOL)


def test_k3_bfloat16_within_one_ulp(cuda):
    x, g, b = _k3_inputs(cuda, 999, 512, torch.bfloat16)
    got = _norm_act_cuda(x, g, b, 1e-5, 8, 0.0).float()
    want = _norm_act_ref(x, g, b, 1e-5, 8, 0.0).float()
    assert torch.allclose(got, want, rtol=2.0 ** -7, atol=TOL)


def test_k3_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    x, g, b = _k3_inputs(cuda, 4, 16)
    bad = [(x.double(), g.double(), b.double()), (x, g.double(), b),
           (x.t().contiguous().t(), g, b), (x[:, :8], g, b),
           _k3_inputs(cuda, 2, MAX_C + 4)]
    for args in bad:
        with pytest.raises(mx.MXNetError):
            _norm_act_cuda(*args, 1e-5, 8, 0.0)
    with pytest.raises(mx.MXNetError, match="several devices"):
        _norm_act_cuda(x, g.cpu(), b, 1e-5, 8, 0.0)


def test_symbolic_predict_on_card_launches_k3_and_k1(cuda, tmp_path,
                                                     monkeypatch):
    """A small wav2vec2 export served on the card: every fused cluster
    runs its kernel, each bucket execution launches K3 once per
    feature-encoder layer and K1 once per encoder layer, and the logits
    match the CPU port's within 1e-4 of the largest."""
    monkeypatch.setenv("MXNET_GRAPH_OPT", "1")
    cfg = dict(WAV2VEC2_LARGE_LV60, conv_dim=(32,) * 3,
               conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4), hidden_size=64,
               num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=4)
    samples = SAMPLE_RATE // 4
    prefix = str(tmp_path / "w")
    export_wav2vec2(prefix, mx.sym, mx.nd, cfg, 3)
    sess = serving.InferenceSession.load(
        prefix, input_shapes=[(1, samples, 1)], buckets=[1, 4], ctx=mx.gpu(0))
    x = onp.random.RandomState(2).randn(3, samples, 1).astype("float32")
    _build.reset_launch_counts()
    got = sess.predict(x).asnumpy()
    counts = _build.launch_counts()
    assert counts.get(NORM_ACT_KERNEL) == 3
    assert counts.get(FLASH_KERNEL) == 2
    graph = sess._block._optimized_outputs(mx.nd.zeros((4, samples, 1),
                                                       ctx=mx.gpu(0)))
    impls = [s._kwargs["impl"] for s in graph._walk()
             if s._op in ("_fused_norm_act", "_fused_attention")]
    assert impls == ["cuda"] * 5
    cpu = serving.InferenceSession.load(
        prefix, input_shapes=[(1, samples, 1)], buckets=[4],
        ctx=mx.cpu()).predict(x).asnumpy()
    scale = float(onp.abs(cpu).max())
    assert onp.allclose(got, cpu, rtol=1e-4, atol=1e-4 * scale)


def test_fused_attention_on_transposed_keys_launches_k1(cuda):
    """A graph whose keys are a transposed input (a permuted view, last
    axis strided) is fused onto K1 on the card: the op copies the
    operand contiguous, K1 launches once, and the result matches the
    unfused graph within 1e-5."""
    from mxnet_tpu_torch import nd, sym
    from mxnet_tpu_torch.analysis.graph_opt import optimize_symbol

    q, kt, v = sym.var("q"), sym.var("kt"), sym.var("v")
    k = sym.transpose(kt, axes=(0, 2, 1))
    sc = sym.broadcast_mul_scalar(sym.batch_dot(q, k, transpose_b=True),
                                  scalar=0.125)
    out = sym.batch_dot(sym.softmax(sc), v)
    shapes = {"q": (4, 70, 64), "kt": (4, 64, 70), "v": (4, 70, 64)}
    opt, st = optimize_symbol(out, shapes=shapes, level=1, device=cuda)
    assert not st["rejected"] and opt._op == "_fused_attention"
    assert opt._kwargs["impl"] == "cuda"
    rs = onp.random.RandomState(5)
    feed = {n: nd.array(rs.randn(*s).astype("float32"), ctx=mx.gpu(0))
            for n, s in shapes.items()}
    _build.reset_launch_counts()
    got = opt.eval_with(feed).asnumpy()
    assert _build.launch_counts().get(FLASH_KERNEL) == 1
    want = out.eval_with(feed).asnumpy()
    assert onp.allclose(got, want, rtol=TOL, atol=TOL)


# -- K4: rtc.CudaModule and the rtc_softmax head ------------------------------

DOUBLE_SRC = r"""
extern "C" __global__ void double_kernel(const float* x, float* y, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}
extern "C" __global__ void axpy(const float* x, float* y, float a, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += a * x[i];
}
template <class T>
__global__ void scale(T* x, T a, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] *= a;
}
extern "C" __global__ void big_shared(const float* x, float* y, int n) {
  extern __shared__ float buf[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
}
"""


@pytest.fixture
def rtc_module(cuda):
    return rtc.CudaModule(DOUBLE_SRC, exports=["scale<float>",
                                               "scale<double>"])


def test_rtc_double_and_axpy_match_torch_exactly(rtc_module):
    n = 2 ** 20 + 3
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(n, device="cuda", generator=gen)
    y = mx.nd.zeros((n,), ctx=mx.gpu(0))
    k = rtc_module.get_kernel("double_kernel", "const float* x, float* y, int n")
    _build.reset_launch_counts()
    assert k.launch([mx.nd.NDArray(x), y, n], mx.gpu(0),
                    ((n + 255) // 256, 1, 1), (256, 1, 1)) is None
    assert torch.equal(y.data, x * 2)
    y0 = torch.randn(n, device="cuda", generator=gen)
    y = mx.nd.NDArray(y0.clone())
    ax = rtc_module.get_kernel("axpy", "const float* x, float* y, float a, "
                                       "int n")
    ax.launch([x, y, 0.75, n], mx.gpu(0), ((n + 255) // 256, 1, 1),
              (256, 1, 1))
    assert torch.equal(y.data, torch.addcmul(y0, x, torch.tensor(
        0.75, device="cuda")))
    assert _build.launch_counts() == {"double_kernel": 1, "axpy": 1}


def test_rtc_exported_templates_in_float_and_double(rtc_module):
    for dtype, ctype in ((torch.float32, "float"), (torch.float64, "double")):
        x = torch.arange(1000, dtype=dtype, device="cuda")
        k = rtc_module.get_kernel(f"scale<{ctype}>",
                                  f"{ctype}* x, {ctype} a, int64_t n")
        k.launch([x, 0.5, 1000], mx.gpu(0), (4, 1, 1), (256, 1, 1))
        assert torch.equal(x, torch.arange(1000, dtype=dtype,
                                           device="cuda") * 0.5)


def test_rtc_dynamic_shared_memory_above_48k(rtc_module):
    n = 20000  # 80,000 bytes of dynamic shared memory
    x = torch.randn(n, device="cuda")
    y = torch.empty_like(x)
    k = rtc_module.get_kernel("big_shared", "const float* x, float* y, int n")
    k.launch([x, y, n], mx.gpu(0), (1, 1, 1), (256, 1, 1), shared_mem=4 * n)
    assert torch.equal(y, x.flip(0))


def test_rtc_launches_in_order_on_torch_stream(rtc_module):
    """Launches ride torch's current stream: work queued before is seen,
    work queued after sees the result, on a side stream too."""
    k = rtc_module.get_kernel("double_kernel", "const float* x, float* y, int n")
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        x = torch.full((1 << 22,), 3.0, device="cuda")
        x.mul_(2.0)  # queued before the launch
        y = torch.empty_like(x)
        k.launch([x, y, x.numel()], mx.gpu(0), (x.numel() // 256, 1, 1),
                 (256, 1, 1))
        z = y + 1.0  # queued after
    s.synchronize()
    assert torch.equal(z, torch.full_like(x, 13.0))


def test_rtc_launch_from_a_fresh_thread(rtc_module):
    """A thread that never touched CUDA has no current context; the
    launcher makes torch's primary context current first."""
    import threading

    x = torch.randn(4096, device="cuda")
    y = torch.zeros_like(x)
    k = rtc_module.get_kernel("double_kernel", "const float* x, float* y, int n")
    errors = []

    def run():
        try:
            k.launch([x, y, 4096], mx.gpu(0), (16, 1, 1), (256, 1, 1))
            torch.cuda.synchronize()
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and errors == []
    assert torch.equal(y, x * 2)


def test_rtc_failures_raise_on_card(rtc_module):
    with pytest.raises(mx.MXNetError, match="undefined_name"):
        rtc.CudaModule('extern "C" __global__ void f(float* x) '
                       '{ x[0] = undefined_name; }')
    k = rtc_module.get_kernel("double_kernel", "const float* x, float* y, int n")
    x = torch.zeros(8, device="cuda")
    with pytest.raises(mx.MXNetError, match="float64"):
        k.launch([x.double(), x, 8], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="GPU context"):
        k.launch([x, x, 8], mx.cpu(), (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="lies on cpu"):
        k.launch([x.cpu(), x, 8], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="contiguous"):
        k.launch([torch.zeros(8, 2, device="cuda")[:, 0], x, 8], mx.gpu(0),
                 (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="takes 3 arguments"):
        k.launch([x, x], mx.gpu(0), (1, 1, 1), (32, 1, 1))
    with pytest.raises(mx.MXNetError, match="cuLaunchKernel"):
        k.launch([x, x, 8], mx.gpu(0), (1, 1, 1), (2048, 1, 1))
    with pytest.raises(mx.MXNetError, match="cuModuleGetFunction"):
        rtc_module.get_kernel("no_such_kernel", "int n").launch(
            [1], mx.gpu(0), (1, 1, 1), (1, 1, 1))


@pytest.mark.parametrize("B,C", [(128, 1000), (64, 1001), (8, 4097),
                                 (3, 7)])
def test_rtc_softmax_kernels_match_plain(cuda, B, C):
    gen = torch.Generator(device="cuda").manual_seed(B + C)
    x = torch.randn(B, C, device="cuda", generator=gen) * 4
    label = torch.randint(0, C, (B,), device="cuda", generator=gen).float()
    y = torch.zeros_like(x)
    _build.reset_launch_counts()
    pr.softmax_fwd(x, y)
    p = pr.softmax_fwd_plain(x)
    torch.testing.assert_close(y, p, rtol=1e-6, atol=1e-6)
    dx = torch.zeros_like(x)
    pr.softmax_bwd(label, y, dx)
    torch.testing.assert_close(dx, pr.softmax_bwd_plain(label, y), rtol=1e-6,
                               atol=1e-6)
    pr.softmax_bwd(label, y, dx, "add")
    torch.testing.assert_close(dx, 2 * pr.softmax_bwd_plain(label, y),
                               rtol=1e-6, atol=1e-6)
    assert _build.launch_counts() == {pr.FWD_KERNEL: 1, pr.BWD_KERNEL: 2}
    xd = x.double()
    yd = torch.zeros_like(xd)
    pr.softmax_fwd(xd, yd)
    torch.testing.assert_close(yd, pr.softmax_fwd_plain(xd), rtol=1e-12,
                               atol=1e-12)


def test_resnet_steps_on_card_with_rtc_head_match_cpu(cuda):
    """SGD-momentum steps (lr 0.01) of resnet18_v1(thumbnail) with the
    rtc_softmax head, from the same weights, on the card and on the CPU:
    two K4 launches per step on the card (the head's double kernels in
    float64) and none on the CPU. Two steps in float64: the card's
    training matches the CPU's, losses within rtol 1e-6, every parameter
    and running statistic within 1e-6 of its scale. One step in float32:
    the loss within rtol 1e-5 and the classifier within 1e-3 of its
    scale. The deeper float32 parameters, and every later loss, carry the
    rounding of batch statistics over few values, which batch norm
    amplifies (the card sums them in float32, torch's CPU kernels in
    float64: up to 7% of an element, 2e-4 of the second loss here). The
    two heads' gradients on the card agree within 1e-4 of the largest
    entry."""
    mx.random.seed(3)
    src = vision.resnet18_v1(thumbnail=True, classes=10)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    rs = onp.random.RandomState(4)
    x = rs.randn(8, 3, 64, 64).astype("float32")
    y = rs.randint(0, 10, 8).astype("float32")
    with mx.autograd.pause():
        src(mx.nd.array(x, ctx=mx.cpu()))
    arrays = {k: p.data().asnumpy()
              for k, p in src._collect_params_with_prefix().items()}
    runs = {}
    for ctx, dtype in ((mx.cpu(), "float32"), (mx.cpu(), "float64"),
                       (mx.gpu(0), "float32"), (mx.gpu(0), "float64")):
        net = vision.resnet18_v1(thumbnail=True, classes=10)
        for p in net.collect_params().values():
            p.dtype = dtype
        convert.params_from_numpy(
            net, {k: v.astype(dtype) for k, v in arrays.items()}, ctx=ctx)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.01, "momentum": 0.9,
                                    "wd": 1e-4})
        xs = mx.nd.array(x, ctx=ctx, dtype=dtype)
        ys = mx.nd.array(y, ctx=ctx, dtype=dtype)
        _build.reset_launch_counts()
        losses = [pr.train_step(net, trainer, xs, ys).asscalar()
                  for _ in range(2 if dtype == "float64" else 1)]
        runs[ctx.device_type, dtype] = (losses, _build.launch_counts(), {
            k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()})
    assert runs["gpu", "float32"][1] == {pr.FWD_KERNEL: 1, pr.BWD_KERNEL: 1}
    assert runs["gpu", "float64"][1] == {"rtc_softmax_fwd<double>": 2,
                                         "rtc_softmax_bwd<double>": 2}
    assert runs["cpu", "float32"][1] == {}
    card, cpu = runs["gpu", "float64"], runs["cpu", "float64"]
    onp.testing.assert_allclose(card[0], cpu[0], rtol=1e-6)
    for k, want in cpu[2].items():
        scale = float(onp.abs(want).max()) or 1.0
        onp.testing.assert_allclose(card[2][k], want, rtol=0,
                                    atol=1e-6 * scale, err_msg=k)
    card, cpu = runs["gpu", "float32"], runs["cpu", "float32"]
    onp.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for k in ("output.weight", "output.bias"):
        scale = float(onp.abs(cpu[2][k]).max())
        onp.testing.assert_allclose(card[2][k], cpu[2][k], rtol=0,
                                    atol=1e-3 * scale, err_msg=k)
    net = convert.params_from_numpy(
        vision.resnet18_v1(thumbnail=True, classes=10), arrays, ctx=mx.gpu(0))
    xs, ys = mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(y, ctx=mx.gpu(0))
    grads = []
    for head in ("rtc", "loss"):
        with mx.autograd.record():
            out = net(xs)
            h = pr.rtc_softmax(out, ys) if head == "rtc" else \
                mx.gluon.loss.SoftmaxCrossEntropyLoss()(out, ys)
        h.backward()
        grads.append({k: p.grad().asnumpy() for k, p in
                      net._collect_params_with_prefix().items()
                      if p.grad_req != "null"})
    scale = max(float(onp.abs(g).max()) for g in grads[1].values())
    for k, want in grads[1].items():
        assert onp.abs(grads[0][k] - want).max() <= 1e-4 * scale, k


def test_decode_step_at_batch_one_splits_and_counts_per_layer(cuda):
    """One decode step of GPT-2-small widths at batch 1: K2 splits its
    key sweep there, and its counter still rises by one per layer."""
    cfg = dict(vocab_size=50257, embed_dim=768, num_layers=12,
               num_heads=12, ffn_dim=3072, max_len=1024)
    assert _decode_splits(1, 12, 1024, _n_sm(cuda))[0] > 1
    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = DecoderBlockLM(**cfg)
    net.initialize(ctx=ctx)
    states = [mx.nd.zeros((1,) + s, ctx=ctx, dtype=dt) for s, dt in
              zip(net.state_row_shapes(), net.state_row_dtypes())]
    tok = mx.nd.array(onp.array([[17]], "int32"), ctx=ctx)
    with mx.autograd.pause():
        out, *states = net(tok, *states)  # finishes the deferred shapes
        _build.reset_launch_counts()
        out, *states = net(tok, *states)
    torch.cuda.synchronize()
    assert _build.launch_counts().get(KERNEL, 0) == cfg["num_layers"]
    assert out.shape == (1, cfg["vocab_size"])
    assert onp.isfinite(out.asnumpy()).all()


# -- slice 5: graphs per occupancy bucket, paged store, conv precision ------

def _decode_stack(net, ctx, page_tokens, buckets, graphs=None, rows=4):
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=rows,
        byte_budget=0, ttl_s=0, pageable=net.state_row_pageable(),
        page_tokens=page_tokens, ctx=ctx)
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=buckets, graphs=graphs, ctx=ctx)
    return store, sess


def test_graph_replay_matches_eager_at_every_bucket(cuda):
    """At every occupancy bucket, one step from the same random states:
    the captured graph's replay against the eager step. The same kernels
    run, so they are expected bitwise equal; held within 1e-5 in case
    cuBLAS picks another algorithm under capture. K2 counts one launch
    per layer per replay, none for the capture."""
    ctx = mx.gpu(0)
    net = _carried_net(None, ctx)
    rs = onp.random.RandomState(11)
    got = {}
    for graphs in (False, True):
        store, sess = _decode_stack(net, ctx, 4, [1, 2, 4], graphs=graphs)
        assert sess.graphs is graphs
        for b in (1, 2, 3, 4):
            states = [rs.randint(0, 12, (b,) + s).astype(dt)
                      if dt == "int32" else
                      rs.standard_normal((b,) + s).astype(dt)
                      for s, dt in zip(net.state_row_shapes(),
                                       net.state_row_dtypes())]
            tok = rs.randint(0, SMALL["vocab_size"], (b, 1)).astype("int32")
            _build.reset_launch_counts()
            out, news = sess.step(tok, states=states)
            torch.cuda.synchronize()
            assert _build.launch_counts() == {KERNEL: SMALL["num_layers"]}
            got[graphs, b] = [out.asnumpy()] + [n.asnumpy() for n in news]
        stats = sess.graph_stats()
        assert all(g["graph"] is graphs for g in stats.values())
        if graphs:
            assert [stats[b]["replays"] for b in (1, 2, 4)] == [1, 1, 2]
        sess.close()
        store.close()
        rs = onp.random.RandomState(11)
    for b in (1, 2, 3, 4):
        for e, g in zip(got[False, b], got[True, b]):
            onp.testing.assert_allclose(g, e, rtol=TOL, atol=TOL)


def test_paged_matches_row_slot_on_card(cuda):
    """The same streams through the batcher on a paged and on a row-slot
    store, one bucket (4), graphs on: bitwise-equal logits, since both
    stores hand the step the same dense rows."""
    ctx = mx.gpu(0)
    net = _carried_net(None, ctx)
    rs = onp.random.RandomState(12)
    streams = {sid: [rs.randint(0, SMALL["vocab_size"], (1, 1))
                     .astype("int32") for _ in range(n)]
               for sid, n in (("a", 3), ("b", 9), ("c", 16))}
    got = {}
    for pt in (4, 0):
        store, sess = _decode_stack(net, ctx, pt, [4])
        bat = serving.DynamicBatcher(sess, max_batch_size=4,
                                     max_latency_ms=2.0, timeout_ms=120000,
                                     admission=False)
        try:
            futs = {sid: [bat.submit(t, session_id=sid) for t in toks]
                    for sid, toks in streams.items()}
            got[pt] = {sid: [onp.asarray(f.result(timeout=300))
                             for f in fs] for sid, fs in futs.items()}
            if pt:
                assert store.stats()["pages_used"] == 1 + 3 + 4
        finally:
            bat.close()
            sess.close()
            store.close()
    for sid in streams:
        for a, b in zip(got[4][sid], got[0][sid]):
            assert onp.array_equal(a, b)


class _Syncs(mx.gluon.HybridBlock):
    """A step that waits on the host: legal eagerly, not in a capture."""

    def hybrid_forward(self, F, tok, state):
        float(state.data.sum())  # a device-to-host read
        return tok * 2, state + 1


def test_failed_capture_raises_without_fallback(cuda):
    ctx = mx.gpu(0)
    store = serving.SessionStateStore([(3,)], ["float32"], max_sessions=2,
                                      byte_budget=0, ctx=ctx)
    sess = serving.InferenceSession(_Syncs(), input_shapes=[(1, 1)],
                                    state_store=store, buckets=[2],
                                    warm=False, ctx=ctx)
    try:
        for _ in range(2):  # no entry is left behind: it fails again
            with pytest.raises(mx.MXNetError, match="CUDA graph failed"):
                sess.warmup()
            assert sess.graph_stats() == {}
        with pytest.raises(mx.MXNetError, match="CUDA graph failed"):
            sess.step(onp.ones((1, 1), "float32"),
                      states=[onp.zeros((1, 3), "float32")])
        torch.cuda.synchronize()
        # the same block runs eagerly when asked to, on a fresh session
        eager = serving.InferenceSession(_Syncs(), input_shapes=[(1, 1)],
                                         state_store=store, buckets=[2],
                                         graphs=False, ctx=ctx)
        out, news = eager.step(onp.ones((1, 1), "float32"),
                               states=[onp.zeros((1, 3), "float32")])
        assert out.asnumpy().tolist() == [[2.0]]
        assert news[0].asnumpy().tolist() == [[1.0, 1.0, 1.0]]
    finally:
        sess.close()
        store.close()


def test_fp32_convolution_at_default_flags_matches_cpu(cuda):
    """With cuDNN's global flags at torch's defaults (``allow_tf32``
    True, ``benchmark`` False), the port's convolutions stay float32.
    Three stacked 3x3 convolutions of 256 channels (4.6 k-term sums, no
    activation: nothing but the convolutions' arithmetic) on the card
    and on the CPU: the output and the gradients of the input and of
    every weight within 1e-4 of their largest entry, where one TF32
    pass (10 mantissa bits, ~5e-4 of each product) lands above it; and
    a resnet18_v1 (thumbnail) eval forward and its classifier's gradient
    within rtol 1e-3 of the CPU. (Deeper gradients of the ReLU network
    are left out: an activation that flips sign between the two
    computations moves them by more than the precision does.)"""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = \
        True, False
    try:
        rs = onp.random.RandomState(21)
        x = rs.standard_normal((2, 256, 14, 14)).astype("float32")
        ws = [rs.standard_normal((256, 256, 3, 3)).astype("float32") / 48
              for _ in range(3)]
        runs = []
        for ctx in (mx.gpu(0), mx.cpu()):
            xs = mx.nd.array(x, ctx=ctx)
            wn = [mx.nd.array(w, ctx=ctx) for w in ws]
            for t in [xs] + wn:
                t.attach_grad()
            with mx.autograd.record():
                h = xs
                for w in wn:
                    h = mx.nd.convolution(h, w, kernel=(3, 3), pad=(1, 1),
                                          num_filter=256, no_bias=True)
            h.backward(mx.nd.array(onp.linspace(
                -1, 1, h.size, dtype="float32").reshape(h.shape), ctx=ctx))
            runs.append([h.asnumpy(), xs.grad.asnumpy()] +
                        [w.grad.asnumpy() for w in wn])
        for card, cpu in zip(*runs):
            scale = float(onp.abs(cpu).max())
            assert onp.abs(card - cpu).max() <= 1e-4 * scale
        assert torch.backends.cudnn.allow_tf32  # the global flag untouched
        mx.random.seed(5)
        src = vision.resnet18_v1(thumbnail=True, classes=10)
        src.initialize(mx.init.Xavier(), ctx=mx.cpu())
        xb = rs.standard_normal((2, 3, 32, 32)).astype("float32")
        yb = rs.randint(0, 10, 2).astype("float32")
        with mx.autograd.pause():
            src(mx.nd.array(xb, ctx=mx.cpu()))
        arrays = {k: p.data().asnumpy()
                  for k, p in src._collect_params_with_prefix().items()}
        runs = []
        for ctx in (mx.gpu(0), mx.cpu()):
            net = convert.params_from_numpy(
                vision.resnet18_v1(thumbnail=True, classes=10), arrays,
                ctx=ctx)
            xs, ys = mx.nd.array(xb, ctx=ctx), mx.nd.array(yb, ctx=ctx)
            with mx.autograd.record(train_mode=False):
                logits = net(xs)
                loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(logits, ys)
            loss.backward()
            params = net._collect_params_with_prefix()
            runs.append([logits.asnumpy(),
                         params["output.weight"].grad().asnumpy()])
        for card, cpu in zip(*runs):
            scale = float(onp.abs(cpu).max())
            onp.testing.assert_allclose(card, cpu, rtol=1e-3,
                                        atol=1e-3 * scale)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = \
            saved


# -- slice 6: bf16 AMP and the fused step on the card ------------------------

def _card_params(n=6, dim=64, seed=0, dtype="float32"):
    from mxnet_tpu_torch.gluon.parameter import Parameter

    rs = onp.random.RandomState(seed)
    params = []
    for i in range(n):
        shape = (dim, dim) if i % 2 == 0 else (dim,)
        p = Parameter(f"p{i}", shape=shape, dtype=dtype)
        p.initialize(ctx=mx.gpu(0))
        p.set_data(rs.randn(*shape).astype("f"))
        params.append(p)
    return params


def _card_grads(params, step, poison=False):
    rs = onp.random.RandomState(100 + step)
    for p in params:
        g = onp.full(p.shape, onp.inf, "f") if poison else \
            rs.randn(*p.shape).astype("f") * 0.1
        p.grad().data.copy_(torch.from_numpy(g))


@pytest.fixture
def fused(cuda):
    from mxnet_tpu_torch.gluon import fused_step

    saved = os.environ.pop("MXNET_FUSED_STEP", None)
    fused_step.reset_fused_step_cache()
    yield fused_step
    os.environ.pop("MXNET_FUSED_STEP", None)
    if saved is not None:
        os.environ["MXNET_FUSED_STEP"] = saved
    fused_step.reset_fused_step_cache()


def test_fused_step_captures_once_and_replays(fused):
    """One CUDA graph per signature: captured at the first step, replayed
    every step; a new learning rate, a scheduler's rate and the loss
    scale's growth change device scalars, never the graph."""
    from mxnet_tpu_torch.contrib.amp import LossScaler

    params = _card_params()
    tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                          "momentum": 0.9})
    tr._amp_loss_scaler = LossScaler(init_scale=4.0, scale_window=2)
    for s in range(5):
        if s == 3:
            tr.set_learning_rate(0.01)
        _card_grads(params, s)
        tr.step(1)
    st = fused.fused_step_stats()
    assert st["captures"] == 1 and st["replays"] == 5 and st["misses"] == 1
    assert tr._amp_loss_scaler.loss_scale == 16.0  # grew twice on device


def test_fused_graph_matches_eager_bitwise(fused):
    """The captured fused step (AMP scaler included) against the eager
    per-parameter loop from the same weights and gradients: the same
    bits, through a poisoned step and a growth of the scale."""
    from mxnet_tpu_torch.contrib.amp import LossScaler

    runs = []
    for flag in ("1", "0"):
        os.environ["MXNET_FUSED_STEP"] = flag
        params = _card_params()
        tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                              "momentum": 0.9, "wd": 1e-4})
        tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 8,
                                         scale_window=3)
        for s in range(6):
            _card_grads(params, s, poison=(s == 2))
            tr.step(4)
        runs.append(([p.data().asnumpy() for p in params],
                     tr._amp_loss_scaler.loss_scale))
    (wf, sf), (we, se) = runs
    assert sf == se
    assert all(a.tobytes() == b.tobytes() for a, b in zip(wf, we))


def test_fused_graph_matches_eager_on_a_resnet50_step(fused):
    """One ResNet-50 SGD step (batch 8, 64 x 64): the same gradients
    through the captured fused step and through the eager loop give the
    same weights and momenta, bit for bit."""
    mx.random.seed(11)
    net = vision.resnet50_v1(classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rs = onp.random.RandomState(12)
    x = mx.nd.array(rs.randn(8, 3, 64, 64).astype("f"), ctx=mx.gpu(0))
    y = mx.nd.array(rs.randint(0, 10, 8).astype("f"), ctx=mx.gpu(0))
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    w0 = [p.data().data.clone() for p in params]
    results = []
    for flag in ("1", "0"):
        os.environ["MXNET_FUSED_STEP"] = flag
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.data().data.copy_(w)
        tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                              "momentum": 0.9, "wd": 1e-4})
        tr.step(8)
        tr.step(8)  # a second step reads the momenta the first wrote
        results.append(([p.data().data.clone() for p in params],
                        [s.data.clone() for s in tr._states]))
    assert fused.fused_step_stats()["replays"] == 2
    for a, b in zip(results[0][0] + results[0][1],
                    results[1][0] + results[1][1]):
        assert torch.equal(a, b)


def test_step_and_scale_loss_make_no_host_sync(fused):
    """After the first (capturing) step, ``amp.scale_loss`` and
    ``Trainer.step`` on the fused path never wait for the device: torch's
    sync debug mode raises on any synchronizing call inside them."""
    from mxnet_tpu_torch.contrib import amp

    amp.init("bfloat16")
    try:
        net = mx.gluon.nn.Dense(16, in_units=32)
        net.initialize(ctx=mx.gpu(0))
        tr = mx.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 1e-3})
        amp.init_trainer(tr)
        x = mx.nd.array(onp.random.RandomState(0).randn(8, 32).astype("f"),
                        ctx=mx.gpu(0))

        def step(check):
            with mx.autograd.record():
                loss = net(x).sum()
                torch.cuda.set_sync_debug_mode("error" if check else 0)
                try:
                    with amp.scale_loss(loss, tr) as scaled:
                        pass
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                scaled.backward()
            torch.cuda.set_sync_debug_mode("error" if check else 0)
            try:
                tr.step(8)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        step(False)  # captures (a capture synchronizes once)
        for _ in range(3):
            step(True)
        torch.cuda.synchronize()
        assert fused.fused_step_stats()["replays"] == 4
    finally:
        amp.disable()


def test_poisoned_step_on_card_is_skipped_bitwise(fused):
    from mxnet_tpu_torch.contrib.amp import LossScaler

    params = _card_params(dtype="float32")
    tr = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
    tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 10)
    for s in range(2):
        _card_grads(params, s)
        tr.step(1)
    w0 = [p.data().data.clone() for p in params]
    s0 = [(m.data.clone(), v.data.clone()) for m, v in tr._states]
    _card_grads(params, 2, poison=True)
    tr.step(1)
    assert all(torch.equal(a, p.data().data) for a, p in zip(w0, params))
    assert all(torch.equal(m0, m.data) and torch.equal(v0, v.data)
               for (m0, v0), (m, v) in zip(s0, tr._states))
    assert tr._amp_loss_scaler.loss_scale == 2.0 ** 9
    assert fused.fused_step_stats()["skipped_steps"] == 1


def test_forced_capture_failure_raises_without_fallback(fused):
    """A capture that fails raises MXNetError: the card runs the fused
    step only as a graph, with no silent eager fallback (the JAX
    trainer's ``_fused_broken``); the parameters are untouched."""
    from mxnet_tpu_torch.resilience import faults

    params = _card_params()
    tr = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    _card_grads(params, 0)
    w0 = [p.data().data.clone() for p in params]
    with faults.inject("fused_step_capture", every=1):
        with pytest.raises(mx.MXNetError, match="CUDA graph"):
            tr.step(1)
    assert all(torch.equal(a, p.data().data) for a, p in zip(w0, params))
    assert fused.fused_step_stats()["captures"] == 0
    tr.step(1)  # disarmed: captures and steps
    assert fused.fused_step_stats()["captures"] == 1


def test_batch_norm_one_pass_statistics_on_card(cuda):
    """cuDNN's batch norm hands back the batch mean and (converted from
    its unbiased form) the biased variance from the one pass: within
    1e-5 of float64 at n = 2 and 128 values per channel, and in bf16
    with float32 parameters (a cast network)."""
    for shape in ((2, 3, 1, 1), (2, 3, 8, 8), (64, 32, 14, 14)):
        C = shape[1]
        rs = onp.random.RandomState(C)
        x = (rs.randn(*shape) * 2 + 0.5).astype("f")
        args = [mx.nd.array(a, ctx=mx.gpu(0)) for a in
                (x, onp.ones(C, "f"), onp.zeros(C, "f"), onp.zeros(C, "f"),
                 onp.ones(C, "f"))]
        out, mean, var = mx.nd.batch_norm(*args, eps=1e-5, fix_gamma=False,
                                          output_mean_var=True,
                                          use_batch_stats=True)
        x64 = x.astype("float64").transpose(1, 0, 2, 3).reshape(C, -1)
        onp.testing.assert_allclose(mean.asnumpy(), x64.mean(1), rtol=1e-5,
                                    atol=1e-6)
        onp.testing.assert_allclose(var.asnumpy(), x64.var(1), rtol=1e-5,
                                    atol=1e-6)
        half = mx.nd.batch_norm(args[0].astype("bfloat16"), *args[1:],
                                eps=1e-5, fix_gamma=False,
                                use_batch_stats=True)
        assert str(half.dtype) == "bfloat16"
        onp.testing.assert_allclose(half.asnumpy().astype("f"),
                                    out.asnumpy(), rtol=2.0 ** -7, atol=2e-2)


def test_bf16_amp_lm_step_on_card_launches_k1_in_bf16(cuda):
    """A TransformerLM step under bf16 AMP on the card: K1 runs on the
    bf16 q, k and v (one launch per layer), the loss and every gradient
    are finite, and the loss is within 2e-2 of the CPU port's bf16
    loss from the same weights."""
    from mxnet_tpu_torch.contrib import amp

    cfg = dict(vocab_size=64, embed_dim=64, num_layers=2, num_heads=4,
               max_len=64, tie_weights=True)
    toks = onp.random.RandomState(2).randint(0, 64, (2, 64)).astype("f")
    mx.random.seed(4)
    src = TransformerLM(**cfg)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    with mx.autograd.pause():
        src(mx.nd.array(toks, ctx=mx.cpu()))
    arrays = {k: p.data().asnumpy()
              for k, p in src._collect_params_with_prefix().items()}
    losses = []
    amp.init("bfloat16")
    try:
        for ctx in (mx.gpu(0), mx.cpu()):
            net = convert.params_from_numpy(TransformerLM(**cfg), arrays,
                                            ctx=ctx)
            t = mx.nd.array(toks, ctx=ctx)
            _build.reset_launch_counts()
            with mx.autograd.record():
                logits = net(t)
                loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                    logits[:, :-1].reshape(-1, 64),
                    t[:, 1:].reshape(-1)).mean()
            loss.backward()
            assert str(logits.dtype) == "bfloat16"
            losses.append(loss.asscalar())
            if ctx.device_type == "gpu":
                assert _build.launch_counts() == {FLASH_KERNEL: 2}
                for p in net.collect_params().values():
                    assert torch.isfinite(p.grad().data).all()
    finally:
        amp.disable()
    onp.testing.assert_allclose(losses[0], losses[1], rtol=2e-2)


# -- hybridize: CachedOp as captured CUDA graphs, and DeviceFeed ------------

def _mlp_bn(seed, ctx):
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(64, activation="relu", in_units=32),
            mx.gluon.nn.BatchNorm(in_channels=64),
            mx.gluon.nn.Dense(10, in_units=64))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _grads_of(net):
    return {k: p.grad().data.clone()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def test_hybridized_equals_eager_forward_backward_and_stats(cuda):
    """The captured forward and backward run the eager path's kernels:
    outputs, gradients and batch norm's running statistics bitwise equal
    over three recorded steps and an eval call; one capture for the
    recorded signature and one replay per call."""
    ctx = mx.gpu(0)
    eager, hyb = _mlp_bn(1, ctx), _mlp_bn(1, ctx)
    hyb.hybridize()
    mx.gluon.reset_cached_op_stats()
    rs = onp.random.RandomState(0)
    for _ in range(3):
        x = mx.nd.array(rs.randn(16, 32).astype("f"), ctx=ctx)
        ys = []
        for net in (eager, hyb):
            with mx.autograd.record():
                y = net(x)
                (y * y).sum().backward()
            ys.append(y.data)
        assert torch.equal(ys[0], ys[1])
        ge, gh = _grads_of(eager), _grads_of(hyb)
        assert all(torch.equal(ge[k], gh[k]) for k in ge)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(eager[1], name).data().data,
                           getattr(hyb[1], name).data().data)
    st = mx.gluon.cached_op_stats()
    assert st["captures"] == 1 and st["replays"] == 3
    assert st["backward_replays"] == 3
    ent = next(iter(hyb._cached_op.entries.values()))
    assert ent.graph is not None and ent.bwd is not None
    with mx.autograd.predict_mode():
        assert torch.equal(eager(x).data, hyb(x).data)


def test_hybridized_dropout_draws_fresh_masks_per_replay(cuda):
    """The device generator is registered with the graph: each replay
    draws a new mask, and the keep rate is 1 - p."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dropout(0.5))
    net.initialize(ctx=mx.gpu(0))
    net.hybridize()
    x = mx.nd.ones((1000, 100), ctx=mx.gpu(0))
    masks = []
    for _ in range(3):
        with mx.autograd.train_mode():
            masks.append(net(x).data != 0)
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])
    keep = float(masks[0].float().mean())
    assert abs(keep - 0.5) < 0.01, keep
    ent = next(iter(net._cached_op.entries.values()))
    assert ent.replays == 3


def test_hybridized_lm_counts_k1_per_replay_on_sm90(cuda):
    """A bf16 TransformerLM hybridized: K1 runs inside the captured
    forward, its launches counted per replay (one per layer per step,
    every one on the sm90 kernel); logits and weights bitwise equal to
    the eager run's after two steps."""
    from mxnet_tpu_torch.contrib import amp

    cfg = dict(vocab_size=500, embed_dim=128, num_layers=2, num_heads=2,
               ffn_dim=256, max_len=128, tie_weights=True)
    toks = mx.nd.array(onp.random.RandomState(0).randint(
        0, 500, (4, 128)).astype("int32"), ctx=mx.gpu(0))
    lf = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    amp.init("bfloat16")
    runs = []
    try:
        for hyb in (False, True):
            mx.random.seed(3)
            net = TransformerLM(**cfg)
            net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 1e-3})
            amp.init_trainer(tr)
            if hyb:
                net.hybridize()
            logits = []
            for step in range(3):
                if step == 1:
                    _build.reset_launch_counts()
                with mx.autograd.record():
                    lg = net(toks)
                    loss = lf(lg[:, :-1].reshape(-1, 500),
                              toks[:, 1:].reshape(-1)).mean()
                    with amp.scale_loss(loss, tr) as sc:
                        sc.backward()
                tr.step(4)
                logits.append(lg.data.clone())
            runs.append((net, logits, _build.launch_counts()))
    finally:
        amp.disable()
    (a, la, ca), (b, lb, cb) = runs
    assert cb == ca == {FLASH_KERNEL: 4, FLASH_SM90_KERNEL: 4}
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    pa, pb = a._collect_params_with_prefix(), b._collect_params_with_prefix()
    assert all(torch.equal(pa[k].data().data, pb[k].data().data) for k in pa)
    ent = next(iter(b._cached_op.entries.values()))
    assert ent.fwd_launches == {FLASH_KERNEL: 2, FLASH_SM90_KERNEL: 2}


def test_hybridized_capture_of_a_host_sync_raises(cuda):
    """A forward that syncs with the host cannot be captured: MXNetError
    naming the block and the signature, no eager fallback; the card
    works afterwards."""
    class Sync(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * float(x.asnumpy().sum() > 0)

    blk = Sync()
    blk.hybridize()
    with pytest.raises(mx.MXNetError, match="Sync .*signature"):
        blk(mx.nd.ones((4,), ctx=mx.gpu(0)))
    assert (mx.nd.ones((3,), ctx=mx.gpu(0)) * 2).asnumpy().tolist() == \
        [2.0, 2.0, 2.0]


def test_hybridized_second_signature_captures_anew(cuda):
    net = _mlp_bn(2, mx.gpu(0))
    net.hybridize()
    mx.gluon.reset_cached_op_stats()
    for B in (8, 8, 16, 16, 8):
        with mx.autograd.predict_mode():
            net(mx.nd.ones((B, 32), ctx=mx.gpu(0)))
    st = mx.gluon.cached_op_stats()
    assert st["captures"] == 2 and st["replays"] == 5
    assert sorted(e.replays for e in net._cached_op.entries.values()) == \
        [2, 3]


def test_hybridized_second_recorded_call_before_backward_raises(cuda):
    """A recorded call whose backward runs only after a later record()
    scope called the block again raises: the later call reused its
    slot's graphs and overwrote the activations."""
    net = _mlp_bn(3, mx.gpu(0))
    net.hybridize()
    x = mx.nd.ones((4, 32), ctx=mx.gpu(0))
    with mx.autograd.record():
        l1 = net(x).sum()
    with mx.autograd.record():
        l2 = net(x).sum()  # a later scope: the first slot again
    with pytest.raises(mx.MXNetError, match="before this call's backward"):
        mx.autograd.backward([l1])
    mx.autograd.backward([l2])
    assert torch.isfinite(net[0].weight.grad().data).all()


def test_hybridized_block_called_twice_in_one_record_matches_eager(cuda):
    """Two recorded calls of one signature in one scope before the
    backward (a GAN's discriminator on real and on fake data) take two
    slots, each captured: the gradients equal the eager block's."""
    x1 = mx.nd.array(onp.random.RandomState(0).randn(4, 32).astype("f"),
                     ctx=mx.gpu(0))
    x2 = mx.nd.array(onp.random.RandomState(1).randn(4, 32).astype("f"),
                     ctx=mx.gpu(0))
    grads, losses = [], []
    for hybrid in (False, True):
        net = _mlp_bn(4, mx.gpu(0))
        if hybrid:
            net.hybridize()
        for _ in range(2):  # the second round replays both slots
            with mx.autograd.record():
                loss = net(x1).sum() + 2 * net(x2).sum()
            loss.backward()
        losses.append(float(loss.asscalar()))
        grads.append(_grads_of(net))
    assert len(net._cached_op.entries) == 2
    assert onp.isclose(losses[0], losses[1], rtol=1e-6)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5,
                                   atol=1e-6)


def test_device_feed_overlaps_and_never_hands_out_reused_memory(cuda):
    """DeviceFeed stages on its own stream; the consumer waits on the
    batch's event. A batch handed out stays intact while the source
    rewrites its host buffer and the allocator hands out new blocks."""
    from mxnet_tpu_torch.pipeline import DeviceFeed

    host = torch.zeros((1 << 20,), dtype=torch.float32).pin_memory()

    def gen():
        for i in range(6):
            host.fill_(float(i))
            yield host

    feed = DeviceFeed(gen(), depth=2, device=mx.gpu(0))
    assert feed._stream is not None
    assert feed._stream != torch.cuda.current_stream()
    got = []
    for b in feed:
        scratch = [torch.full((1 << 20,), -1.0, device="cuda")
                   for _ in range(4)]
        got.append(b)
        del scratch
    torch.cuda.synchronize()
    assert [float(b.data[0]) for b in got] == [0, 1, 2, 3, 4, 5]
    assert all(bool((b.data == b.data[0]).all()) for b in got)


# -- symbolic training: the executor, Module and the fused RNN ---------------


def test_rnn_cudnn_is_float32_accurate_in_the_ports_scope(cuda):
    """cuDNN's LSTM against the op's plain version (the JAX step
    arithmetic) on the card, forward and the backward in the scope the
    port's backward runs in (``autograd._torch_grad``): float32, not
    TF32 (2e-5 of the largest value; TF32 misses it by 10x)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray import ops_nn

    gen = torch.Generator(device=cuda).manual_seed(0)
    T, N, E, H, L = 12, 8, 256, 256, 2
    size = ops_nn.rnn_param_size(L, E, H, False, "lstm")
    base = [torch.randn(T, N, E, device=cuda, generator=gen),
            (torch.rand(size, device=cuda, generator=gen) - 0.5) * 0.2,
            torch.randn(L, N, H, device=cuda, generator=gen) * 0.5,
            torch.randn(L, N, H, device=cuda, generator=gen) * 0.5]
    cot = [torch.randn(T, N, H, device=cuda, generator=gen),
           torch.randn(L, N, H, device=cuda, generator=gen),
           torch.randn(L, N, H, device=cuda, generator=gen)]
    res = []
    for fn in (ops_nn.rnn, ops_nn.rnn_plain):
        ins = [t.clone().requires_grad_(True) for t in base]
        outs = fn(*ins, state_size=H, num_layers=L, mode="lstm")
        grads = autograd._torch_grad(list(outs), ins, cot,
                                     retain_graph=False)
        res.append([o.detach() for o in outs] + list(grads))
    for a, b in zip(*res):
        err = float((a - b).abs().max() / b.abs().max())
        assert err < 2e-5, err


def _tiny_word_lm(det=True):
    from mxnet_tpu_torch.tools import profile_module as pm

    cfg = dict(vocab=200, embed=64, hidden=64, layers=2,
               dropout=0.0 if det else 0.5, bptt=12, batch=4)
    toks = pm.markov_tokens(cfg["bptt"] * cfg["batch"] * 5 + 1,
                            cfg["vocab"], 3)
    return pm, cfg, pm.bptt_batches(toks, cfg["bptt"], cfg["batch"])


def test_executor_captured_equals_eager_bitwise(cuda):
    pm, cfg, batches = _tiny_word_lm()
    ctx = mx.gpu(0)
    w0 = None
    runs = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        for graphs in (False, True):
            with pm.bind_mode(mx, graphs):
                mod = pm.word_lm_module(mx, cfg, ctx, arg_params=w0)
            if w0 is None:
                w0 = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
            eager0 = mx.executor.executor_stats()["eager_forwards"]
            outs, states = [], None
            for b in batches:
                _, states = pm.word_lm_train(mx, mod, [b], cfg, ctx,
                                             states=states)
                outs.append(mod.get_outputs()[0].asnumpy())
            eager = mx.executor.executor_stats()["eager_forwards"] - eager0
            runs.append((outs, {k: v.asnumpy() for k, v in
                                mod.get_params()[0].items()}, mod, eager))
    (eo, ew, emod, e_eager), (co, cw, cmod, c_eager) = runs
    # the eager module never captured, the captured one never ran eagerly
    assert emod._exec.graph_info() == [] and e_eager == len(batches)
    (info,) = cmod._exec.graph_info()
    assert info["is_train"] and info["replays"] == len(batches) == \
        info["backward_replays"] and c_eager == 0
    for a, b in zip(eo, co):
        assert onp.array_equal(a, b)
    for k in ew:
        assert onp.array_equal(ew[k], cw[k]), k


def test_executor_dropout_replays_draw_fresh_masks(cuda):
    pm, cfg, batches = _tiny_word_lm(det=False)
    ctx = mx.gpu(0)
    mod = pm.word_lm_module(mx, cfg, ctx)
    x, y = batches[0]
    outs = []
    for _ in range(3):
        h = mx.nd.zeros((2, 4, 64), ctx=ctx)
        batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu()), h, h],
                                [mx.nd.array(y, ctx=mx.cpu())])
        mod.forward(batch, is_train=True)
        outs.append(mod.get_outputs()[0].asnumpy())
    assert not onp.array_equal(outs[0], outs[1])
    assert not onp.array_equal(outs[1], outs[2])
    assert mod._exec.graph_info()[0]["replays"] == 3


def test_executor_capture_failure_raises(cuda):
    from mxnet_tpu_torch.resilience import faults

    sym = mx.sym.make_loss(mx.sym.sum(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=3, name="fc")), name="l")
    ex = sym.simple_bind(ctx=mx.gpu(0), data=(2, 4))
    with faults.inject("executor_capture", every=1):
        with pytest.raises(mx.MXNetError, match="capturing the bound graph"):
            ex.forward(is_train=True)
    ex.forward(is_train=True)
    ex.backward()
    assert float(ex.grad_dict["fc_bias"].asnumpy().sum()) == 6.0


def test_training_bind_never_launches_k3_on_a_graph_with_gradients(cuda,
                                                                   monkeypatch):
    sym = mx.sym
    x = sym.Variable("data")
    y = sym.LeakyReLU(sym.LayerNorm(x, sym.Variable("g"), sym.Variable("b"),
                                    name="ln"), act_type="gelu", name="act")
    out = sym.make_loss(sym.sum(sym.square(y)), name="loss")
    rs = onp.random.RandomState(0)
    feed = {"g": (1 + 0.1 * rs.randn(256)).astype("f"),
            "b": (0.1 * rs.randn(256)).astype("f")}
    data = mx.nd.array(rs.randn(64, 256).astype("f"), ctx=mx.gpu(0))
    grads, counts = {}, {}
    for level in ("0", "2"):
        monkeypatch.setenv("MXNET_GRAPH_OPT", level)
        ex = out.simple_bind(ctx=mx.gpu(0), data=(64, 256), g=(256,),
                             b=(256,))
        ex.copy_params_from({k: mx.nd.array(v, ctx=mx.gpu(0))
                             for k, v in feed.items()})
        _build.reset_launch_counts()
        ex.forward(is_train=True, data=data)
        ex.backward()
        counts[level] = _build.launch_counts().get(NORM_ACT_KERNEL, 0)
        grads[level] = {k: v.asnumpy() for k, v in ex.grad_dict.items()}
        ex.forward(is_train=False)
        counts[level + "_infer"] = \
            _build.launch_counts().get(NORM_ACT_KERNEL, 0)
    assert counts["2"] == 0 and counts["2_infer"] >= 1
    for k in grads["0"]:
        scale = onp.abs(grads["0"][k]).max()
        assert onp.abs(grads["2"][k] - grads["0"][k]).max() <= 1e-5 * scale


def test_gluon_lstm_hybridized_trains_through_graphs(cuda):
    pm, cfg, batches = _tiny_word_lm(det=False)
    ctx = mx.gpu(0)
    net = pm.gluon_word_lm(mx)(**cfg)
    net.initialize(mx.init.Uniform(0.1), ctx=ctx)
    net.hybridize()
    mx.gluon.reset_cached_op_stats()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(pm.WORD_LM_OPT))
    losses, _ = pm.gluon_word_lm_train(mx, net, trainer, batches, cfg, ctx)
    stats = mx.gluon.cached_op_stats()
    assert stats["captures"] == 1 and stats["replays"] == len(batches)
    assert stats["backward_replays"] == len(batches)
    assert onp.isfinite(float(losses[-1].asscalar()))


# -- the NDArray and op surface ----------------------------------------------

def test_in_place_update_reaches_the_captured_graph(cuda):
    """``w -= lr * g`` on ``Parameter.data()`` writes the registered leaf,
    whose storage a hybridized block's captured forward reads: the replay
    after the update equals the eager forward bitwise."""
    from mxnet_tpu_torch import autograd, gluon, nd

    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    x = nd.random.uniform(-1, 1, shape=(8, 5), ctx=ctx)
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    gluon.reset_cached_op_stats()
    net.hybridize()
    before = net(x).asnumpy()
    for p in net.collect_params().values():
        w = p.data()
        w -= 0.1 * p.grad()
    captured = net(x).asnumpy()
    stats = gluon.cached_op_stats()
    net.hybridize(False)
    eager = net(x).asnumpy()
    assert stats["captures"] == 1 and stats["replays"] == 2
    assert onp.array_equal(captured, eager)
    assert not onp.array_equal(captured, before)


def test_random_ops_draw_anew_under_capture_and_repeat_after_seed(cuda):
    from mxnet_tpu_torch.tools import op_sweep

    assert op_sweep.random_capture_check(cuda) == len(op_sweep.RANDOM) + 4


def test_op_sweep_on_card_matches_cpu_and_captures(cuda):
    """Every case of the op sweep on the card against the CPU port (exact
    outputs bitwise), and every deterministic one in one CUDA graph."""
    from mxnet_tpu_torch.tools import op_sweep

    assert len(op_sweep.card_sweep(cuda)) == len(op_sweep.ALL)
    assert op_sweep.capture_check(cuda) == len(
        [c for c in op_sweep.ALL if c.op not in op_sweep.DATA_DEPENDENT])


def test_fault_1_rows_on_card(cuda):
    """ROADMAP C's fault 1 table on the card: each row gives the JAX
    package's answer (the CPU tests hold the rows against it)."""
    from mxnet_tpu_torch import autograd, gluon, nd

    ctx = mx.gpu(0)
    net = gluon.nn.Dense(2, in_units=2)
    net.initialize(mx.init.One(), ctx=ctx)
    w = net.weight.data()
    w -= 0.5
    assert net.weight.data().asnumpy().tolist() == [[0.5, 0.5]] * 2
    x = nd.ones((1, 2), ctx=ctx)
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    d = net.weight.data()
    d -= 0.1 * net.weight.grad()
    assert onp.allclose(net.weight.data().asnumpy(), 0.4)
    a = nd.array([1.0, 2.0], ctx=ctx)
    alias = a
    a += 1
    assert alias.asnumpy().tolist() == [2.0, 3.0]
    assert bool(nd.array([0.0], ctx=ctx)) is False
    eq = nd.array([1.0, 2.0], ctx=ctx) == 1
    assert str(eq.dtype) == "float32" and eq.asnumpy().tolist() == [1.0, 0.0]


# -- the Gluon surface and the zoo on the card (ROADMAP A3) ------------------

def _carry_to_cpu(net, ctor):
    other = ctor()
    convert.params_from_numpy(
        other, {k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()},
        ctx=mx.cpu())
    return other


@pytest.mark.parametrize("name,size", [("vgg11_bn", 32),
                                       ("squeezenet1_1", 224),
                                       ("mobilenet_v2_0_25", 32),
                                       ("densenet121", 32),
                                       ("resnet18_v2", 32)])
def test_zoo_models_on_the_card_match_the_cpu(cuda, name, size):
    """Eval-mode logits and the input gradient on the card against the
    CPU port with the same weights, within 1e-3 of the largest
    magnitude (the input gradient, when a max-pool near-tie resolves
    differently on the two devices, within 1e-2 in relative L2, as
    ``tests/test_torch_zoo.py`` explains); hybridized equal to eager on
    the card."""
    mx.random.seed(0)
    x = onp.random.RandomState(0).randn(2, 3, size, size).astype("f")
    net = vision.get_model(name, classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net(mx.nd.array(x, ctx=mx.gpu(0)))
    cpu = _carry_to_cpu(net, lambda: vision.get_model(name, classes=10))
    outs = []
    for n, ctx in ((net, mx.gpu(0)), (cpu, mx.cpu())):
        xin = mx.nd.array(x, ctx=ctx)
        xin.attach_grad()
        with mx.autograd.record(train_mode=False):
            y = n(xin)
        y.backward()
        outs.append((y.asnumpy(), xin.grad.asnumpy()))
    (logits, gx), (logits_cpu, gx_cpu) = outs
    assert onp.abs(logits - logits_cpu).max() <= \
        1e-3 * onp.abs(logits_cpu).max()
    if onp.abs(gx - gx_cpu).max() > 1e-3 * onp.abs(gx_cpu).max():
        assert onp.linalg.norm((gx - gx_cpu).ravel()) <= \
            1e-2 * onp.linalg.norm(gx_cpu.ravel())
    torch.backends.cudnn.deterministic = True
    try:
        with mx.autograd.predict_mode():
            eager = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
            net.hybridize()
            hyb = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
    finally:
        torch.backends.cudnn.deterministic = False
    assert onp.array_equal(eager, hyb)


def test_transposed_convolution_and_new_losses_on_the_card(cuda):
    """Conv2DTranspose with adj and groups, InstanceNorm and GroupNorm,
    and the losses on the card against the CPU port, within 1e-5 of the
    largest magnitude (cuDNN in float32 against the CPU's sums)."""
    rs = onp.random.RandomState(1)
    x = rs.randn(2, 4, 5, 5).astype("f")
    for make in (lambda: mx.gluon.nn.Conv2DTranspose(
                     6, 3, strides=3, padding=1, output_padding=2,
                     groups=2, in_channels=4),
                 lambda: mx.gluon.nn.InstanceNorm(in_channels=4),
                 lambda: mx.gluon.nn.GroupNorm(num_groups=2)):
        net = make()
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(mx.nd.array(x, ctx=mx.gpu(0)))
        cpu = _carry_to_cpu(net, make)
        a = net(mx.nd.array(x, ctx=mx.gpu(0))).asnumpy()
        b = cpu(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
        assert onp.abs(a - b).max() <= 1e-5 * onp.abs(b).max()
    pred, label = rs.randn(4, 5).astype("f"), \
        (rs.rand(4, 5) > 0.5).astype("f")
    for loss in (mx.gluon.loss.SigmoidBCELoss(), mx.gluon.loss.HuberLoss(),
                 mx.gluon.loss.LogisticLoss(label_format="binary"),
                 mx.gluon.loss.KLDivLoss(from_logits=False)):
        a = loss(mx.nd.array(pred, ctx=mx.gpu(0)),
                 mx.nd.array(label, ctx=mx.gpu(0))).asnumpy()
        b = loss(mx.nd.array(pred, ctx=mx.cpu()),
                 mx.nd.array(label, ctx=mx.cpu())).asnumpy()
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("adamax", {}), ("nadam", {}), ("ftml", {}), ("lamb", {"wd": 0.01}),
    ("lars", {"momentum": 0.9}), ("lbsgd", {"momentum": 0.9}),
    ("dcasgd", {"momentum": 0.9}), ("groupadagrad", {})])
def test_new_optimizers_on_the_card_match_the_cpu(cuda, name, kw):
    """Three updates of 2-D weights on the card against the CPU port,
    within 1e-5 of each weight's largest magnitude."""
    rs = onp.random.RandomState(2)
    w0 = rs.randn(16, 8).astype("f")
    grads = [rs.randn(16, 8).astype("f") for _ in range(3)]
    out = []
    for ctx in (mx.gpu(0), mx.cpu()):
        opt = mx.optimizer.create(name, learning_rate=0.01, **kw)
        w = mx.nd.array(w0, ctx=ctx)
        st = opt.create_state_multi_precision(0, w)
        for g in grads:
            opt.update_multi_precision(0, w, mx.nd.array(g, ctx=ctx), st)
        out.append(w.asnumpy())
    assert onp.abs(out[0] - out[1]).max() <= 1e-5 * onp.abs(out[1]).max()


def test_gan_twin_trains_hybridized_on_the_card(cuda):
    """The GAN twin of examples/train_gan_toy.py: its discriminator is
    called twice under one record(), hybridized."""
    from mxnet_tpu_torch.examples import train_gan_toy

    res = train_gan_toy.main(["--steps", "60"])
    assert onp.isfinite(res["mean_radius"]) and onp.isfinite(res["d_loss"])


# -- N1, box_nms's greedy sweep, and the detection ops ------------------------

def _nms_inputs(dev, B, N, seed=0, classes=20, span=0.3):
    """Score-sorted detection rows as ``box_nms`` hands them to its sweep:
    (corner boxes, valid mask, class ids, the rows), from a numpy seed."""
    from mxnet_tpu_torch.ndarray.ops_contrib import _nms_sorted

    rs = onp.random.RandomState(seed)
    d = onp.zeros((B, N, 6), "float32")
    d[..., 0] = rs.randint(0, classes, (B, N))
    d[..., 1] = rs.rand(B, N)
    d[..., 1][rs.rand(B, N) < 0.2] = 0  # a fifth invalid
    xy = rs.uniform(0, 1 - span, (B, N, 2))
    d[..., 2:4] = xy
    d[..., 4:6] = xy + rs.uniform(0.02, span, (B, N, 2))
    return torch.from_numpy(d).to(dev)


def _n1_routes(dev, B, limit):
    """The N1 routes that take ``limit`` rows on this card."""
    from mxnet_tpu_torch.kernels import box_nms as n1

    routes = ["mask_reduce"]
    try:
        n1._card_plan(dev, B, limit, "fused")
    except mx.MXNetError:
        return routes
    return ["fused"] + routes


@pytest.mark.parametrize("topk,force", [(400, False), (400, True),
                                        (-1, False), (-1, True)])
def test_n1_keep_mask_equals_plain_version_at_ssd300_shape(cuda, topk,
                                                            force):
    """N1 at (32, 8732), SSD300's detection batch: the keep mask of every
    route that takes the limit equal, bit for bit, to the plain loop on
    the same card inputs, each route's kernels launched once."""
    from mxnet_tpu_torch.kernels import box_nms as n1
    from mxnet_tpu_torch.ndarray.ops_contrib import _nms_sorted

    d = _nms_inputs(cuda, 32, 8732)
    _, vs, boxes, ids, limit = _nms_sorted(d, 0.0, topk, 2, 1, 0, -1,
                                           force, "corner")
    want = n1._nms_keep_ref(boxes, vs, ids, 0.45, limit)
    routes = _n1_routes(cuda, 32, limit)
    assert routes == (["fused", "mask_reduce"] if topk == 400
                      else ["mask_reduce"])
    assert n1._card_plan(cuda, 32, limit)["route"] == "mask_reduce"
    for route in routes:
        _build.reset_launch_counts()
        got = n1._nms_keep_cuda(boxes, vs, ids, 0.45, limit, route=route)
        assert _build.launch_counts() == dict.fromkeys(
            n1.ROUTE_KERNELS[route], 1)
        torch.cuda.synchronize()
        assert torch.equal(got, want), route
    assert 0 < int(got.sum()) < int(vs.sum())


@pytest.mark.parametrize("topk,force", [(400, False), (-1, True)])
def test_n1_mask_kernel_words_equal_the_plain_mask(cuda, topk, force):
    """The mask kernel's triangle of words at (32, 8732), bit for bit."""
    from mxnet_tpu_torch.kernels import box_nms as n1
    from mxnet_tpu_torch.ndarray.ops_contrib import _nms_sorted

    d = _nms_inputs(cuda, 32, 8732, seed=1)
    _, vs, boxes, ids, limit = _nms_sorted(d, 0.0, topk, 2, 1, 0, -1,
                                           force, "corner")
    got = n1._nms_mask_cuda(boxes, ids, 0.45, limit)
    want = n1._nms_mask_ref(boxes, ids, 0.45, limit)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (32, n1._triangle_words(limit))
    assert torch.equal(got, want)
    assert bool((want != 0).any())


@pytest.mark.parametrize("B,N,limit", [(1, 1, 1), (3, 255, 255),
                                       (2, 257, 100), (5, 1000, 1000),
                                       (2, 12000, 12000), (3, 40, 0),
                                       (4, 5, 2), (32, 2, 2),
                                       (2, 1700, 1664), (2, 1700, 1665),
                                       (33, 1665, 1665), (1, 64, 63)])
def test_n1_at_ragged_sizes_and_past_shared_memory(cuda, B, N, limit):
    """Ragged B, N and limits, on each route that takes them: across the
    fused route's shared-memory edge (1,664 rows fused on an H100, 1,665
    not), past a block of threads, past 64 words, none."""
    from mxnet_tpu_torch.kernels import box_nms as n1

    d = _nms_inputs(cuda, B, N, seed=N, classes=3, span=0.5)
    boxes = d[..., 2:6].contiguous()
    vs = (d[..., 1] > 0).contiguous()
    routes = _n1_routes(cuda, B, limit)
    assert ("fused" in routes) == (limit <= 1664)
    for ids in (None, d[..., 0].contiguous()):
        want = n1._nms_keep_ref(boxes, vs, ids, 0.3, limit)
        for route in routes:
            got = n1._nms_keep_cuda(boxes, vs, ids, 0.3, limit, route=route)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (B, N, limit, ids is None, route)


@pytest.mark.parametrize("B,N,limit", [(1, 40000, 40000),
                                       (2, 33000, 32769)])
def test_n1_past_512_words_equals_plain_version(cuda, B, N, limit):
    """Past 32,768 rows (512 words) the reduce keeps its removed bits in
    shared memory: the keep mask equal to the plain loop's."""
    from mxnet_tpu_torch.kernels import box_nms as n1

    d = _nms_inputs(cuda, B, N, seed=N, classes=3, span=0.05)
    boxes = d[..., 2:6].contiguous()
    vs = (d[..., 1] > 0).contiguous()
    plan = n1._card_plan(cuda, B, limit)
    assert plan["route"] == "mask_reduce" and plan["words"] > 512
    for ids in (None, d[..., 0].contiguous()):
        want = n1._nms_keep_ref(boxes, vs, ids, 0.3, limit)
        got = n1._nms_keep_cuda(boxes, vs, ids, 0.3, limit)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ids is None
        assert 0 < int(got.sum()) < int(vs.sum())


@pytest.mark.parametrize("R", [4, 2])
def test_n1_reduce_on_short_ring_stages_equals_plain_version(cuda, R):
    """Stages of 4 rows and of 2, which the route rule takes past about
    100,000 and 200,000 rows, here at 2,900 rows (45 words a row, an odd
    count): the keep mask equal to the plain loop's."""
    from mxnet_tpu_torch.kernels import box_nms as n1

    d = _nms_inputs(cuda, 3, 3000, seed=R, classes=3, span=0.3)
    boxes = d[..., 2:6].contiguous()
    vs = (d[..., 1] > 0).contiguous()
    ids = d[..., 0].contiguous()
    plan = dict(n1._card_plan(cuda, 3, 2900, "mask_reduce"),
                rows_per_stage=R, stages=3)
    got = n1._nms_reduce_cuda(n1._nms_mask_cuda(boxes, ids, 0.3, 2900), vs,
                              2900, plan)
    want = n1._nms_keep_ref(boxes, vs, ids, 0.3, 2900)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_n1_splits_a_batch_whose_triangles_pass_the_cap(cuda, monkeypatch):
    """Triangles past the workspace cap: the images in turns, each launch
    pair over as many as the cap holds; the keep mask as one sweep's."""
    from mxnet_tpu_torch.kernels import box_nms as n1

    d = _nms_inputs(cuda, 5, 3000, seed=5)
    boxes = d[..., 2:6].contiguous()
    vs = (d[..., 1] > 0).contiguous()
    ids = d[..., 0].contiguous()
    monkeypatch.setattr(n1, "_workspace_cap",
                        lambda index: 2 * 8 * n1._triangle_words(3000))
    assert n1._card_plan(cuda, 5, 3000)["launches"] == 3
    _build.reset_launch_counts()
    got = n1._nms_keep_cuda(boxes, vs, ids, 0.45, 3000)
    assert _build.launch_counts() == {n1.MASK: 3, n1.REDUCE: 3}
    want = n1._nms_keep_ref(boxes, vs, ids, 0.45, 3000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_box_nms_on_the_card_is_captured_and_matches_the_cpu(cuda):
    """``box_nms`` inside a CUDA graph: the replay's rows equal the eager
    card run's and the CPU port's; N1's kernels (the mask_reduce route at
    ``topk`` 400) launch once each per replay."""
    from mxnet_tpu_torch.kernels.box_nms import MASK, REDUCE

    d = _nms_inputs(cuda, 4, 3000, seed=3)
    kw = dict(overlap_thresh=0.45, topk=400, id_index=0, coord_start=2,
              score_index=1)
    eager = mx.nd.contrib.box_nms(mx.nd.NDArray(d), **kw)._data
    cpu = mx.nd.contrib.box_nms(mx.nd.NDArray(d.cpu()), **kw)._data
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mx.nd.contrib.box_nms(mx.nd.NDArray(d), **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.recording_launches() as rec:
        with mx.context.cuda_graph(graph):
            out = mx.nd.contrib.box_nms(mx.nd.NDArray(d), **kw)._data
    assert rec == {MASK: 1, REDUCE: 1}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(out.cpu(), cpu)


def test_box_nms_short_sweep_is_captured_on_the_fused_route(cuda):
    """``box_nms`` over 200 rows inside a CUDA graph: the fused kernel
    once per replay; the replay's rows equal the eager run's and the CPU
    port's."""
    from mxnet_tpu_torch.kernels.box_nms import FUSED

    d = _nms_inputs(cuda, 4, 200, seed=4)
    kw = dict(overlap_thresh=0.45, id_index=0, coord_start=2, score_index=1)
    cpu = mx.nd.contrib.box_nms(mx.nd.NDArray(d.cpu()), **kw)._data
    eager = mx.nd.contrib.box_nms(mx.nd.NDArray(d), **kw)._data
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mx.nd.contrib.box_nms(mx.nd.NDArray(d), **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _build.recording_launches() as rec:
        with mx.context.cuda_graph(graph):
            out = mx.nd.contrib.box_nms(mx.nd.NDArray(d), **kw)._data
    assert rec == {FUSED: 1}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(out.cpu(), cpu)


def test_detection_ops_on_the_card_match_the_cpu(cuda):
    """multibox prior, target (with mining) and detection, bipartite
    matching and roi_align (values and gradient) on the card against the
    CPU port: integer outputs exact, values within 1e-5."""
    from mxnet_tpu_torch.tools import profile_ssd as ps

    rs = onp.random.RandomState(5)
    xs, ys = ps.synthetic_batch(4, seed=5)
    cls = rs.randn(4, 21, ps.ANCHORS).astype("f")
    loc = (rs.randn(4, ps.ANCHORS * 4) * 0.3).astype("f")
    res = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        nd = mx.nd
        anc = ps.anchors(mx, ctx)
        tgt = nd.contrib.MultiBoxTarget(anc, nd.array(ys, ctx=ctx),
                                        nd.array(cls, ctx=ctx), **ps.TARGET)
        prob = nd.softmax(nd.array(cls, ctx=ctx), axis=1)
        det = nd.contrib.MultiBoxDetection(prob, nd.array(loc, ctx=ctx),
                                           anc, **ps.DETECT)
        bip = nd.contrib.bipartite_matching(nd.array(cls[:, :6, :40],
                                                     ctx=ctx))
        data = nd.array(xs[:, :, :64, :64], ctx=ctx)
        data.attach_grad()
        rois = nd.array([[0, 2, 3, 40, 50], [3, 10.5, 0, 63, 20]], ctx=ctx)
        with mx.autograd.record():
            out = nd.contrib.ROIAlign(data, rois, pooled_size=(7, 7),
                                      spatial_scale=1.0)
        out.backward()
        res[ctx.device_type] = [anc, *tgt, det, *bip, out, data.grad]
    card, cpu = ([a.asnumpy() for a in res[k]] for k in ("gpu", "cpu"))
    names = ["anchors", "loc_t", "loc_mask", "cls_t", "detection",
             "row_match", "col_match", "roi_align", "roi_align_grad"]
    for name, a, b in zip(names, card, cpu):
        if name in ("loc_mask", "cls_t", "row_match", "col_match"):
            onp.testing.assert_array_equal(a, b, err_msg=name)
        elif name == "detection":
            onp.testing.assert_array_equal(a[..., 0], b[..., 0])
            onp.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        else:
            onp.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(
                1.0, onp.abs(b).max()), err_msg=name)


def test_ssd_toy_twin_trains_on_the_card(cuda):
    from mxnet_tpu_torch.examples import train_ssd_toy

    res = train_ssd_toy.main(["--steps", "60"])
    assert res["final_loss"] < min(2.0, res["first_loss"])


def test_sym_contrib_detection_graph_bound_on_the_card(cuda):
    """``MultiBoxPrior`` → ``MultiBoxDetection`` as a bound symbol graph
    on the card (the executor captures it, N1 inside): two forwards equal
    each other and the CPU port's rows (ids and -1 rows exactly, values
    within 1e-5)."""
    from mxnet_tpu_torch.kernels.box_nms import FUSED as N1  # nms_topk 50

    S = mx.sym
    anchor = S.contrib.MultiBoxPrior(S.var("feat"), sizes=[0.3, 0.5],
                                     ratios=[1, 2], name="anchors")
    det = S.contrib.MultiBoxDetection(S.var("cls_prob"), S.var("loc_pred"),
                                      anchor, nms_threshold=0.45,
                                      nms_topk=50, name="detection")
    rs = onp.random.RandomState(6)
    logits = rs.randn(4, 5, 10 * 10 * 3).astype("f")
    prob = onp.exp(logits) / onp.exp(logits).sum(1, keepdims=True)
    arrays = {"feat": onp.zeros((1, 8, 10, 10), "f"),
              "cls_prob": prob.astype("f"),
              "loc_pred": (rs.randn(4, 1200) * 0.3).astype("f")}
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        ex = det.bind(ctx, {k: mx.nd.array(v, ctx=ctx)
                            for k, v in arrays.items()}, grad_req="null")
        _build.reset_launch_counts()
        first = ex.forward(is_train=False)[0].asnumpy()
        second = ex.forward(is_train=False)[0].asnumpy()
        assert onp.array_equal(first, second)
        if ctx.device_type == "gpu":  # a warm-up, then one a replay
            assert _build.launch_counts().get(N1, 0) >= 2
        outs.append(second)
    card, cpu = outs
    onp.testing.assert_array_equal(card[..., 0], cpu[..., 0])
    onp.testing.assert_allclose(card, cpu, rtol=0, atol=1e-5)


# -- N2, the int8 convolution, and the int8 products ---------------------------

_N2_EXTRA = [((2, 8, 13, 11), (12, 4, 3, 3), (2, 1), (1, 2), (1, 1), 2),
             ((3, 6, 17, 17), (8, 6, 3, 3), (1, 1), (2, 2), (2, 2), 1),
             ((1, 3, 31, 31), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
             ((4, 64, 7, 7), (64, 1, 3, 3), (1, 1), (1, 1), (1, 1), 64)]


def _s8(dev, shape, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)


def _n2_cases():
    from mxnet_tpu_torch.tools.profile_quant import resnet50_convolutions

    seen, out = set(), []
    for x, w, st, p in resnet50_convolutions(2):
        if (x, w, st, p) not in seen:
            seen.add((x, w, st, p))
            out.append((x, w, st, p, (1, 1), 1))
    return out + _N2_EXTRA


@pytest.mark.parametrize("case", _n2_cases(),
                         ids=lambda c: f"x{c[0]}w{c[1]}s{c[2]}g{c[5]}")
def test_n2_equals_its_plain_version_bitwise(cuda, case):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    x_s, w_s, st, p, d, g = case
    x, w = _s8(cuda, x_s, 1), _s8(cuda, w_s, 2)
    _build.reset_launch_counts()
    got = k8.int8_conv(x, w, st, p, d, g)
    # the sm90 route copies the NCHW x (and a kh x kw weight) to NHWC in
    # one launch before its own
    want = {k8.KERNEL: 1}
    if k8._int8_conv_route(x, w, g) == "sm90":
        want.update({k8.SM90_KERNEL: 1, k8.NHWC_KERNEL: 1})
    assert _build.launch_counts() == want
    assert torch.equal(got, k8._int8_conv_ref(x, w, st, p, d, g))


# the sm90 kernel's edges: M not a multiple of 128 and O not one of the
# tile width, C = 16 and 48, a flat 1 x 1, a stride-2 1 x 1, a padded
# 3 x 3 at 7 x 7 (two images a tile), dilated, anisotropic, a wide image
_N2_SM90_EDGES = [
    ((3, 16, 9, 7), (48, 16, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((2, 48, 7, 7), (80, 48, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((3, 48, 5, 6), (144, 48, 1, 1), (1, 1), (0, 0), (1, 1)),
    ((2, 64, 9, 9), (128, 64, 1, 1), (2, 2), (0, 0), (1, 1)),
    ((5, 512, 7, 7), (272, 512, 3, 3), (1, 1), (1, 1), (1, 1)),
    ((1, 32, 12, 12), (16, 32, 3, 3), (1, 1), (2, 2), (2, 2)),
    ((2, 16, 11, 13), (32, 16, 3, 3), (2, 1), (1, 2), (1, 1)),
    ((2, 32, 40, 70), (64, 32, 3, 3), (1, 1), (1, 1), (1, 1))]


@pytest.mark.parametrize("bn", [None, 64, 128, 256])
@pytest.mark.parametrize("case", _N2_SM90_EDGES,
                         ids=lambda c: f"x{c[0]}w{c[1]}s{c[2]}")
def test_n2_sm90_edges_bitwise(cuda, case, bn):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    x_s, w_s, st, p, d = case
    x, w = _s8(cuda, x_s, 7), _s8(cuda, w_s, 8)
    plan = k8._sm90_plan(x_s, w_s, st, p, d, _n_sm(cuda), bn=bn,
                         splits=None if bn is None else 1)
    got = k8._int8_conv_sm90(x, w, st, p, d, plan)
    assert torch.equal(got, k8._int8_conv_ref(x, w, st, p, d, 1))


def _r50_batch32():
    from mxnet_tpu_torch.tools.profile_quant import resnet50_convolutions

    return list(dict.fromkeys(resnet50_convolutions(32)))


@pytest.mark.parametrize("case", _r50_batch32(),
                         ids=lambda c: f"x{c[0][1:]}w{c[1]}s{c[2][0]}")
def test_n2_both_routes_at_resnet50_batch32_shapes(cuda, case):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    x_s, w_s, st, p = case
    x, w = _s8(cuda, x_s, 9), _s8(cuda, w_s, 10)
    want = k8._int8_conv_ref(x, w, st, p, (1, 1), 1)
    assert torch.equal(k8.int8_conv(x, w, st, p, (1, 1), 1, route="mma"),
                       want)
    # the sm90 kernel takes the stem too when it is handed it (padded)
    assert torch.equal(k8._int8_conv_sm90(x, w, st, p, (1, 1)), want)


def test_n2_sm90_split_k_reruns_bitwise(cuda):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    x, w = _s8(cuda, (1, 512, 7, 7), 11), _s8(cuda, (512, 512, 3, 3), 12)
    plan = k8._sm90_plan(x.shape, w.shape, (1, 1), (1, 1), (1, 1),
                         _n_sm(cuda))
    assert plan["splits"] > 1
    want = k8._int8_conv_ref(x, w, (1, 1), (1, 1), (1, 1), 1)
    for splits in (plan["splits"], 3, 4):
        p_ = k8._sm90_plan(x.shape, w.shape, (1, 1), (1, 1), (1, 1),
                           _n_sm(cuda), splits=splits)
        first = k8._int8_conv_sm90(x, w, (1, 1), (1, 1), (1, 1), p_)
        assert torch.equal(first, want)
        assert torch.equal(k8._int8_conv_sm90(x, w, (1, 1), (1, 1), (1, 1),
                                              p_), first)


def test_n2_route_rule_on_card_tensors(cuda):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    cases = [((2, 64, 9, 9), (64, 64, 3, 3), 1, "sm90"),
             ((2, 3, 31, 31), (64, 3, 7, 7), 1, "mma"),  # the stem
             ((2, 64, 9, 9), (64, 32, 3, 3), 2, "mma"),
             ((2, 24, 9, 9), (32, 24, 1, 1), 1, "mma"),
             ((2, 32, 9, 9), (40, 32, 1, 1), 1, "mma")]
    for x_s, w_s, g, want in cases:
        x, w = _s8(cuda, x_s, 13), _s8(cuda, w_s, 14)
        assert k8._int8_conv_route(x, w, g) == want
        _build.reset_launch_counts()
        got = k8.int8_conv(x, w, (1, 1), (1, 1), (1, 1), g)
        counts = _build.launch_counts()
        assert counts.get(k8.KERNEL) == 1
        assert counts.get(k8.SM90_KERNEL, 0) == (want == "sm90")
        assert torch.equal(got, k8._int8_conv_ref(x, w, (1, 1), (1, 1),
                                                  (1, 1), g))
    # the 1-D convolution is lifted and routed like the 2-D one
    x, w = _s8(cuda, (2, 32, 40), 15), _s8(cuda, (64, 32, 3), 16)
    _build.reset_launch_counts()
    got = k8.int8_conv(x, w, (2,), (1,), (1,), 1)
    assert _build.launch_counts().get(k8.SM90_KERNEL) == 1
    assert torch.equal(got, k8._int8_conv_ref(x, w, (2,), (1,), (1,), 1))


def test_int8_to_nhwc_equals_plain(cuda):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    for shape, Cp in (((2, 3, 9, 9), 16), ((32, 256, 56, 56), 256),
                      ((3, 48, 7, 7), 48), ((512, 512, 3, 3), 512),
                      ((5, 130, 14, 14), 144), ((7, 5, 3, 3), 16)):
        t = _s8(cuda, shape, 17)
        assert torch.equal(k8._to_nhwc((t, Cp))[0], k8._to_nhwc_ref(t, Cp))
    a, b = _s8(cuda, (2, 64, 9, 9), 18), _s8(cuda, (128, 64, 3, 3), 19)
    got = k8._to_nhwc((a, 64), (b, 64))
    assert torch.equal(got[0], k8._to_nhwc_ref(a, 64))
    assert torch.equal(got[1], k8._to_nhwc_ref(b, 64))


def test_n2_sm90_refused_launch_raises(cuda):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    x, w = _s8(cuda, (2, 64, 9, 9), 20), _s8(cuda, (64, 64, 3, 3), 21)
    with pytest.raises(mx.MXNetError, match="route 'sm90'"):
        k8.int8_conv(x, w[:, :32], (1, 1), (1, 1), (1, 1), 2, route="sm90")
    plan = dict(k8._sm90_plan(x.shape, w.shape, (1, 1), (1, 1), (1, 1),
                              _n_sm(cuda)), tile=(1, 16, 16))  # 256 rows
    with pytest.raises(mx.MXNetError, match="sm90 kernel launch failed"):
        k8._int8_conv_sm90(x, w, (1, 1), (1, 1), (1, 1), plan)


@pytest.mark.parametrize("M,K,N", [(1, 2048, 1000), (32, 2048, 1000),
                                   (16, 64, 64), (5, 147, 63)])
def test_int_mm_padded_shapes(cuda, M, K, N):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    a, b = _s8(cuda, (M, K), 3), _s8(cuda, (N, K), 4).t()
    _build.reset_launch_counts()
    assert torch.equal(k8.int8_mm(a, b), k8._int8_mm_ref(a, b))
    assert _build.launch_counts() == {k8.INT_MM: 1}


def test_n2_refuses_what_it_cannot_take(cuda):
    from mxnet_tpu_torch.kernels import int8_conv as k8

    x, w = _s8(cuda, (1, 4, 5, 5), 5), _s8(cuda, (4, 4, 3, 3), 6)
    with pytest.raises(mx.MXNetError, match="int8"):
        k8.int8_conv(x.float(), w, (1, 1), (0, 0), (1, 1))
    with pytest.raises(mx.MXNetError, match="groups"):
        k8.int8_conv(x, w, (1, 1), (0, 0), (1, 1), 3)


def test_int8_symbol_block_hybridized_replays(cuda, monkeypatch):
    """An int8 SymbolBlock from quantize_net_graph, hybridized: the
    captured graph replays bitwise equal to the eager forward, counts N2
    and _int_mm per replay, and a lowering switch captures a second
    entry (dequant launches no int8 kernel)."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net_graph

    monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", "native")
    mx.random.seed(7)
    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    x = mx.nd.array(onp.random.RandomState(0).randn(4, 3, 32, 32)
                    .astype("float32"), ctx=mx.gpu(0))
    with mx.autograd.pause():
        net(x)
    qb = quantize_net_graph(net, calib_data=[x], calib_mode="naive")
    with mx.autograd.pause():
        eager = qb(x).asnumpy()
        qb.hybridize()
        qb(x)
        _build.reset_launch_counts()
        replayed = qb(x).asnumpy()
        counts = _build.launch_counts()
        monkeypatch.setenv("MXNET_QUANTIZE_LOWERING", "dequant")
        _build.reset_launch_counts()
        dq = qb(x).asnumpy()
        dcounts = _build.launch_counts()
    assert onp.array_equal(eager, replayed)
    # 20 convolutions, all but the stem (3 channels) on the sm90 route,
    # each of those after one layout copy
    assert counts == {"int8_conv": 20, "int8_conv_sm90": 19,
                      "int8_to_nhwc": 19, "int_mm": 1}
    assert len(qb._cached_op.entries) == 2 and not dcounts.get("int8_conv")
    assert float(onp.abs(dq - eager).max()) <= 1e-5 * float(
        onp.abs(eager).max())


def test_int8_kv_pages_decode_on_the_card(cuda):
    """Decode through the batcher on int8 KV pages: within 0.1 of the
    float32 client-side loop, the appended pages counted."""
    from mxnet_tpu_torch.analysis import quantize as qpass

    mx.random.seed(21)
    net = DecoderBlockLM(**SMALL)
    net.initialize(ctx=mx.gpu(0))
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=4,
        byte_budget=0, ttl_s=0, pageable=net.state_row_pageable(),
        page_tokens=4, kv_int8=True, ctx=mx.gpu(0))
    sess = serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=[1, 2], ctx=mx.gpu(0))
    bat = serving.DynamicBatcher(sess, max_batch_size=2, admission=False,
                                 timeout_ms=120000.0)
    qpass.reset_counters()
    toks = [onp.array([[t]], "int32") for t in (3, 1, 4, 1, 5, 9, 2, 6, 5)]
    try:
        for x in toks:
            out = onp.asarray(bat.submit(x, session_id="q").result(
                timeout=120))
        states = [onp.zeros((1,) + s, dt) for s, dt in
                  zip(net.state_row_shapes(), net.state_row_dtypes())]
        for x in toks:
            ref, states = sess.step(x, states=states)
        ref = ref.asnumpy()
        assert float(onp.abs(out - ref).max()) < \
            0.1 * float(onp.abs(ref).max())
        assert qpass.counters()["kv_pages_quantized"] >= len(toks)
    finally:
        bat.close()
        sess.close()
        store.close()


def test_profiler_device_trace_holds_the_cards_kernels(cuda, tmp_path,
                                                        monkeypatch):
    """``profiler.start``/``stop`` on the card: the device trace holds
    kernel events, K2's among them. (Smoke phase 54 checks K2 inside the
    replayed decode graphs.)"""
    from mxnet_tpu_torch import profiler, telemetry
    import json

    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    profiler.set_config(filename=str(tmp_path / "card.json"))
    profiler.start()
    try:
        a = torch.randn(256, 256, device=cuda)
        (a @ a).sum()
        q, k, v, lengths = _inputs(cuda, 2, 64, 4, 64, [10, 64])
        _decode_flash(q, k, v, lengths, 0.125)
        torch.cuda.synchronize()
    finally:
        profiler.stop()
    doc = json.load(open(profiler.device_trace_path()))
    kernels = [e["name"] for e in doc["traceEvents"]
               if e.get("cat") == "kernel"]
    assert kernels
    assert any("decode_attention_kernel" in n for n in kernels)
    assert profiler.device_trace_path().endswith("card_device.json")
    telemetry.reset_trace()


# -- the host runtime and the record pipeline (slice 10c) ---------------------

def _seeded_jpegs(n, side=64, seed=0, subsampling=-1):
    from io import BytesIO

    from PIL import Image

    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(n):
        buf = BytesIO()
        Image.fromarray(rng.randint(0, 255, (side, side, 3), "uint8")).save(
            buf, format="JPEG", quality=90, subsampling=subsampling)
        out.append(buf.getvalue())
    return out


def test_engine_decode_pushed_before_waitall_is_done_when_it_returns(cuda):
    """An nvJPEG decode pushed to the engine's IO lane with ``device=``
    is finished, on the card too, when ``nd.waitall()`` returns."""
    from mxnet_tpu_torch import engine, nd
    from mxnet_tpu_torch.kernels import jpeg_decode as jd

    if not jd.available():
        pytest.skip("no nvJPEG on this machine")
    eng = engine.get()
    dev = torch.device("cuda", 0)
    blobs = _seeded_jpegs(32)
    crops = onp.full((32, 3), -1, onp.int32)
    crops[:, 2] = 0
    box = {}
    v = eng.new_variable()
    eng.push(lambda: box.update(out=jd.decode_batch(blobs, 56, 56, 0,
                                                    crops, dev)),
             mutable_vars=(v,), lane=engine.LANE_IO, device=dev)
    nd.waitall()
    _, done = eng._device_events[v.id]
    assert done.query()
    src, sizes = jd.decode_full(blobs, dev)
    plan = torch.from_numpy(jd.crop_plan(sizes, 56, 56, 0, crops)).to(dev)
    assert torch.equal(box["out"], jd._crop_ref(src, plan, 56, 56))


def test_jpeg_crop_is_bitwise_its_plain_version(cuda):
    """The crop kernel against its plain version on nvJPEG's pixels:
    with and without a resize, at libjpeg's 1/2 and 1/4 scales, mirrored
    and at the free space's edges."""
    from mxnet_tpu_torch.kernels import jpeg_decode as jd

    if not jd.available():
        pytest.skip("no nvJPEG on this machine")
    dev = torch.device("cuda", 0)
    blobs = _seeded_jpegs(6, side=96) + _seeded_jpegs(2, side=300, seed=1)
    src, sizes = jd.decode_full(blobs, dev)
    rs = onp.random.RandomState(0)
    for resize in (0, 40, 80, 150):
        crops = onp.stack([rs.randint(-1, 10001, 8), rs.randint(-1, 10001, 8),
                           rs.randint(0, 2, 8)], 1).astype(onp.int32)
        crops[0, :2] = (0, 10000)
        plan = torch.from_numpy(jd.crop_plan(sizes, 32, 40, resize,
                                             crops)).to(dev)
        assert torch.equal(jd.jpeg_crop(src, plan, 32, 40),
                           jd._crop_ref(src, plan, 32, 40)), resize


def test_image_record_iter_on_the_card(cuda, tmp_path):
    """The nvJPEG route's batches lie on the card, normalized, and match
    the Python twin's geometry (4:4:4 JPEGs: the IDCT's rounding only)."""
    from mxnet_tpu_torch import io, recordio
    from mxnet_tpu_torch.io.image_record import _decode_batch_python

    path = str(tmp_path / "x.rec")
    blobs = _seeded_jpegs(8, side=72, subsampling=0)
    w = recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i, b in enumerate(blobs):
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, float(i), i, 0), b))
    w.close()
    it = io.ImageRecordIter(path, data_shape=(3, 64, 64), batch_size=4,
                            path_imgidx=path + ".idx")
    if it.decoder != "nvjpeg":
        it.close()
        pytest.skip("this machine decodes on the host")
    b = it.next()
    it.close()
    x = b.data[0].data
    assert x.device.type == "cuda" and x.shape == (4, 3, 64, 64)
    twin = _decode_batch_python(blobs[:4], 64, 64, 0, [(-1, -1, 0)] * 4)
    want = torch.from_numpy(twin).permute(0, 3, 1, 2).float()
    assert (x.cpu() - want).abs().mean() < 1.5
    assert b.label[0].asnumpy().tolist() == [0.0, 1.0, 2.0, 3.0]
