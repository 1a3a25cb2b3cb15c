"""The port on the card: the CUDA kernel K2 and the decode path that
launches it. Every test here needs an NVIDIA GPU and skips without one.

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch for CUDA. From the repo root:

    python -m pytest --noconftest -p no:cacheprovider \
        -o "markers=cuda: needs a CUDA device" -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX.) K2 is held against
its plain version within rtol = atol = 1e-5, the bound the JAX package
puts on its Pallas kernel against the lax path: both sum the softmax in
fp32, in different orders.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, serving
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (KERNEL, _decode_flash,
                                                     _decode_flash_ref)
from mxnet_tpu_torch.models import DecoderBlockLM

pytestmark = pytest.mark.cuda

TOL = 1e-5
SMALL = dict(vocab_size=32, embed_dim=16, num_layers=2, num_heads=2,
             max_len=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K2 is a CUDA kernel with no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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
