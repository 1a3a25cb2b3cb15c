"""K1's plain version and the port's ``flash_attention`` against the JAX
package's ``flash_attention``: its XLA reference path
(``use_pallas=False``) and the Pallas kernel ``_fa_kernel`` itself,
which runs in interpret mode on the CPU (``use_pallas=True``).

The same inputs, made with numpy from a seed, go through both packages.
The cases are those of ``tests/test_attention.py:26-78`` plus a causal
S_q < S_k case. Tolerance 1e-5 absolute, the JAX test's own bound for
its kernel against its reference path: all of them sum the softmax in
fp32, in different orders. Gradients go through the port's
``autograd.Function`` (the recompute backward) and through ``jax.vjp``
of the JAX function (its ``custom_vjp`` recompute) with the same
cotangent, within the same 1e-5.

On the CPU the K1 wrapper runs the plain version; the kernel itself is
held against that plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from mxnet_tpu.kernels.flash_attention import _ref_attention as jax_ref

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_fwd_cuda,
                                                     _flash_load_width,
                                                     _flash_ref,
                                                     _flash_route,
                                                     flash_attention)

TOL = 1e-5

# (B, H, S_q, S_k, D, causal, seed)
CASES = [
    pytest.param(2, 3, 64, 64, 16, False, 0, id="plain"),
    pytest.param(2, 3, 64, 64, 16, True, 0, id="causal"),
    pytest.param(1, 2, 100, 70, 24, False, 1, id="ragged-100x70-d24"),
    pytest.param(1, 2, 1, 40, 8, True, 3, id="decode-alignment"),
    pytest.param(1, 2, 30, 70, 16, True, 4, id="causal-sq-lt-sk"),
]


def _inputs(B, H, S_q, S_k, D, seed):
    rs = onp.random.RandomState(seed)
    return (rs.randn(B, H, S_q, D).astype("f"),
            rs.randn(B, H, S_k, D).astype("f"),
            rs.randn(B, H, S_k, D).astype("f"))


def _jax(arrays, causal, use_pallas):
    q, k, v = (jnp.asarray(a) for a in arrays)
    return onp.asarray(jax_flash_attention(q, k, v, causal=causal,
                                           use_pallas=use_pallas))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,H,S_q,S_k,D,causal,seed", CASES)
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jax-xla", "jax-pallas-interpret"])
def test_forward_matches_jax(B, H, S_q, S_k, D, causal, seed, use_pallas):
    arrays = _inputs(B, H, S_q, S_k, D, seed)
    want = _jax(arrays, causal, use_pallas)
    q, k, v = _torch(arrays)
    ref = _flash_ref(q, k, v, D ** -0.5, causal).numpy()
    got = flash_attention(q, k, v, causal=causal).numpy()
    assert got.shape == want.shape == (B, H, S_q, D)
    assert float(onp.abs(ref - want).max()) < TOL
    assert float(onp.abs(got - want).max()) < TOL


def test_causality_probe():
    """Output at position t does not depend on keys and values past t
    (the probe of ``test_flash_causal``)."""
    q, k, v = _torch(_inputs(2, 3, 64, 64, 16, 0))
    base = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 32:] = 999.0
    v2[:, :, 32:] = 999.0
    probe = flash_attention(q, k2, v2, causal=True)
    assert float((base[:, :, :32] - probe[:, :, :32]).abs().max()) < 1e-6


def test_decode_row_matches_full_sequence_row():
    """S_q = 1 against the whole cache equals the last row of the full
    causal attention (bottom-right alignment)."""
    q, k, v = _torch(_inputs(1, 2, 40, 40, 8, 3))
    full = flash_attention(q, k, v, causal=True)
    last = flash_attention(q[:, :, -1:], k, v, causal=True)
    assert float((full[:, :, -1:] - last).abs().max()) < TOL


@pytest.mark.parametrize("B,H,S_q,S_k,D,causal,seed", CASES)
def test_gradients_match_jax(B, H, S_q, S_k, D, causal, seed):
    arrays = _inputs(B, H, S_q, S_k, D, seed)
    do = onp.random.RandomState(seed + 100).randn(B, H, S_q, D).astype("f")
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(
        q, k, v, causal=causal, use_pallas=False), jq, jk, jv)
    want = [onp.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [t.requires_grad_(True) for t in _torch(arrays)]
    flash_attention(*leaves, causal=causal).backward(torch.from_numpy(do))
    for name, leaf, w in zip("qkv", leaves, want):
        err = float(onp.abs(leaf.grad.numpy() - w).max())
        assert err < TOL, (name, err)


def test_backward_recompute_matches_autograd_of_plain():
    """``_flash_bwd``'s chunked recompute (two chunks of 512 rows and a
    ragged third) against torch autograd through the plain version."""
    arrays = _inputs(1, 1, 1100, 1100, 8, 7)
    q, k, v = (t.requires_grad_(True) for t in _torch(arrays))
    do = torch.from_numpy(
        onp.random.RandomState(8).randn(1, 1, 1100, 8).astype("f"))
    _flash_ref(q, k, v, 0.3, True).backward(do)
    got = _flash_bwd(q.detach(), k.detach(), v.detach(), do, 0.3, True)
    for g, leaf in zip(got, (q, k, v)):
        assert float((g - leaf.grad).abs().max()) < TOL


def test_causal_with_more_queries_than_keys_raises():
    q, k, v = _torch(_inputs(1, 1, 8, 4, 8, 0))
    with pytest.raises(ValueError, match="S_q <= S_k"):
        flash_attention(q, k, v, causal=True)
    flash_attention(q, k, v, causal=False)  # fine without the mask


def test_kernel_wrapper_on_cpu_tensors_is_the_plain_version():
    q, k, v = _torch(_inputs(1, 2, 9, 9, 8, 5))
    _build.reset_launch_counts()
    got = _flash_fwd_cuda(q, k, v, 0.25, True)
    assert _build.launch_counts() == {}
    assert torch.equal(got, _flash_ref(q, k, v, 0.25, True))
    for use_kernel in (None, True, False):
        out = flash_attention(q, k, v, sm_scale=0.25, causal=True,
                              use_kernel=use_kernel)
        assert torch.equal(out, got)


def test_nd_op_on_the_tape():
    """Port of ``test_nd_flash_attention_op_tape``
    (``tests/test_attention.py:90-101``), with the JAX package's answer
    beside it."""
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jautograd

    arrays = _inputs(1, 2, 32, 32, 8, 2)
    jq, jk, jv = (jmx.nd.array(a) for a in arrays)
    jq.attach_grad()
    with jautograd.record():
        jloss = jmx.nd.sum(jmx.nd.flash_attention(jq, jk, jv, causal=True))
    jloss.backward()

    q, k, v = (nd.array(a, ctx=mx.cpu()) for a in arrays)
    q.attach_grad()
    with autograd.record():
        out = nd.flash_attention(q, k, v, causal=True)
        loss = nd.sum(out)
    loss.backward()
    assert q.grad.shape == q.shape
    assert float(nd.sum(nd.abs(q.grad)).asscalar()) > 0
    assert k.grad is None
    onp.testing.assert_allclose(loss.asscalar(), jloss.asscalar(),
                                rtol=TOL, atol=TOL)
    assert float(onp.abs(q.grad.asnumpy() - jq.grad.asnumpy()).max()) < TOL


# -- K1's arithmetic on the tensor cores, emulated ---------------------------
#
# The kernel takes both products in 3xTF32 (csrc/flash_attention.cu): each
# fp32 operand x splits as big = tf32(x), small = tf32(x - big), and a.b is
# a_small.b_big + a_big.b_small + a_big.b_big with fp32 sums, over
# 128-row query tiles and 64-key tiles (D <= 64) with a base-2 online
# softmax.
# The emulation below repeats that arithmetic in torch on the CPU, so the
# 1e-5 parity bound is shown to hold for the design before any card runs
# it; one-pass TF32 at the same inputs does not hold it.

_LOG2E = 1.4426950408889634


def _tf32(x):
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, to nearest, ties
    away from zero, on the int32 view of the float32 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _emulate_k1(q, k, v, sm_scale, causal, mm, BQ=128, BK=64):
    """K1's forward in its tile order at D <= 64: per tile of 128 query
    rows, key tiles of BK up to the last one the tile can see, scores
    scaled into base 2, masked with -1e30, folded into a running max and
    sum, each tile's P.V summed apart and added to the accumulator."""
    S_q, S_k = q.shape[2], k.shape[2]
    off = S_k - S_q
    out = torch.empty_like(q)
    for q0 in range(0, S_q, BQ):
        qt = q[:, :, q0:q0 + BQ]
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        m = torch.full(qt.shape[:3] + (1,), -1e30)
        l = torch.zeros(qt.shape[:3] + (1,))
        acc = torch.zeros(qt.shape)
        kend = min(S_k, q0 + BQ + off) if causal else S_k
        for k0 in range(0, kend, BK):
            kt, vt = k[:, :, k0:k0 + BK], v[:, :, k0:k0 + BK]
            s = mm(qt, kt.transpose(-1, -2)) * (sm_scale * _LOG2E)
            if causal:
                keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
                s = torch.where(keys <= rows + off, s,
                                torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + mm(p, vt)  # the tile's P.V, then one add
            m = m_new
        out[:, :, q0:q0 + BQ] = acc / l.clamp_min(1e-30)
    return out


# the training shape at B = 1, H = 2; the fusion route's shape at B = 2
EMULATED = [
    pytest.param(1, 2, 1024, 1024, 64, True, 11, id="training-causal"),
    pytest.param(2, 1, 499, 499, 64, False, 12, id="route"),
]


@pytest.mark.parametrize("B,H,S_q,S_k,D,causal,seed", EMULATED)
def test_3xtf32_emulation_within_1e5_of_plain_and_jax(B, H, S_q, S_k, D,
                                                      causal, seed):
    arrays = _inputs(B, H, S_q, S_k, D, seed)
    q, k, v = _torch(arrays)
    scale = D ** -0.5
    got = _emulate_k1(q, k, v, scale, causal, _mm_3xtf32)
    plain = _flash_ref(q, k, v, scale, causal)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    want = onp.asarray(jax_ref(jq, jk, jv, scale, causal, S_k))
    assert float((got - plain).abs().max()) < TOL
    assert float(onp.abs(got.numpy() - want).max()) < TOL


@pytest.mark.parametrize("B,H,S_q,S_k,D,causal,seed", EMULATED)
def test_one_pass_tf32_breaks_the_bound(B, H, S_q, S_k, D, causal, seed):
    """Why three passes: one TF32 pass keeps ~3 digits."""
    q, k, v = _torch(_inputs(B, H, S_q, S_k, D, seed))
    scale = D ** -0.5
    got = _emulate_k1(q, k, v, scale, causal, _mm_1xtf32)
    plain = _flash_ref(q, k, v, scale, causal)
    assert float((got - plain).abs().max()) > 10 * TOL


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # representable in TF32
    half_ulp = 2.0 ** -11
    x = torch.tensor([1.0 + half_ulp, -(1.0 + half_ulp), one + half_ulp,
                      1.0 + half_ulp * 0.99, 3.0], dtype=torch.float32)
    got = _tf32(x).tolist()
    assert got == [one, -one, 1.0 + 2.0 ** -9, 1.0, 3.0]


# bytes per K/V copy into shared memory (the kernel's load path), as the
# wrapper picks it for the card's check cases: (B, H, S_q, S_k, D, dtype)
_WIDTH_CASES = [
    pytest.param((8, 12, 64, 64, 64), torch.float32, 16, id="f32-d64"),
    pytest.param((1, 2, 77, 77, 20), torch.bfloat16, 4, id="bf16-40B-rows"),
    pytest.param((1, 2, 33, 50, 21), torch.bfloat16, 2, id="bf16-42B-rows"),
    pytest.param((1, 1, 5, 9, 3), torch.float32, 4, id="f32-12B-rows"),
    pytest.param((2, 3, 64, 64, 32), torch.bfloat16, 16, id="bf16-d32"),
]


@pytest.mark.parametrize("shape,dtype,width", _WIDTH_CASES)
def test_load_width_follows_alignment(shape, dtype, width):
    B, H, S_q, S_k, D = shape
    k = torch.zeros(B, H, S_k, D, dtype=dtype)
    assert _flash_load_width(k, k.clone()) == width


def test_load_width_of_strided_views():
    """The model's views of one (B, S, 3, H, D) projection keep 16-byte
    rows; an odd s-stride drops to 4-byte copies in fp32 and to element
    loads in bf16; a view that starts 4 bytes into its storage does too."""
    qkv = torch.zeros(2, 40, 3, 4, 64)
    _, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert _flash_load_width(k, v) == 16
    odd = torch.zeros(2, 4, 40 * 65)[..., :40 * 65].reshape(2, 4, 40, 65)
    k = odd[..., :64]
    assert k.stride(2) == 65
    assert _flash_load_width(k, k) == 4
    kb = torch.zeros(2, 4, 40, 65, dtype=torch.bfloat16)[..., :64]
    assert _flash_load_width(kb, kb) == 2
    shifted = torch.zeros(2 * 4 * 40 * 64 + 1)[1:].reshape(2, 4, 40, 64)
    assert _flash_load_width(shifted, shifted) == 4


# -- K1's bf16 route on Hopper, emulated ------------------------------------
#
# bf16 q, k and v at D = 64 go to csrc/flash_attention_sm90.cu: wgmma with
# bf16 operands, so Q.K^T is exact products with fp32 sums; the online
# softmax in base 2 and O in fp32, per warpgroup of 64 query rows over
# tiles of 128 keys; P split into P_hi (p cut to bf16: its high 16 bits)
# and P_lo = bf16(p - P_hi), O rescaled, then P_lo.V added before P_hi.V;
# the output rounded once to bf16. The emulation below repeats that arithmetic in torch on the CPU
# and holds it, on bf16 inputs, against the TPU kernel ``_fa_kernel`` in
# interpret mode and the plain version in fp32 rounded once, within the
# card's gate: rtol 2^-6 (two bf16 ulps), atol 1e-5.

BF16_RTOL = 2.0 ** -6


def _emulate_k1_bf16(q, k, v, sm_scale, causal, two_pass=True, BM=64,
                     BK=128):
    """The sm90 kernel's forward on bf16 (B, H, S, 64) tensors."""
    qf, kf, vf = q.float(), k.float(), v.float()
    S_q, S_k = q.shape[2], k.shape[2]
    off = S_k - S_q
    # the kernel's scale: sm_scale * log2(e) in fp32
    c = float(torch.tensor(sm_scale, dtype=torch.float32) *
              torch.tensor(_LOG2E, dtype=torch.float32))
    out = torch.empty(q.shape, dtype=torch.float32)
    for r0 in range(0, S_q, BM):
        qt = qf[:, :, r0:r0 + BM]
        rows = torch.arange(r0, r0 + qt.shape[2])[:, None]
        kend = min(S_k, r0 + qt.shape[2] + off) if causal else S_k
        m = torch.full(qt.shape[:3] + (1,), -1e30)
        l = torch.zeros(qt.shape[:3] + (1,))
        acc = torch.zeros(qt.shape)
        for k0 in range(0, kend, BK):
            kt, vt = kf[:, :, k0:k0 + BK], vf[:, :, k0:k0 + BK]
            s = qt @ kt.transpose(-1, -2)
            if causal:  # a masked score is -inf, its weight exactly 0
                keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
                s = torch.where(keys <= rows + off, s,
                                torch.full_like(s, float("-inf")))
            # the max in base-2 units, then p = 2^(s * c - m) in one
            # rounding (the kernel's fused multiply-add)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2((s.double() * c - m_new.double()).float())
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha
            if two_pass:  # P_hi: p's high 16 bits
                p_hi = (p.view(torch.int32) & -65536).view(torch.float32)
            else:  # one pass: p rounded to bf16
                p_hi = p.bfloat16().float()
            if two_pass:
                acc = acc + (p - p_hi).bfloat16().float() @ vt
            acc = acc + p_hi @ vt
            m = m_new
        out[:, :, r0:r0 + BM] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


def _bf16_inputs(B, H, S_q, S_k, seed, scale=1.0):
    rs = onp.random.RandomState(seed)
    return [torch.from_numpy((rs.randn(B, H, s, 64) * scale).astype("f"))
            .bfloat16() for s in (S_q, S_k, S_k)]


def _close_bf16(got, want):
    return torch.allclose(got.float(), want.float(), rtol=BF16_RTOL,
                          atol=TOL)


# (B, H, S_q, S_k, causal, seed, input scale): ragged S, causal offsets
# S_q < S_k, B*H = 1, and large logits (inputs x 4: scores up to ~100)
BF16_CASES = [
    pytest.param(1, 2, 130, 130, True, 21, 1.0, id="ragged-130-causal"),
    pytest.param(1, 1, 499, 499, False, 22, 1.0, id="ragged-499-bh1"),
    pytest.param(2, 1, 100, 300, True, 23, 1.0, id="causal-sq-lt-sk"),
    pytest.param(1, 1, 1, 200, True, 24, 1.0, id="decode-row"),
    pytest.param(1, 2, 256, 256, True, 25, 4.0, id="large-logits"),
]


@pytest.mark.parametrize("B,H,S_q,S_k,causal,seed,scale", BF16_CASES)
def test_sm90_emulation_within_gate_of_plain_and_pallas(B, H, S_q, S_k,
                                                        causal, seed, scale):
    q, k, v = _bf16_inputs(B, H, S_q, S_k, seed, scale)
    sm_scale = 64 ** -0.5
    got = _emulate_k1_bf16(q, k, v, sm_scale, causal)
    plain = _flash_ref(q.float(), k.float(), v.float(), sm_scale,
                       causal).bfloat16()
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    pallas = torch.from_numpy(onp.asarray(jax_flash_attention(
        jq, jk, jv, causal=causal, use_pallas=True).astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, S_q, 64)
    assert _close_bf16(got, plain), float((got.float() - plain.float())
                                          .abs().max())
    assert _close_bf16(got, pallas), float((got.float() - pallas)
                                           .abs().max())


def test_sm90_one_bf16_pass_of_p_breaks_the_gate():
    """Why P_lo: one bf16 pass rounds P to 8 bits, and the output leaves
    the gate; with two passes P is held to about 2^-16 and the output is
    the plain version's own rounding in all but a few elements."""
    q, k, v = _bf16_inputs(1, 2, 256, 256, 26)
    plain = _flash_ref(q.float(), k.float(), v.float(), 0.125,
                       True).bfloat16()
    two = _emulate_k1_bf16(q, k, v, 0.125, True)
    one = _emulate_k1_bf16(q, k, v, 0.125, True, two_pass=False)
    assert _close_bf16(two, plain)
    assert not _close_bf16(one, plain)
    assert float((two != plain).float().mean()) < 0.01
    assert float((one != plain).float().mean()) > 0.1


# (shape, make) -> route: the rule on dtypes, shapes, strides, pointers
def _qkv_views(B, S, H, D, dtype=torch.bfloat16):
    qkv = torch.zeros(B, S, 3, H, D, dtype=dtype)
    return qkv.permute(2, 0, 3, 1, 4)


def test_route_takes_the_lm_views_at_gpt2_small_widths():
    q, k, v = _qkv_views(8, 1024, 12, 64)
    assert not q.is_contiguous()
    assert _flash_route(q, k, v) == "sm90"
    # k starts 1,536 bytes into the projection; its byte strides, which
    # the tensor map takes, are (b, h, s) = (4,718,592, 128, 4,608)
    assert k.data_ptr() - q.data_ptr() == 12 * 64 * 2
    assert tuple(2 * s for s in k.stride()[:3]) == (1024 * 2304 * 2, 128,
                                                    4608)
    c = torch.zeros(2, 12, 100, 64, dtype=torch.bfloat16)
    assert _flash_route(c, c, c) == "sm90"


def test_route_sends_what_tma_cannot_read_to_mma():
    c = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    # a base 2 bytes into its storage
    shifted = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16)[1:] \
        .reshape(1, 2, 64, 64)
    assert _flash_route(shifted, c, c) == "mma"
    assert _flash_route(c, c, shifted) == "mma"
    # an odd s-stride (65 elements)
    odd = torch.zeros(1, 2, 64, 65, dtype=torch.bfloat16)[..., :64]
    assert _flash_route(c, odd, odd) == "mma"
    # other head widths, fp32, a mixed pair
    for D in (32, 128):
        t = torch.zeros(1, 2, 64, D, dtype=torch.bfloat16)
        assert _flash_route(t, t, t) == "mma"
    f = c.float()
    assert _flash_route(f, f, f) == "mma"
    assert _flash_route(c, f, c) == "mma"
    # D not contiguous
    tr = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16).transpose(2, 3)
    assert _flash_route(tr, c, c) == "mma"


def test_kernel_wrapper_rejects_an_unknown_or_impossible_route():
    """On CPU tensors the wrapper is the plain version whatever the route
    (the route is the card's), and counts nothing."""
    q, k, v = _bf16_inputs(1, 1, 8, 8, 27)
    _build.reset_launch_counts()
    want = _flash_ref(q, k, v, 0.125, True)
    for route in (None, "sm90", "mma"):
        assert torch.equal(_flash_fwd_cuda(q, k, v, 0.125, True,
                                           route=route), want)
    assert _build.launch_counts() == {}
