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

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.kernels import _build
from mxnet_tpu_torch.kernels.flash_attention import (_flash_bwd,
                                                     _flash_fwd_cuda,
                                                     _flash_ref,
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
