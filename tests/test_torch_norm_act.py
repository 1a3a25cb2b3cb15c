"""K3's plain version and the fused LayerNorm→activation op against the
JAX package.

The JAX package's ``_fused_norm_act`` runs as its own tests run it on
the CPU: ``impl="interpret"`` (the Pallas kernel ``_ln_act_kernel``,
interpreted) and ``impl="lax"`` (the replay). The port's
``_norm_act_ref`` (K3's plain version, which K3 is held against on the
card), its wrapper on CPU tensors and ``_fused_norm_act`` with both
impls must agree with them within 1e-5 in float32 — the JAX package's
own bound between its kernel and its replay — over every activation
form ``FUSABLE_ACTS`` lets the fusion pass absorb, ragged row counts and
widths that are not a multiple of 128. In bfloat16 they agree within
one bfloat16 ulp (both compute in float32 and round once). On a meta
tensor the wrapper returns an empty result of the output's shape, which
shape inference of a fused graph needs.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.kernels import norm_act as jnorm_act

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import norm_act
from mxnet_tpu_torch.kernels.norm_act import (
    FUSABLE_ACTS, _fused_norm_act, _norm_act_cuda, _norm_act_ref, act_code)

TOL = 1e-5
BF16_ULP = 2.0 ** -7

# (act_op, act_kw): every form FUSABLE_ACTS admits, with non-default
# slopes and bounds where the form takes them
FORMS = [("activation", (("act_type", a),))
         for a in sorted(FUSABLE_ACTS["activation"])] + [
    ("leaky_relu", (("act_type", "leaky"), ("slope", 0.1))),
    ("leaky_relu", (("act_type", "elu"), ("slope", 0.7))),
    ("leaky_relu", (("act_type", "selu"),)),
    ("leaky_relu", (("act_type", "gelu"),)),
    ("leaky_relu", (("act_type", "rrelu"), ("lower_bound", 0.2),
                    ("upper_bound", 0.4))),
    ("leaky_relu", ()),  # the default act_type, leaky at slope 0.25
] + [(op, ()) for op in ("relu", "sigmoid", "tanh", "softsign")]


def _inputs(rows, C, seed=0):
    rs = onp.random.RandomState(seed)
    return ((rs.randn(rows, C) * 2 + 0.5).astype("float32"),
            (1 + 0.1 * rs.randn(C)).astype("float32"),
            (0.1 * rs.randn(C)).astype("float32"))


def _jax(x, g, b, act_op, act_kw, impl, norm_kw=(("eps", 1e-5),)):
    out = jnorm_act._fused_norm_act(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b), norm_kw=norm_kw,
                                    act_op=act_op, act_kw=act_kw, impl=impl)
    return onp.asarray(out)


def test_every_fusable_form_is_covered():
    covered = {(op, dict(kw).get("act_type")) for op, kw in FORMS}
    for op, acts in FUSABLE_ACTS.items():
        for act in acts:
            assert (op, act) in covered
    assert FUSABLE_ACTS == jnorm_act.FUSABLE_ACTS


@pytest.mark.parametrize("act_op,act_kw", FORMS)
@pytest.mark.parametrize("rows,C", [(37, 100), (300, 512)])
def test_plain_version_matches_jax_kernel_and_replay(act_op, act_kw, rows,
                                                     C):
    x, g, b = _inputs(rows, C)
    code, slope = act_code(act_op, act_kw)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, g, b))
    ref = _norm_act_ref(tx, tg, tb, 1e-5, code, slope).numpy()
    wrapped = _norm_act_cuda(tx, tg, tb, 1e-5, code, slope).numpy()
    assert (wrapped == ref).all()  # a CPU tensor takes the plain version
    for impl in ("interpret", "lax"):
        onp.testing.assert_allclose(
            ref, _jax(x, g, b, act_op, act_kw, impl), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act_op,act_kw", [FORMS[0], FORMS[8]])
def test_fused_op_both_impls_match_jax(act_op, act_kw):
    """``_fused_norm_act`` over a 3-d input: the torch replay and the
    cuda impl (its wrapper takes the plain version for CPU tensors)."""
    x, g, b = _inputs(2 * 13, 96, seed=1)
    x3 = x.reshape(2, 13, 96)
    want = _jax(x3, g, b, act_op, act_kw, "lax")
    for impl in ("torch", "cuda"):
        got = _fused_norm_act(torch.from_numpy(x3), torch.from_numpy(g),
                              torch.from_numpy(b), norm_kw=(("eps", 1e-5),),
                              act_op=act_op, act_kw=act_kw, impl=impl)
        assert got.shape == (2, 13, 96)
        onp.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_torch_impl_normalizes_any_axis_and_cuda_refuses():
    x, g, b = _inputs(6, 4, seed=2)
    g6, b6 = g[:1].repeat(6), b[:1].repeat(6)
    kw = dict(norm_kw=(("axis", 0), ("eps", 1e-3)), act_op="activation",
              act_kw=(("act_type", "tanh"),))
    args = [torch.from_numpy(a) for a in (x, g6, b6)]
    got = _fused_norm_act(*args, impl="torch", **kw)
    want = _jax(x, g6, b6, kw["act_op"], kw["act_kw"], "lax",
                norm_kw=kw["norm_kw"])
    onp.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(MXNetError, match="last axis"):
        _fused_norm_act(*args, impl="cuda", **kw)


def test_bfloat16_within_one_ulp_of_jax_kernel():
    x, g, b = _inputs(130, 200, seed=3)
    xb, gb, bb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g, b))
    got = _norm_act_ref(xb, gb, bb, 1e-5, *act_code(
        "leaky_relu", (("act_type", "gelu"),)))
    assert got.dtype == torch.bfloat16
    want = jnorm_act._fused_norm_act(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        jnp.asarray(gb.float().numpy(), jnp.bfloat16),
        jnp.asarray(bb.float().numpy(), jnp.bfloat16),
        norm_kw=(("eps", 1e-5),), act_op="leaky_relu",
        act_kw=(("act_type", "gelu"),), impl="interpret")
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(want.astype(jnp.float32)),
                                rtol=BF16_ULP, atol=TOL)


def test_meta_tensors_give_the_output_shape():
    x = torch.empty(255992, 512, device="meta")
    g = torch.empty(512, device="meta")
    out = _norm_act_cuda(x, g, g, 1e-5, 8, 0.0)
    assert out.device.type == "meta" and out.shape == (255992, 512)
    out = _fused_norm_act(torch.empty(8, 31999, 512, device="meta"), g, g,
                          act_op="leaky_relu",
                          act_kw=(("act_type", "gelu"),), impl="cuda")
    assert out.shape == (8, 31999, 512) and out.device.type == "meta"
    assert norm_act._build.launch_counts().get(norm_act.KERNEL, 0) == 0


def test_wrapper_refuses_mismatched_inputs_before_launching():
    x = torch.zeros(4, 8)
    with pytest.raises(MXNetError, match="several devices"):
        _norm_act_cuda(x, torch.zeros(8, device="meta"), torch.zeros(8),
                       1e-5, 0, 0.0)
    with pytest.raises(MXNetError, match="no kernel code"):
        act_code("leaky_relu", (("act_type", "prelu"),))
