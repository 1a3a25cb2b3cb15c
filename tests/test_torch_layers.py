"""The Gluon layers the decoder is built from: the PyTorch port against
the JAX package on the CPU, with weights carried across.

Each JAX block is initialized and run once (finishing deferred shape
inference), its parameters are read out as numpy and loaded into the
port's block through ``convert.params_from_numpy``, and both run the
same seeded input. Tolerance 1e-6: one matmul or one normalisation in
fp32, summed in a different order by torch and XLA.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import nn

TOL = 1e-6
# Every JAX block here gets an explicit prefix, so building it does not
# advance the JAX package's process-wide name counters: other tests in
# the same process see the auto-generated names they would see alone.


def _carry(jblock, tblock, x):
    """Run ``jblock`` on ``x`` (finishing its deferred init), carry its
    weights into ``tblock``; returns both outputs as numpy."""
    jblock.initialize()
    with jautograd.pause(train_mode=False):
        want = jblock(jmx.nd.array(x)).asnumpy()
    arrays = {k: p.data().asnumpy()
              for k, p in jblock._collect_params_with_prefix().items()}
    convert.params_from_numpy(tblock, arrays, ctx=mx.cpu())
    with mx.autograd.pause():
        got = tblock(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    return got, want


@pytest.mark.parametrize("kw,shape", [
    ({"flatten": False}, (3, 5, 7)),
    ({"flatten": False, "activation": "relu"}, (4, 7)),
    ({"flatten": True}, (3, 2, 7)),
    ({"flatten": False, "use_bias": False}, (2, 7)),
])
def test_dense_matches_jax(kw, shape):
    x = onp.random.RandomState(1).randn(*shape).astype("f")
    got, want = _carry(jnn.Dense(6, prefix="dense_", **kw),
                        nn.Dense(6, **kw), x)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_embedding_matches_jax_including_out_of_range():
    """In range, negative (counts from the end) and out of range (a row
    of NaN: the JAX package's ``jnp.take`` fill rule, never a trap)."""
    idx = onp.array([[0, 3, 9], [-1, 10, 4]], "int32")
    got, want = _carry(jnn.Embedding(10, 4, prefix="embedding_"),
                        nn.Embedding(10, 4), idx)
    assert onp.isnan(want[1, 1]).all()
    onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches_jax(axis):
    x = (onp.random.RandomState(2).randn(3, 6, 5) * 3 + 1).astype("f")
    jblk = jnn.LayerNorm(axis=axis, prefix="layernorm_")
    tblk = nn.LayerNorm(axis=axis)
    jblk.initialize()
    rs = onp.random.RandomState(3)
    c = x.shape[axis]
    for p in jblk.collect_params().values():  # non-trivial gamma / beta
        p.shape = (c,)
    with jautograd.pause(train_mode=False):
        jblk(jmx.nd.array(x))
    jblk.gamma.set_data(jmx.nd.array(rs.rand(c).astype("f") + 0.5))
    jblk.beta.set_data(jmx.nd.array(rs.randn(c).astype("f")))
    got, want = _carry(jblk, tblk, x)
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_relu_activation_matches_jax():
    x = onp.random.RandomState(4).randn(4, 9).astype("f")
    got, want = _carry(jnn.Activation("relu", prefix="relu_"),
                        nn.Activation("relu"), x)
    onp.testing.assert_array_equal(got, want)


def test_hybrid_sequential_structural_names_match_jax():
    def build(nnmod):
        net = nnmod.HybridSequential(prefix="seq_")
        with net.name_scope():
            net.add(nnmod.Dense(8, activation="relu"), nnmod.LayerNorm(),
                    nnmod.Dense(3))
        return net

    x = onp.random.RandomState(5).randn(4, 6).astype("f")
    jnet, tnet = build(jnn), build(nn)
    got, want = _carry(jnet, tnet, x)
    assert sorted(tnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix()) == \
        ["0.bias", "0.weight", "1.beta", "1.gamma", "2.bias", "2.weight"]
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the torch view of the same parameters
    assert sorted(n for n, _ in tnet.named_parameters()) == \
        ["0.bias", "0.weight", "1.beta", "1.gamma", "2.bias", "2.weight"]


def test_params_from_numpy_refuses_bad_names_and_shapes():
    net = nn.Dense(4, in_units=3)
    good = {"weight": onp.zeros((4, 3), "f"), "bias": onp.zeros(4, "f")}
    with pytest.raises(mx.MXNetError, match="missing"):
        convert.params_from_numpy(net, {"weight": good["weight"]},
                                  ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="extra"):
        convert.params_from_numpy(net, {**good, "gamma": good["bias"]},
                                  ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="shape"):
        convert.params_from_numpy(
            net, {**good, "weight": onp.zeros((3, 4), "f")}, ctx=mx.cpu())
    # nothing was written by the refused calls; a good call loads exactly
    assert net.weight._ndarray is None
    convert.params_from_numpy(net, {k: v + 1 for k, v in good.items()},
                              ctx=mx.cpu())
    assert torch.equal(net.weight.data().data, torch.ones(4, 3))


def test_deferred_dense_initializes_on_first_forward():
    """Also when that forward runs in inference mode, as the serving
    session's does: the parameter stays updatable outside it."""
    net = nn.Dense(5, flatten=False)
    net.initialize(ctx=mx.cpu())
    with torch.inference_mode():
        out = net(mx.nd.array(onp.ones((2, 3, 4), "f"), ctx=mx.cpu()))
    assert out.shape == (2, 3, 5)
    assert net.weight.shape == (5, 4)
    assert out.context == mx.cpu()
    assert not net.weight.data().data.is_inference()
    net.weight.set_data(onp.ones((5, 4), "f"))
    assert torch.equal(net.weight.data().data, torch.ones(5, 4))
