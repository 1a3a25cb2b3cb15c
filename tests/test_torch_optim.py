"""The port's optimizer ops, optimizers and Trainer against the JAX
package's.

The update ops (``sgd_update``, ``sgd_mom_update``, ``adam_update``)
write in place in the port and return new arrays in JAX; both get the
same numpy inputs, with ``wd``, ``rescale_grad`` and ``clip_gradient``
on and off, and must agree within 1e-6 (the same fp32 arithmetic in
the same order). The Trainer must update every parameter's own tensor
in place: the ``torch.nn.Parameter`` a block registered stays the one
it computes with.
"""
import itertools

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.ndarray import ops_optim

TOL = 1e-6
HYPER = [dict(wd=wd, rescale_grad=rs, clip_gradient=clip)
         for wd, rs, clip in itertools.product((0.0, 0.01), (1.0, 0.25),
                                               (-1.0, 0.5))]


def _arrays(n, seed=0, shape=(4, 6)):
    rs = onp.random.RandomState(seed)
    return [(rs.randn(*shape) * 2).astype("f") for _ in range(n)]


def _ids(h):
    return f"wd{h['wd']}-rs{h['rescale_grad']}-clip{h['clip_gradient']}"


@pytest.mark.parametrize("hyper", HYPER, ids=_ids)
def test_sgd_update_matches_jax(hyper):
    w, g = _arrays(2, 1)
    want = jmx.nd.sgd_update(jmx.nd.array(w), jmx.nd.array(g), lr=0.1,
                             **hyper).asnumpy()
    tw = torch.from_numpy(w.copy())
    out = ops_optim.sgd_update(tw, torch.from_numpy(g), 0.1, **hyper)
    assert out is tw  # in place
    onp.testing.assert_allclose(tw.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hyper", HYPER, ids=_ids)
def test_sgd_mom_update_matches_jax(hyper):
    w, g, m = _arrays(3, 2)
    jw, jm = jmx.nd.sgd_mom_update(jmx.nd.array(w), jmx.nd.array(g),
                                   jmx.nd.array(m), lr=0.1, momentum=0.9,
                                   **hyper)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    ops_optim.sgd_mom_update(tw, torch.from_numpy(g), tm, 0.1, momentum=0.9,
                             **hyper)
    onp.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hyper", HYPER, ids=_ids)
def test_adam_update_matches_jax(hyper):
    w, g, m = _arrays(3, 3)
    v = onp.abs(_arrays(1, 4)[0])
    want = jmx.nd.adam_update(jmx.nd.array(w), jmx.nd.array(g),
                              jmx.nd.array(m), jmx.nd.array(v), lr=0.01,
                              **hyper)
    got = [torch.from_numpy(a.copy()) for a in (w, m, v)]
    ops_optim.adam_update(got[0], torch.from_numpy(g), got[1], got[2], 0.01,
                          **hyper)
    for t, j in zip(got, want):
        onp.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=TOL,
                                    atol=TOL)


def test_registered_ops_record_nothing_and_update_in_place():
    w = nd.array(_arrays(1, 5)[0], ctx=mx.cpu())
    w.attach_grad()
    g = nd.array(_arrays(1, 6)[0], ctx=mx.cpu())
    before = w.data.data_ptr()
    with autograd.record():
        out = nd.sgd_update(w, g, lr=0.5)
    assert out.data is w.data and w.data.data_ptr() == before
    assert out.data.grad_fn is None


def _dense_nets(w, b):
    """The same Dense(3) in both packages, weights carried from numpy."""
    jnet = jgluon.nn.Dense(3, in_units=5, prefix="optim_dense_")
    jnet.initialize()
    jnet.weight.set_data(jmx.nd.array(w))
    jnet.bias.set_data(jmx.nd.array(b))
    tnet = gluon.nn.Dense(3, in_units=5)
    tnet.initialize(ctx=mx.cpu())
    tnet.weight.set_data(w)
    tnet.bias.set_data(b)
    return jnet, tnet


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.05, "clip_gradient": 0.2}),
])
def test_trainer_tracks_jax_and_keeps_tensor_identity(optimizer, params):
    rs = onp.random.RandomState(11)
    w, b = rs.randn(3, 5).astype("f"), rs.randn(3).astype("f")
    X, Y = rs.randn(8, 5).astype("f"), rs.randn(8, 3).astype("f")
    jnet, tnet = _dense_nets(w, b)
    jtr = jgluon.Trainer(jnet.collect_params(), optimizer, dict(params))
    ttr = gluon.Trainer(tnet.collect_params(), optimizer, dict(params))
    jl, tl = jgluon.loss.L2Loss(), gluon.loss.L2Loss()
    tensors = {n: p.data().data for n, p in tnet.collect_params().items()}
    ptrs = {n: t.data_ptr() for n, t in tensors.items()}
    for _ in range(4):
        with jautograd.record():
            jloss = jl(jnet(jmx.nd.array(X)), jmx.nd.array(Y)).mean()
        jloss.backward()
        jtr.step(8)
        with autograd.record():
            tloss = tl(tnet(nd.array(X, ctx=mx.cpu())),
                       nd.array(Y, ctx=mx.cpu())).mean()
        tloss.backward()
        ttr.step(8)
        onp.testing.assert_allclose(tloss.asscalar(), jloss.asscalar(),
                                    rtol=1e-5)
    for (jn, jp), (tn, tp) in zip(sorted(jnet._collect_params_with_prefix()
                                         .items()),
                                  sorted(tnet._collect_params_with_prefix()
                                         .items())):
        assert jn == tn
        onp.testing.assert_allclose(tp.data().asnumpy(), jp.data().asnumpy(),
                                    rtol=1e-5, atol=1e-6)
    for n, p in tnet.collect_params().items():
        assert p.data().data is tensors[n]
        assert p.data().data.data_ptr() == ptrs[n]
    assert tnet._parameters["weight"] is tensors[tnet.weight.name]


def test_trainer_save_and_load_states(tmp_path):
    rs = onp.random.RandomState(12)
    w, b = rs.randn(3, 5).astype("f"), rs.randn(3).astype("f")
    X, Y = rs.randn(8, 5).astype("f"), rs.randn(8, 3).astype("f")
    runs = []
    for resume in (False, True):
        _, net = _dense_nets(w, b)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.05})
        for step in range(4):
            if resume and step == 2:
                tr.save_states(str(tmp_path / "adam.states"))
                tr = gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.05})
                tr.load_states(str(tmp_path / "adam.states"))
            with autograd.record():
                loss = gluon.loss.L2Loss()(net(nd.array(X, ctx=mx.cpu())),
                                           nd.array(Y, ctx=mx.cpu()))
            loss.backward()
            tr.step(8)
        runs.append(net.weight.data().asnumpy())
    onp.testing.assert_array_equal(runs[0], runs[1])


def test_trainer_options():
    _, net = _dense_nets(*_arrays(1, 13, (3, 5)), onp.zeros(3, "f"))
    # a one-process dist_sync Trainer steps exactly as a local one
    w0 = net.weight.data().asnumpy().copy()
    b0 = net.bias.data().asnumpy().copy()
    runs = []
    for kv in ("dist_sync", "local"):
        net.weight.set_data(w0)
        net.bias.set_data(b0)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           kvstore=kv)
        assert tr._distributed == (kv == "dist_sync")
        for i in range(3):
            with autograd.record():
                loss = nd.sum(net(nd.array(_arrays(1, 20 + i, (2, 5))[0],
                                           ctx=mx.cpu())) ** 2)
            loss.backward()
            tr.step(2)
        runs.append((net.weight.data().asnumpy(), net.bias.data().asnumpy()))
    for a, b in zip(*runs):
        onp.testing.assert_array_equal(a, b)
    net.weight.set_data(w0)
    net.bias.set_data(b0)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.3},
                       kvstore="local")
    assert tr.learning_rate == 0.3
    tr.set_learning_rate(0.1)
    assert tr.learning_rate == 0.1
    net.bias.grad_req = "null"  # skipped by step
    before = net.bias.data().asnumpy()
    with autograd.record():
        loss = nd.sum(net(nd.array(_arrays(1, 14, (2, 5))[0], ctx=mx.cpu())))
    loss.backward()
    tr.step(2)
    onp.testing.assert_array_equal(net.bias.data().asnumpy(), before)
    tr.zero_grad()
    assert not net.weight.grad().asnumpy().any()
