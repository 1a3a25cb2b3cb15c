"""The port's autograd tape against the JAX package's.

The port's tape is torch's autograd graph, with MXNet's ``grad_req``
rules laid over it: ``write`` overwrites, ``add`` accumulates, ``null``
never gets a gradient, and a marked variable a ``backward`` does not
reach keeps its old gradient. Each case runs the same numpy inputs
through both packages and compares the gradients within 1e-6 (the
same fp32 arithmetic, a few ops deep).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon import nn

TOL = 1e-6


def _pair(a):
    """The same numpy array in both packages (the port's on the CPU)."""
    return jmx.nd.array(a), nd.array(a, ctx=mx.cpu())


def _x(seed=0, shape=(3, 4)):
    return onp.random.RandomState(seed).randn(*shape).astype("f")


def test_scopes_match_jax():
    seen = []
    for ag in (jautograd, autograd):
        flags = [(ag.is_recording(), ag.is_training())]
        with ag.record():
            flags.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                flags.append((ag.is_recording(), ag.is_training()))
            with ag.pause(train_mode=True):
                flags.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            flags.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            flags.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                flags.append((ag.is_recording(), ag.is_training()))
        flags.append((ag.is_recording(), ag.is_training()))
        seen.append(flags)
    assert seen[0] == seen[1]
    assert seen[1][1] == (True, True) and seen[1][2] == (False, False)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_grad_req_write_and_add_over_two_backwards(grad_req):
    grads = []
    for pkg, ag, x in zip((jmx.nd, nd), (jautograd, autograd), _pair(_x())):
        x.attach_grad(grad_req=grad_req)
        for c in (2.0, 3.0):
            with ag.record():
                y = pkg.sum(x * x * c)
            y.backward()
        grads.append(x.grad.asnumpy())
    want = 2 * 3.0 * _x() + (2 * 2.0 * _x() if grad_req == "add" else 0)
    onp.testing.assert_allclose(grads[0], want, rtol=1e-5)
    onp.testing.assert_allclose(grads[1], grads[0], rtol=TOL, atol=TOL)


def test_grad_req_null_never_gets_a_gradient():
    grads = []
    for pkg, ag, (x, z) in zip((jmx.nd, nd), (jautograd, autograd),
                               zip(_pair(_x(1)), _pair(_x(2)))):
        x.attach_grad(grad_req="null")
        z.attach_grad()
        with ag.record():
            y = pkg.sum(x * z)
        y.backward()
        grads.append((x.grad.asnumpy(), z.grad.asnumpy()))
    for g_jax, g_port in zip(*grads):
        onp.testing.assert_allclose(g_port, g_jax, rtol=TOL, atol=TOL)
    assert not grads[1][0].any()  # the null buffer stays zero


def test_unreached_variable_keeps_its_old_gradient():
    grads = []
    for pkg, ag, (x, z) in zip((jmx.nd, nd), (jautograd, autograd),
                               zip(_pair(_x(3)), _pair(_x(4)))):
        x.attach_grad()
        z.attach_grad()
        with ag.record():
            both = pkg.sum(x * z)
        both.backward()  # both get a gradient
        with ag.record():
            only_x = pkg.sum(x * x)
        only_x.backward()  # z is not reached: keeps z.grad == x
        grads.append((x.grad.asnumpy(), z.grad.asnumpy()))
    for g_jax, g_port in zip(*grads):
        onp.testing.assert_allclose(g_port, g_jax, rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(grads[1][1], _x(3), rtol=TOL)


def test_head_gradient_and_shared_use_sum_once():
    """A variable used twice gets the sum of both paths, once; an
    explicit head gradient seeds the backward."""
    seed = _x(6)
    grads = []
    for pkg, ag, x in zip((jmx.nd, nd), (jautograd, autograd), _pair(_x(5))):
        x.attach_grad()
        with ag.record():
            y = x * x + x * 3.0
        y.backward(pkg.array(seed) if pkg is jmx.nd
                   else nd.array(seed, ctx=mx.cpu()))
        grads.append(x.grad.asnumpy())
    onp.testing.assert_allclose(grads[1], grads[0], rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(grads[1], seed * (2 * _x(5) + 3), rtol=1e-5)


def _dense_pair(grad_req):
    w = _x(7, (5, 4))
    jd = jnn.Dense(5, in_units=4, use_bias=False, prefix="autograd_dense_")
    jd.initialize()
    jd.weight.set_data(jmx.nd.array(w))
    td = nn.Dense(5, in_units=4, use_bias=False)
    td.initialize(ctx=mx.cpu())
    td.weight.set_data(w)
    for d in (jd, td):
        d.weight.grad_req = grad_req
    return jd, td


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_parameter_grad_req_and_zero_grad(grad_req):
    jd, td = _dense_pair(grad_req)
    x = _x(8, (2, 4))
    results = []
    for d, ag, pkg in ((jd, jautograd, jmx.nd), (td, autograd, nd)):
        xs = pkg.array(x) if pkg is jmx.nd else nd.array(x, ctx=mx.cpu())
        for _ in range(2):
            with ag.record():
                loss = pkg.sum(d(xs))
            loss.backward()
        after_two = d.weight.grad().asnumpy()
        d.weight.zero_grad()
        results.append((after_two, d.weight.grad().asnumpy()))
    for g_jax, g_port in zip(*results):
        onp.testing.assert_allclose(g_port, g_jax, rtol=TOL, atol=TOL)
    assert not results[1][1].any()
    td.weight.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        td.weight.grad()
    assert not td.weight.data().data.requires_grad


def test_no_graph_outside_record():
    """A forward outside record() (or inside pause()) builds no graph,
    so a serving step holds no activations."""
    _, td = _dense_pair("write")
    x = nd.array(_x(9, (2, 4)), ctx=mx.cpu())
    assert td.weight.data().data.requires_grad
    out = td(x)
    assert out.data.grad_fn is None and not out.data.requires_grad
    arith = td.weight.data() * 2.0 + 1.0
    assert arith.data.grad_fn is None
    with autograd.record():
        inside = td(x)
        with autograd.pause():
            paused = td(x)
    assert inside.data.grad_fn is not None
    assert paused.data.grad_fn is None
    with pytest.raises(mx.MXNetError, match="record"):
        out.backward()


def test_attach_grad_cuts_history_and_detach():
    x = nd.array(_x(10), ctx=mx.cpu())
    x.attach_grad()
    with autograd.record():
        y = x * 2.0
    y.attach_grad()  # y becomes a leaf of its own
    with autograd.record():
        z = nd.sum(y * y)
    z.backward()
    onp.testing.assert_allclose(y.grad.asnumpy(), 4 * _x(10), rtol=1e-6)
    assert not x.grad.asnumpy().any()  # the cut history never reached x
    assert x.detach().data.grad_fn is None
    assert torch.equal(x.detach().data, x.data.detach())


def test_parameter_gradient_buffer_is_allocated_by_first_backward():
    """A model that only runs forward holds no gradient buffers; grad()
    before any backward reads zeros, as the JAX package's does."""
    jd, td = _dense_pair("write")
    x = nd.array(_x(11, (2, 4)), ctx=mx.cpu())
    td(x)
    assert td.weight.data().grad is None
    onp.testing.assert_array_equal(td.weight.grad().asnumpy(),
                                   jd.weight.grad().asnumpy())
    with autograd.record():
        loss = nd.sum(td(x))
    loss.backward()
    assert td.weight.data().grad is td.weight.grad()
    assert td.weight.grad().asnumpy().any()
