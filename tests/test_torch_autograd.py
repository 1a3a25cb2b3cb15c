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


# -- grad (first and higher order), Function, get_symbol -------------------
# Against the JAX package's grad (tests/test_higher_order_dlpack.py) and
# Function (tests/test_autograd.py:109): the same fp32 arithmetic, a few
# ops deep, so 1e-6 holds for first order; second and third derivatives
# run through more ops, 1e-5.

HO_TOL = 1e-5


def test_grad_first_order_matches_jax_and_leaves_buffers():
    got = []
    for ag, x in zip((jautograd, autograd), _pair(_x(3, (5,)))):
        x.attach_grad()
        x.grad[:] = 7.0
        with ag.record():
            y = x * x * x
        g = ag.grad(y, x)
        assert g.shape == x.shape
        # the variable's buffer and grad_req are as they were
        onp.testing.assert_array_equal(x.grad.asnumpy(), onp.full(5, 7.0))
        assert x._grad_req == "write"
        got.append(g.asnumpy())
    onp.testing.assert_allclose(got[1], got[0], rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(got[1], 3 * _x(3, (5,)) ** 2, rtol=TOL)


def test_grad_of_several_variables_and_head_grads():
    got = []
    a0, b0 = _x(4, (3,)), _x(5, (3,))
    hg = _x(6, (3,))
    for pkg, ag, ctx in ((jmx.nd, jautograd, None), (nd, autograd, mx.cpu())):
        kw = {} if ctx is None else {"ctx": ctx}
        a, b = pkg.array(a0, **kw), pkg.array(b0, **kw)
        a.attach_grad()
        b.attach_grad()
        with ag.record():
            y = a * b + a
        ga, gb = ag.grad(y, [a, b], head_grads=pkg.array(hg, **kw))
        got.append((ga.asnumpy(), gb.asnumpy()))
    for j, p in zip(got[0], got[1]):
        onp.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_grad_second_order_polynomial_matches_jax():
    got = []
    for ag, x in zip((jautograd, autograd),
                     _pair(onp.array([2.0, -1.0, 0.5], "f"))):
        x.attach_grad()
        with ag.record():
            y = x * x * x
            g = ag.grad(y, x, create_graph=True)  # 3x^2
            g.backward()
        got.append((g.asnumpy(), x.grad.asnumpy()))
    for j, p in zip(got[0], got[1]):
        onp.testing.assert_allclose(p, j, rtol=HO_TOL, atol=HO_TOL)
    onp.testing.assert_allclose(got[1][1], [12.0, -6.0, 3.0], rtol=HO_TOL)


def test_grad_third_order_via_nested_grad_matches_jax():
    got = []
    for ag, x in zip((jautograd, autograd), _pair(onp.array([1.5], "f"))):
        x.attach_grad()
        with ag.record():
            y = x * x * x * x
            g1 = ag.grad(y, x, create_graph=True)   # 4x^3
            g2 = ag.grad(g1, x, create_graph=True)  # 12x^2
            g2.backward()                           # 24x
        got.append(x.grad.asnumpy())
    onp.testing.assert_allclose(got[1], got[0], rtol=HO_TOL, atol=HO_TOL)
    onp.testing.assert_allclose(got[1], [36.0], rtol=HO_TOL)


@pytest.mark.parametrize("op", ["sigmoid", "tanh", "log", "exp"])
def test_grad_second_order_unary_matches_jax(op):
    got = []
    for pkg, ag, x in zip((jmx.nd, nd), (jautograd, autograd),
                          _pair(onp.array([0.7], "f"))):
        x.attach_grad()
        with ag.record():
            y = getattr(pkg, op)(x)
            g = ag.grad(y, x, create_graph=True)
            g.backward()
        got.append(x.grad.asnumpy())
    onp.testing.assert_allclose(got[1], got[0], rtol=HO_TOL, atol=HO_TOL)


def test_grad_second_order_through_matmul_loss_matches_jax():
    rs = onp.random.RandomState(0)
    w0, x0 = rs.rand(3, 3).astype("f"), rs.rand(4, 3).astype("f")
    got = []
    for pkg, ag, ctx in ((jmx.nd, jautograd, None), (nd, autograd, mx.cpu())):
        kw = {} if ctx is None else {"ctx": ctx}
        w, x = pkg.array(w0, **kw), pkg.array(x0, **kw)
        w.attach_grad()
        with ag.record():
            loss = pkg.sum(pkg.dot(x, w) * pkg.dot(x, w))
            g = ag.grad(loss, w, create_graph=True)
            gnorm = pkg.sum(g * g)
            gnorm.backward()
        got.append(w.grad.asnumpy())
    onp.testing.assert_allclose(got[1], got[0], rtol=HO_TOL, atol=HO_TOL)
    A = x0.T @ x0
    onp.testing.assert_allclose(got[1], 8 * A @ A @ w0, rtol=1e-4)


def test_grad_needs_a_marked_variable():
    x = nd.array(_x(), ctx=mx.cpu())
    v = nd.array(_x(1), ctx=mx.cpu())
    v.attach_grad()
    with autograd.record():
        y = v * 2
    with pytest.raises(mx.MXNetError, match="attach_grad"):
        autograd.grad(y, x)


def test_custom_function_matches_jax():
    got = []
    for pkg, ag, x in zip((jmx.nd, nd), (jautograd, autograd),
                          _pair(_x(7, (6,)))):
        class Sigmoid(ag.Function):
            def forward(self, x):
                y = pkg.sigmoid(x)
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        x.attach_grad()
        with ag.record():
            y = Sigmoid()(x)
            z = (y * y).sum()
        z.backward()
        got.append((y.asnumpy(), x.grad.asnumpy()))
    for j, p in zip(got[0], got[1]):
        onp.testing.assert_allclose(p, j, rtol=TOL, atol=TOL)


def test_custom_function_with_two_inputs_and_outputs():
    class MulAdd(autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + b

        def backward(self, d_mul, d_add):
            a, b = self.saved_tensors
            return d_mul * b + d_add, d_mul * a + d_add

    a = nd.array(_x(1, (4,)), ctx=mx.cpu())
    b = nd.array(_x(2, (4,)), ctx=mx.cpu())
    a.attach_grad()
    b.attach_grad()
    with autograd.record():
        m, s = MulAdd()(a, b)
        z = (m + s * 3).sum()
    z.backward()
    onp.testing.assert_allclose(a.grad.asnumpy(), _x(2, (4,)) + 3, rtol=TOL)
    onp.testing.assert_allclose(b.grad.asnumpy(), _x(1, (4,)) + 3, rtol=TOL)
    # outside record() it is the plain forward
    m2, _ = MulAdd()(a, b)
    assert m2.data.grad_fn is None


def test_get_symbol_raises():
    with pytest.raises(NotImplementedError):
        autograd.get_symbol(nd.zeros((1,), ctx=mx.cpu()))
