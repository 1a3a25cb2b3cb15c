"""Custom ops (``operator.CustomOp``, ``nd.Custom``): the port against the
JAX package.

The same ops are registered in both packages under the same names and
fed the same numpy inputs (made from a seed):

- the ``test_sigmoid`` op of ``tests/test_quant_custom.py:127-172``
  (forward ``sigmoid``, backward ``out_grad * y * (1 - y)``), forward and
  gradient, at rtol = atol = 1e-6: both compute the same float32
  expression elementwise;
- ``rtc_softmax``, the ResNet path's loss head: the port's plain version
  (the CPU side of ``tools/profile_resnet.py``) against the same op on
  the JAX side, whose forward and backward are ``rtc.PallasModule``
  kernels run in interpret mode (K4 as the JAX tests reach it): softmax
  and ``p - onehot(label)`` within rtol = atol = 1e-6 (the same float32
  arithmetic, reductions in another order);
- a two-output op, the request modes of ``CustomOp.assign`` (write,
  inplace, add, null), ``need_top_grad=False``, and an unregistered op,
  each with the same outcome on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest

import mxnet_tpu.operator as jop
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu import rtc as jrtc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd, operator
from mxnet_tpu_torch.tools import profile_resnet as pr

TOL = 1e-6


# -- the ops, written once per package ----------------------------------------

def _sigmoid_op(base, F):
    class Sigmoid(base.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], F.sigmoid(in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @base.register("torchparity_sigmoid")
    class SigmoidProp(base.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()


def _two_output_op(base):
    """out0 = a * x, out1 = x + b (a, b keyword arguments, which arrive
    as strings); backward a * g0 + g1."""
    class Affine(base.CustomOp):
        def __init__(self, a, b):
            self.a, self.b = a, b

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * self.a)
            self.assign(out_data[1], req[1], in_data[0] + self.b)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * self.a + out_grad[1])

    @base.register("torchparity_affine2")
    class AffineProp(base.CustomOpProp):
        def __init__(self, a="1", b="0"):
            super().__init__()
            self.a, self.b = float(a), float(b)

        def list_outputs(self):
            return ["scaled", "shifted"]

        def create_operator(self, ctx, shapes, dtypes):
            return Affine(self.a, self.b)


for _base, _F in ((jop, jnd), (operator, nd)):
    _sigmoid_op(_base, _F)
    _two_output_op(_base)


# rtc_softmax on the JAX side: its two kernels as Pallas kernels, mapped
# by the JAX package's runtime-kernel module (interpret mode on the CPU)

def _pallas_softmax_fwd(x_ref, o_ref):
    x = x_ref[...]
    e = jnp.exp(x - jnp.max(x, axis=-1, keepdims=True))
    o_ref[...] = e / jnp.sum(e, axis=-1, keepdims=True)


def _pallas_softmax_bwd(label_ref, p_ref, o_ref):
    p = p_ref[...]
    cls = jax.lax.broadcasted_iota(jnp.int32, p.shape, 1)
    onehot = cls == label_ref[...].astype(jnp.int32)[:, None]
    o_ref[...] = p - onehot.astype(p.dtype)


_PALLAS = jrtc.PallasModule(fwd=_pallas_softmax_fwd, bwd=_pallas_softmax_bwd)


class _JaxRtcSoftmax(jop.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0],
                    _PALLAS.get_kernel("fwd").launch([in_data[0]]))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        p = out_data[0]
        self.assign(in_grad[0], req[0], _PALLAS.get_kernel("bwd").launch(
            [in_data[1], p], out_shape=p.shape, out_dtype=p.dtype))


@jop.register("rtc_softmax")
class _JaxRtcSoftmaxProp(jop.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _JaxRtcSoftmax()


def _port(a):
    return nd.array(a, ctx=mx.cpu())


# -- tests --------------------------------------------------------------------

def test_sigmoid_op_forward_and_gradient_match_jax():
    x = onp.random.RandomState(0).randn(5, 7).astype("f") * 3
    head = onp.random.RandomState(1).randn(5, 7).astype("f")
    ja = jnd.array(x)
    ja.attach_grad()
    with jautograd.record():
        jout = jnd.Custom(ja, op_type="torchparity_sigmoid")
    jout.backward(jnd.array(head))
    ta = _port(x)
    ta.attach_grad()
    with autograd.record():
        tout = nd.Custom(ta, op_type="torchparity_sigmoid")
    tout.backward(_port(head))
    onp.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=TOL,
                                atol=TOL)
    onp.testing.assert_allclose(ta.grad.asnumpy(), ja.grad.asnumpy(),
                                rtol=TOL, atol=TOL)
    sig = 1 / (1 + onp.exp(-x.astype("f8")))
    onp.testing.assert_allclose(ta.grad.asnumpy(), head * sig * (1 - sig),
                                rtol=1e-5, atol=1e-6)


def test_custom_op_outside_record_builds_no_graph():
    ta = _port(onp.ones((3,), "f"))
    ta.attach_grad()
    out = nd.Custom(ta, op_type="torchparity_sigmoid")
    assert out.data.grad_fn is None and not out.data.requires_grad
    onp.testing.assert_allclose(out.asnumpy(), 1 / (1 + onp.exp(-1.0)),
                                rtol=TOL)


@pytest.mark.parametrize("B,C", [(4, 10), (3, 1001), (2, 1)])
def test_rtc_softmax_matches_the_pallas_module_form(B, C):
    rs = onp.random.RandomState(B * C)
    x = (rs.randn(B, C) * 4).astype("f")
    label = rs.randint(0, C, B).astype("f")
    ja = jnd.array(x)
    ja.attach_grad()
    with jautograd.record():
        jp = jnd.Custom(ja, jnd.array(label), op_type="rtc_softmax")
    jp.backward()
    ta = _port(x)
    ta.attach_grad()
    with autograd.record():
        tp = pr.rtc_softmax(ta, _port(label))
    tp.backward()
    onp.testing.assert_allclose(tp.asnumpy(), jp.asnumpy(), rtol=TOL,
                                atol=TOL)
    onp.testing.assert_allclose(ta.grad.asnumpy(), ja.grad.asnumpy(),
                                rtol=TOL, atol=TOL)


def test_rtc_softmax_needs_no_top_gradient():
    """need_top_grad=False: the head's gradient is p - onehot whatever
    head gradient backward is given, in both packages."""
    rs = onp.random.RandomState(7)
    x = rs.randn(3, 6).astype("f")
    label = onp.array([0, 5, 2], "f")
    head = rs.randn(3, 6).astype("f") * 10
    grads = []
    for seed_grad in (None, head):
        ta = _port(x)
        ta.attach_grad()
        with autograd.record():
            tp = pr.rtc_softmax(ta, _port(label))
        tp.backward(None if seed_grad is None else _port(seed_grad))
        grads.append(ta.grad.asnumpy())
    ja = jnd.array(x)
    ja.attach_grad()
    with jautograd.record():
        jp = jnd.Custom(ja, jnd.array(label), op_type="rtc_softmax")
    jp.backward(jnd.array(head))
    onp.testing.assert_array_equal(grads[0], grads[1])
    onp.testing.assert_allclose(grads[1], ja.grad.asnumpy(), rtol=TOL,
                                atol=TOL)
    prop = operator.get_all_registered()["rtc_softmax"]()
    assert prop.need_top_grad_ is False
    assert prop.declare_backward_dependency(["g"], ["x", "l"], ["p"]) == \
        ["x", "l", "p"]


def test_rtc_softmax_plain_versions_against_numpy():
    rs = onp.random.RandomState(3)
    x = rs.randn(5, 9).astype("f8")
    label = onp.array([0, 8, 3, -1, 9], "f8")  # -1 and 9: outside the row
    import torch

    p = pr.softmax_fwd_plain(torch.from_numpy(x)).numpy()
    e = onp.exp(x - x.max(-1, keepdims=True))
    onp.testing.assert_allclose(p, e / e.sum(-1, keepdims=True), rtol=1e-12)
    g = pr.softmax_bwd_plain(torch.from_numpy(label), torch.from_numpy(p))
    want = p.copy()
    want[[0, 1, 2], [0, 8, 3]] -= 1
    onp.testing.assert_allclose(g.numpy(), want, rtol=1e-12)


def test_rtc_softmax_refuses_mixed_inputs():
    with pytest.raises(mx.MXNetError, match="every input"):
        pr.rtc_softmax(_port(onp.zeros((2, 3), "f")),
                       nd.array(onp.zeros(2, "i"), ctx=mx.cpu(),
                                dtype="int32"))
    with pytest.raises(mx.MXNetError, match=r"\(B, C\)"):
        pr.rtc_softmax(_port(onp.zeros((2, 3, 4), "f")),
                       _port(onp.zeros(2, "f")))


def test_two_output_op_with_kwargs_matches_jax():
    x = onp.random.RandomState(2).randn(4, 3).astype("f")
    g0 = onp.random.RandomState(3).randn(4, 3).astype("f")
    g1 = onp.random.RandomState(4).randn(4, 3).astype("f")
    ja = jnd.array(x)
    ja.attach_grad()
    with jautograd.record():
        j0, j1 = jnd.Custom(ja, op_type="torchparity_affine2", a=2.5, b=-1)
    jautograd.backward([j0, j1], [jnd.array(g0), jnd.array(g1)])
    ta = _port(x)
    ta.attach_grad()
    with autograd.record():
        t0, t1 = nd.Custom(ta, op_type="torchparity_affine2", a=2.5, b=-1)
    autograd.backward([t0, t1], [_port(g0), _port(g1)])
    for t, j in ((t0, j0), (t1, j1), (ta.grad, ja.grad)):
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=TOL,
                                    atol=TOL)
    onp.testing.assert_allclose(ta.grad.asnumpy(), 2.5 * g0 + g1, rtol=TOL)


@pytest.mark.parametrize("req", ["write", "inplace", "add", "null"])
def test_assign_honours_the_request_like_jax(req):
    dst0 = onp.arange(6, dtype="f").reshape(2, 3)
    src = onp.full((2, 3), 10.0, "f")
    jdst = jnd.array(dst0)
    jop.CustomOp().assign(jdst, req, jnd.array(src))
    tdst = _port(dst0)
    operator.CustomOp().assign(tdst, req, _port(src))
    onp.testing.assert_array_equal(tdst.asnumpy(), jdst.asnumpy())
    want = {"write": src, "inplace": src, "add": dst0 + src,
            "null": dst0}[req]
    onp.testing.assert_array_equal(tdst.asnumpy(), want)


def test_unknown_request_and_unregistered_op_raise():
    with pytest.raises(mx.MXNetError, match="unknown request"):
        operator.CustomOp().assign(_port(onp.zeros(2, "f")), "sum",
                                   _port(onp.ones(2, "f")))
    with pytest.raises(ValueError):
        jnd.Custom(jnd.ones(3), op_type="torchparity_never_registered")
    with pytest.raises(ValueError, match="not registered"):
        nd.Custom(_port(onp.ones(3, "f")),
                  op_type="torchparity_never_registered")
    with pytest.raises(ValueError, match="op_type"):
        nd.Custom(_port(onp.ones(3, "f")))
    with pytest.raises(mx.MXNetError, match="expects 2 inputs"):
        nd.Custom(_port(onp.ones((2, 3), "f")), op_type="rtc_softmax")
    assert {"rtc_softmax", "torchparity_sigmoid"} <= \
        set(operator.get_all_registered())


def test_forward_runs_paused_in_the_callers_train_mode():
    seen = []

    class Probe(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append((is_train, autograd.is_recording(),
                         autograd.is_training()))
            self.assign(out_data[0], req[0], in_data[0])

    @operator.register("torchparity_probe")
    class ProbeProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Probe()

    x = _port(onp.ones(2, "f"))
    x.attach_grad()
    with autograd.record():
        nd.Custom(x, op_type="torchparity_probe")
    with autograd.record(train_mode=False):
        nd.Custom(x, op_type="torchparity_probe")
    nd.Custom(x, op_type="torchparity_probe")
    assert seen == [(True, False, True), (False, False, False),
                    (False, False, False)]
