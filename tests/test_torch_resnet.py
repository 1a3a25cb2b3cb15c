"""ResNet V1 and its layers: the port against the JAX package on the CPU.

Weights and running statistics are built and initialized in JAX (Xavier,
explicit prefixes), then carried into the port by
``convert.params_from_numpy``; inputs are made with numpy from a seed.
The JAX networks are hybridized, so XLA compiles each mode once.

Tolerances:

- ``pooling``, ``flatten``, ``batch_norm`` and the layers: rtol = atol =
  1e-5 (max pooling 1e-6: it selects, it does not sum); torch and XLA sum
  windows, convolutions and statistics in other orders;
- the networks' outputs and gradients: within 1e-3 of the largest
  magnitude of each compared tensor (measured: about 1e-6 for resnet18
  and eval-mode resnet50);
- running statistics after a training forward: atol 1e-5;
- three SGD-momentum ``Trainer`` steps with the ``rtc_softmax`` head
  (batch 4, lr 0.01): losses rtol 1e-4 (atol 1e-4 of the first loss,
  since a loss near 0 keeps no relative precision), every parameter and
  running statistic within 1e-3 of its tensor's largest magnitude plus
  1e-5 for the tensors that start at zero (the JAX package sums batch
  statistics in float32 where torch's CPU kernels accumulate in
  float64, and the stem's weights are sensitive to it: the port's own
  float32 and float64 runs differ by 1.6e-4 of their scale). The port's
  float64 run of the same steps is held to the same bounds first, so a
  difference from the JAX package beyond them is not float32 rounding.

Training-mode gradients of these random networks are ill-conditioned
in float32 for some inputs: a channel whose batch statistics come from
few, nearly equal values (the last stage holds 4 x 4 or 2 x 2 positions
per image) multiplies the rounding of everything behind it by
1/sigma in batch norm's backward. On such inputs the JAX package's own
eager and hybridized runs differ by up to 26%, and the JAX package in
float32 differs from the port in float64 by up to 15%, as does the
port's float32 run. So the comparisons are placed where float32 is
accurate, and say so:

- resnet18(thumbnail) at batch 4: every training-mode gradient (float32
  against float64: 4e-6 on both sides);
- resnet50 at batch 2 and 64 x 64: every gradient in eval mode with the
  initial running statistics (2e-6), and in training mode the loss and
  the classifier's and last BatchNorm's gradients; after a training
  forward has moved the running statistics by their float32 noise, the
  deep eval-mode gradients are ill-conditioned too (7.5%);
- the ``Trainer`` steps at batch 4 and lr 0.01, with the precondition
  above checked in the test.
"""
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.operator as jop
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu import rtc as jrtc
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.tools import profile_resnet as pr

TOL = 1e-5
NET_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The networks' CPU convolutions run on two threads, so this file
    leaves the other test workers of a parallel run their cores."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(a):
    return nd.array(a, ctx=mx.cpu())


def _rs(seed):
    return onp.random.RandomState(seed)


def _carry(jblock, tblock, x):
    """Finish ``jblock``'s deferred shapes with one forward of ``x`` and
    carry every parameter into ``tblock`` on the CPU."""
    with jautograd.pause():
        jblock(jnd.array(x))
    arrays = {k: p.data().asnumpy()
              for k, p in jblock._collect_params_with_prefix().items()}
    return convert.params_from_numpy(tblock, arrays, ctx=mx.cpu())


def _close(got, want, tol, what="", floor=0.0):
    scale = float(onp.abs(want).max()) or 1.0
    err = float(onp.abs(got - want).max())
    assert err <= tol * scale + floor, f"{what}: {err} > {tol} x {scale}"


# -- ops -----------------------------------------------------------------------

_POOL_CASES = [
    # (shape, kwargs)
    ((2, 3, 9, 8), dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                        pad=(1, 1))),
    ((2, 3, 9, 8), dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                        pad=(1, 1), pooling_convention="full")),
    ((2, 3, 9, 8), dict(kernel=(3, 3), pool_type="max", stride=(1, 1),
                        pad=(2, 2))),
    ((2, 3, 9, 8), dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                        pad=(1, 1))),
    ((2, 3, 9, 8), dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                        pad=(1, 1), count_include_pad=False,
                        pooling_convention="full")),
    ((2, 3, 9, 8), dict(kernel=(2, 2), pool_type="sum", stride=(2, 2),
                        pooling_convention="full")),
    ((2, 3, 9, 8), dict(kernel=(3, 3), pool_type="lp", stride=(1, 1),
                        pad=(1, 1))),
    ((2, 9, 8, 3), dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                        pad=(1, 1), layout="NHWC")),
    ((2, 9, 8, 3), dict(kernel=(2, 2), pool_type="avg", stride=(2, 2),
                        pad=(1, 1), count_include_pad=False,
                        layout="NHWC")),
    ((2, 3, 11), dict(kernel=(3,), pool_type="max", stride=(2,), pad=(1,))),
    ((2, 3, 11), dict(kernel=(4,), pool_type="avg", stride=(3,),
                      pooling_convention="full")),
    ((1, 2, 5, 6, 7), dict(kernel=(2, 2, 2), pool_type="max",
                           stride=(2, 2, 2), pad=(1, 1, 1))),
    ((1, 2, 5, 6, 7), dict(kernel=(3, 3, 3), pool_type="avg",
                           stride=(2, 2, 2), pad=(1, 1, 1),
                           pooling_convention="full")),
    ((2, 3, 5, 4), dict(pool_type="max", global_pool=True)),
    ((2, 3, 5, 4), dict(pool_type="avg", global_pool=True)),
    ((2, 3, 5, 4), dict(pool_type="sum", global_pool=True)),
    ((2, 5, 4, 3), dict(pool_type="avg", global_pool=True, layout="NHWC")),
]


@pytest.mark.parametrize("shape,kw", _POOL_CASES,
                         ids=[f"case{i}" for i in range(len(_POOL_CASES))])
def test_pooling_matches_jax(shape, kw):
    x = _rs(len(shape)).randn(*shape).astype("f")
    want = jnd.pooling(jnd.array(x), **kw).asnumpy()
    got = nd.pooling(_port(x), **kw).asnumpy()
    assert got.shape == want.shape
    tol = 1e-6 if kw["pool_type"] == "max" else TOL
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_flatten_matches_jax():
    x = _rs(1).randn(2, 3, 4, 5).astype("f")
    onp.testing.assert_array_equal(nd.flatten(_port(x)).asnumpy(),
                                   jnd.flatten(jnd.array(x)).asnumpy())
    onp.testing.assert_array_equal(
        nn.Flatten()(_port(x)).asnumpy(), x.reshape(2, -1))


@pytest.mark.parametrize("axis,shape", [(1, (4, 3, 5, 6)), (-1, (4, 5, 6, 3)),
                                        (1, (6, 3))])
def test_batch_norm_op_matches_jax_with_mean_var_and_gradient(axis, shape):
    rs = _rs(2)
    x = (rs.randn(*shape) * 3 + 1).astype("f")
    C = shape[axis]
    g, b = (1 + 0.1 * rs.randn(C)).astype("f"), (0.1 * rs.randn(C)).astype("f")
    mm, mv = rs.randn(C).astype("f"), (rs.rand(C) + 0.5).astype("f")
    head = rs.randn(*shape).astype("f")
    kw = dict(eps=1e-5, fix_gamma=False, axis=axis)
    jx, jg, jb = jnd.array(x), jnd.array(g), jnd.array(b)
    for a in (jx, jg, jb):
        a.attach_grad()
    with jautograd.record():
        jout, jmean, jvar = jnd.batch_norm(jx, jg, jb, jnd.array(mm),
                                           jnd.array(mv), output_mean_var=True,
                                           use_batch_stats=True, **kw)
    jout.backward(jnd.array(head))
    tx, tg, tb = _port(x), _port(g), _port(b)
    for a in (tx, tg, tb):
        a.attach_grad()
    with autograd.record():
        tout, tmean, tvar = nd.batch_norm(tx, tg, tb, _port(mm), _port(mv),
                                          output_mean_var=True,
                                          use_batch_stats=True, **kw)
    tout.backward(_port(head))
    for t, j in ((tout, jout), (tmean, jmean), (tvar, jvar), (tx.grad, jx.grad),
                 (tg.grad, jg.grad), (tb.grad, jb.grad)):
        onp.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=TOL,
                                    atol=TOL)
    # the moving statistics, and fix_gamma's ones
    for kw2 in (dict(use_global_stats=True), dict(use_batch_stats=False,
                                                  fix_gamma=True)):
        args = dict(kw, **kw2)
        want = jnd.batch_norm(jnd.array(x), jg, jb, jnd.array(mm),
                              jnd.array(mv), **args).asnumpy()
        got = nd.batch_norm(_port(x), tg, tb, _port(mm), _port(mv),
                            **args).asnumpy()
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_conv_and_pool_layers_match_jax(layout):
    shape = (2, 3, 12, 10) if layout == "NCHW" else (2, 12, 10, 3)
    x = _rs(3).randn(*shape).astype("f")
    pairs = [
        (jnn.Conv2D(8, 3, strides=2, padding=1, layout=layout,
                    prefix=f"torchparity_conv_{layout}_"),
         nn.Conv2D(8, 3, strides=2, padding=1, layout=layout)),
        (jnn.Conv2D(6, (3, 1), use_bias=False, in_channels=3, layout=layout,
                    activation="relu",
                    prefix=f"torchparity_convr_{layout}_"),
         nn.Conv2D(6, (3, 1), use_bias=False, in_channels=3, layout=layout,
                   activation="relu")),
        (jnn.MaxPool2D(3, 2, 1, layout=layout,
                       prefix=f"torchparity_mp_{layout}_"),
         nn.MaxPool2D(3, 2, 1, layout=layout)),
        (jnn.AvgPool2D(2, ceil_mode=True, layout=layout,
                       prefix=f"torchparity_ap_{layout}_"),
         nn.AvgPool2D(2, ceil_mode=True, layout=layout)),
        (jnn.GlobalAvgPool2D(layout=layout,
                             prefix=f"torchparity_gap_{layout}_"),
         nn.GlobalAvgPool2D(layout=layout)),
        (jnn.GlobalMaxPool2D(layout=layout,
                             prefix=f"torchparity_gmp_{layout}_"),
         nn.GlobalMaxPool2D(layout=layout)),
    ]
    for jblock, tblock in pairs:
        jblock.initialize(jmx.init.Xavier())
        tblock = _carry(jblock, tblock, x)
        want = jblock(jnd.array(x)).asnumpy()
        got = tblock(_port(x)).asnumpy()
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                    err_msg=type(tblock).__name__)


def test_conv1d_and_conv3d_layers_match_jax():
    for jcls, tcls, shape, k in ((jnn.Conv1D, nn.Conv1D, (2, 3, 15), 3),
                                 (jnn.Conv3D, nn.Conv3D, (1, 2, 5, 6, 7), 2)):
        x = _rs(4).randn(*shape).astype("f")
        jblock = jcls(4, k, strides=2, padding=1,
                      prefix=f"torchparity_{jcls.__name__.lower()}_")
        jblock.initialize(jmx.init.Xavier())
        tblock = _carry(jblock, tcls(4, k, strides=2, padding=1), x)
        onp.testing.assert_allclose(tblock(_port(x)).asnumpy(),
                                    jblock(jnd.array(x)).asnumpy(),
                                    rtol=TOL, atol=TOL)


@pytest.mark.parametrize("axis", [1, -1])
def test_batchnorm_layer_train_eval_and_running_stats(axis):
    shape = (4, 3, 5, 5) if axis == 1 else (4, 5, 5, 3)
    rs = _rs(5)
    xs = [(rs.randn(*shape) * 2 + 1).astype("f") for _ in range(3)]
    jbn = jnn.BatchNorm(axis=axis, prefix=f"torchparity_bn{axis % 4}_")
    jbn.initialize(jmx.init.Xavier())
    with jautograd.pause():
        jbn(jnd.array(xs[0]))  # eval: shapes, no statistics written
    arrays = {k: p.data().asnumpy()
              for k, p in jbn._collect_params_with_prefix().items()}
    arrays["gamma"] = (1 + 0.1 * rs.randn(3)).astype("f")
    arrays["beta"] = (0.1 * rs.randn(3)).astype("f")
    for k in ("gamma", "beta"):
        jbn._collect_params_with_prefix()[k].set_data(jnd.array(arrays[k]))
    tbn = convert.params_from_numpy(nn.BatchNorm(axis=axis), arrays,
                                    ctx=mx.cpu())
    for x in xs[:2]:  # two training forwards, one recorded, one not
        with jautograd.record():
            jout = jbn(jnd.array(x))
        with autograd.record():
            tout = tbn(_port(x))
        onp.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=TOL,
                                    atol=TOL)
    with jautograd.train_mode():
        jbn(jnd.array(xs[1]))
    with autograd.train_mode():
        tbn(_port(xs[1]))
    jp, tp = jbn._collect_params_with_prefix(), tbn._collect_params_with_prefix()
    for k in ("running_mean", "running_var"):
        onp.testing.assert_allclose(tp[k].data().asnumpy(),
                                    jp[k].data().asnumpy(), rtol=TOL,
                                    atol=TOL, err_msg=k)
        assert not onp.allclose(tp[k].data().asnumpy(), arrays[k])
    assert tp["running_mean"].grad_req == "null"
    # eval: the running statistics, nothing written
    before = tp["running_mean"].data().asnumpy()
    onp.testing.assert_allclose(tbn(_port(xs[2])).asnumpy(),
                                jbn(jnd.array(xs[2])).asnumpy(), rtol=TOL,
                                atol=TOL)
    onp.testing.assert_array_equal(tp["running_mean"].data().asnumpy(),
                                   before)


def test_batchnorm_running_update_is_mxnet_momentum_and_biased_variance():
    x = _rs(6).randn(8, 2, 3).astype("f")
    bn = nn.BatchNorm(momentum=0.9, in_channels=2)
    bn.initialize(ctx=mx.cpu())
    with autograd.train_mode():
        bn(_port(x))
    p = bn._collect_params_with_prefix()
    batch_var = x.transpose(1, 0, 2).reshape(2, -1).var(axis=1)  # biased
    onp.testing.assert_allclose(p["running_var"].data().asnumpy(),
                                0.9 * 1 + 0.1 * batch_var, rtol=1e-6)
    onp.testing.assert_allclose(
        p["running_mean"].data().asnumpy(),
        0.1 * x.transpose(1, 0, 2).reshape(2, -1).mean(axis=1), rtol=1e-5,
        atol=1e-7)


# -- networks ------------------------------------------------------------------

def _resnet_pair(depth, layout, tag, H, B=2, classes=10):
    thumb = depth == 18
    jmx.random.seed(0)
    jnet = jvision.get_model(f"resnet{depth}_v1", thumbnail=thumb,
                             classes=classes, layout=layout,
                             prefix=f"torchparity_r{depth}{tag}_")
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    shape = (B, 3, H, H) if layout == "NCHW" else (B, H, H, 3)
    x = _rs(depth).randn(*shape).astype("f")
    tnet = _carry(jnet, vision.get_model(f"resnet{depth}_v1",
                                         thumbnail=thumb, classes=classes,
                                         layout=layout), x)
    return jnet, tnet, x


def _ce_backward(jnet, tnet, x, label, train):
    """Softmax cross-entropy of each net on ``x``, recorded in ``train``
    mode, and its backward; returns (jax loss, port loss)."""
    with jautograd.record(train_mode=train):
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(jnet(jnd.array(x)),
                                                   jnd.array(label))
    jl.backward()
    with autograd.record(train_mode=train):
        tl = gluon.loss.SoftmaxCrossEntropyLoss()(tnet(_port(x)),
                                                  _port(label))
    tl.backward()
    return jl.asnumpy(), tl.asnumpy()


def _compare_grads(jnet, tnet, names=None):
    jp, tp = jnet._collect_params_with_prefix(), \
        tnet._collect_params_with_prefix()
    names = names or [k for k, p in jp.items() if p.grad_req != "null"]
    for k in names:
        _close(tp[k].grad().asnumpy(), jp[k].grad().asnumpy(), NET_TOL, k)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet18_thumbnail_matches_jax(layout):
    jnet, tnet, x = _resnet_pair(18, layout, layout, 32, B=4)
    with jautograd.predict_mode():
        want = jnet(jnd.array(x)).asnumpy()
    got = tnet(_port(x)).asnumpy()
    assert got.shape == (4, 10)
    _close(got, want, NET_TOL, "eval forward")
    label = onp.array([1, 9, 0, 4], "f")
    jl, tl = _ce_backward(jnet, tnet, x, label, train=True)
    onp.testing.assert_allclose(tl, jl, rtol=NET_TOL)
    _compare_grads(jnet, tnet)
    jp, tp = jnet._collect_params_with_prefix(), \
        tnet._collect_params_with_prefix()
    stats = [k for k in jp if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 19  # 16 in the blocks, 3 on the shortcuts
    for k in stats:  # written back by the training forward
        onp.testing.assert_allclose(tp[k].data().asnumpy(),
                                    jp[k].data().asnumpy(), atol=TOL, err_msg=k)


def test_resnet50_matches_jax_at_64():
    jnet, tnet, x = _resnet_pair(50, "NCHW", "", 64)
    n_params = sum(p.data().size for p in tnet.collect_params().values())
    assert n_params == sum(p.data().size
                           for p in jnet.collect_params().values())
    label = onp.array([3, 7], "f")
    # eval mode first, with the initial running statistics, where batch
    # norm is linear: the outputs, the loss and every gradient
    with jautograd.predict_mode():
        want = jnet(jnd.array(x)).asnumpy()
    _close(tnet(_port(x)).asnumpy(), want, NET_TOL, "eval forward")
    jl, tl = _ce_backward(jnet, tnet, x, label, train=False)
    onp.testing.assert_allclose(tl, jl, rtol=NET_TOL)
    _compare_grads(jnet, tnet)
    # training mode: the outputs through batch statistics, the loss, the
    # gradients of the classifier and the last BatchNorm, and the running
    # statistics both write back
    with jautograd.record():
        jout = jnet(jnd.array(x))
    with autograd.record():
        tout = tnet(_port(x))
    _close(tout.asnumpy(), jout.asnumpy(), NET_TOL, "train forward")
    jl, tl = _ce_backward(jnet, tnet, x, label, train=True)
    onp.testing.assert_allclose(tl, jl, rtol=NET_TOL)
    _compare_grads(jnet, tnet, ["output.weight", "output.bias",
                                "features.7.2.body.7.gamma"])
    jp, tp = jnet._collect_params_with_prefix(), \
        tnet._collect_params_with_prefix()
    for k in ("features.1.running_mean", "features.7.2.body.7.running_var"):
        onp.testing.assert_allclose(tp[k].data().asnumpy(),
                                    jp[k].data().asnumpy(), atol=1e-4,
                                    rtol=1e-4, err_msg=k)


def test_model_zoo_surface(tmp_path, monkeypatch):
    """The zoo knows every model the JAX package's does; the V2 family
    and the space-to-depth stem build; a version other than 1 or 2 and a
    norm layer other than BatchNorm raise; pretrained weights raise with
    an empty model store, saying where to put the file, and load from a
    file there whose checksum matches."""
    assert sorted(vision._models) == sorted(jvision._models)
    assert type(vision.get_model("resnet18_v2")).__name__ == "ResNetV2"
    assert type(vision.resnet50_v1(stem_s2d=True).features[0]).__name__ \
        == "_S2DStemConv"
    with pytest.raises(ValueError, match="not supported"):
        vision.get_model("resnet18_v3")
    with pytest.raises(mx.MXNetError, match="version"):
        vision.get_resnet(3, 50)
    with pytest.raises(RuntimeError, match="put the file at"):
        vision.get_resnet(2, 50, pretrained=True, root=str(tmp_path))
    from mxnet_tpu_torch.gluon.model_zoo import model_store

    src = vision.get_resnet(2, 50, classes=10)
    src.initialize(mx.init.Xavier(), ctx=mx.cpu())
    src(nd.zeros((1, 3, 32, 32), ctx=mx.cpu()))
    staged = str(tmp_path / "staged.params")
    src.save_parameters(staged)
    sha = hashlib.sha1(open(staged, "rb").read()).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, "resnet50_v2", sha)
    os.replace(staged, str(tmp_path / f"resnet50_v2-{sha[:8]}.params"))
    net = vision.get_resnet(2, 50, pretrained=True, classes=10,
                            ctx=mx.cpu(), root=str(tmp_path))
    for k, p in src._collect_params_with_prefix().items():
        assert net._collect_params_with_prefix()[k].data().asnumpy() \
            .tobytes() == p.data().asnumpy().tobytes(), k
    with pytest.raises(mx.MXNetError, match="BatchNorm only"):
        vision.resnet18_v1(norm_layer=nn.LayerNorm)
    net = vision.resnet18_v1(norm_kwargs={"momentum": 0.5})
    assert net.features._children["1"]._momentum == 0.5
    assert gluon.model_zoo.get_model("resnet34_v1") is not None


# -- training: three SGD-momentum steps with the rtc_softmax head -----------

def _pallas_softmax_fwd(x_ref, o_ref):
    x = x_ref[...]
    e = jnp.exp(x - jnp.max(x, axis=-1, keepdims=True))
    o_ref[...] = e / jnp.sum(e, axis=-1, keepdims=True)


def _pallas_softmax_bwd(label_ref, p_ref, o_ref):
    p = p_ref[...]
    cls = jax.lax.broadcasted_iota(jnp.int32, p.shape, 1)
    o_ref[...] = p - (cls == label_ref[...].astype(jnp.int32)[:, None]
                      ).astype(p.dtype)


_PALLAS = jrtc.PallasModule(fwd=_pallas_softmax_fwd, bwd=_pallas_softmax_bwd)


class _JaxHead(jop.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0],
                    _PALLAS.get_kernel("fwd").launch([in_data[0]]))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        p = out_data[0]
        self.assign(in_grad[0], req[0], _PALLAS.get_kernel("bwd").launch(
            [in_data[1], p], out_shape=p.shape, out_dtype=p.dtype))


@jop.register("torchparity_resnet_head")
class _JaxHeadProp(jop.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shape):
        return [in_shape[0], [in_shape[0][0]]], [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return _JaxHead()


def test_three_sgd_momentum_steps_with_the_rtc_head_match_jax():
    B, lr = 4, 0.01
    jnet, tnet, x = _resnet_pair(18, "NCHW", "steps", 32, B=B)
    label = _rs(8).randint(0, 10, B).astype("f")
    arrays = {k: p.data().asnumpy()
              for k, p in tnet._collect_params_with_prefix().items()}
    opt = {"learning_rate": lr, "momentum": pr.MOMENTUM, "wd": pr.WD}
    jtrainer = jgluon.Trainer(jnet.collect_params(), "sgd", dict(opt))
    jlosses = []
    for _ in range(3):
        with jautograd.record():
            jp = jnd.Custom(jnet(jnd.array(x)), jnd.array(label),
                            op_type="torchparity_resnet_head")
        jp.backward()
        jtrainer.step(B)
        jlosses.append(-onp.log(jp.asnumpy()[onp.arange(B),
                                             label.astype(int)]).mean())
    runs = {}
    for dtype in ("float32", "float64"):
        net = vision.resnet18_v1(thumbnail=True, classes=10)
        for p in net.collect_params().values():
            p.dtype = dtype
        convert.params_from_numpy(
            net, {k: v.astype(dtype) for k, v in arrays.items()}, ctx=mx.cpu())
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(opt))
        xs = nd.array(x, ctx=mx.cpu(), dtype=dtype)
        ys = nd.array(label, ctx=mx.cpu(), dtype=dtype)
        losses = [pr.train_step(net, trainer, xs, ys).asscalar()
                  for _ in range(3)]
        runs[dtype] = (losses, {k: p.data().asnumpy() for k, p in
                                net._collect_params_with_prefix().items()})
    # the precondition: this run is well conditioned in float32 (the
    # port's float32 and float64 runs agree), so a difference from the
    # JAX package is the port's and not rounding amplified
    tlosses, tparams = runs["float32"]
    onp.testing.assert_allclose(tlosses, runs["float64"][0], rtol=1e-4,
                                atol=1e-4 * tlosses[0])
    # a loss near 0 (-log p, p near 1) keeps no relative precision: the
    # absolute bound is relative to the first loss
    onp.testing.assert_allclose(tlosses, jlosses, rtol=1e-4,
                                atol=1e-4 * jlosses[0])
    assert tlosses[-1] < tlosses[0]
    jp = jnet._collect_params_with_prefix()
    for k in jp:
        _close(runs["float64"][1][k], tparams[k], NET_TOL, f"float64 {k}",
               floor=1e-5)
        _close(tparams[k], jp[k].data().asnumpy(), NET_TOL, k, floor=1e-5)
