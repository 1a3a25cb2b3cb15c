"""The Gluon surface of the PyTorch port against the JAX package, on the
CPU: the losses, the activation layers, the transposed convolutions,
``ReflectionPad2D``, ``InstanceNorm``, ``GroupNorm``, ``Sequential``,
``Lambda``, ``HybridLambda``, ``Constant``, ``gluon.contrib.nn``,
``gluon.utils`` and ``Trainer.allreduce_grads``.

Inputs are drawn with numpy from a seed; a layer's parameters are made
by the JAX package (explicit prefixes) and carried into the port by
``convert.params_from_numpy``. Each case runs a forward and, where
there is one, the gradient of ``sum(out * cotangent)`` with a random
cotangent, in both packages.

Tolerances, relative to the reference's largest magnitude (torch and XLA
sum in other orders; the transcendentals differ in their last bits):

- losses, their gradients and the layers: 1e-5;
- ``ctc_loss`` and ``CTCLoss`` (a log-space recursion over time): 1e-4;
- selections and copies (``Identity``, ``PixelShuffle``, the padding,
  ``Constant``, the data splits): bitwise;
- ``clip_global_norm``: the norm within 1e-6 of numpy's in float64, the
  arrays within 1e-6 of their clipped values;
- ``allreduce_grads()`` then ``update()`` against ``step()``: bitwise
  (the fused step and the eager loop run the same SGD arithmetic).
"""
import hashlib
import os

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd

CPU = mx.cpu()
TOL = 1e-5
CTC_TOL = 1e-4


def _close(got, want, tol, what=""):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol == 0:
        onp.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = float(onp.max(onp.abs(want))) if want.size else 1.0
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                err_msg=what)


def _rs(seed=0):
    return onp.random.RandomState(seed)


def _f32(rs, *shape):
    return rs.randn(*shape).astype("float32")


def _carry(jblock, tblock):
    """Copy the JAX block's parameters into the port's block."""
    arrays = {k: p.data().asnumpy()
              for k, p in jblock._collect_params_with_prefix().items()}
    convert.params_from_numpy(tblock, arrays, ctx=CPU)


def _both(jblock, tblock, inputs, grad_inputs=(0,), train=False, tol=TOL):
    """Run ``jblock`` and ``tblock`` (parameters carried over after the
    JAX block's first call) on ``inputs`` and compare the outputs and
    the gradients of ``sum(out * cotangent)`` with respect to the inputs
    in ``grad_inputs`` and every parameter that takes one."""
    jblock(*[jnd.array(a) for a in inputs])
    _carry(jblock, tblock)
    jin = [jnd.array(a) for a in inputs]
    tin = [nd.array(a, ctx=CPU) for a in inputs]
    for i in grad_inputs:
        jin[i].attach_grad()
        tin[i].attach_grad()
    with jautograd.record(train_mode=train):
        jout = jblock(*jin)
    with autograd.record(train_mode=train):
        tout = tblock(*tin)
    _close(tout.asnumpy(), jout.asnumpy(), tol, "forward")
    cot = _f32(_rs(7), *jout.shape)
    with jautograd.record(train_mode=train):
        jl = (jblock(*jin) * jnd.array(cot)).sum()
    jl.backward()
    with autograd.record(train_mode=train):
        tl = (tblock(*tin) * nd.array(cot, ctx=CPU)).sum()
    tl.backward()
    for i in grad_inputs:
        _close(tin[i].grad.asnumpy(), jin[i].grad.asnumpy(), tol,
               f"input {i} gradient")
    jp = jblock._collect_params_with_prefix()
    for k, p in tblock._collect_params_with_prefix().items():
        if p.grad_req != "null":
            _close(p.grad().asnumpy(), jp[k].grad().asnumpy(), tol,
                   f"{k} gradient")
    return tout, jout


# -- losses -----------------------------------------------------------------

def _signs(rs, *shape):
    return onp.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype("float32")


def _loss_cases():
    """(id, loss name, constructor kwargs, inputs maker, maker of the
    optional trailing arguments, positional: ``sample_weight`` and then
    ``pos_weight``): every loss of the JAX package's ``__all__``, with
    ``weight``, ``sample_weight`` and ``batch_axis`` among the cases."""
    def sw(rs, n=4):
        return [rs.rand(n, 1).astype("float32")]

    def sw3(rs, n=4):
        return [rs.rand(n, 1, 1).astype("float32")]

    def pos_weight(rs):
        return [None, (1 + rs.rand(1, 5)).astype("float32")]

    return [
        ("l2", "L2Loss", {"weight": 0.5},
         lambda rs: [_f32(rs, 4, 3, 2), _f32(rs, 4, 6)], sw3),
        ("l2_batch_axis1", "L2Loss", {"batch_axis": 1},
         lambda rs: [_f32(rs, 3, 4), _f32(rs, 3, 4)], None),
        ("l1", "L1Loss", {"weight": 2.0},
         lambda rs: [_f32(rs, 4, 5), _f32(rs, 4, 5)], sw),
        ("l1_batch_axis1", "L1Loss", {"batch_axis": 1},
         lambda rs: [_f32(rs, 3, 4, 2), _f32(rs, 3, 4, 2)], None),
        ("sigmoid_bce", "SigmoidBinaryCrossEntropyLoss", {"weight": 0.7},
         lambda rs: [3 * _f32(rs, 4, 5),
                     (rs.rand(4, 5) > 0.5).astype("float32")], sw),
        ("sigmoid_bce_pos_weight", "SigmoidBCELoss", {},
         lambda rs: [3 * _f32(rs, 4, 5),
                     (rs.rand(4, 5) > 0.5).astype("float32")],
         pos_weight),
        ("sigmoid_bce_from_sigmoid", "SigmoidBCELoss",
         {"from_sigmoid": True},
         lambda rs: [rs.uniform(0.05, 0.95, (4, 5)).astype("float32"),
                     (rs.rand(4, 5) > 0.5).astype("float32")], sw),
        ("sigmoid_bce_from_sigmoid_pos_weight", "SigmoidBCELoss",
         {"from_sigmoid": True},
         lambda rs: [rs.uniform(0.05, 0.95, (4, 5)).astype("float32"),
                     (rs.rand(4, 5) > 0.5).astype("float32")],
         pos_weight),
        ("softmax_ce", "SoftmaxCELoss", {"weight": 1.5},
         lambda rs: [_f32(rs, 4, 6), rs.randint(0, 6, 4).astype("float32")],
         sw),
        ("softmax_ce_dense", "SoftmaxCrossEntropyLoss",
         {"sparse_label": False, "axis": 1},
         lambda rs: [_f32(rs, 4, 6),
                     onp.abs(_f32(rs, 4, 6)) / 6], None),
        ("kl_div", "KLDivLoss", {},
         lambda rs: [onp.log(rs.dirichlet(onp.ones(5), 4)).astype("f"),
                     rs.dirichlet(onp.ones(5), 4).astype("f")], sw),
        ("kl_div_logits", "KLDivLoss", {"from_logits": False,
                                        "weight": 0.5},
         lambda rs: [_f32(rs, 4, 5),
                     rs.dirichlet(onp.ones(5), 4).astype("f")], None),
        ("huber", "HuberLoss", {"rho": 0.5, "weight": 2.0},
         lambda rs: [_f32(rs, 4, 5), _f32(rs, 4, 5)], sw),
        ("huber_batch_axis1", "HuberLoss", {"batch_axis": 1},
         lambda rs: [_f32(rs, 3, 4), _f32(rs, 3, 4)], None),
        ("hinge", "HingeLoss", {"margin": 1.5},
         lambda rs: [_f32(rs, 4, 5), _signs(rs, 4, 5)], sw),
        ("squared_hinge", "SquaredHingeLoss", {"weight": 0.5},
         lambda rs: [_f32(rs, 4, 5), _signs(rs, 4, 5)], sw),
        ("logistic_signed", "LogisticLoss", {},
         lambda rs: [_f32(rs, 4, 5), _signs(rs, 4, 5)], sw),
        ("logistic_binary", "LogisticLoss", {"label_format": "binary",
                                             "weight": 0.3},
         lambda rs: [_f32(rs, 4, 5),
                     (rs.rand(4, 5) > 0.5).astype("float32")], None),
        ("triplet", "TripletLoss", {"margin": 2.0},
         lambda rs: [_f32(rs, 4, 5), _f32(rs, 4, 5), _f32(rs, 4, 5)],
         lambda rs: [rs.rand(4).astype("float32")]),
        ("poisson_logits", "PoissonNLLLoss", {"weight": 0.5},
         lambda rs: [_f32(rs, 4, 5),
                     rs.poisson(2.0, (4, 5)).astype("float32")], sw),
        ("poisson_rates_full", "PoissonNLLLoss",
         {"from_logits": False, "compute_full": True},
         lambda rs: [rs.uniform(0.5, 3, (4, 5)).astype("float32"),
                     rs.poisson(2.0, (4, 5)).astype("float32")], None),
        ("cosine", "CosineEmbeddingLoss", {"margin": 0.2, "weight": 1.5},
         lambda rs: [_f32(rs, 4, 6), _f32(rs, 4, 6), _signs(rs, 4)],
         lambda rs: [rs.rand(4).astype("float32")]),
    ]


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("case", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_losses_match_jax(case):
    _, name, kw, make, extra = case
    rs = _rs(1)
    inputs = make(rs)
    trailing = extra(rs) if extra is not None else []
    jloss = getattr(jgluon.loss, name)(**kw)
    tloss = getattr(gluon.loss, name)(**kw)
    jin = [jnd.array(a) for a in inputs]
    tin = [nd.array(a, ctx=CPU) for a in inputs]
    jx = [None if v is None else jnd.array(v) for v in trailing]
    tx = [None if v is None else nd.array(v, ctx=CPU) for v in trailing]
    jin[0].attach_grad()
    tin[0].attach_grad()
    with jautograd.record():
        jl = jloss(*jin, *jx)
    with autograd.record():
        tl = tloss(*tin, *tx)
    _close(tl.asnumpy(), jl.asnumpy(), TOL, "loss")
    jl.backward()
    tl.backward()
    _close(tin[0].grad.asnumpy(), jin[0].grad.asnumpy(), TOL, "gradient")


def test_loss_aliases_and_all():
    import mxnet_tpu.gluon.loss as jl

    assert sorted(gluon.loss.__all__) == sorted(jl.__all__)
    assert gluon.loss.SigmoidBCELoss is \
        gluon.loss.SigmoidBinaryCrossEntropyLoss
    assert gluon.loss.SoftmaxCELoss is gluon.loss.SoftmaxCrossEntropyLoss


def _ctc_inputs(rs, blank, N=3, T=7, C=5, L=3):
    """Activations (N, T, C) and padded labels (N, L): labels avoid the
    blank class, and each row is padded (0 for the first blank, -1 for
    the last) after 1..L labels."""
    pred = _f32(rs, N, T, C)
    lo, hi = (1, C) if blank == "first" else (0, C - 1)
    pad = 0 if blank == "first" else -1
    label = rs.randint(lo, hi, (N, L)).astype("float32")
    for i in range(N):
        label[i, 1 + i % L:] = pad
    return pred, label


@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_ctc_loss_layer_matches_jax(layout):
    """``CTCLoss`` (blank class 0, the op's default, as the JAX layer
    uses it) with and without lengths, in both layouts; the gradient of
    the activations."""
    rs = _rs(2)
    pred, label = _ctc_inputs(rs, "first")
    lengths = [onp.array([7, 5, 6], "float32"), onp.array([1, 2, 3], "f")]
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    kw = {"layout": layout, "label_layout": "NT", "weight": 0.5}
    for extra in ([], lengths):
        jl_, tl_ = jgluon.loss.CTCLoss(**kw), gluon.loss.CTCLoss(**kw)
        jp, tp = jnd.array(pred), nd.array(pred, ctx=CPU)
        jp.attach_grad()
        tp.attach_grad()
        with jautograd.record():
            jl = jl_(jp, jnd.array(label), *[jnd.array(a) for a in extra])
        with autograd.record():
            tl = tl_(tp, nd.array(label, ctx=CPU),
                     *[nd.array(a, ctx=CPU) for a in extra])
        _close(tl.asnumpy(), jl.asnumpy(), CTC_TOL, "ctc loss")
        jl.backward()
        tl.backward()
        _close(tp.grad.asnumpy(), jp.grad.asnumpy(), CTC_TOL, "ctc grad")


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_loss_op_both_blank_labels_match_jax(blank):
    """The ``ctc_loss`` op under both ``blank_label`` values (the JAX
    layer passes none, so the op's are held here), loss and gradient."""
    rs = _rs(3)
    pred, label = _ctc_inputs(rs, blank)
    data = pred.transpose(1, 0, 2).copy()  # (T, N, C)
    jd, td = jnd.array(data), nd.array(data, ctx=CPU)
    jd.attach_grad()
    td.attach_grad()
    with jautograd.record():
        jl = jnd.ctc_loss(jd, jnd.array(label), blank_label=blank)
    with autograd.record():
        tl = nd.ctc_loss(td, nd.array(label, ctx=CPU), blank_label=blank)
    _close(tl.asnumpy(), jl.asnumpy(), CTC_TOL, "ctc loss")
    jl.backward()
    tl.backward()
    _close(td.grad.asnumpy(), jd.grad.asnumpy(), CTC_TOL, "ctc grad")


# -- activation layers --------------------------------------------------------

ACTIVATIONS = [("LeakyReLU", (0.1,)), ("PReLU", ()), ("ELU", (0.7,)),
               ("SELU", ()), ("Swish", (1.5,)), ("GELU", ())]


@pytest.mark.parametrize("name,args", ACTIVATIONS,
                         ids=[a[0] for a in ACTIVATIONS])
def test_activation_layers_match_jax(name, args):
    """Forward and input gradient of each layer; ``PReLU``'s slope
    gradient too (``_both`` compares every parameter's)."""
    jb = getattr(jgluon.nn, name)(*args, prefix="j_")
    tb = getattr(gluon.nn, name)(*args)
    jb.initialize()
    tb.initialize(ctx=CPU)
    _both(jb, tb, [_f32(_rs(4), 3, 4, 5)])


def test_prelu_slope_is_learned_and_shared():
    tb = gluon.nn.PReLU()
    tb.initialize(ctx=CPU)
    assert tb.alpha.shape == (1,)
    assert float(tb.alpha.data().asscalar()) == 0.25
    x = nd.array(-onp.ones((2, 3), "float32"), ctx=CPU)
    with autograd.record():
        y = tb(x).sum()
    y.backward()
    # d/d alpha of sum(alpha * x) over six entries of -1
    assert float(tb.alpha.grad().asscalar()) == -6.0
    assert gluon.nn.Activation is gluon.nn.activations.Activation


# -- transposed convolutions and padding ------------------------------------

DECONVS = [
    ("1d_stride2_adj1", "Conv1DTranspose",
     dict(channels=4, kernel_size=3, strides=2, padding=1,
          output_padding=1), (2, 3, 5)),
    ("2d_stride3_adj2", "Conv2DTranspose",
     dict(channels=6, kernel_size=(3, 2), strides=(3, 2), padding=(1, 0),
          output_padding=(2, 1)), (2, 4, 4, 3)),
    ("2d_groups_dilation", "Conv2DTranspose",
     dict(channels=4, kernel_size=3, strides=2, padding=1,
          output_padding=1, groups=2, dilation=2, in_channels=4),
     (2, 4, 3, 3)),
    ("2d_relu_no_bias", "Conv2DTranspose",
     dict(channels=3, kernel_size=2, strides=2, activation="relu",
          use_bias=False), (1, 2, 3, 3)),
    ("3d_stride2", "Conv3DTranspose",
     dict(channels=2, kernel_size=2, strides=2, output_padding=1),
     (1, 3, 2, 3, 2)),
]


@pytest.mark.parametrize("case", DECONVS, ids=[c[0] for c in DECONVS])
def test_transposed_convolutions_match_jax(case):
    """Forward, input and parameter gradients; the weight is (in,
    out/groups, *k) in both packages and ``output_padding`` (the op's
    ``adj``) adds to the high side."""
    _, name, kw, shape = case
    jb = getattr(jgluon.nn, name)(prefix="j_", **kw)
    tb = getattr(gluon.nn, name)(**kw)
    jb.initialize(jmx.init.Xavier())
    tb.initialize(ctx=CPU)
    tout, _ = _both(jb, tb, [_f32(_rs(5), *shape)])
    g = kw.get("groups", 1)
    assert tb.weight.shape == (shape[1], kw["channels"] // g) + \
        tuple(jb.weight.shape[2:])
    k = tb._kernel
    s, p, d = tb._stride, tb._pad, tb._dilate
    adj = tb._adj
    want = tuple((n - 1) * s_ - 2 * p_ + d_ * (k_ - 1) + a + 1 for
                 n, s_, p_, d_, k_, a in zip(shape[2:], s, p, d, k, adj))
    assert tout.shape[2:] == want


def test_deconvolution_target_shape_is_ignored_as_in_jax():
    """Both packages' ``deconvolution`` op accept ``target_shape`` and
    size the output from ``pad`` and ``adj`` alone (ROADMAP C)."""
    rs = _rs(6)
    x, w = _f32(rs, 1, 2, 4, 4), _f32(rs, 2, 3, 3, 3)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
              num_filter=3, target_shape=(9, 9))
    j = jnd.deconvolution(jnd.array(x), jnd.array(w), **kw)
    t = nd.deconvolution(nd.array(x, ctx=CPU), nd.array(w, ctx=CPU), **kw)
    assert t.shape == j.shape == (1, 3, 8, 8)
    _close(t.asnumpy(), j.asnumpy(), TOL)


def test_transposed_convolution_refuses_channel_last():
    with pytest.raises(ValueError, match="channel-first"):
        gluon.nn.Conv2DTranspose(4, 3, layout="NHWC")


def test_reflection_pad_matches_jax():
    x = _f32(_rs(8), 2, 3, 4, 5)
    for pad in (2, (0, 0, 0, 0, 1, 2, 3, 1)):
        j = jgluon.nn.ReflectionPad2D(pad)(jnd.array(x))
        t = gluon.nn.ReflectionPad2D(pad)(nd.array(x, ctx=CPU))
        _close(t.asnumpy(), j.asnumpy(), 0, f"pad {pad}")


# -- norms, containers, lambdas, constants ----------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_instance_and_group_norm_match_jax(train):
    """``InstanceNorm`` (per channel gamma and beta, learned) and
    ``GroupNorm`` (per group, ``(num_groups,)``) with random parameters,
    forward and every gradient."""
    rs = _rs(9)
    for jb, tb in ((jgluon.nn.InstanceNorm(prefix="j_", in_channels=4),
                    gluon.nn.InstanceNorm(in_channels=4)),
                   (jgluon.nn.GroupNorm(num_groups=2, prefix="j_"),
                    gluon.nn.GroupNorm(num_groups=2))):
        jb.initialize(jmx.init.Uniform(1.0))
        tb.initialize(ctx=CPU)
        _both(jb, tb, [_f32(rs, 3, 4, 5, 6)], train=train)
    assert tb.gamma.shape == (2,) and tb.beta.shape == (2,)


def _dense_stack(pkg, prefix=None):
    kw = {} if prefix is None else {"prefix": prefix}
    net = pkg.nn.Sequential(**kw)
    with net.name_scope():
        net.add(pkg.nn.Dense(6, activation="tanh"), pkg.nn.Dense(3))
    return net


def test_sequential_matches_jax_and_indexes():
    jb, tb = _dense_stack(jgluon, "jseq_"), _dense_stack(gluon)
    jb.initialize(jmx.init.Xavier())
    tb.initialize(ctx=CPU)
    _both(jb, tb, [_f32(_rs(10), 4, 5)])
    assert len(tb) == 2 and isinstance(tb[1], gluon.nn.Dense)
    assert isinstance(tb[:1], gluon.nn.Sequential) and len(tb[:1]) == 1
    assert not isinstance(tb, gluon.HybridBlock)
    # hybridize reaches the hybridizable children, which cache
    out = tb(nd.array(_f32(_rs(10), 4, 5), ctx=CPU)).asnumpy()
    tb.hybridize()
    assert tb[0]._active and tb[1]._active
    _close(tb(nd.array(_f32(_rs(10), 4, 5), ctx=CPU)).asnumpy(), out, 0)


@pytest.mark.parametrize("kind", ["lambda_name", "lambda_fn",
                                  "hybrid_name", "hybrid_fn"])
def test_lambdas_match_jax(kind):
    x = _f32(_rs(11), 3, 4)

    def make(pkg):
        if kind == "lambda_name":
            return pkg.nn.Lambda("tanh")
        if kind == "lambda_fn":
            return pkg.nn.Lambda(lambda a: a * 2 + 1)
        if kind == "hybrid_name":
            return pkg.nn.HybridLambda("tanh")
        return pkg.nn.HybridLambda(lambda F, a: F.relu(a) * 3)

    jb, tb = make(jgluon), make(gluon)
    _both(jb, tb, [x])
    if kind.startswith("hybrid"):
        tb.hybridize()
        _close(tb(nd.array(x, ctx=CPU)).asnumpy(),
               jb(jnd.array(x)).asnumpy(), TOL, "hybridized")


def test_lambda_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="not found"):
        gluon.nn.Lambda("no_such_function")
    with pytest.raises(ValueError, match="not found"):
        gluon.nn.HybridLambda("no_such_function")


def _with_constant(pkg, value, prefix=None):
    class Shift(pkg.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.const = self.params.get_constant("const", value)
                self.dense = pkg.nn.Dense(2, in_units=2)

        def hybrid_forward(self, F, x, const):
            return self.dense(x) + const

    return Shift(**({} if prefix is None else {"prefix": prefix}))


def test_constant_matches_jax_and_takes_no_gradient():
    value = [[1.0, -2.0], [0.5, 4.0]]
    jb, tb = _with_constant(jgluon, value, "jc_"), _with_constant(gluon,
                                                                   value)
    jb.initialize(jmx.init.Xavier())
    tb.initialize(mx.init.Zero(), ctx=CPU)
    # the constant keeps its value whatever initializer the block is given
    _close(tb.const.data().asnumpy(), onp.array(value, "float32"), 0)
    assert tb.const.grad_req == "null"
    _both(jb, tb, [_f32(_rs(12), 2, 2)])
    c = gluon.Constant("c", onp.arange(3.0))
    assert c.shape == (3,) and c.dtype == "float32"
    assert isinstance(c, gluon.Parameter)
    assert gluon.Constant is gluon.parameter.Constant


def test_parameter_dict_save_load_round_trip(tmp_path):
    """``ParameterDict.save`` then ``load`` into parameters that are not
    allocated yet (``_load_init_from``): they take the saved values and
    shapes."""
    src = _dense_stack(gluon)
    src.initialize(ctx=CPU)
    src(nd.ones((2, 5), ctx=CPU))
    fname = str(tmp_path / "p.params")
    src.collect_params().save(fname, strip_prefix=src.prefix)
    dst = _dense_stack(gluon)
    params = dst.collect_params()
    params.load(fname, ctx=CPU, restore_prefix=dst.prefix)
    for (_, a), (_, b) in zip(sorted(src.collect_params().items()),
                              sorted(params.items())):
        _close(b.data().asnumpy(), a.data().asnumpy(), 0)
    with pytest.raises(IOError, match="missing"):
        _dense_stack(gluon).collect_params().load(fname, ctx=CPU)


# -- gluon.contrib.nn ---------------------------------------------------------

@pytest.mark.parametrize("hybrid", [False, True])
def test_concurrent_blocks_match_jax(hybrid):
    def make(pkg, prefix=None):
        cls = pkg.contrib.nn.HybridConcurrent if hybrid else \
            pkg.contrib.nn.Concurrent
        net = cls(axis=1, **({} if prefix is None else {"prefix": prefix}))
        with net.name_scope():
            net.add(pkg.contrib.nn.Identity(), pkg.nn.Dense(3),
                    pkg.nn.Dense(2, activation="relu"))
        return net

    import mxnet_tpu.gluon.contrib  # noqa: F401  (JAX gluon.contrib)

    jb, tb = make(jgluon, "jcc_"), make(gluon)
    jb.initialize(jmx.init.Xavier())
    tb.initialize(ctx=CPU)
    tout, _ = _both(jb, tb, [_f32(_rs(13), 4, 5)])
    assert tout.shape == (4, 10)
    if hybrid:
        tb.hybridize()
        _close(tb(nd.array(_f32(_rs(13), 4, 5), ctx=CPU)).asnumpy(),
               tout.asnumpy(), TOL, "hybridized")


@pytest.mark.parametrize("factor,shape", [(2, (2, 6, 5)), (3, (1, 3, 4)),
                                          (2, (2, 8, 3, 4)),
                                          ((2, 3), (1, 12, 2, 3))])
def test_pixel_shuffle_matches_jax(factor, shape):
    import mxnet_tpu.gluon.contrib.nn as jcnn

    name = "PixelShuffle1D" if len(shape) == 3 else "PixelShuffle2D"
    x = _f32(_rs(14), *shape)
    j = getattr(jcnn, name)(factor)(jnd.array(x))
    t = getattr(gluon.contrib.nn, name)(factor)(nd.array(x, ctx=CPU))
    _close(t.asnumpy(), j.asnumpy(), 0, name)


# -- gluon.utils ---------------------------------------------------------------

def test_split_data_and_split_and_load_match_jax():
    from mxnet_tpu.gluon import utils as jutils

    x = _f32(_rs(15), 7, 3)
    for even, n in ((False, 3), (True, 7)):
        js = jutils.split_data(jnd.array(x), n, even_split=even)
        ts = gluon.utils.split_data(nd.array(x, ctx=CPU), n,
                                    even_split=even)
        assert len(ts) == len(js)
        for t, j in zip(ts, js):
            _close(t.asnumpy(), j.asnumpy(), 0)
    with pytest.raises(ValueError, match="evenly"):
        gluon.utils.split_data(nd.array(x, ctx=CPU), 3)
    ts = gluon.utils.split_data(nd.array(x, ctx=CPU), 7, batch_axis=0)
    assert [t.shape for t in ts] == [(1, 3)] * 7
    out = gluon.utils.split_and_load(x, [CPU])
    assert len(out) == 1 and out[0].context == CPU
    _close(out[0].asnumpy(), x, 0)
    out = gluon.utils.split_and_load(nd.array(x[:6], ctx=CPU), [CPU, CPU])
    assert [o.shape for o in out] == [(3, 3), (3, 3)]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax_and_writes_in_place(max_norm):
    from mxnet_tpu.gluon import utils as jutils

    rs = _rs(16)
    arrays = [_f32(rs, 3, 4), _f32(rs, 5)]
    total = onp.sqrt(sum((a.astype("float64") ** 2).sum() for a in arrays))
    jarr = [jnd.array(a) for a in arrays]
    tarr = [nd.array(a, ctx=CPU) for a in arrays]
    tensors = [t.data for t in tarr]
    jn = jutils.clip_global_norm(jarr, max_norm)
    tn = gluon.utils.clip_global_norm(tarr, max_norm)
    assert abs(tn - total) <= 1e-6 * total and abs(tn - jn) <= 1e-6 * total
    scale = min(1.0, max_norm / (total + 1e-8))
    for t, j, a, ten in zip(tarr, jarr, arrays, tensors):
        assert t.data is ten  # the handle's own tensor, written in place
        _close(t.asnumpy(), j.asnumpy(), 1e-6)
        _close(t.asnumpy(), a * scale, 1e-6)


def test_clip_global_norm_warns_on_nan_and_writes_nothing():
    a = nd.array(onp.array([onp.nan, 1.0], "float32"), ctx=CPU)
    with pytest.warns(UserWarning, match="nan or inf"):
        n = gluon.utils.clip_global_norm([a], 1.0)
    assert onp.isnan(n) and a.asnumpy()[1] == 1.0


def test_check_sha1_download_and_shape_is_known(tmp_path):
    from mxnet_tpu.gluon import utils as jutils

    f = tmp_path / "blob.bin"
    f.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert gluon.utils.check_sha1(str(f), digest)
    assert not gluon.utils.check_sha1(str(f), "0" * 40)
    # download fetches nothing: an existing file is returned as is
    url = "http://example.invalid/blob.bin"
    assert gluon.utils.download(url, path=str(f)) == str(f)
    assert gluon.utils.download(url, path=str(tmp_path)) == \
        os.path.join(str(tmp_path), "blob.bin")
    with pytest.raises(RuntimeError, match="fetches nothing"):
        gluon.utils.download(url, path=str(tmp_path / "missing.bin"))
    with pytest.raises(RuntimeError):
        gluon.utils.download(url, path=str(f), overwrite=True)
    for shape in (None, (), (2, 3), (2, 0), (0,), (5,)):
        assert gluon.utils.shape_is_known(shape) == \
            jutils.shape_is_known(shape), shape


# -- Trainer.allreduce_grads ----------------------------------------------------

@pytest.mark.parametrize("opt,kw", [("sgd", {"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-3}),
                                    ("nag", {"learning_rate": 0.05,
                                             "momentum": 0.8})])
def test_allreduce_grads_then_update_equals_step(opt, kw):
    """One card holds the only gradients: ``allreduce_grads()`` changes
    nothing, and with ``update()`` after it three steps land where
    ``step()`` lands (the fused step against the eager loop)."""
    rs = _rs(17)
    x, y = _f32(rs, 8, 5), _f32(rs, 8, 3)
    nets = [_dense_stack(gluon) for _ in range(2)]
    nets[0].initialize(mx.init.Xavier(), ctx=CPU)
    nets[0](nd.array(x, ctx=CPU))
    arrays = {k: p.data().asnumpy() for k, p in
              nets[0]._collect_params_with_prefix().items()}
    convert.params_from_numpy(nets[1], arrays, ctx=CPU)
    trainers = [gluon.Trainer(n.collect_params(), opt, dict(kw))
                for n in nets]
    lf = gluon.loss.L2Loss()
    for _ in range(3):
        for i, (net, tr) in enumerate(zip(nets, trainers)):
            with autograd.record():
                loss = lf(net(nd.array(x, ctx=CPU)), nd.array(y, ctx=CPU))
            loss.backward()
            if i == 0:
                tr.step(8)
            else:
                grads = [p.grad().asnumpy().copy() for p in
                         net.collect_params().values()]
                tr.allreduce_grads()
                for g, p in zip(grads, net.collect_params().values()):
                    _close(p.grad().asnumpy(), g, 0, "allreduce_grads")
                tr.update(8)
    p0, p1 = (n._collect_params_with_prefix() for n in nets)
    for k in p0:
        _close(p1[k].data().asnumpy(), p0[k].data().asnumpy(), 0, k)


def test_a_dist_kvstore_names_the_multi_device_slice():
    """Data parallelism over processes (slice 9a) is ported: a dist_sync
    Trainer is made and is distributed, outside a process group as one
    worker; a bind over several contexts of one process (the mesh) names
    slice 9b, and an unknown store raises."""
    net = _dense_stack(gluon)
    net.initialize(ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync")
    assert tr._distributed and tr._kvstore_type == "dist_sync"
    kv = mx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers, kv.num_dead_node()) == (0, 1, 0)
    with pytest.raises(mx.MXNetError, match="slice 9b"):
        mx.executor.one_context([CPU, CPU])
    with pytest.raises(mx.MXNetError, match="unknown kvstore"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_ring")


def test_relu_gradient_at_zero_follows_the_reference():
    """At an input of exactly 0 the port's ReLU passes no gradient, as
    MXNet's does (``x > 0``); the JAX package's passes 0.5 (ROADMAP C:
    a reference-side caveat). Elsewhere the two agree."""
    x = onp.array([0.0, 1.5, -2.0], "float32")
    jx, tx = jnd.array(x), nd.array(x, ctx=CPU)
    jx.attach_grad()
    tx.attach_grad()
    with jautograd.record():
        jl = jnd.activation(jx, act_type="relu").sum()
    with autograd.record():
        tl = nd.activation(tx, act_type="relu").sum()
    jl.backward()
    tl.backward()
    assert tx.grad.asnumpy().tolist() == [0.0, 1.0, 0.0]
    assert jx.grad.asnumpy().tolist() == [0.5, 1.0, 0.0]


def test_example_twins_run_on_the_cpu():
    """The twins of ``examples/train_gan_toy.py`` and
    ``examples/train_recommender_mf.py``: the GAN's generator lands near
    the ring's scale, and the matrix factorization's training MSE falls
    below a quarter of its start (the example's own check)."""
    from mxnet_tpu_torch.examples import train_gan_toy, train_recommender_mf

    gan = train_gan_toy.main(["--cpu", "--steps", "100"])
    assert onp.isfinite(gan["d_loss"]) and 0.5 < gan["mean_radius"] < 4.0
    mf = train_recommender_mf.main(["--cpu", "--epochs", "8"])
    assert mf["last_mse"] < 0.25 * mf["first_mse"]
