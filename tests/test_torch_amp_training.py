"""The slice end to end on the CPU: bf16 AMP training with a loss scaler
and the fused step, the port against the JAX package; and batch norm's
one-pass statistics.

Both packages train the same networks from the same weights (carried by
``convert``) for three steps under ``amp.init("bfloat16")``, with a
dynamic loss scaler and the fused step, and again in float32. bf16
rounds at different places in the two frameworks, so the packages are
not asked to agree in bf16. Each package's bf16 run is compared with
its own float32 run: the deviation of the logits of every step, of the
first step's gradients and of the final weights, each over the whole
network in the L2 norm (the weights relative to how far the float32 run
moved them). The port's
deviation must stay within 1.5 times the JAX package's plus 1e-3 — the port's bf16 error is of the JAX
package's kind and size. The first step's bf16 loss must agree across
the packages within rtol 2e-2 (a few bf16 ulps through a deep net).

The networks: ``resnet18_v1(thumbnail=True)`` at batch 4 of 32 x 32
images (SGD, momentum 0.9), and a 2-layer, 64-wide ``TransformerLM``
with a tied embedding at 2 x 32 tokens (Adam). Batch norm's training
gradients at batch 4 are well conditioned in float32 on these inputs
(``tests/test_torch_resnet.py`` checks the same network against float64).
"""
import os

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.models import TransformerLM as JaxTransformerLM

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import fused_step
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import TransformerLM

CPU = mx.cpu()
STEPS = 3
DEV_FACTOR, DEV_FLOOR = 1.5, 1e-3
LOSS_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _clean():
    import torch

    saved = os.environ.pop("MXNET_FUSED_STEP", None)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    fused_step.reset_fused_step_cache()
    yield
    torch.set_num_threads(prev)
    amp.disable()
    jamp.disable()
    if saved is not None:
        os.environ["MXNET_FUSED_STEP"] = saved


def _np(a):
    return onp.asarray(a.asnumpy(), dtype="float32")


def _rel(a, b):
    """max |a - b| relative to b's largest magnitude."""
    return float(onp.abs(a - b).max() / (onp.abs(b).max() or 1.0))


def _run(pkg, make_net, arrays, data, loss_of, opt, opt_args, use_amp):
    """``STEPS`` steps of one package from ``arrays``: returns (losses,
    every step's logits, the first step's gradients unscaled, the final
    weights), the last two keyed by structural name."""
    if pkg == "jax":
        A, ag, gl, ndm = jamp, jautograd, jgluon, jnd
    else:
        A, ag, gl, ndm = amp, autograd, gluon, nd
    net = make_net()
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        if pkg == "jax":
            p.set_data(jnd.array(arrays[k]))
        else:
            p.set_data(arrays[k])
    if use_amp:
        A.init("bfloat16")
    tr = gl.Trainer(net.collect_params(), opt, dict(opt_args))
    if use_amp:
        A.init_trainer(tr)
    losses, logits, grads = [], [], None
    try:
        for step in range(STEPS):
            scale = tr._amp_loss_scaler.loss_scale if use_amp else 1.0
            with ag.record():
                out, loss = loss_of(net, ndm, data)
                if use_amp:
                    with A.scale_loss(loss, tr) as scaled:
                        scaled.backward()
            if not use_amp:
                loss.backward()
            losses.append(float(_np(loss).reshape(-1)[0]))
            logits.append(_np(out))
            if step == 0:
                grads = {k: _np(p.grad()) / scale for k, p in params.items()
                         if p.grad_req != "null"}
            tr.step(1)
    finally:
        A.disable()
    weights = {k: _np(p.data()) for k, p in params.items()}
    return onp.array(losses), onp.stack(logits), grads, weights


def _l2(parts):
    return float(onp.sqrt(sum(float((p.astype("float64") ** 2).sum())
                              for p in parts)))


def _deviations(amp_run, fp32_run, start):
    """How far a package's bf16 run is from its float32 run, each over
    the whole network in the L2 norm (single entries near zero carry no
    relative precision in bf16): the logits of every step and the first
    step's gradients relative to their norm, and the final weights' gap
    relative to how far the float32 run moved them from ``start``. The
    loss's gap (reported, not bounded) is one scalar per step, a single
    draw of the rounding noise; the logits carry the same error over
    every entry."""
    (la, oa, ga, wa), (lf, of, gf, wf) = amp_run, fp32_run
    return {"loss": float(onp.abs(la - lf).max() / onp.abs(lf).max()),
            "logits": _l2([oa - of]) / _l2([of]),
            "grads": _l2([ga[k] - gf[k] for k in gf]) /
            _l2([gf[k] for k in gf]),
            "weights": _l2([wa[k] - wf[k] for k in wf]) /
            _l2([wf[k] - start[k] for k in wf])}


def _check_slice(make_jax, make_port, arrays, data, loss_of, opt,
                 opt_args):
    runs = {}
    for pkg, make in (("jax", make_jax), ("port", make_port)):
        for use_amp in (True, False):
            runs[pkg, use_amp] = _run(pkg, make, arrays, data, loss_of, opt,
                                      opt_args, use_amp)
    dev = {pkg: _deviations(runs[pkg, True], runs[pkg, False], arrays)
           for pkg in ("jax", "port")}
    for what in ("logits", "grads", "weights"):
        assert dev["port"][what] <= DEV_FACTOR * dev["jax"][what] + \
            DEV_FLOOR, (what, dev)
    # the bf16 runs move away from float32 at all (the policy is on)
    assert dev["port"]["logits"] > 0 and dev["jax"]["logits"] > 0
    onp.testing.assert_allclose(runs["port", True][0][0],
                                runs["jax", True][0][0], rtol=LOSS_RTOL)
    # the float32 runs agree across packages (a sanity bound)
    onp.testing.assert_allclose(runs["port", False][0],
                                runs["jax", False][0], rtol=1e-4,
                                atol=1e-4 * runs["jax", False][0][0])
    return dev


def test_resnet18_bf16_amp_training_tracks_jax():
    B, H = 4, 32
    jmx.random.seed(0)
    jnet = jvision.resnet18_v1(thumbnail=True, classes=10,
                               prefix="torchamp_r18_")
    jnet.initialize(jmx.init.Xavier())
    rs = onp.random.RandomState(5)
    x = rs.randn(B, 3, H, H).astype("f")
    y = rs.randint(0, 10, B).astype("f")
    with jautograd.pause():
        jnet(jnd.array(x))
    arrays = {k: _np(p.data())
              for k, p in jnet._collect_params_with_prefix().items()}

    def make_jax():
        return _finish_jax(jvision.resnet18_v1(
            thumbnail=True, classes=10, prefix="torchamp_r18_"), x)

    def make_port():
        net = vision.resnet18_v1(thumbnail=True, classes=10)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        with autograd.pause():
            net(nd.array(x, ctx=CPU))
        return net

    def loss_of(net, ndm, data):
        xs, ys = data[ndm is jnd]
        out = net(xs)
        return out, (jgluon if ndm is jnd else gluon).loss.\
            SoftmaxCrossEntropyLoss()(out, ys).mean()

    data = {True: (jnd.array(x), jnd.array(y)),
            False: (nd.array(x, ctx=CPU), nd.array(y, ctx=CPU))}
    _check_slice(make_jax, make_port, arrays, data, loss_of, "sgd",
                 {"learning_rate": 0.001, "momentum": 0.9, "wd": 1e-4})


def _finish_jax(jnet, x):
    jnet.initialize(jmx.init.Xavier())
    with jautograd.pause():
        jnet(jnd.array(x))
    return jnet


LM = dict(vocab_size=50, embed_dim=64, num_layers=2, num_heads=4,
          max_len=32, tie_weights=True)


def test_transformer_lm_bf16_amp_training_tracks_jax():
    B, S = 2, 32
    toks = onp.random.RandomState(6).randint(0, LM["vocab_size"],
                                             (B, S)).astype("f")
    jmx.random.seed(1)
    jnet = _finish_jax(JaxTransformerLM(**LM, prefix="torchamp_lm_"), toks)
    arrays = {k: _np(p.data())
              for k, p in jnet._collect_params_with_prefix().items()}

    def make_jax():
        return _finish_jax(JaxTransformerLM(**LM, prefix="torchamp_lm_"),
                           toks)

    def make_port():
        net = TransformerLM(**LM)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        with autograd.pause():
            net(nd.array(toks, ctx=CPU))
        return net

    def loss_of(net, ndm, data):
        t = data[ndm is jnd]
        V = LM["vocab_size"]
        logits = net(t)
        return logits, (jgluon if ndm is jnd else gluon).loss.\
            SoftmaxCrossEntropyLoss()(logits[:, :-1].reshape(B * (S - 1), V),
                                      t[:, 1:].reshape(B * (S - 1))).mean()

    data = {True: jnd.array(toks), False: nd.array(toks, ctx=CPU)}
    _check_slice(make_jax, make_port, arrays, data, loss_of, "adam",
                 {"learning_rate": 1e-3})


def test_trainer_states_carry_from_jax():
    """``convert.trainer_states_from_numpy`` starts the port's trainer
    from the JAX trainer's optimizer state (Adam moments after two steps,
    and the update count): the next step then matches."""
    rs = onp.random.RandomState(9)
    shapes = [(4, 3), (4,)]
    w0 = [rs.randn(*s).astype("f") for s in shapes]
    gs = [[rs.randn(*s).astype("f") * 0.1 for s in shapes]
          for _ in range(3)]
    from mxnet_tpu.gluon.parameter import Parameter as JParameter
    from mxnet_tpu_torch.gluon.parameter import Parameter

    jps = []
    for i, (s, w) in enumerate(zip(shapes, w0)):
        p = JParameter(f"q{i}", shape=s)
        p.initialize()
        p.set_data(jnd.array(w))
        jps.append(p)
    jtr = jgluon.Trainer(jps, "adam", {"learning_rate": 0.01})
    for step in range(2):
        for p, g in zip(jps, gs[step]):
            p.grad()._data = jnd.array(g).data
        jtr.step(1)
    tps = []
    for i, (s, p) in enumerate(zip(shapes, jps)):
        tp = Parameter(f"q{i}", shape=s)
        tp.initialize(ctx=CPU)
        tp.set_data(_np(p.data()))
        tps.append(tp)
    ttr = gluon.Trainer(tps, "adam", {"learning_rate": 0.01})
    jtr._sync_fused_state()
    convert.trainer_states_from_numpy(
        ttr, [tuple(_np(x) for x in s) for s in jtr._states],
        num_update=jtr._optimizer.num_update,
        index_update_count=jtr._optimizer._index_update_count)
    for p, tp, g in zip(jps, tps, gs[2]):
        p.grad()._data = jnd.array(g).data
        tp.grad().data.copy_(nd.array(g, ctx=CPU).data)
    jtr.step(1)
    ttr.step(1)
    for p, tp in zip(jps, tps):
        onp.testing.assert_allclose(_np(tp.data()), _np(p.data()),
                                    rtol=1e-6, atol=1e-7)
    with pytest.raises(mx.MXNetError):
        convert.trainer_states_from_numpy(ttr, [None, None])


# -- batch norm: statistics from the one normalization pass ----------------

@pytest.mark.parametrize("n", [1, 2, 128])
def test_batch_norm_one_pass_statistics(n):
    """Training-mode batch norm at n values per channel: the output, the
    batch mean and the biased variance against the JAX op and float64
    (n = 1: the mean is the value, the variance 0, the output beta)."""
    C = 3
    shape = {1: (1, C, 1, 1), 2: (2, C, 1, 1), 128: (2, C, 8, 8)}[n]
    rs = onp.random.RandomState(n)
    x = (rs.randn(*shape) * 2 + 0.5).astype("f")
    gamma = rs.uniform(0.5, 1.5, C).astype("f")
    beta = rs.randn(C).astype("f")
    mm, mv = onp.zeros(C, "f"), onp.ones(C, "f")
    kw = dict(eps=1e-5, fix_gamma=False, output_mean_var=True,
              use_batch_stats=True)
    t = nd.batch_norm(*[nd.array(a, ctx=CPU) for a in
                        (x, gamma, beta, mm, mv)], **kw)
    j = jnd.batch_norm(*[jnd.array(a) for a in (x, gamma, beta, mm, mv)],
                       **kw)
    x64 = x.astype("float64").transpose(1, 0, 2, 3).reshape(C, -1)
    mean64, var64 = x64.mean(axis=1), x64.var(axis=1)
    out64 = ((x.astype("float64") - mean64.reshape(1, C, 1, 1))
             / onp.sqrt(var64.reshape(1, C, 1, 1) + 1e-5)
             * gamma.reshape(1, C, 1, 1) + beta.reshape(1, C, 1, 1))
    for got, want, ref in zip(t, j, (out64, mean64, var64)):
        assert got.shape == want.shape
        onp.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                    atol=1e-6)
        onp.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-6)


def test_batch_norm_half_input_with_float32_parameters():
    """A bf16 input with float32 parameters (a cast network's batch norm)
    goes in without a float32 copy and comes out bf16, within one bf16
    rounding of the JAX op's output and of float64."""
    C = 4
    rs = onp.random.RandomState(2)
    x = rs.randn(3, C, 5, 5).astype("f")
    gamma, beta = rs.uniform(0.5, 1.5, C).astype("f"), rs.randn(C)\
        .astype("f")
    args = (onp.zeros(C, "f"), onp.ones(C, "f"))
    kw = dict(eps=1e-5, fix_gamma=False, use_batch_stats=True)
    t = nd.batch_norm(nd.array(x, ctx=CPU).astype("bfloat16"),
                      *[nd.array(a, ctx=CPU) for a in (gamma, beta) + args],
                      **kw)
    j = jnd.batch_norm(jnd.array(x).astype("bfloat16"),
                       *[jnd.array(a) for a in (gamma, beta) + args], **kw)
    assert str(t.dtype) == str(j.dtype) == "bfloat16"
    onp.testing.assert_allclose(_np(t), _np(j), rtol=2.0 ** -7, atol=2e-2)


def test_batchnorm_layer_running_update_matches_jax():
    """The fused running-statistics write of ``BatchNorm`` (MXNet's
    momentum, biased variance) after two training forwards."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn

    rs = onp.random.RandomState(3)
    xs = [rs.randn(4, 3, 6, 6).astype("f") * 3 + 1 for _ in range(2)]
    jbn = jnn.BatchNorm(momentum=0.8, in_channels=3, prefix="torchamp_bn_")
    jbn.initialize()
    bn = nn.BatchNorm(momentum=0.8, in_channels=3)
    bn.initialize(ctx=CPU)
    for x in xs:
        with jautograd.train_mode():
            jbn(jnd.array(x))
        with autograd.train_mode():
            bn(nd.array(x, ctx=CPU))
    jp, tp = jbn._collect_params_with_prefix(), \
        bn._collect_params_with_prefix()
    for k in ("running_mean", "running_var"):
        onp.testing.assert_allclose(_np(tp[k].data()), _np(jp[k].data()),
                                    rtol=1e-6, atol=1e-6)


def test_rtc_head_takes_the_loss_scale_and_step_divides_it_out():
    """ResNet's ``rtc_softmax`` head ignores its top gradient, so under a
    loss scaler it multiplies its gradient by the scale that
    ``amp.scale_loss`` hands out (the device scale on the fused step).
    The scale is a power of two, so a scaled bf16 run and an unscaled
    one take the same steps, bit for bit."""
    from mxnet_tpu_torch.tools import profile_resnet as pr

    rs = onp.random.RandomState(8)
    x = rs.randn(4, 3, 32, 32).astype("f")
    y = rs.randint(0, 10, 4).astype("f")
    runs = []
    for scaled in (True, False):
        mx.random.seed(2)
        net = vision.resnet18_v1(thumbnail=True, classes=10)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        xs, ys = nd.array(x, ctx=CPU), nd.array(y, ctx=CPU)
        with autograd.pause():
            net(xs)
        tr = pr.make_trainer(net)
        amp.init("bfloat16")
        if scaled:
            amp.init_trainer(tr)
        try:
            losses = [float(pr.train_step(net, tr, xs, ys).asscalar())
                      for _ in range(3)]
        finally:
            amp.disable()
        runs.append((losses, [p.data().asnumpy() for p in
                              net.collect_params().values()]))
    (ls, ws), (lu, wu) = runs
    assert ls == lu
    assert all(a.tobytes() == b.tobytes() for a, b in zip(ws, wu))
