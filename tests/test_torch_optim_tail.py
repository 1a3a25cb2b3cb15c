"""The optimizers without a fused kernel — ``Adamax``, ``Nadam``,
``FTML``, ``LAMB``, ``LARS``, ``LBSGD``, ``DCASGD``, ``SGLD`` and
``contrib.GroupAdaGrad`` — and the ops ``ftml_update``,
``lamb_update_phase1``, ``lamb_update_phase2`` and ``multi_lars``, in
the port against the JAX package on the CPU.

Each optimizer takes several steps on the same weights and gradients
(numpy, from a seed) in both packages, called directly
(``create_state_multi_precision``, ``update_multi_precision``) and
through a ``Trainer`` on a small MLP; every weight and every state
tensor is compared after each step. ``SGLD`` is held without its noise
(the JAX draw is replaced by zeros and the port's ``_noise`` by None:
the two generators never agree), and its noise alone is held to N(0,
lr) statistically. The ops run on the same inputs in both packages and
in ``sym`` (shape inference and evaluation).

Tolerances: the updates within 1e-5 of each tensor's largest magnitude
(float32 in another order: torch and XLA fuse the elementwise chains
differently, and the LARS rate and the LAMB trust ratio divide two
norms); the ops within 1e-6; the noise's mean within 5 standard errors
of 0 and its standard deviation within 2% of sqrt(lr) over 200,000
draws.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd, sym

CPU = mx.cpu()
TOL = 1e-5
OP_TOL = 1e-6
STEPS = 4

OPTIMIZERS = [
    ("adamax", "adamax", dict(learning_rate=0.01, wd=0.01,
                              clip_gradient=0.5, rescale_grad=0.5)),
    ("nadam", "nadam", dict(learning_rate=0.01, wd=0.01)),
    ("ftml", "ftml", dict(learning_rate=0.01, wd=0.001, clip_gradient=1.0)),
    ("lamb", "lamb", dict(learning_rate=0.01, wd=0.01)),
    ("lamb_bounds", "lamb", dict(learning_rate=0.02, lower_bound=0.5,
                                 upper_bound=2.0, bias_correction=False,
                                 clip_gradient=0.8)),
    ("lars_momentum", "lars", dict(learning_rate=0.1, momentum=0.9,
                                   wd=1e-3, eta=0.01)),
    ("lars", "lars", dict(learning_rate=0.1, eta=0.02, eps=1e-6,
                          rescale_grad=0.5)),
    ("lbsgd_linear", "lbsgd", dict(learning_rate=0.05, momentum=0.9,
                                   batch_scale=4, updates_per_epoch=2,
                                   warmup_epochs=2)),
    ("lbsgd_sqrt", "lbsgd", dict(learning_rate=0.05,
                                 warmup_strategy="sqrt", batch_scale=2,
                                 updates_per_epoch=1, warmup_epochs=3)),
    ("lbsgd_lars", "lbsgd", dict(learning_rate=0.05, momentum=0.5,
                                 warmup_strategy="lars", wd=1e-3)),
    ("dcasgd_momentum", "dcasgd", dict(learning_rate=0.05, momentum=0.9,
                                       lamda=0.04, wd=1e-3)),
    ("dcasgd", "dcasgd", dict(learning_rate=0.05, lamda=0.1,
                              clip_gradient=0.7)),
    ("sgld", "sgld", dict(learning_rate=0.01, wd=0.01, clip_gradient=1.0)),
    ("group_adagrad", "groupadagrad", dict(learning_rate=0.1, eps=1e-5,
                                           clip_gradient=2.0)),
]
IDS = [c[0] for c in OPTIMIZERS]


@pytest.fixture
def quiet_sgld(monkeypatch):
    """SGLD without its noise in both packages."""
    import mxnet_tpu.random as jrandom

    monkeypatch.setattr(jrandom, "normal",
                        lambda loc, scale, shape, dtype="float32", **kw:
                        jnd.zeros(shape, dtype=dtype))
    monkeypatch.setattr(mx.optimizer.SGLD, "_noise",
                        lambda self, weight, lr: None)


def _close(got, want, tol, what):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(onp.max(onp.abs(want))) if want.size else 1.0
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                                err_msg=what)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


def _shapes(name):
    return [(6, 4), (5, 3)] if name == "groupadagrad" else \
        [(6, 4), (4,), (3, 2, 2)]


@pytest.mark.parametrize("case", OPTIMIZERS, ids=IDS)
def test_optimizer_steps_match_jax(case, quiet_sgld):
    _, name, kw = case
    rs = onp.random.RandomState(0)
    shapes = _shapes(name)
    weights = [rs.randn(*s).astype("float32") for s in shapes]
    jopt = jmx.optimizer.create(name, **kw)
    topt = mx.optimizer.create(name, **kw)
    jw = [jnd.array(w) for w in weights]
    tw = [nd.array(w, ctx=CPU) for w in weights]
    tensors = [w.data for w in tw]
    js = [jopt.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    ts = [topt.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    for step in range(STEPS):
        for i, s in enumerate(shapes):
            g = (rs.randn(*s) * 2).astype("float32")
            jopt.update_multi_precision(i, jw[i], jnd.array(g), js[i])
            topt.update_multi_precision(i, tw[i], nd.array(g, ctx=CPU),
                                        ts[i])
        for i in range(len(shapes)):
            _close(tw[i].asnumpy(), jw[i].asnumpy(), TOL,
                   f"step {step} weight {i}")
            jl, tl = _leaves(js[i]), _leaves(ts[i])
            assert len(jl) == len(tl)
            for k, (a, b) in enumerate(zip(tl, jl)):
                _close(a.asnumpy(), b.asnumpy(), TOL,
                       f"step {step} weight {i} state {k}")
    # the weights were written in place
    assert all(w.data is t for w, t in zip(tw, tensors))
    assert topt.num_update == jopt.num_update == STEPS


def _mlp(pkg, prefix=None):
    net = pkg.nn.HybridSequential(**({} if prefix is None
                                     else {"prefix": prefix}))
    with net.name_scope():
        net.add(pkg.nn.Dense(8, activation="relu"), pkg.nn.Dense(3))
    return net


@pytest.mark.parametrize("case", OPTIMIZERS, ids=IDS)
def test_trainer_runs_the_eager_loop_like_jax(case, quiet_sgld):
    """Three Trainer steps on a small MLP: the port's Trainer runs these
    optimizers through its eager per-parameter loop (a fused-step bypass,
    as the JAX Trainer has no fused kernel for them either)."""
    from mxnet_tpu_torch.gluon import fused_step

    _, name, kw = case
    rs = onp.random.RandomState(1)
    x, y = rs.randn(8, 5).astype("f"), rs.randn(8, 3).astype("f")
    jnet, tnet = _mlp(jgluon, "jm_"), _mlp(gluon)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(x))
    convert.params_from_numpy(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()},
        ctx=CPU)
    def params(net):
        # GroupAdaGrad's rows share one rate: it takes 2-D weights only
        ps = net._collect_params_with_prefix()
        return [ps[k] for k in sorted(ps)
                if name != "groupadagrad" or k.endswith("weight")]

    jtr = jgluon.Trainer(params(jnet), name, dict(kw))
    ttr = gluon.Trainer(params(tnet), name, dict(kw))
    before = fused_step.fused_step_stats()["bypasses"]
    jl_, tl_ = jgluon.loss.L2Loss(), gluon.loss.L2Loss()
    for _ in range(3):
        with jautograd.record():
            jl = jl_(jnet(jnd.array(x)), jnd.array(y)).mean()
        jl.backward()
        jtr.step(8)
        with autograd.record():
            tl = tl_(tnet(nd.array(x, ctx=CPU)), nd.array(y, ctx=CPU)).mean()
        tl.backward()
        ttr.step(8)
        _close(tl.asnumpy(), jl.asnumpy(), TOL, "loss")
    assert fused_step.fused_step_stats()["bypasses"] - before == 3
    jp = jnet._collect_params_with_prefix()
    for k, p in tnet._collect_params_with_prefix().items():
        _close(p.data().asnumpy(), jp[k].data().asnumpy(), TOL, k)


def test_sgld_noise_is_normal_with_variance_lr():
    """The port's noise alone: a zero gradient, no weight decay."""
    lr = 0.04
    opt = mx.optimizer.SGLD(learning_rate=lr)
    w = nd.zeros((400, 500), ctx=CPU)
    opt.update(0, w, nd.zeros((400, 500), ctx=CPU), None)
    a = w.asnumpy().astype("float64").ravel()
    sd = lr ** 0.5
    assert abs(a.mean()) < 5 * sd / a.size ** 0.5
    assert abs(a.std() / sd - 1) < 0.02
    # two updates draw different noise
    w2 = nd.zeros((400, 500), ctx=CPU)
    opt.update(0, w2, nd.zeros((400, 500), ctx=CPU), None)
    assert not onp.array_equal(w2.asnumpy(), w.asnumpy())


def test_group_adagrad_refuses_weight_decay_and_1d_weights():
    opt = mx.optimizer.GroupAdaGrad(wd=0.1)
    w = nd.ones((3, 2), ctx=CPU)
    st = opt.create_state(0, w)
    assert st.shape == (3, 1)
    with pytest.raises(AssertionError, match="Weight decay"):
        opt.update(0, w, nd.ones((3, 2), ctx=CPU), st)
    with pytest.raises(AssertionError, match="2-D"):
        opt.create_state(0, nd.ones((3,), ctx=CPU))


def test_registry_knows_every_jax_optimizer():
    for _, name, _ in OPTIMIZERS:
        assert type(mx.optimizer.create(name)).__name__ == \
            type(jmx.optimizer.create(name)).__name__
    assert set(jmx.optimizer.__all__) <= set(mx.optimizer.__all__)
    assert mx.optimizer.contrib.GroupAdaGrad is mx.optimizer.GroupAdaGrad


# -- the ops -------------------------------------------------------------------

def _op_inputs(seed, n, shape=(5, 4)):
    rs = onp.random.RandomState(seed)
    return [rs.randn(*shape).astype("float32") for _ in range(n)]


OP_CASES = [
    ("ftml_update", 5, dict(lr=0.01, beta1=0.6, beta2=0.999, epsilon=1e-8,
                            wd=0.01, rescale_grad=0.5, clip_grad=0.8, t=3)),
    ("ftml_update_plain", 5, dict(lr=0.02, t=1)),
    ("lamb_update_phase1", 4, dict(beta1=0.9, beta2=0.99, epsilon=1e-6,
                                   t=2, bias_correction=True, wd=0.01,
                                   rescale_grad=0.5, clip_gradient=0.8)),
    ("lamb_update_phase1_no_correction", 4,
     dict(t=5, bias_correction=False)),
]


def _positive(arrays, idx):
    """The second moments (v, var) must be non-negative."""
    return [onp.abs(a) if i in idx else a for i, a in enumerate(arrays)]


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_ftml_and_lamb_phase1_ops_match_jax(case):
    op, n, kw = case
    op = op.replace("_plain", "").replace("_no_correction", "")
    arrays = _positive(_op_inputs(2, n), {3})
    if op == "ftml_update":
        arrays[2] = onp.abs(arrays[2]) + 0.5  # d is positive after step 1
    jout = getattr(jnd, op)(*[jnd.array(a) for a in arrays], **kw)
    tin = [nd.array(a, ctx=CPU) for a in arrays]
    tout = getattr(nd, op)(*tin, **kw)
    assert len(tout) == len(jout)
    for k, (t, j) in enumerate(zip(tout, jout)):
        _close(t.asnumpy(), j.asnumpy(), OP_TOL, f"{op} output {k}")
    # written in place: the weight and states (FTML), the moments (LAMB)
    inplace = (0, 2, 3, 4) if op == "ftml_update" else (2, 3)
    for k, i in enumerate(inplace):
        j = jout[k] if op == "ftml_update" else jout[k + 1]
        _close(tin[i].asnumpy(), j.asnumpy(), OP_TOL, f"input {i}")


@pytest.mark.parametrize("bounds", [(-1.0, -1.0), (0.5, 1.5), (2.0, 4.0)])
def test_lamb_phase2_matches_jax(bounds):
    w, g = _op_inputs(3, 2)
    for r1, r2 in ((3.0, 1.5), (0.0, 2.0), (2.0, 0.0)):
        args = [w, g, onp.array([r1], "f"), onp.array([r2], "f")]
        j = jnd.lamb_update_phase2(*[jnd.array(a) for a in args], lr=0.1,
                                   lower_bound=bounds[0],
                                   upper_bound=bounds[1])
        tw = nd.array(w, ctx=CPU)
        t = nd.lamb_update_phase2(tw, *[nd.array(a, ctx=CPU)
                                        for a in args[1:]], lr=0.1,
                                  lower_bound=bounds[0],
                                  upper_bound=bounds[1])
        _close(t.asnumpy(), j.asnumpy(), OP_TOL, f"r1={r1} r2={r2}")
        _close(tw.asnumpy(), j.asnumpy(), OP_TOL, "in place")


def test_multi_lars_matches_jax():
    rs = onp.random.RandomState(4)
    lrs = rs.uniform(0.01, 0.1, 6).astype("f")
    wss = (rs.rand(6) * 4).astype("f")
    gss = (rs.rand(6) * 2).astype("f")
    wss[1], gss[2] = 0.0, 0.0  # a zero norm keeps the plain rate
    wds = rs.uniform(0, 0.01, 6).astype("f")
    for kw in ({}, dict(eta=0.01, eps=1e-6, rescale_grad=0.5)):
        j = jnd.multi_lars(*[jnd.array(a) for a in (lrs, wss, gss, wds)],
                           **kw)
        t = nd.multi_lars(*[nd.array(a, ctx=CPU) for a in
                            (lrs, wss, gss, wds)], **kw)
        _close(t.asnumpy(), j.asnumpy(), OP_TOL, str(kw))
        assert t.asnumpy()[1] == lrs[1] and t.asnumpy()[2] == lrs[2]


def test_the_four_ops_in_sym_infer_and_evaluate():
    """``sym`` mirrors: every output's shape inferred from the inputs'
    and the evaluated graph equal to the ``nd`` call (``ftml_update``
    has four outputs and ``lamb_update_phase1`` three, the op's)."""
    shape = (5, 4)
    arrays = _positive(_op_inputs(5, 5), {3})
    arrays[2] = onp.abs(arrays[2]) + 0.5
    v = [sym.var(n) for n in ("w", "g", "d", "v", "z")]
    f = sym.ftml_update(*v, lr=0.01, t=2, name="ftml")
    assert f.list_outputs() == [f"ftml_output{i}" for i in range(4)]
    f = sym.Group([f[i] for i in range(4)])
    _, outs, _ = f.infer_shape(w=shape, g=shape, d=shape, v=shape, z=shape)
    assert outs == [shape] * 4
    feed = dict(zip(("w", "g", "d", "v", "z"), arrays))
    got = f.eval(ctx=CPU, **{k: nd.array(a, ctx=CPU)
                             for k, a in feed.items()})
    want = nd.ftml_update(*[nd.array(a, ctx=CPU) for a in arrays], lr=0.01,
                          t=2)
    for a, b in zip(got, want):
        _close(a.asnumpy(), b.asnumpy(), OP_TOL, "ftml sym")
    p1 = sym.lamb_update_phase1(*v[:4], t=1, wd=0.01, name="lamb1")
    assert len(p1.list_outputs()) == 3
    _, outs, _ = sym.Group([p1[i] for i in range(3)]).infer_shape(
        w=shape, g=shape, d=shape, v=shape)
    assert outs == [shape] * 3
    p2 = sym.lamb_update_phase2(v[0], v[1], sym.var("r1"), sym.var("r2"),
                                lr=0.1)
    _, outs, _ = p2.infer_shape(w=shape, g=shape, r1=(1,), r2=(1,))
    assert outs == [shape]
    ml = sym.multi_lars(*[sym.var(n) for n in ("a", "b", "c", "e")])
    _, outs, _ = ml.infer_shape(a=(6,), b=(6,), c=(6,), e=(6,))
    assert outs == [(6,)]
    got = ml.eval(ctx=CPU, **{n: nd.array(onp.full(6, 0.5, "f"), ctx=CPU)
                              for n in ("a", "b", "c", "e")})[0]
    want = nd.multi_lars(*[nd.array(onp.full(6, 0.5, "f"), ctx=CPU)] * 4)
    _close(got.asnumpy(), want.asnumpy(), OP_TOL, "multi_lars sym")


@pytest.mark.parametrize("case", [c for c in OPTIMIZERS if c[0] in (
    "adamax", "ftml", "lamb", "lbsgd_linear", "dcasgd_momentum",
    "group_adagrad")], ids=lambda c: c[0])
def test_trainer_states_carry_across_from_jax(case):
    """Two JAX Trainer steps, then the JAX optimizer's states and update
    counts carried into the port's Trainer by
    ``convert.trainer_states_from_numpy``: the third step lands where
    the JAX package's third step lands."""
    _, name, kw = case
    rs = onp.random.RandomState(5)
    x, y = rs.randn(8, 5).astype("f"), rs.randn(8, 3).astype("f")
    jnet, tnet = _mlp(jgluon, "js_"), _mlp(gluon)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(x))

    def params(net):
        ps = net._collect_params_with_prefix()
        return [ps[k] for k in sorted(ps)
                if name != "groupadagrad" or k.endswith("weight")]

    jtr = jgluon.Trainer(params(jnet), name, dict(kw))
    lf = jgluon.loss.L2Loss()

    def jstep():
        with jautograd.record():
            loss = lf(jnet(jnd.array(x)), jnd.array(y)).mean()
        loss.backward()
        jtr.step(8)

    for _ in range(2):
        jstep()
    convert.params_from_numpy(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()},
        ctx=CPU)

    def host(state):
        if state is None:
            return None
        if isinstance(state, (tuple, list)):
            return tuple(host(s) for s in state)
        return state.asnumpy()

    ttr = gluon.Trainer(params(tnet), name, dict(kw))
    convert.trainer_states_from_numpy(
        ttr, [host(s) for s in jtr._states],
        num_update=jtr._optimizer.num_update,
        index_update_count=jtr._optimizer._index_update_count)
    jstep()
    with autograd.record():
        loss = gluon.loss.L2Loss()(tnet(nd.array(x, ctx=CPU)),
                                   nd.array(y, ctx=CPU)).mean()
    loss.backward()
    ttr.step(8)
    jp = jnet._collect_params_with_prefix()
    for k, p in tnet._collect_params_with_prefix().items():
        _close(p.data().asnumpy(), jp[k].data().asnumpy(), TOL, k)
