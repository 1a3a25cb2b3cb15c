"""``HybridBlock.hybridize`` in the port against the JAX package's.

The port's :class:`CachedOp` captures a block's forward (and, under
``record()``, its backward) as CUDA graphs on the card; on the CPU, where
these tests run, the same function runs uncaptured, keyed and counted by
signature as on the card. The JAX package's ``CachedOp`` is ``jax.jit``
of the forward. Weights are built in JAX (Xavier, explicit prefixes) and
carried across with ``convert.params_from_numpy``; inputs come from
numpy seeds.

Tolerances:

- ``resnet18_v1(thumbnail=True)`` in eval mode (initial running
  statistics): the output and the loss within 1e-5 of the JAX
  package's, and every gradient within 1e-5 of the port's float64 run
  (of the largest magnitude of each tensor), since the JAX package's
  own eval-mode gradients stand up to 1.2% from float64 at this input
  (ROADMAP C);
- the 2-layer ``TransformerLM``: logits, the loss and every gradient
  within 1e-5 of the JAX package's (K1's plain version against the JAX
  package's CPU route for attention);
- training-mode ResNet gradients are ill-conditioned in float32 (batch
  norm's backward at small batches, ROADMAP C), so they are held, as
  ``tests/test_torch_resnet.py`` holds them, against the port's float64
  run within 1e-3 of each tensor's scale, both packages alike;
- batch norm's running statistics after N hybridized training calls:
  atol 1e-6 (one float32 mean and variance per call);
- the port's hybridized against its own eager path on the CPU: bitwise
  (the same function runs).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.models import TransformerLM as JaxTransformerLM

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, nd
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.models import TransformerLM
from mxnet_tpu_torch.ndarray import registry

TOL = 1e-5
F64_TOL = 1e-3
STATS_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(a):
    return nd.array(a, ctx=mx.cpu())


def _rs(seed):
    return onp.random.RandomState(seed)


def _close(got, want, tol, what=""):
    scale = float(onp.abs(want).max()) or 1.0
    err = float(onp.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _carry(jblock, tblock, x):
    with jautograd.pause():
        jblock(jnd.array(x))
    arrays = {k: p.data().asnumpy()
              for k, p in jblock._collect_params_with_prefix().items()}
    return convert.params_from_numpy(tblock, arrays, ctx=mx.cpu())


def _grads(net):
    return {k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


# -- the slice's models, hybridized in both packages --------------------------

def _resnet18_pair(tag, B=4):
    jmx.random.seed(0)
    jnet = jvision.resnet18_v1(thumbnail=True, classes=10,
                               prefix=f"hybparity_r18{tag}_")
    jnet.initialize(jmx.init.Xavier())
    x = _rs(18).randn(B, 3, 32, 32).astype("f")
    tnet = _carry(jnet, vision.resnet18_v1(thumbnail=True, classes=10), x)
    jnet.hybridize()
    tnet.hybridize()
    return jnet, tnet, x


def _ce(lossmod, net, x, label, pkg, ag, train):
    with ag.record(train_mode=train):
        loss = lossmod.SoftmaxCrossEntropyLoss()(net(x), label)
    loss.backward()
    return loss.asnumpy()


def _float64_twin(jnet):
    """The port's resnet18 holding ``jnet``'s weights in float64."""
    ref = vision.resnet18_v1(thumbnail=True, classes=10)
    arrays = {k: p.data().asnumpy().astype("float64")
              for k, p in jnet._collect_params_with_prefix().items()}
    convert.params_from_numpy(ref, arrays, ctx=mx.cpu())
    ref.cast("float64")
    return ref


def _x64(x):
    return nd.array(x.astype("float64"), ctx=mx.cpu(), dtype="float64")


def test_resnet18_eval_hybridized_matches_jax_hybridized():
    """Eval mode: the output and the loss against the JAX package's within
    1e-5; every gradient within 1e-5 of the float64 run. (The JAX
    package's eval-mode gradients at this input stand up to 1.2% from
    float64, eager and hybridized alike, where the port's float32 stands
    within 1.2e-6: ROADMAP C.)"""
    jnet, tnet, x = _resnet18_pair("eval")
    want = jnet(jnd.array(x)).asnumpy()
    got = tnet(_port(x)).asnumpy()
    _close(got, want, TOL, "eval forward")
    label = onp.array([1, 9, 0, 4], "f")
    ref = _float64_twin(jnet)
    _ce(gluon.loss, ref, _x64(x), _port(label), nd, autograd, train=False)
    jl = _ce(jgluon.loss, jnet, jnd.array(x), jnd.array(label), jnd,
             jautograd, train=False)
    tl = _ce(gluon.loss, tnet, _port(x), _port(label), nd, autograd,
             train=False)
    onp.testing.assert_allclose(tl, jl, rtol=TOL)
    g64, jg, tg = _grads(ref), _grads(jnet), _grads(tnet)
    assert sorted(jg) == sorted(tg) == sorted(g64)
    for k in tg:
        _close(tg[k], g64[k], TOL, k)
    _close(tg["output.weight"], jg["output.weight"], TOL, "output.weight")
    # the JAX package's own distance from float64 (1.2% when measured):
    # bounded, so a larger drift of the reference shows here
    jdev = max(float(onp.abs(jg[k] - g64[k]).max() / onp.abs(g64[k]).max())
               for k in g64)
    assert jdev < 0.05, f"JAX eval-mode gradients {jdev:.4f} from float64"
    st = tnet._cached_op.entries
    assert len(st) == 2  # eval unrecorded, eval recorded
    assert all(e.calls == 1 for e in st.values())


def test_resnet18_training_gradients_against_float64():
    """Training-mode gradients of both packages' hybridized runs, each
    within 1e-3 of the port's float64 eager run (see the docstring)."""
    jnet, tnet, x = _resnet18_pair("train")
    label = onp.array([3, 1, 7, 2], "f")
    ref = _float64_twin(jnet)
    _ce(gluon.loss, ref, _x64(x), _port(label), nd, autograd, train=True)
    jl = _ce(jgluon.loss, jnet, jnd.array(x), jnd.array(label), jnd,
             jautograd, train=True)
    tl = _ce(gluon.loss, tnet, _port(x), _port(label), nd, autograd,
             train=True)
    onp.testing.assert_allclose(tl, jl, rtol=1e-5)
    g64, jg, tg = _grads(ref), _grads(jnet), _grads(tnet)
    for k in g64:
        _close(tg[k], g64[k], F64_TOL, f"port {k}")
        _close(jg[k], g64[k], F64_TOL, f"jax {k}")


def _lm_pair(tie=True):
    cfg = dict(vocab_size=40, embed_dim=32, num_layers=2, num_heads=4,
               max_len=32, tie_weights=tie)
    toks = _rs(0).randint(0, 40, (4, 12)).astype("f")
    jmx.random.seed(0)
    jnet = JaxTransformerLM(**cfg, prefix=f"hybparity_lm{int(tie)}_")
    jnet.initialize(jmx.init.Xavier())
    tnet = _carry(jnet, TransformerLM(**cfg), toks)
    jnet.hybridize()
    tnet.hybridize()
    return jnet, tnet


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_transformer_lm_hybridized_matches_jax_hybridized(tie):
    jnet, tnet = _lm_pair(tie)
    toks = _rs(2).randint(0, 40, (4, 12)).astype("f")
    want = jnet(jnd.array(toks)).asnumpy()
    got = tnet(_port(toks)).asnumpy()
    _close(got, want, TOL, "logits")
    outs = []
    for pkg, ag, lossmod, net in ((jnd, jautograd, jgluon.loss, jnet),
                                  (nd, autograd, gluon.loss, tnet)):
        t = pkg.array(toks) if pkg is jnd else _port(toks)
        with ag.record():
            logits = net(t)
            loss = lossmod.SoftmaxCrossEntropyLoss()(
                logits[:, :-1].reshape(44, 40), t[:, 1:].reshape(44)).mean()
        loss.backward()
        outs.append(loss.asscalar())
    onp.testing.assert_allclose(outs[1], outs[0], rtol=TOL)
    jg, tg = _grads(jnet), _grads(tnet)
    assert sorted(jg) == sorted(tg)
    for k in tg:
        assert onp.abs(jg[k]).max() > 0, k
        _close(tg[k], jg[k], TOL, k)


# -- batch norm's running statistics: the JAX package's oracle -----------------

@pytest.mark.parametrize("deferred", [False, True],
                         ids=["shaped", "deferred"])
@pytest.mark.parametrize("calls", [1, 3])
def test_hybridized_batchnorm_statistics_after_n_calls_match_jax(deferred,
                                                                 calls):
    """``tests/test_gluon.py::test_hybridized_batchnorm_updates_stats``
    with the values held against the JAX package: N recorded training
    calls move the statistics as JAX's N calls do, including JAX's first
    call with deferred shapes (one throwaway eager forward, then the
    cached one: two updates)."""
    kw = {} if deferred else {"in_channels": 3}
    x = (_rs(4).rand(4, 3, 2, 2) * 5 + 3).astype("f")
    got = []
    for pkg, ag, nnmod, ctx in ((jnd, jautograd, jnn, None),
                                (nd, autograd, nn, mx.cpu())):
        layer = nnmod.BatchNorm(**kw)
        layer.initialize(ctx=ctx) if ctx else layer.initialize()
        layer.hybridize()
        arr = pkg.array(x) if ctx is None else pkg.array(x, ctx=ctx)
        for _ in range(calls):
            with ag.record():
                layer(arr)
        got.append((layer.running_mean.data().asnumpy(),
                    layer.running_var.data().asnumpy()))
    for j, p in zip(got[0], got[1]):
        onp.testing.assert_allclose(p, j, atol=STATS_TOL)
    assert (onp.abs(got[1][0]) > 0.01).any()


def test_hybridized_equals_eager_bitwise_on_the_cpu():
    def build():
        mx.random.seed(7)
        with mx.cpu():
            net = nn.HybridSequential()
            net.add(nn.Dense(8, activation="relu", in_units=5),
                    nn.BatchNorm(in_channels=8), nn.Dense(3, in_units=8))
            net.initialize(mx.init.Xavier())
        return net

    eager, hyb = build(), build()
    hyb.hybridize()
    for step in range(3):
        x = _port(_rs(step).randn(6, 5).astype("f"))
        outs = []
        for net in (eager, hyb):
            with autograd.record():
                y = net(x)
                (y * y).sum().backward()
            outs.append(y.asnumpy())
        onp.testing.assert_array_equal(outs[1], outs[0])
    ge, gh = _grads(eager), _grads(hyb)
    for k in ge:
        onp.testing.assert_array_equal(gh[k], ge[k])
    onp.testing.assert_array_equal(hyb[1].running_var.data().asnumpy(),
                                   eager[1].running_var.data().asnumpy())


# -- the cache's bookkeeping --------------------------------------------------

def _dense_net():
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
        net.initialize(mx.init.Xavier())
    return net


def test_one_entry_per_signature_and_counters():
    gluon.reset_cached_op_stats()
    net = _dense_net()
    net.hybridize(static_alloc=True, static_shape=True)
    x1 = _port(_rs(0).randn(2, 3).astype("f"))
    x2 = _port(_rs(1).randn(5, 3).astype("f"))
    net(x1)
    net(x1)
    op = net._cached_op
    assert op.static_alloc and op.static_shape
    assert len(op.entries) == 1
    net(x2)  # a second shape: a new entry
    assert len(op.entries) == 2
    with autograd.record():
        net(x1)  # recording: a new entry
    with autograd.train_mode():
        net(x1)  # training without recording: another
    assert len(op.entries) == 4
    st = gluon.cached_op_stats()
    assert st["builds"] == 4 and st["calls"] == 5
    assert st["captures"] == 0 and st["replays"] == 0  # the CPU: uncaptured
    sigs = sorted((e.sig["train"], e.sig["recording"], e.sig["inputs"][0][0])
                  for e in op.entries.values())
    assert sigs == [(False, False, (2, 3)), (False, False, (5, 3)),
                    (True, False, (2, 3)), (True, True, (2, 3))]
    assert op.entries[next(iter(op.entries))].calls == 2


def test_amp_version_bump_rebuilds_and_cast_and_hybridize_drop():
    gluon.reset_cached_op_stats()
    net = _dense_net()
    net.hybridize()
    x = _port(_rs(0).randn(2, 3).astype("f"))
    net(x)
    before = registry.amp_version()
    amp.init("bfloat16")
    try:
        assert registry.amp_version() > before
        y = net(x)  # the AMP policy is part of the key
        assert len(net._cached_op.entries) == 2
        assert y.dtype != onp.float32  # the bf16 policy ran
    finally:
        amp.disable()
    net(x)
    assert len(net._cached_op.entries) == 3  # disable bumps it again
    net.cast("float64")
    assert net._cached_op is None
    y = net(_port(_rs(0).randn(2, 3).astype("f")).astype("float64"))
    assert y.dtype == onp.float64
    net.hybridize()
    assert net._cached_op is None
    assert gluon.cached_op_stats()["drops"] == 2


def test_only_the_outermost_block_caches():
    net = _dense_net()
    net[0].hybridize()
    net.hybridize()
    assert net._active and not net[0]._active and not net[1]._active
    net(_port(_rs(0).randn(2, 3).astype("f")))
    assert net._cached_op is not None and net[0]._cached_op is None
    net.hybridize(False)
    assert not net._active


def test_outputs_keep_their_structure():
    class Two(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * 2, [x + 1, x - 1]

    blk = Two()
    blk.hybridize()
    x = _port(onp.arange(3, dtype="f"))
    a, (b, c) = blk(x)
    onp.testing.assert_array_equal(a.asnumpy(), [0, 2, 4])
    onp.testing.assert_array_equal(c.asnumpy(), [-1, 0, 1])
    a2, rest = blk(x)
    assert isinstance(rest, list) and len(rest) == 2


def test_mirror_recomputes_with_equal_gradients(monkeypatch):
    """``MXNET_BACKWARD_DO_MIRROR=1`` (the JAX package's jax.checkpoint)
    recomputes the forward in the backward with the forward's dropout
    draws: gradients equal the unmirrored run's bitwise."""
    def run():
        mx.random.seed(3)
        with mx.cpu():
            net = nn.HybridSequential()
            net.add(nn.Dense(16, activation="relu", in_units=4),
                    nn.Dropout(0.5), nn.Dense(2, in_units=16))
            net.initialize(mx.init.Xavier())
        net.hybridize()
        x = _port(_rs(5).randn(8, 4).astype("f"))
        with autograd.record():
            y = net(x)
        y.backward()
        return y.asnumpy(), _grads(net)

    y0, g0 = run()
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    y1, g1 = run()
    onp.testing.assert_array_equal(y1, y0)
    for k in g0:
        onp.testing.assert_array_equal(g1[k], g0[k])


def test_second_order_through_a_hybridized_block():
    """Higher-order gradients through the cache on the CPU (the JAX
    package's ``test_second_order_through_hybridized_block``), checked
    against a finite difference."""
    net = _dense_net()
    net.hybridize()
    x = _port(_rs(1).rand(4, 3).astype("f"))
    w = net[0].weight.data()

    def gnorm():
        with autograd.record():
            y = net(x)
            g = autograd.grad((y * y).sum(), w, create_graph=True)
            gn = (g * g).sum()
        return gn

    gn = gnorm()
    gn.backward()
    hvp = w.grad.asnumpy().copy()
    assert onp.isfinite(hvp).all() and (hvp != 0).any()
    wv = w.asnumpy().copy()
    eps = 1e-3

    def at(delta):
        net[0].weight.set_data(wv + delta)
        return float(gnorm().asscalar())

    d = onp.zeros_like(wv)
    d[0, 0] = eps
    fd = (at(d) - at(-d)) / (2 * eps)
    net[0].weight.set_data(wv)
    assert abs(hvp[0, 0] - fd) < 0.05 * max(1.0, abs(fd)), (hvp[0, 0], fd)


def test_infer_shape_and_optimize_for():
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(4), nn.Dense(2))
        net.initialize()
    x = _port(_rs(0).randn(3, 7).astype("f"))
    net.infer_shape(x)
    assert net[0].weight.shape == (4, 7)
    y = net.optimize_for(x)
    assert net._active and y.shape == (3, 2)


# -- hooks --------------------------------------------------------------------

def test_forward_hooks_fire_hybridized_with_mxnet_signature():
    """``register_forward_hook`` is MXNet's (``hook(block, args, out)``,
    a ``HookHandle`` with ``detach``), not ``nn.Module``'s, on the eager
    and the cached path (``tests/test_gluon2.py:85``)."""
    net = _dense_net()
    calls = []
    h1 = net.register_forward_pre_hook(
        lambda blk, inp: calls.append(("pre", blk is net, len(inp))))
    h2 = net.register_forward_hook(
        lambda blk, inp, out: calls.append(("post", out.shape)))
    assert isinstance(h1, gluon.HookHandle) and hasattr(h2, "detach")
    x = _port(_rs(0).randn(2, 3).astype("f"))
    net(x)
    net.hybridize()
    net(x)
    assert calls == [("pre", True, 1), ("post", (2, 2))] * 2
    h1.detach()
    h2.detach()
    calls.clear()
    net(x)
    assert calls == []
    assert len(net._forward_hooks) == 0  # torch's own list stays empty


def test_op_hook_taps_every_call_and_detaches():
    """``tests/test_gluon2.py:293``: taps fire eagerly and, hybridized,
    on every call; detached, the cached path resumes."""
    with mx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Dense(4, activation="relu"), nn.Dense(2))
        net.initialize(mx.init.Xavier())
    seen = []
    handle = net.register_op_hook(lambda name, arr: seen.append(name))
    x = _port(onp.ones((2, 3), "f"))
    net(x)
    assert any("dense" in s for s in seen), seen
    assert any(s.endswith("_output") for s in seen)
    n_eager = len(seen)
    net.hybridize()
    net(x)
    assert len(seen) == 2 * n_eager
    net(x)
    assert len(seen) == 3 * n_eager
    assert net._cached_op is None  # the taps forced the eager path
    handle.detach()
    before = len(seen)
    net(x)
    net(x)
    assert len(seen) == before
    assert net._cached_op is not None


def test_op_hook_names_match_jax():
    names = []
    for nnmod, pkg, ctx in ((jnn, jnd, None), (nn, nd, mx.cpu())):
        with (ctx or mx.cpu()):
            net = nnmod.HybridSequential(prefix="ophook_")
            with net.name_scope():
                net.add(nnmod.Dense(4, activation="relu", in_units=3),
                        nnmod.Dense(2, in_units=4))
        net.initialize(ctx=ctx) if ctx else net.initialize()
        seen = []
        h = net.register_op_hook(lambda n, a: seen.append(n),
                                 monitor_all=True)
        x = onp.ones((2, 3), "f")
        net(pkg.array(x) if ctx is None else pkg.array(x, ctx=ctx))
        h.detach()
        names.append(seen)
    assert names[1] == names[0]


def test_op_hooks_nested_and_out_of_order_detach():
    """``tests/test_gluon2.py:324``."""
    with mx.cpu():
        inner = nn.HybridSequential()
        inner.add(nn.Dense(4, activation="relu"))
        outer = nn.HybridSequential()
        outer.add(inner, nn.Dense(2))
        outer.initialize(mx.init.Xavier())
    inner.hybridize()
    x = _port(onp.ones((2, 3), "f"))
    outer(x)
    values = []
    h1 = outer.register_op_hook(
        lambda name, arr: values.append(float(arr.asnumpy().max())))
    names2 = []
    h2 = outer.register_op_hook(lambda name, arr: names2.append(name))
    outer(x)
    outer(x)
    assert len(values) >= 4
    n2 = len(names2)
    h1.detach()
    nv = len(values)
    outer(x)
    assert len(values) == nv and len(names2) > n2
    h2.detach()
    n2 = len(names2)
    outer(x)
    assert len(names2) == n2


def test_apply_and_summary(capsys):
    net = _dense_net()
    seen = []
    assert net.apply(lambda b: seen.append(type(b).__name__)) is net
    assert seen == ["Dense", "Dense", "HybridSequential"]
    net.summary()
    out = capsys.readouterr().out
    assert "Dense" in out and "16 params" in out
