"""The port's fused step (``gluon/fused_step.py`` and the Trainer's
wiring) on the CPU, where it runs uncaptured.

Mirrors ``tests/test_fused_step.py:83-309``: the fused step against the
eager per-parameter loop (bitwise for SGD, NAG and Signum, whose lists
and single-tensor updates share their arithmetic; rtol 1e-4, atol 1e-6
for the optimizers with a division by a square root, as in the JAX
tests: Adam's bias correction is float32 on the device against float64
on the host), an AMP skip episode, hyperparameters that never rebuild
the step, save/load before and after the first fused step, the
``MXNET_FUSED_STEP=0`` and bypass paths, multi-precision, and a whole
training loop. Then the port's fused step against the JAX package's
over five steps (rtol 1e-6: the same float32 arithmetic on two CPU
backends), and the port's own contracts: re-seeding in place after
``load_states`` and a write to the scale, warmup, and a cast or a new
``grad_req`` rebuilding the step.
"""
import os

import numpy as onp
import pytest

from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import fused_step as jfused
from mxnet_tpu.gluon.parameter import Parameter as JParameter

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.contrib.amp.loss_scaler import LossScaler
from mxnet_tpu_torch.gluon import fused_step, nn
from mxnet_tpu_torch.gluon.parameter import Parameter
from mxnet_tpu_torch.optimizer import SGD, lr_scheduler

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _fresh_cache():
    saved = {k: os.environ.pop(k, None)
             for k in ("MXNET_FUSED_STEP", "MXNET_FUSED_STEP_DONATE")}
    fused_step.reset_fused_step_cache()
    yield
    for k, v in saved.items():
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v
    fused_step.reset_fused_step_cache()


def _make_params(n=6, dim=4, seed=0, dtype="float32"):
    rs = onp.random.RandomState(seed)
    params = []
    for i in range(n):
        shape = (dim, dim) if i % 2 == 0 else (dim,)
        p = Parameter(f"p{i}", shape=shape, dtype=dtype)
        p.initialize(ctx=CPU)
        p.set_data(rs.randn(*shape).astype("f"))
        params.append(p)
    return params


def _grad_values(params, step, seed=100, poison=False):
    rs = onp.random.RandomState(seed + step)
    out = []
    for p in params:
        g = rs.randn(*p.shape).astype("f") * 0.1
        if poison:
            g = onp.full(p.shape, onp.inf, "f")
        out.append(g)
    return out


def _set_grads(params, step, seed=100, poison=False):
    for p, g in zip(params, _grad_values(params, step, seed, poison)):
        grad = p.grad().data
        grad.copy_(nd.array(g, ctx=CPU).data.to(grad.dtype))


def _run(optimizer, opt_args, fused, steps=6, scaler=None, inf_at=None,
         lr_at=None, multi_precision=False, dtype="float32"):
    os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
    params = _make_params(dtype=dtype)
    args = dict(opt_args)
    if multi_precision:
        args["multi_precision"] = True
    tr = gluon.Trainer(params, optimizer, args)
    if scaler is not None:
        tr._amp_loss_scaler = scaler
    for s in range(steps):
        if lr_at is not None and s == lr_at:
            tr.set_learning_rate(0.01)
        _set_grads(params, s, poison=(inf_at is not None and s == inf_at))
        tr.step(2)
    return [p.data().asnumpy() for p in params], tr


def _bitwise(ws1, ws2):
    return all(a.tobytes() == b.tobytes() for a, b in zip(ws1, ws2))


@pytest.mark.parametrize("opt,args", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.05, "clip_gradient": 0.02}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9}),
    ("signsgd", {"learning_rate": 0.01, "wd": 0.01}),
])
def test_fused_matches_eager_bitwise(opt, args):
    we, _ = _run(opt, args, fused=False)
    wf, _ = _run(opt, args, fused=True)
    assert _bitwise(we, wf)


@pytest.mark.parametrize("opt,args", [
    ("adagrad", {"learning_rate": 0.05, "wd": 0.01}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("adadelta", {}),
    ("ftrl", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01}),
])
def test_fused_matches_eager_ulp(opt, args):
    we, _ = _run(opt, args, fused=False)
    wf, _ = _run(opt, args, fused=True)
    assert all(onp.allclose(a, b, rtol=1e-4, atol=1e-6)
               for a, b in zip(we, wf))


def test_fused_amp_skip_episode_bitwise():
    """An all-inf gradient step is skipped on the device, halves the
    scale and leaves the trajectory bitwise equal to eager."""
    we, tre = _run("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                   fused=False, inf_at=2,
                   scaler=LossScaler(init_scale=2.0 ** 8, scale_window=3))
    wf, trf = _run("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                   fused=True, inf_at=2,
                   scaler=LossScaler(init_scale=2.0 ** 8, scale_window=3))
    assert _bitwise(we, wf)
    assert trf._amp_loss_scaler.loss_scale == \
        tre._amp_loss_scaler.loss_scale
    assert fused_step.fused_step_stats()["skipped_steps"] == 1
    trf._sync_fused_state()
    assert trf._optimizer.num_update == tre._optimizer.num_update


def test_skipped_step_leaves_everything_bitwise():
    """One poisoned step: weights, momenta and the device update count
    unchanged to the bit, the scale halved, the window reset."""
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "adam", {"learning_rate": 0.01})
    tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 10, scale_window=100)
    for s in range(3):
        _set_grads(params, s)
        tr.step(1)
    w0 = [p.data().asnumpy() for p in params]
    s0 = [(m.asnumpy(), v.asnumpy()) for m, v in tr._states]
    t0 = int(tr._fused_state["vals"]["t"].item())
    _set_grads(params, 3, poison=True)
    tr.step(1)
    assert _bitwise(w0, [p.data().asnumpy() for p in params])
    for (m0, v0), (m, v) in zip(s0, tr._states):
        assert m0.tobytes() == m.asnumpy().tobytes()
        assert v0.tobytes() == v.asnumpy().tobytes()
    assert int(tr._fused_state["vals"]["t"].item()) == t0
    assert tr._amp_loss_scaler.loss_scale == 2.0 ** 9
    assert tr._amp_loss_scaler._unskipped == 0


def test_set_learning_rate_no_rebuild():
    """lr is a device scalar: changing it takes effect on the next step
    with the miss counter flat."""
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    _set_grads(params, 0)
    tr.step(1)
    misses = fused_step.fused_step_stats()["misses"]
    w_before = params[0].data().asnumpy().copy()
    tr.set_learning_rate(0.0)  # next step must be a no-op update
    _set_grads(params, 1)
    tr.step(1)
    st = fused_step.fused_step_stats()
    assert st["misses"] == misses
    assert st["hits"] >= 1
    assert onp.array_equal(params[0].data().asnumpy(), w_before)
    tr.set_learning_rate(0.5)
    _set_grads(params, 2)
    tr.step(1)
    assert fused_step.fused_step_stats()["misses"] == misses
    assert not onp.array_equal(params[0].data().asnumpy(), w_before)


def test_lr_scheduler_no_rebuild_and_matches_eager():
    def run(fused):
        os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
        params = _make_params()
        sch = lr_scheduler.FactorScheduler(step=2, factor=0.5)
        tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                           "momentum": 0.9,
                                           "lr_scheduler": sch})
        for s in range(6):
            _set_grads(params, s)
            tr.step(1)
        return [p.data().asnumpy() for p in params]

    we = run(False)
    wf = run(True)
    assert _bitwise(we, wf)
    assert fused_step.fused_step_stats()["misses"] == 1


def test_loss_scale_growth_no_rebuild():
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    tr._amp_loss_scaler = LossScaler(init_scale=4.0, scale_window=2)
    _set_grads(params, 0)
    tr.step(1)
    misses = fused_step.fused_step_stats()["misses"]
    for s in range(1, 4):
        _set_grads(params, s)
        tr.step(1)
    assert tr._amp_loss_scaler.loss_scale == 16.0  # grew twice (window 2)
    assert fused_step.fused_step_stats()["misses"] == misses


def test_external_loss_scale_write_reseeds_in_place():
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 8)
    _set_grads(params, 0)
    tr.step(1)
    cache, scale_t = tr._fused, tr._fused_state["vals"]["scale"]
    tr._amp_loss_scaler.loss_scale = 2.0  # external write
    _set_grads(params, 1)
    tr.step(1)
    assert tr._amp_loss_scaler.loss_scale == 2.0  # device re-seeded
    assert tr._fused is cache and tr._fused_state["vals"]["scale"] is scale_t
    assert fused_step.fused_step_stats()["misses"] == 1


def test_fused_cache_shared_across_trainers():
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr1 = gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    _set_grads(params, 0)
    tr1.step(1)
    misses = fused_step.fused_step_stats()["misses"]
    tr2 = gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    tr2.step(1)  # the same signature: the same step function
    st = fused_step.fused_step_stats()
    assert st["misses"] == misses
    assert st["size"] == 1


def test_cache_is_bounded():
    os.environ["MXNET_FUSED_STEP"] = "1"
    fused_step.reset_fused_step_cache(maxsize=2)
    for n in (2, 3, 4):
        params = _make_params(n=n)
        tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
        _set_grads(params, 0)
        tr.step(1)
    st = fused_step.fused_step_stats()
    assert st["size"] == 2 and st["evictions"] == 1 and st["misses"] == 3


def test_env_fallback_matches_and_bypasses_cache():
    os.environ["MXNET_FUSED_STEP"] = "0"
    _run("sgd", {"learning_rate": 0.05, "momentum": 0.9}, fused=False)
    st = fused_step.fused_step_stats()
    assert st["size"] == 0 and st["misses"] == 0


def test_unsupported_optimizer_bypasses_to_eager():
    """An optimizer whose update is its own (no fused kernel) takes the
    eager loop and counts a bypass."""

    class HalvedSGD(SGD):
        def update(self, index, weight, grad, state):
            super().update(index, weight, grad * 0.5, state)

    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, HalvedSGD(learning_rate=0.01))
    w0 = params[0].data().asnumpy().copy()
    _set_grads(params, 0)
    tr.step(1)
    st = fused_step.fused_step_stats()
    assert st["bypasses"] >= 1 and st["size"] == 0
    assert not onp.array_equal(params[0].data().asnumpy(), w0)


def test_multi_precision_fused_matches_eager():
    """bf16 params with fp32 masters: fused mp update == eager mp."""
    we, tre = _run("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                   fused=False, multi_precision=True, dtype="bfloat16")
    wf, trf = _run("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                   fused=True, multi_precision=True, dtype="bfloat16")
    assert _bitwise(we, wf)
    for s in trf._states:
        assert str(s[0].dtype) == "float32"  # the master


def test_donate_env_is_accepted_and_changes_nothing():
    we, _ = _run("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                 fused=True)
    os.environ["MXNET_FUSED_STEP_DONATE"] = "1"
    assert fused_step.donate_params_enabled()
    wd, _ = _run("sgd", {"learning_rate": 0.05, "momentum": 0.9},
                 fused=True)
    assert _bitwise(we, wd)


def test_save_load_states_roundtrip_before_first_step(tmp_path):
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                       "momentum": 0.9})
    tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 6)
    fname = str(tmp_path / "pre.states")
    tr.save_states(fname)
    tr2 = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                        "momentum": 0.9})
    tr2._amp_loss_scaler = LossScaler()
    tr2.load_states(fname)
    assert tr2._amp_loss_scaler.loss_scale == 2.0 ** 6
    _set_grads(params, 0)
    tr2.step(1)
    assert onp.isfinite(params[0].data().asnumpy()).all()


def test_save_load_states_roundtrip_after_first_step(tmp_path):
    """After fused steps (a skip among them) the device update count and
    scaler state reach the checkpoint; a fresh trainer restores them,
    and a restore into a trainer that already stepped re-seeds in place
    (same step function, same buffers)."""
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                       "momentum": 0.9})
    tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 8, scale_window=3)
    for s in range(4):
        _set_grads(params, s, poison=(s == 1))
        tr.step(1)
    fname = str(tmp_path / "post.states")
    tr.save_states(fname)
    assert tr._optimizer.num_update == 3  # the skipped step not counted
    tr2 = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                        "momentum": 0.9})
    tr2._amp_loss_scaler = LossScaler()
    tr2.load_states(fname)
    assert tr2._optimizer.num_update == 3
    assert tr2._amp_loss_scaler.loss_scale == 2.0 ** 7  # halved once
    for a, b in zip(tr._states, tr2._states):
        assert onp.array_equal(a.asnumpy(), b.asnumpy())
    cache, moms = tr._fused, [s.data for s in tr._states]
    tr.load_states(fname)
    _set_grads(params, 4)
    tr.step(1)
    assert tr._fused is cache
    assert all(a is s.data for a, s in zip(moms, tr._states))
    assert fused_step.fused_step_stats()["misses"] == 1


def test_eager_toggle_mid_training_syncs_state():
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05})
    tr._amp_loss_scaler = LossScaler(init_scale=8.0, scale_window=2)
    for s in range(2):
        _set_grads(params, s)
        tr.step(1)
    os.environ["MXNET_FUSED_STEP"] = "0"
    _set_grads(params, 2)
    tr.step(1)
    # grew once on the device (window 2), then one clean eager step
    assert tr._amp_loss_scaler._unskipped == 1
    assert tr._amp_loss_scaler._loss_scale == 16.0
    os.environ["MXNET_FUSED_STEP"] = "1"
    _set_grads(params, 3)
    tr.step(1)  # re-seeded from the host: grows again at window 2
    assert tr._amp_loss_scaler.loss_scale == 32.0


def test_counters():
    os.environ["MXNET_FUSED_STEP"] = "1"
    assert fused_step.fused_step_enabled()
    os.environ["MXNET_FUSED_STEP"] = "0"
    assert not fused_step.fused_step_enabled()
    ctr = fused_step.fused_step_stats()
    for k in ("hits", "misses", "evictions", "bypasses", "captures",
              "replays", "size", "maxsize", "skipped_steps"):
        assert k in ctr
    # on the CPU the step runs uncaptured
    _run("sgd", {"learning_rate": 0.05}, fused=True, steps=2)
    ctr = fused_step.fused_step_stats()
    assert ctr["captures"] == 0 and ctr["replays"] == 0


def test_grad_req_change_and_cast_rebuild():
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                       "multi_precision": True})
    _set_grads(params, 0)
    tr.step(1)
    assert fused_step.fused_step_stats()["misses"] == 1
    params[1].grad_req = "null"
    w1 = params[1].data().asnumpy().copy()
    _set_grads(params[:1], 1)
    tr.step(1)
    assert fused_step.fused_step_stats()["misses"] == 2
    assert onp.array_equal(params[1].data().asnumpy(), w1)
    params[1].grad_req = "write"
    for p in params:
        p.cast("bfloat16")
    tr._states = None  # new masters for the half weights
    _set_grads(params, 2)
    tr.step(1)
    assert fused_step.fused_step_stats()["misses"] == 3
    assert all(str(p.data().dtype) == "bfloat16" for p in params)


def test_warmup_builds_without_changing_anything():
    os.environ["MXNET_FUSED_STEP"] = "1"
    params = _make_params()
    tr = gluon.Trainer(params, "adam", {"learning_rate": 0.01})
    w0 = [p.data().asnumpy() for p in params]
    assert tr.warmup() == 0
    assert fused_step.fused_step_stats()["misses"] == 1
    assert _bitwise(w0, [p.data().asnumpy() for p in params])
    _set_grads(params, 0)
    tr.step(1)
    st = fused_step.fused_step_stats()
    assert st["misses"] == 1 and st["hits"] >= 1


def test_warmup_with_block_restores_state():
    """warmup(shapes, block) runs forward/backward/step on zeros and
    restores everything: training after it equals training without."""
    def train(warm):
        os.environ["MXNET_FUSED_STEP"] = "1"
        mx.random.seed(3)
        net = nn.HybridSequential()
        net.add(nn.Dense(8, activation="relu"), nn.Dense(2))
        net.initialize(mx.init.Xavier(), ctx=CPU)
        net(nd.zeros((4, 5), ctx=CPU))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
        tr._amp_loss_scaler = LossScaler(init_scale=2.0 ** 4)
        if warm:
            assert tr.warmup(shapes=[(4, 5)], block=net) == 1
        x = nd.array(onp.random.RandomState(0).randn(4, 5).astype("f"),
                     ctx=CPU)
        for _ in range(3):
            with autograd.record():
                loss = net(x).sum()
            loss.backward()
            tr.step(4)
        return [p.data().asnumpy() for p in net.collect_params().values()]

    assert _bitwise(train(False), train(True))


def test_fused_in_training_loop_end_to_end():
    """A whole forward/backward/step loop converges on the fused path and
    matches the eager loop bitwise."""
    def train(fused):
        os.environ["MXNET_FUSED_STEP"] = "1" if fused else "0"
        mx.random.seed(7)
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(2))
        net.initialize(mx.init.Xavier(), ctx=CPU)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
        lf = gluon.loss.SoftmaxCrossEntropyLoss()
        rs = onp.random.RandomState(0)
        X = rs.randn(32, 8).astype("f")
        y = (X.sum(1) > 0).astype("f")
        for _ in range(10):
            with autograd.record():
                loss = lf(net(nd.array(X, ctx=CPU)),
                          nd.array(y, ctx=CPU)).mean()
            loss.backward()
            tr.step(1)
        return [p.data().asnumpy()
                for p in net.collect_params().values()], float(
                    loss.asscalar())

    we, le = train(False)
    wf, lw = train(True)
    assert _bitwise(we, wf)
    assert le == lw


# -- the port's fused step against the JAX package's -------------------------

@pytest.mark.parametrize("opt,args", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
])
def test_port_fused_matches_jax_fused(opt, args):
    os.environ["MXNET_FUSED_STEP"] = "1"
    jfused.reset_fused_step_cache()
    rs = onp.random.RandomState(0)
    shapes = [(4, 4) if i % 2 == 0 else (4,) for i in range(6)]
    init = [rs.randn(*s).astype("f") for s in shapes]
    jparams, tparams = [], []
    for i, (s, w) in enumerate(zip(shapes, init)):
        jp = JParameter(f"p{i}", shape=s)
        jp.initialize()
        jp.set_data(jnd.array(w))
        jparams.append(jp)
        tp = Parameter(f"p{i}", shape=s)
        tp.initialize(ctx=CPU)
        tp.set_data(w)
        tparams.append(tp)
    jtr = jgluon.Trainer(jparams, opt, dict(args))
    ttr = gluon.Trainer(tparams, opt, dict(args))
    for step in range(5):
        gs = _grad_values(tparams, step)
        for jp, tp, g in zip(jparams, tparams, gs):
            jp.grad()._data = jnd.array(g).data
            tp.grad().data.copy_(nd.array(g, ctx=CPU).data)
        jtr.step(2)
        ttr.step(2)
    assert jfused.fused_step_stats()["misses"] == 1
    assert fused_step.fused_step_stats()["misses"] == 1
    for jp, tp in zip(jparams, tparams):
        onp.testing.assert_allclose(tp.data().asnumpy(),
                                    jp.data().asnumpy(), rtol=1e-6,
                                    atol=1e-7)
    jfused.reset_fused_step_cache()
