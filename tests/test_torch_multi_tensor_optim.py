"""The port's optimizer ops, optimizers, Updater and lr schedulers
against the JAX package's, on the same inputs (both on the CPU).

Every op ported into ``mxnet_tpu_torch/ndarray/ops_optim.py`` agrees
with the JAX op within rtol 1e-6, atol 1e-7 on float32 outputs: the
same arithmetic, one float32 rounding apart at most (torch's and XLA's
CPU kernels may contract or order a product differently). A bfloat16
output (the half weight of a multi-precision op) is the cast of the
float32 master, so it may differ by one bfloat16 ulp (2^-8 relative)
where the master sits within that rounding of a boundary. The port's
ops write in place: each test also checks that the outputs are the
input tensors themselves.
"""
import numpy as onp
import pytest

from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, optimizer as opt

CPU = mx.cpu()
RTOL, ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -8


def _f(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, shape).astype("float32")


def _pos(rs, *shape):
    return rs.uniform(0.5, 2.0, shape).astype("float32")


def _bf16(a):
    import ml_dtypes

    return a.astype(ml_dtypes.bfloat16)


def _arrays(spec, rs):
    out = []
    for kind, shape in spec:
        if kind == "f":
            out.append(_f(rs, *shape))
        elif kind == "p":
            out.append(_pos(rs, *shape))
        elif kind == "g":  # a small gradient
            out.append(_f(rs, *shape) * 0.1)
        elif kind == "h":  # a half weight: bf16 of a float
            out.append(_bf16(_f(rs, *shape)))
        elif kind == "hg":
            out.append(_bf16(_f(rs, *shape) * 0.1))
        elif kind == "v":  # a (n,) vector of rates
            out.append(rs.uniform(0.01, 0.1, shape).astype("float32"))
    return out


W = (3, 4)
K = {"rescale_grad": 0.5, "clip_gradient": 0.04}
# op -> (array kinds and shapes, kwargs). Positional scalars ride in the
# kwargs by name.
_OPS = {
    "sgd_update": ([("f", W), ("g", W)], dict(lr=0.1, wd=0.01, **K)),
    "sgd_mom_update": ([("f", W), ("g", W), ("f", W)],
                       dict(lr=0.1, momentum=0.9, wd=0.01, **K)),
    "nag_mom_update": ([("f", W), ("g", W), ("f", W)],
                       dict(lr=0.1, momentum=0.9, wd=0.01, **K)),
    "adam_update": ([("f", W), ("g", W), ("f", W), ("p", W)],
                    dict(lr=0.01, beta1=0.8, beta2=0.95, epsilon=1e-6,
                         wd=0.01, **K)),
    "adamw_update": ([("f", W), ("g", W), ("f", W), ("p", W)],
                     dict(lr=0.01, eta=0.7, beta1=0.8, beta2=0.95,
                          epsilon=1e-6, wd=0.01, **K)),
    "rmsprop_update": ([("f", W), ("g", W), ("p", W)],
                       dict(lr=0.01, gamma1=0.8, epsilon=1e-6, wd=0.01,
                            clip_weights=0.5, **K)),
    "rmspropalex_update": ([("f", W), ("g", W), ("p", W), ("g", W),
                            ("g", W)],
                           dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                epsilon=1e-6, wd=0.01, clip_weights=0.9,
                                **K)),
    "ftrl_update": ([("f", W), ("g", W), ("f", W), ("p", W)],
                    dict(lr=0.1, lamda1=0.05, beta=1.0, wd=0.01, **K)),
    "signsgd_update": ([("f", W), ("g", W)], dict(lr=0.1, wd=0.01, **K)),
    "signum_update": ([("f", W), ("g", W), ("f", W)],
                      dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.02, **K)),
    "mp_sgd_update": ([("h", W), ("hg", W), ("f", W)],
                      dict(lr=0.1, wd=0.01, **K)),
    "mp_sgd_mom_update": ([("h", W), ("hg", W), ("f", W), ("f", W)],
                          dict(lr=0.1, momentum=0.9, wd=0.01, **K)),
    "mp_nag_mom_update": ([("h", W), ("hg", W), ("f", W), ("f", W)],
                          dict(lr=0.1, momentum=0.9, wd=0.01, **K)),
    "all_finite": ([("f", W), ("f", (5,))], {}),
    "multi_all_finite": ([("f", W), ("f", (5,))], {"num_arrays": 2}),
    "multi_sum_sq": ([("f", W), ("f", (5,)), ("f", (2, 2))], {}),
    "multi_sgd_update": ([("f", W), ("g", W), ("f", (5,)), ("g", (5,))],
                         dict(lrs=[0.1, 0.2], wds=[0.01, 0.0],
                              num_weights=2, **K)),
    "multi_sgd_mom_update": ([("f", W), ("g", W), ("f", W),
                              ("f", (5,)), ("g", (5,)), ("f", (5,))],
                             dict(lrs=[0.1, 0.2], wds=[0.01, 0.0],
                                  momentum=0.9, num_weights=2, **K)),
    "multi_mp_sgd_update": ([("h", W), ("hg", W), ("f", W),
                             ("h", (5,)), ("hg", (5,)), ("f", (5,))],
                            dict(lrs=[0.1, 0.2], wds=[0.01, 0.0],
                                 num_weights=2, **K)),
    "multi_mp_sgd_mom_update": ([("h", W), ("hg", W), ("f", W), ("f", W),
                                 ("h", (5,)), ("hg", (5,)), ("f", (5,)),
                                 ("f", (5,))],
                                dict(lrs=[0.1, 0.2], wds=[0.01, 0.0],
                                     momentum=0.9, num_weights=2, **K)),
    "preloaded_multi_sgd_update": ([("f", W), ("g", W), ("f", (5,)),
                                    ("g", (5,)), ("v", (2,)), ("v", (2,))],
                                   dict(num_weights=2, **K)),
    "preloaded_multi_sgd_mom_update": ([("f", W), ("g", W), ("f", W),
                                        ("f", (5,)), ("g", (5,)),
                                        ("f", (5,)), ("v", (2,)),
                                        ("v", (2,))],
                                       dict(momentum=0.9, num_weights=2,
                                            **K)),
    "preloaded_multi_mp_sgd_update": ([("h", W), ("hg", W), ("f", W),
                                       ("h", (5,)), ("hg", (5,)),
                                       ("f", (5,)), ("v", (2,)),
                                       ("v", (2,))],
                                      dict(num_weights=2, **K)),
    "preloaded_multi_mp_sgd_mom_update": ([("h", W), ("hg", W), ("f", W),
                                           ("f", W), ("h", (5,)),
                                           ("hg", (5,)), ("f", (5,)),
                                           ("f", (5,)), ("v", (2,)),
                                           ("v", (2,))],
                                          dict(momentum=0.9, num_weights=2,
                                               **K)),
    "mp_adamw_update": ([("h", W), ("hg", W), ("f", W), ("p", W), ("f", W),
                         ("v", (1,))],
                        dict(lr=0.01, eta=0.7, beta1=0.8, beta2=0.95,
                             epsilon=1e-6, wd=0.01, clip_gradient=0.04)),
    "multi_adamw_update": ([("f", W), ("g", W), ("f", W), ("p", W),
                            ("f", (5,)), ("g", (5,)), ("f", (5,)),
                            ("p", (5,)), ("v", (1,))],
                           dict(lrs=[0.01, 0.02], wds=[0.01, 0.0],
                                etas=[0.7, 1.0], beta1=0.8, beta2=0.95,
                                epsilon=1e-6, num_weights=2,
                                clip_gradient=0.04)),
    "multi_mp_adamw_update": ([("h", W), ("hg", W), ("f", W), ("p", W),
                               ("f", W), ("h", (5,)), ("hg", (5,)),
                               ("f", (5,)), ("p", (5,)), ("f", (5,)),
                               ("v", (1,))],
                              dict(lrs=[0.01, 0.02], wds=[0.01, 0.0],
                                   etas=[0.7, 1.0], beta1=0.8, beta2=0.95,
                                   epsilon=1e-6, num_weights=2,
                                   clip_gradient=0.04)),
}


def _close(got, want):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype)
    if str(want.dtype) == "bfloat16":
        onp.testing.assert_allclose(got.astype("float32"),
                                    want.astype("float32"),
                                    rtol=BF16_RTOL, atol=0)
    else:
        onp.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(_OPS))
def test_optimizer_op_matches_jax(name):
    spec, kwargs = _OPS[name]
    arrays = _arrays(spec, onp.random.RandomState(7))
    jout = getattr(jnd, name)(*[jnd.array(a) for a in arrays], **kwargs)
    targs = [nd.array(a, ctx=CPU) for a in arrays]
    tout = getattr(nd, name)(*targs, **kwargs)
    jouts = jout if isinstance(jout, (list, tuple)) else [jout]
    touts = tout if isinstance(tout, (list, tuple)) else [tout]
    assert len(touts) == len(jouts)
    for t, j in zip(touts, jouts):
        _close(t.asnumpy(), j.asnumpy())
    if name.endswith("update"):
        # in place: each output is one of the inputs' own tensors
        ptrs = {a.data.data_ptr() for a in targs}
        assert all(t.data.data_ptr() in ptrs for t in touts)


def test_all_finite_sees_inf_and_nan():
    for bad in (onp.inf, -onp.inf, onp.nan):
        a = onp.ones((3,), "float32")
        a[1] = bad
        ok = nd.all_finite(nd.array(a, ctx=CPU), nd.ones((2,), ctx=CPU))
        assert ok.asnumpy().tolist() == [0.0]
        assert jnd.all_finite(jnd.array(a)).asnumpy().tolist() == [0.0]


# -- optimizers: one update per class, port against JAX ----------------------

_OPTS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "clip_gradient": 0.05}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("adagrad", {"learning_rate": 0.05, "wd": 0.01}),
    ("adagrad", {"learning_rate": 0.05, "clip_gradient": 0.03}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("adadelta", {"wd": 0.01}),
    ("ftrl", {"learning_rate": 0.1}),
    ("signsgd", {"learning_rate": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9, "wd_lh": 0.01}),
]


def _leaves(s):
    if s is None:
        return []
    if isinstance(s, tuple):
        return [x for i in s for x in _leaves(i)]
    return [s]


def _state_np(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_np(x) for x in s)
    return s.asnumpy()


@pytest.mark.parametrize("name,kwargs", _OPTS)
def test_optimizer_class_matches_jax(name, kwargs):
    """Three updates of one weight through each optimizer class (AdaGrad
    and AdaDelta's arithmetic lives in the class, as in the JAX
    package)."""
    rs = onp.random.RandomState(11)
    w0 = _f(rs, *W)
    grads = [_f(rs, *W) * 0.1 for _ in range(3)]
    jo, to = jopt.create(name, **kwargs), opt.create(name, **kwargs)
    jw, tw = jnd.array(w0), nd.array(w0, ctx=CPU)
    js, ts = jo.create_state(0, jw), to.create_state(0, tw)
    for g in grads:
        jo.update(0, jw, jnd.array(g), js)
        to.update(0, tw, nd.array(g, ctx=CPU), ts)
    _close(tw.asnumpy(), jw.asnumpy())
    tl, jl = _leaves(_state_np(ts)), _leaves(_state_np(js))
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        _close(a, b)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("multi_precision", [False, True])
def test_updater_aggregates_through_update_multi(momentum, multi_precision):
    """A list of indices through the Updater takes SGD's multi-tensor
    path (chunks of ``aggregate_num``), which equals the per-index loop
    bitwise and the JAX package's aggregated update within tolerance;
    half weights keep float32 masters in the Updater's states."""
    rs = onp.random.RandomState(13)
    shapes = [(3, 4), (4,), (2, 2), (5,), (3,)]
    kw = {"learning_rate": 0.1, "momentum": momentum, "wd": 0.01,
          "multi_precision": multi_precision}
    ws = [_f(rs, *s) for s in shapes]
    gs = [_f(rs, *s) * 0.1 for s in shapes]
    dt = "bfloat16" if multi_precision else "float32"

    def port(aggregate):
        u = opt.get_updater(opt.create("sgd", **kw))
        u.aggregate_updates = aggregate
        tws = [nd.array(w, ctx=CPU).astype(dt) for w in ws]
        tgs = [nd.array(g, ctx=CPU).astype(dt) for g in gs]
        for _ in range(2):
            u(list(range(len(ws))), tgs, tws)
        return [w.asnumpy() for w in tws], u

    agg, u = port(True)
    loop, _ = port(False)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(agg, loop))
    if multi_precision:
        assert all(str(s[0].dtype) == "float32" for s in u.states.values())
    ju = jopt.get_updater(jopt.create("sgd", **kw))
    jws = [jnd.array(w).astype(dt) for w in ws]
    jgs = [jnd.array(g).astype(dt) for g in gs]
    for _ in range(2):
        ju(list(range(len(ws))), jgs, jws)
    for a, j in zip(agg, jws):
        _close(a, j.asnumpy())


def test_updater_states_round_trip():
    u = opt.get_updater(opt.create("adam", learning_rate=0.01))
    w = nd.array(onp.ones((3,), "f"), ctx=CPU)
    u(0, nd.array(onp.full((3,), 0.5, "f"), ctx=CPU), w)
    blob = u.get_states()
    u2 = opt.get_updater(opt.create("adam", learning_rate=0.01))
    with CPU:
        u2.set_states(blob)
    for a, b in zip(u.states[0], u2.states[0]):
        assert onp.array_equal(a.asnumpy(), b.asnumpy())


# -- lr schedulers -----------------------------------------------------------

_SCHEDULES = [
    ("FactorScheduler", dict(step=5, factor=0.5, base_lr=0.1)),
    ("FactorScheduler", dict(step=3, factor=0.9, base_lr=0.2,
                             warmup_steps=4, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[3, 8, 20], factor=0.5,
                                  base_lr=0.1)),
    ("PolyScheduler", dict(max_update=30, base_lr=0.1, pwr=2,
                           final_lr=0.001, warmup_steps=5)),
    ("CosineScheduler", dict(max_update=30, base_lr=0.1, final_lr=0.0,
                             warmup_steps=5, warmup_mode="constant")),
]


@pytest.mark.parametrize("name,kwargs", _SCHEDULES)
def test_lr_scheduler_matches_jax(name, kwargs):
    from mxnet_tpu.optimizer import lr_scheduler as jls
    from mxnet_tpu_torch.optimizer import lr_scheduler as tls

    js, ts = getattr(jls, name)(**kwargs), getattr(tls, name)(**kwargs)
    assert [ts(n) for n in range(40)] == [js(n) for n in range(40)]


def test_optimizer_reads_its_scheduler():
    from mxnet_tpu_torch.optimizer import lr_scheduler

    sch = lr_scheduler.FactorScheduler(step=2, factor=0.5)
    o = opt.create("sgd", learning_rate=0.4, lr_scheduler=sch)
    assert o.learning_rate == 0.4
    o.num_update = 5
    assert o.learning_rate == 0.1
    with pytest.raises(UserWarning):
        o.set_learning_rate(0.1)
