"""Metrics, callbacks and initializers: the port against the JAX package.

Every metric of ``metric.py`` gets the same numpy-seeded labels and
predictions (as host arrays and as the port's NDArrays) in both packages
and must give the same name and value within 1e-6 (numpy on the host in
both). The callbacks fire on the same batches and write what the JAX
ones write (logged lines, checkpoint files the other package loads).
The initializers that draw nothing (``Constant``, ``One``, ``Zero``,
``Bilinear``, ``LSTMBias``, ``Mixed``'s dispatch, the suffix rules) fill
exactly what the JAX ones fill; the random ones are held to their
distributions, since torch's Philox and JAX's threefry never agree.
"""
import json
import logging
import math

import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd

CPU = mx.cpu()
rs = onp.random.RandomState(0)
_PROBS = rs.dirichlet(onp.ones(5), size=12).astype("f")
_LABELS = rs.randint(0, 5, 12).astype("f")
_BIN = rs.dirichlet(onp.ones(2), size=12).astype("f")
_BIN_LABELS = rs.randint(0, 2, 12).astype("f")
_REG = rs.randn(12, 1).astype("f")
_REG_LABELS = rs.randn(12).astype("f")

# metric name or instance factory -> (labels, predictions)
_CASES = {
    "acc": ([_LABELS], [_PROBS]),
    "accuracy": ([_LABELS], [_PROBS]),
    "top_k_accuracy": ([_LABELS], [_PROBS]),
    "f1": ([_BIN_LABELS], [_BIN]),
    "mcc": ([_BIN_LABELS], [_BIN]),
    "perplexity": ([_LABELS], [_PROBS]),
    "mae": ([_REG_LABELS], [_REG]),
    "mse": ([_REG_LABELS], [_REG]),
    "rmse": ([_REG_LABELS], [_REG]),
    "ce": ([_LABELS], [_PROBS]),
    "nll_loss": ([_LABELS], [_PROBS]),
    "pearsonr": ([_REG_LABELS], [_REG]),
    "loss": ([_LABELS], [_PROBS]),
    "torch": ([_LABELS], [_PROBS]),
    "caffe": ([_LABELS], [_PROBS]),
}


def _metrics(pkg, name):
    if name == "top_k_accuracy":
        return pkg.metric.create(name, top_k=3)
    if name == "perplexity":
        return pkg.metric.Perplexity(ignore_label=2)
    return pkg.metric.create(name)


def _same(jm, tm):
    jn, jv = jm.get()
    tn, tv = tm.get()
    assert tn == jn
    onp.testing.assert_allclose(onp.asarray(tv, "f8"), onp.asarray(jv, "f8"),
                                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_metric_matches_jax(name):
    labels, preds = _CASES[name]
    jm, tm = _metrics(jmx, name), _metrics(mx, name)
    for _ in range(2):  # two batches: the running sums
        jm.update([jmx.nd.array(a) for a in labels],
                  [jmx.nd.array(a) for a in preds])
        tm.update([nd.array(a, ctx=CPU) for a in labels],
                  [nd.array(a, ctx=CPU) for a in preds])
    _same(jm, tm)
    assert tm.get_name_value() == [tuple(x) for x in tm.get_name_value()]
    tm.reset()
    assert math.isnan(tm.get()[1]) or name in ("f1", "mcc")


def test_composite_custom_and_np_metrics_match_jax():
    def feval(label, pred):
        return float(onp.abs(label - pred.argmax(1)).sum()), len(label)

    pairs = [
        (jmx.metric.create(["acc", "ce"]), mx.metric.create(["acc", "ce"])),
        (jmx.metric.create(feval), mx.metric.create(feval)),
        (jmx.metric.np(lambda l, p: float((p.argmax(1) == l).mean()),
                       name="mine"),
         mx.metric.np(lambda l, p: float((p.argmax(1) == l).mean()),
                      name="mine")),
    ]
    for jm, tm in pairs:
        jm.update([jmx.nd.array(_LABELS)], [jmx.nd.array(_PROBS)])
        tm.update([nd.array(_LABELS, ctx=CPU)], [nd.array(_PROBS, ctx=CPU)])
        _same(jm, tm)
    comp = pairs[0][1]
    assert comp.get_metric(1).name == "cross-entropy"
    assert [type(m).__name__ for m in comp.metrics] == ["Accuracy",
                                                       "CrossEntropy"]


def test_update_dict_registry_and_shape_checks():
    tm = mx.metric.Accuracy(output_names=["b"], label_names=["l"])
    jm = jmx.metric.Accuracy(output_names=["b"], label_names=["l"])
    for m, ndm, kw in ((jm, jmx.nd, {}), (tm, nd, {"ctx": CPU})):
        m.update_dict({"l": ndm.array(_LABELS, **kw)},
                      {"a": ndm.array(_PROBS[::-1].copy(), **kw),
                       "b": ndm.array(_PROBS, **kw)})
    _same(jm, tm)
    assert tm.get_config() == jm.get_config()

    @mx.metric.register
    class Twice(mx.metric.Loss):
        pass

    assert isinstance(mx.metric.create("twice"), Twice)
    with pytest.raises(ValueError, match="not registered"):
        mx.metric.create("no_such_metric")
    with pytest.raises(ValueError, match="does not match"):
        mx.metric.Accuracy().update([nd.array(_LABELS, ctx=CPU)] * 2,
                                    [nd.array(_PROBS, ctx=CPU)])


class _Param:
    def __init__(self, epoch, nbatch, metric):
        self.epoch, self.nbatch, self.eval_metric = epoch, nbatch, metric
        self.locals = {}


def _log_lines(caplog, fire):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        fire()
    return [r.getMessage() for r in caplog.records]


def test_batch_callbacks_log_like_jax(caplog, monkeypatch):
    import time as _time

    clock = iter(range(1000))
    monkeypatch.setattr(_time, "perf_counter", lambda: float(next(clock)))
    for factory in (lambda cb: cb.Speedometer(8, frequent=2),
                    lambda cb: cb.log_train_metric(2, auto_reset=True),
                    lambda cb: cb.ProgressBar(4, length=10),
                    lambda cb: cb.LogValidationMetricsCallback()):
        logs = []
        for pkg in (jmx, mx):
            cb = factory(pkg.callback)
            metric = pkg.metric.create("acc")
            metric.update([pkg.nd.array(_LABELS)] if pkg is jmx else
                          [nd.array(_LABELS, ctx=CPU)],
                          [pkg.nd.array(_PROBS)] if pkg is jmx else
                          [nd.array(_PROBS, ctx=CPU)])

            def fire(cb=cb, metric=metric):
                for i in range(5):
                    cb(_Param(0, i, metric))

            logs.append(_log_lines(caplog, fire))
        assert logs[1] == logs[0] and logs[0]


def test_checkpoint_callbacks_write_what_the_other_package_loads(tmp_path):
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                name="fc")
    args = {"fc_weight": nd.array(onp.eye(3, 4, dtype="f"), ctx=CPU),
            "fc_bias": nd.zeros((3,), ctx=CPU)}
    prefix = str(tmp_path / "ck")
    cb = mx.callback.do_checkpoint(prefix, period=2)
    for epoch in range(4):
        cb(epoch, sym, args, {})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ck-0002.params", "ck-0004.params", "ck-symbol.json"]
    s, ja, jx = jmx.model.load_checkpoint(prefix, 4)
    assert s.list_arguments() == ["data", "fc_weight", "fc_bias"]
    onp.testing.assert_array_equal(ja["fc_weight"].asnumpy(),
                                   onp.eye(3, 4, dtype="f"))

    class _Mod:
        saved = []

        def save_checkpoint(self, prefix, epoch, states):
            self.saved.append((prefix, epoch, states))

    m = _Mod()
    mcb = mx.callback.module_checkpoint(m, "p", period=3,
                                        save_optimizer_states=True)
    for epoch in range(6):
        mcb(epoch)
    assert m.saved == [("p", 3, True), ("p", 6, True)]


# -- initializers ------------------------------------------------------------


def _fill(pkg, init, name, shape):
    if pkg is mx:
        arr = nd.zeros(shape, ctx=CPU)
    else:
        arr = jmx.nd.zeros(shape)
    init(pkg.init.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("make,name,shape", [
    (lambda p: p.init.Constant(0.3), "w_weight", (3, 4)),
    (lambda p: p.init.One(), "w_weight", (3,)),
    (lambda p: p.init.Zero(), "w_weight", (3,)),
    (lambda p: p.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
    (lambda p: p.init.Bilinear(), "up_weight", (1, 1, 3, 5)),
    (lambda p: p.init.LSTMBias(forget_bias=2.0), "lstm_h2h_bias", (8,)),
    (lambda p: p.init.Uniform(), "bn_gamma", (4,)),
    (lambda p: p.init.Uniform(), "bn_beta", (4,)),
    (lambda p: p.init.Uniform(), "bn_moving_mean", (4,)),
    (lambda p: p.init.Uniform(), "bn_moving_var", (4,)),
    (lambda p: p.init.Uniform(), "fc_bias", (4,)),
    (lambda p: p.init.Uniform(), "q_min", (1,)),
    (lambda p: p.init.Mixed([".*bias", ".*"],
                            [p.init.Constant(2.0), p.init.One()]),
     "fc_bias", (3,)),
    (lambda p: p.init.Mixed([".*bias", ".*"],
                            [p.init.Constant(2.0), p.init.One()]),
     "fc_weight", (2, 3)),
])
def test_deterministic_initializers_match_jax(make, name, shape):
    onp.testing.assert_array_equal(_fill(mx, make(mx), name, shape),
                                   _fill(jmx, make(jmx), name, shape))


def test_init_desc_attribute_and_create():
    desc = mx.init.InitDesc("x_weight", attrs={"__init__": "one"})
    arr = nd.zeros((2, 2), ctx=CPU)
    mx.init.Uniform()(desc, arr)
    onp.testing.assert_array_equal(arr.asnumpy(), onp.ones((2, 2)))
    for name in ("uniform", "normal", "xavier", "msraprelu", "orthogonal",
                 "zeros", "ones", "lstmbias"):
        assert isinstance(mx.init.create(name), mx.init.Initializer)
    x = mx.init.Xavier(rnd_type="gaussian", magnitude=2)
    assert json.loads(x.dumps()) == ["xavier", {
        "rnd_type": "gaussian", "factor_type": "avg", "magnitude": 2}]
    assert isinstance(mx.init.create(x.dumps()), mx.init.Xavier)
    assert json.loads(mx.init.MSRAPrelu().dumps()) == json.loads(
        jmx.init.MSRAPrelu().dumps())
    with pytest.raises(ValueError, match="did not match"):
        mx.init.Mixed(["a.*"], ["one"])("b_weight", nd.zeros((1,), ctx=CPU))


def test_random_initializers_follow_their_distributions():
    mx.random.seed(1)
    w = _fill(mx, mx.init.Normal(0.5), "w_weight", (400, 500))
    assert abs(w.std() - 0.5) < 0.01 and abs(w.mean()) < 0.01
    w = _fill(mx, mx.init.MSRAPrelu(slope=0.0), "w_weight", (300, 200))
    assert abs(w.std() - math.sqrt(2.0 / 250)) < 0.003
    w = _fill(mx, mx.init.Orthogonal(scale=1.0), "w_weight", (6, 3, 2))
    m = w.reshape(6, 6)
    onp.testing.assert_allclose(m @ m.T, onp.eye(6), atol=1e-5)
    w = _fill(mx, mx.init.Orthogonal(scale=2.0, rand_type="normal"),
              "w_weight", (4, 9))
    onp.testing.assert_allclose(w @ w.T, 4 * onp.eye(4), atol=1e-4)
