"""The Gluon Fit API of the PyTorch port against the JAX package's, on the
CPU (``mxnet_tpu_torch/gluon/contrib/estimator`` against
``mxnet_tpu/gluon/contrib/estimator``): twins of
``tests/test_aux.py::test_estimator_fit`` and
``::test_estimator_early_stopping`` and of the handler tests of
``tests/test_estimator_handlers.py``.

Each net is built and initialized by the port from a seed, with an
explicit ``prefix=``, and its weights are carried into the JAX net by
structural name; both see the same batches (``NDArrayIter`` without
shuffling, data from a numpy seed). After ``fit`` the parameters and
the metrics agree within 1e-5, the handlers fire the same events in the
same order, the log lines are the same (times aside; their numbers
within 1e-5) and the checkpoints have the same file names.
"""
import logging
import os
import re

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.contrib import estimator as jest
from mxnet_tpu.gluon.contrib.estimator import event_handler as jeh

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.gluon.contrib import estimator as test_
from mxnet_tpu_torch.gluon.contrib.estimator import event_handler as teh

CPU = mx.cpu()
TOL = 1e-5


def _host(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _twins(make, in_shape):
    """``make(gluon)`` in each package; the port's initialized weights
    carried into the JAX net."""
    mx.random.seed(0)
    tnet = make(gluon)
    tnet.initialize(mx.init.Xavier(), ctx=CPU)
    tnet(nd.zeros(in_shape, ctx=CPU))
    jnet = make(jgluon)
    jp = jnet._collect_params_with_prefix()
    tp = _host(tnet)
    assert sorted(jp) == sorted(tp)
    for k, v in tp.items():
        jp[k]._load_init_from(jnd.array(v))
    return tnet, jnet


def _tracker(eh):
    """A handler of package ``eh`` that records every event it sees."""
    events = []

    class Tracker(eh.TrainBegin, eh.TrainEnd, eh.EpochBegin, eh.EpochEnd,
                  eh.BatchBegin, eh.BatchEnd):
        def train_begin(self, estimator, *args, **kwargs):
            events.append("train_begin")

        def train_end(self, estimator, *args, **kwargs):
            events.append("train_end")

        def epoch_begin(self, estimator, *args, **kwargs):
            events.append("epoch_begin")

        def epoch_end(self, estimator, *args, **kwargs):
            events.append("epoch_end")

        def batch_begin(self, estimator, *args, **kwargs):
            events.append("batch_begin")

        def batch_end(self, estimator, *args, **kwargs):
            events.append("batch_end:" + ",".join(sorted(kwargs)))

    return Tracker(), events


_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")
_TIME = re.compile(r"in \d+\.\d+s")


def _lines(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger]


def _same_lines(got, want):
    """The same log lines, times aside, their numbers within TOL."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        g, w = _TIME.sub("in Ts", g), _TIME.sub("in Ts", w)
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        gn = [float(v) for v in _NUM.findall(g)]
        wn = [float(v) for v in _NUM.findall(w)]
        onp.testing.assert_allclose(gn, wn, rtol=TOL, atol=TOL)


def _mlp(g):
    net = g.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(g.nn.Dense(16, activation="relu"), g.nn.Dense(2))
    return net


def test_estimator_fit_equals_jax(tmp_path, caplog):
    """Twin of test_estimator_fit, with validation data, a batch-level
    LoggingHandler and a save-best CheckpointHandler."""
    rs = onp.random.RandomState(0)
    X = rs.randn(64, 8).astype("float32")
    y = (X.sum(1) > 0).astype("float32")
    Xv = rs.randn(32, 8).astype("float32")
    yv = (Xv.sum(1) > 0).astype("float32")
    tnet, jnet = _twins(_mlp, (1, 8))
    runs = {}
    for tag, pkg, net, est_mod, eh, logger in (
            ("t", mx, tnet, test_, teh, "mxnet_tpu_torch.estimator"),
            ("j", jmx, jnet, jest, jeh, "mxnet_tpu.estimator")):
        train = pkg.io.NDArrayIter(X, y, batch_size=16)
        val = pkg.io.NDArrayIter(Xv, yv, batch_size=16)
        trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 5e-3})
        est = est_mod.Estimator(
            net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
            metrics=[pkg.metric.Accuracy()], trainer=trainer)
        ckdir = tmp_path / tag
        ckpt = eh.CheckpointHandler(str(ckdir), model_prefix="fit",
                                    monitor=est.train_metrics[0],
                                    save_best=True, max_checkpoints=2)
        log = eh.LoggingHandler(log_interval=2, metrics=est.train_metrics)
        tracker, events = _tracker(eh)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger):
            est.fit(train, val_data=val, epochs=4,
                    event_handlers=[ckpt, log, tracker])
        runs[tag] = dict(
            events=events, lines=_lines(caplog, logger),
            files=sorted(os.listdir(ckdir)),
            train=[m.get() for m in est.train_metrics],
            val=[m.get() for m in est.val_metrics],
            params=_host(net))
    t, j = runs["t"], runs["j"]
    assert t["events"] == j["events"]
    assert t["events"].count("batch_end:label,loss,pred") == 16
    assert t["files"] == j["files"] == ["fit-best.params",
                                        "fit-epoch3.params",
                                        "fit-epoch4.params"]
    _same_lines(t["lines"], j["lines"])
    assert any("batch 2" in line for line in t["lines"])
    for (tn, tv), (jn, jv) in zip(t["train"] + t["val"],
                                  j["train"] + j["val"]):
        assert tn == jn
        onp.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    assert [n for n, _ in t["val"]] == ["accuracy", "val_loss"]
    # it learns: the last epoch's accuracy above the first's
    accs = [float(re.search(r"accuracy=(\S+),", line).group(1))
            for line in t["lines"] if line.startswith("Epoch") and
            "finished" in line]
    assert len(accs) == 4 and accs[-1] > accs[0], accs
    assert sorted(t["params"]) == sorted(j["params"])
    for k in t["params"]:
        onp.testing.assert_allclose(t["params"][k], j["params"][k],
                                    rtol=TOL, atol=TOL, err_msg=k)
    # the best checkpoint loads back in the other package
    back = _mlp(jgluon)
    back.load_parameters(str(tmp_path / "t" / "fit-best.params"))
    assert sorted(_host(back)) == sorted(t["params"])


def test_estimator_early_stopping_equals_jax():
    """Twin of test_estimator_early_stopping: constant data keeps the
    accuracy flat, so both stop after the same epoch."""
    def make(g):
        return g.nn.Dense(2, prefix="lin_")

    tnet, jnet = _twins(make, (1, 4))
    X = onp.zeros((32, 4), "float32")
    y = onp.zeros(32, "float32")
    seen = {}
    for tag, pkg, net, est_mod, eh in (("t", mx, tnet, test_, teh),
                                       ("j", jmx, jnet, jest, jeh)):
        train = pkg.io.NDArrayIter(X, y, batch_size=8)
        est = est_mod.Estimator(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(),
                                metrics=[pkg.metric.Accuracy()])
        stop = eh.EarlyStoppingHandler(est.train_metrics[0], patience=1)
        tracker, events = _tracker(eh)
        est.fit(train, epochs=50, event_handlers=[stop, tracker])
        assert stop.stop_training
        seen[tag] = (events, stop.best, stop.wait, _host(net))
    assert seen["t"][0] == seen["j"][0]
    assert seen["t"][0].count("epoch_end") < 50
    assert seen["t"][1:3] == pytest.approx(seen["j"][1:3], abs=TOL)
    for k, v in seen["t"][3].items():
        onp.testing.assert_allclose(v, seen["j"][3][k], rtol=TOL, atol=TOL)


def test_batches_limit_and_default_handlers_equal_jax(caplog):
    """``fit(batches=N)`` stops mid-epoch; without handlers the estimator
    adds its own (stopping, metric, logging) in the JAX order, and
    DataLoader batches (data, label) unpack as DataBatch ones do."""
    def make(g):
        return g.nn.Dense(2, in_units=8, prefix="lin_")

    tnet, jnet = _twins(make, (1, 8))
    rs = onp.random.RandomState(1)
    X = rs.rand(40, 8).astype("float32")
    y = rs.randint(0, 2, 40).astype("float32")
    got = {}
    for tag, pkg, net, est_mod, eh, logger in (
            ("t", mx, tnet, test_, teh, "mxnet_tpu_torch.estimator"),
            ("j", jmx, jnet, jest, jeh, "mxnet_tpu.estimator")):
        kw = {"ctx": CPU} if pkg is mx else {}
        loader = pkg.gluon.data.DataLoader(pkg.gluon.data.ArrayDataset(
            pkg.nd.array(X, **kw), pkg.nd.array(y, **kw)), batch_size=8)
        est = est_mod.Estimator(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss())
        tracker, events = _tracker(eh)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger):
            est.fit(loader, batches=7, event_handlers=[tracker])
        got[tag] = (events, _lines(caplog, logger),
                    [m.get() for m in est.train_metrics], _host(net))
    assert got["t"][0] == got["j"][0]
    assert got["t"][0].count("batch_end:label,loss,pred") == 7
    _same_lines(got["t"][1], got["j"][1])
    for (tn, tv), (jn, jv) in zip(got["t"][2], got["j"][2]):
        assert tn == jn
        onp.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    for k, v in got["t"][3].items():
        onp.testing.assert_allclose(v, got["j"][3][k], rtol=TOL, atol=TOL)


def test_checkpoint_rotation_names_equal_jax(tmp_path):
    """CheckpointHandler's rotation (max_checkpoints) and epoch_period
    keep the same files as the JAX handler, and every file the port
    wrote loads into the JAX net (twin of
    test_checkpoint_handler_rotation_and_best)."""
    def make(g):
        return g.nn.Dense(2, in_units=8, prefix="lin_")

    tnet, jnet = _twins(make, (1, 8))
    rs = onp.random.RandomState(2)
    X = rs.rand(32, 8).astype("float32")
    y = rs.randint(0, 2, 32).astype("float32")
    for tag, pkg, net, est_mod, eh in (("t", mx, tnet, test_, teh),
                                       ("j", jmx, jnet, jest, jeh)):
        est = est_mod.Estimator(net, pkg.gluon.loss.SoftmaxCrossEntropyLoss())
        ck = eh.CheckpointHandler(str(tmp_path / tag), model_prefix="m",
                                  monitor=est.train_metrics[-1],
                                  save_best=True, epoch_period=2,
                                  max_checkpoints=2)
        est.fit(pkg.io.NDArrayIter(X, y, batch_size=8), epochs=7,
                event_handlers=[ck])
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == ["m-best.params", "m-epoch4.params", "m-epoch6.params"]
    for name in names:
        back = jgluon.nn.Dense(2, in_units=8, prefix="lin_")
        back.load_parameters(str(tmp_path / "t" / name))
        want = jgluon.nn.Dense(2, in_units=8, prefix="lin_")
        want.load_parameters(str(tmp_path / "j" / name))
        for k, v in _host(want).items():
            onp.testing.assert_allclose(_host(back)[k], v, rtol=TOL,
                                        atol=TOL, err_msg=name)
