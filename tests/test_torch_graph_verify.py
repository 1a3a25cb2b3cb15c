"""The port's graph verifier against the JAX package's: the traces and
graphs of ``tests/test_graph_verify.py``, run through both packages,
give the same diagnostic codes wherever both can have the hazard.

The hazards both packages have: shape and dtype mismatches at bind
(GV101, GV102), a write into an array a live autograd record saved
(GV201: in the JAX package its donated buffer is deleted, in the port
the tensor is written in place), a write through two slots (GV202),
a random stream drawn twice (GV301), dead values (GV401), duplicate
names (GV403), and a clean shape cross-check (GV103: ``jax.eval_shape``
there, torch's ``meta`` device here). The one the port cannot have: a
read through an alias after an in-place write (the JAX package's
use-after-donate in a trace): torch deletes no buffer, so the alias
reads the written values, as MXNet's arrays do (a deliberate
difference, pinned below).
"""
import logging

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import analysis as janalysis
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu import sym as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import analysis, autograd, gluon, nd, sym
from mxnet_tpu_torch.analysis import GraphVerifyError

CPU = mx.cpu()


@pytest.fixture
def verify_error(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPH_VERIFY", "error")


class _Pkg:
    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.mx, self.nd, self.sym = jmx, jnd, jsym
            self.autograd, self.gluon, self.analysis = \
                jautograd, jgluon, janalysis
        else:
            self.mx, self.nd, self.sym = mx, nd, sym
            self.autograd, self.gluon, self.analysis = \
                autograd, gluon, analysis

    def array(self, a):
        a = onp.asarray(a, "f")
        return self.nd.array(a) if self.name == "jax" else \
            self.nd.array(a, ctx=CPU)

    def ones(self, shape):
        return self.array(onp.ones(shape, "f"))

    def zeros(self, shape):
        return self.array(onp.zeros(shape, "f"))

    def init(self, net):
        if self.name == "jax":
            net.initialize()
        else:
            net.initialize(ctx=CPU)


PKGS = [_Pkg("jax"), _Pkg("port")]


def _codes(fn):
    """The codes of the report ``fn`` returns or raises."""
    try:
        rep = fn()
    except (GraphVerifyError, janalysis.GraphVerifyError) as e:
        rep = e.report
    return [] if rep is None else sorted(rep.codes())


# -- symbol graphs -------------------------------------------------------------

def _shape_mismatch(p):
    data = p.sym.var("data")
    w = p.sym.var("w_gv", shape=(10, 5))
    net = p.sym.FullyConnected(data, weight=w, num_hidden=8, name="fc_gv")
    return p.analysis.verify_symbol(net, shapes={"data": (4, 5)})


def _dtype_mismatch(p):
    data = p.sym.var("data", dtype="float16")
    net = p.sym.relu(data, name="dt_gv")
    return p.analysis.verify_symbol(net, shapes={"data": (2, 2)},
                                    dtypes={"data": "float32"})


def _dead_outputs(p):
    parts = p.sym.split(p.sym.var("data"), num_outputs=3, name="sp")
    return p.analysis.verify_symbol(p.sym.relu(parts[0], name="keep"),
                                    shapes={"data": (6, 6)})


def _consumed_outputs(p):
    parts = p.sym.split(p.sym.var("data"), num_outputs=2, name="sp2")
    return p.analysis.verify_symbol(parts[0] + parts[1],
                                    shapes={"data": (6, 6)})


def _duplicate_names(p):
    a = p.sym.relu(p.sym.var("data"), name="dup")
    b = p.sym.sigmoid(p.sym.var("data"), name="dup")
    return p.analysis.verify_symbol(a + b, shapes={"data": (2, 2)})


def _clean_mlp(p):
    h = p.sym.FullyConnected(p.sym.var("data"), num_hidden=8, name="l1")
    h = p.sym.Activation(h, act_type="relu", name="a1")
    out = p.sym.FullyConnected(h, num_hidden=3, name="l2")
    return p.analysis.verify_symbol(out, shapes={"data": (4, 6)})


SYMBOL_CASES = {"shape_mismatch": (_shape_mismatch, ["GV101"]),
                "dtype_mismatch": (_dtype_mismatch, ["GV102"]),
                "dead_outputs": (_dead_outputs, ["GV401"]),
                "consumed_outputs": (_consumed_outputs, []),
                "duplicate_names": (_duplicate_names, ["GV403"]),
                "clean_mlp_eval_shape": (_clean_mlp, [])}


@pytest.mark.parametrize("case", sorted(SYMBOL_CASES))
def test_symbol_verification_codes_equal_jax(verify_error, case):
    fn, want = SYMBOL_CASES[case]
    got = {p.name: _codes(lambda p=p: fn(p)) for p in PKGS}
    assert got["port"] == got["jax"]
    assert [c for c in got["port"] if c in want] == want or \
        set(want) <= set(got["port"])


def test_shape_mismatch_raises_at_bind_in_both(verify_error):
    for p in PKGS:
        data = p.sym.var("data")
        w = p.sym.var("w_bind", shape=(10, 5))
        net = p.sym.FullyConnected(data, weight=w, num_hidden=8,
                                   name="fc_bind")
        kw = {} if p.name == "jax" else {"ctx": CPU}
        with pytest.raises((GraphVerifyError,
                            janalysis.GraphVerifyError)) as ei:
            net.simple_bind(data=(4, 5), **kw)
        assert "GV101" in ei.value.report.codes()


def test_gv103_runs_on_meta_and_catches_a_desync(verify_error, monkeypatch):
    """The cross-check runs the op bodies on ``meta`` tensors; an inference
    rule that drifts from them is GV103."""
    from mxnet_tpu_torch.analysis import passes

    assert "eval_shape" in passes.DEFAULT_PIPELINE
    assert _clean_mlp(PKGS[1]).by_code("GV103") == []

    real = passes._shapes_fact

    def drifted(ctx):
        var_shapes, out_shapes = real(ctx)
        return var_shapes, [(4, 4)]

    monkeypatch.setitem(passes.FACT_PROVIDERS, "shapes", drifted)
    rep = _clean_mlp(PKGS[1])
    (d,) = rep.by_code("GV103")
    assert "(4, 4)" in d.message and "(4, 3)" in d.message


# -- traces --------------------------------------------------------------------

def _stream_reuse(p):
    with p.analysis.record_trace("keys") as tr:
        p.mx.random.seed(7)
        x1 = p.nd.random.uniform(shape=(3,), ctx=CPU) \
            if p.name == "port" else p.nd.random_uniform(shape=(3,))
        p.mx.random.seed(7)
        x2 = p.nd.random.normal(shape=(3,), ctx=CPU) \
            if p.name == "port" else p.nd.random_normal(shape=(3,))
        tr.mark_outputs([x1, x2])
    return p.analysis.verify_trace(tr, passes=("key_reuse",))


def _distinct_streams(p):
    p.mx.random.seed(8)
    with p.analysis.record_trace("keys2") as tr:
        x1 = p.nd.random.uniform(shape=(3,), ctx=CPU) \
            if p.name == "port" else p.nd.random_uniform(shape=(3,))
        x2 = p.nd.random.uniform(shape=(3,), ctx=CPU) \
            if p.name == "port" else p.nd.random_uniform(shape=(3,))
        tr.mark_outputs([x1, x2])
    return p.analysis.verify_trace(tr, passes=("key_reuse",))


def _dead_value(p):
    with p.analysis.record_trace("dead") as tr:
        a = p.ones((4,))
        _ = a * 3  # computed, never read
        z = a + 1
        tr.mark_outputs([z])
    return p.analysis.verify_trace(tr, passes=("dead_values",))


def _double_write_synthetic(p):
    tr = p.analysis.GraphTrace("dd")
    tr.add("fused_axpy", inputs=(1, 2), outputs=(3,), donated=(1, 1))
    return p.analysis.verify_trace(tr, passes=("donation",))


def _out_without_alias(p):
    with p.analysis.record_trace("w") as tr:
        a, b = p.ones((4,)), p.ones((4,))
        c = p.zeros((4,))
        view = p.nd.NDArray(c.data) if p.name == "jax" else \
            p.nd.NDArray(c.data)
        p.nd.broadcast_add(a, b, out=c)
        z = view + 1
        tr.mark_outputs([z, c])
    return p.analysis.verify_trace(tr, passes=("donation",))


TRACE_CASES = {"stream_reuse": (_stream_reuse, ["GV301"]),
               "distinct_streams": (_distinct_streams, []),
               "dead_value": (_dead_value, ["GV401"]),
               "double_write_synthetic": (_double_write_synthetic,
                                          ["GV202"]),
               "out_without_alias": (_out_without_alias, [])}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_codes_equal_jax(verify_error, case):
    fn, want = TRACE_CASES[case]
    got = {p.name: _codes(lambda p=p: fn(p)) for p in PKGS}
    assert got["port"] == got["jax"] == want


def test_read_through_an_alias_after_a_write_is_no_hazard_here(verify_error):
    """The JAX package's use-after-donate: an alias read after out= wrote
    its buffer. The JAX trace reports GV201 (the donated buffer is
    deleted); the port writes in place and the alias reads the new
    values, as an MXNet array does: no diagnostic."""
    def program(p):
        with p.analysis.record_trace("uad") as tr:
            a = p.ones((4,))
            snap = p.nd.NDArray(a.data)
            p.nd.broadcast_add(a, p.ones((4,)), out=a)
            z = snap + 1
            tr.mark_outputs([z])
        return tr, z

    jtr, _ = program(PKGS[0])
    assert janalysis.verify_trace(jtr, passes=("donation",)).codes() == \
        ["GV201"]
    ttr, z = program(PKGS[1])
    assert analysis.verify_trace(ttr, passes=("donation",)).codes() == []
    onp.testing.assert_array_equal(z.asnumpy(), [3, 3, 3, 3])


# -- in-place writes into what a live record saved -----------------------------

def test_out_write_into_a_saved_array_is_gv201_in_both(verify_error,
                                                       monkeypatch):
    monkeypatch.setenv("MXNET_EAGER_JIT_DONATE", "1")  # the JAX guard's gate
    for p in PKGS:
        a = p.ones((4,))
        a.attach_grad()
        with p.autograd.record():
            b = a * a  # the record saves a for b's gradient
        with pytest.raises((GraphVerifyError,
                            janalysis.GraphVerifyError)) as ei:
            p.nd.broadcast_add(a, p.ones((4,)), out=a)
        assert "GV201" in ei.value.report.codes(), p.name
        b.backward()  # the write was refused: backward is intact
        onp.testing.assert_allclose(a.grad.asnumpy(), 2 * onp.ones(4))


def test_clean_in_place_writes_pass_in_both(verify_error, monkeypatch):
    monkeypatch.setenv("MXNET_EAGER_JIT_DONATE", "1")
    for p in PKGS:
        a = p.ones((4,))
        for _ in range(3):
            p.nd.broadcast_add(a, p.ones((4,)), out=a)
        onp.testing.assert_allclose(a.asnumpy(), 4 * onp.ones(4))


def test_port_out_writes_in_place():
    a, b = nd.ones((4,), ctx=CPU), nd.ones((4,), ctx=CPU)
    c = nd.zeros((4,), ctx=CPU)
    t = c.data
    assert nd.broadcast_add(a, b, out=c) is c
    assert c.data is t and (t == 2).all()
    with pytest.raises(mx.MXNetError, match="multi-output"):
        nd.split(nd.ones((4, 2), ctx=CPU), num_outputs=2, out=c)


def test_step_before_backward_is_gv201_in_both(verify_error, monkeypatch):
    """Two layers: the record saves the second layer's weight (the first
    layer's output needs it for its gradient), so updating it in place
    before backward is the hazard in the port too. (One Dense on a data
    batch saves no weight in torch's graph: no hazard, no diagnostic;
    the JAX tape holds every primal.)"""
    monkeypatch.setenv("MXNET_FUSED_STEP_DONATE", "1")  # the JAX gate
    for p in PKGS:
        net = p.gluon.nn.Sequential()
        net.add(p.gluon.nn.Dense(3), p.gluon.nn.Dense(2))
        p.init(net)
        trainer = p.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1})
        x = p.ones((2, 4))
        with p.autograd.record():
            loss = net(x).sum()
        loss.backward()
        trainer.step(2)  # the record was consumed by backward: fine
        with p.autograd.record():
            loss2 = net(x).sum()  # noqa: F841 — its record stays live
        with pytest.raises((GraphVerifyError,
                            janalysis.GraphVerifyError)) as ei:
            trainer.step(2)  # backward not called: the record holds them
        assert "GV201" in ei.value.report.codes(), p.name


def test_shared_parameter_storage_is_gv202(verify_error):
    import torch

    t = torch.zeros(3)
    with pytest.raises(GraphVerifyError) as ei:
        analysis.check_param_donation([("a", t), ("b", t)])
    assert ei.value.report.codes() == ["GV202"]


def test_checks_are_off_by_default(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPH_VERIFY", "0")
    a = nd.ones((4,), ctx=CPU)
    a.attach_grad()
    with autograd.record():
        a * a
    nd.broadcast_add(a, nd.ones((4,), ctx=CPU), out=a)
    assert analysis.check_param_donation([("a", a.data)]) is None


# -- hybridize ------------------------------------------------------------------

def test_hybridize_verifies_once_and_runs_clean(verify_error):
    before = analysis.counters()["graphs_checked"]
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4), gluon.nn.Dropout(0.5))
    net.initialize(ctx=CPU)
    net.hybridize()
    assert net(nd.ones((2, 3), ctx=CPU)).shape == (2, 4)
    net(nd.ones((2, 3), ctx=CPU))
    assert analysis.counters()["graphs_checked"] == before + 1


def test_hybridize_reports_a_dead_value(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_GRAPH_VERIFY", "warn")

    class Wasteful(gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            F.exp(x)  # computed, never read
            return x + 1

    net = Wasteful()
    net.hybridize()
    with caplog.at_level(logging.WARNING):
        net(nd.ones((2,), ctx=CPU))
    assert any("GV401" in r.getMessage() for r in caplog.records)


def test_verify_does_not_shift_the_random_stream(monkeypatch):
    def seeded_draws(mode):
        monkeypatch.setenv("MXNET_GRAPH_VERIFY", mode)
        mx.random.seed(1234)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(4), gluon.nn.Dropout(0.5))
        net.initialize(ctx=CPU)
        net.hybridize()
        with autograd.record():
            y = net(nd.ones((2, 3), ctx=CPU))
        return y.asnumpy(), nd.random.uniform(shape=(5,), ctx=CPU).asnumpy()

    off, on = seeded_draws("0"), seeded_draws("warn")
    for a, b in zip(off, on):
        onp.testing.assert_array_equal(a, b)


def test_verify_does_not_double_update_batchnorm(monkeypatch):
    def first_step_stats(mode):
        monkeypatch.setenv("MXNET_GRAPH_VERIFY", mode)
        mx.random.seed(5)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(4), gluon.nn.BatchNorm())
        net.initialize(ctx=CPU)
        net.hybridize()
        x = nd.array(onp.random.RandomState(0).randn(8, 3).astype("f"),
                     ctx=CPU)
        with autograd.record():
            net(x).sum().backward()
        return [p.data().asnumpy() for name, p in
                net.collect_params().items()
                if "running" in name or "moving" in name]

    off, on = first_step_stats("0"), first_step_stats("warn")
    assert off
    for a, b in zip(off, on):
        onp.testing.assert_array_equal(a, b)


# -- counters and the registry ---------------------------------------------------

def test_counters_surface_through_the_registry(verify_error):
    from mxnet_tpu_torch import profiler, telemetry

    before = analysis.counters()["graphs_checked"]
    analysis.verify_symbol(sym.relu(sym.var("data"), name="cnt"),
                           shapes={"data": (2, 2)}).disposition()
    assert profiler.graph_verify_counters()["graphs_checked"] == before + 1
    assert telemetry.snapshot()["graph_verify"]["graphs_checked"] == \
        before + 1
    rep = analysis.DiagnosticReport("s")
    rep.emit("GV403", "x")
    with pytest.raises(GraphVerifyError):
        rep.disposition()
    assert analysis.counters()["code_GV403"] >= 1
    assert set(analysis.counters()) >= set(janalysis.counters()) - {
        k for k in janalysis.counters() if k.startswith("code_")}


def test_codes_are_the_jax_catalogue_less_sharding():
    from mxnet_tpu.analysis.diagnostics import CODES as JCODES
    from mxnet_tpu_torch.analysis.diagnostics import CODES

    assert set(CODES) == {c for c in JCODES if not c.startswith("GV5")}
    assert {c: CODES[c][0] for c in CODES} == \
        {c: JCODES[c][0] for c in CODES}
