"""The port's profiler (``mxnet_tpu_torch/profiler.py``) and
``tools/trace_top.py`` against the JAX package's, on the CPU.

- The same scripted ``Domain``/``Task``/``Frame``/``Event``/``Counter``/
  ``Marker`` calls give the same ``dumps()`` rows (domain, name, count)
  in both packages, and so do the ``record_op`` rows of one eager
  forward under ``profile_imperative``.
- ``dump()`` writes a host trace that ``json.load`` reads: the
  profiler's events, the telemetry spans and the registry's counter
  samples, in the JAX package's schema.
- ``start()``/``stop()`` write the device trace ``<stem>_device.json``
  (torch.profiler's Chrome JSON); on the CPU it holds the MLP's
  ``aten::`` operators, and ``trace_top`` prints its table from it.
The card's side (the device trace holds kernel events, replayed graphs'
included) is in ``tests/test_torch_cuda.py``, which imports no JAX.
"""
import contextlib
import io
import json

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import profiler as jprof

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, profiler, telemetry
from mxnet_tpu_torch.tools import trace_top

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _fresh(tmp_path):
    saved = {p: dict(p._config) for p in (jprof, profiler)}
    for p in (jprof, profiler):
        p.dumps(reset=True)
    _clear_host_events()
    yield
    for p in (jprof, profiler):
        if p.is_running():
            p.stop()
        p._config.clear()
        p._config.update(saved[p])
        p.dumps(reset=True)
    _clear_host_events()


def _clear_host_events():
    with profiler._lock:
        profiler._events.clear()


def _scripted(prof):
    dom = prof.Domain("app")
    with dom.new_task("load"):
        pass
    for _ in range(3):
        with dom.new_frame("frame"):
            pass
    with prof.Event("evt"):
        pass
    c = dom.new_counter("items", 2)
    c += 3
    c -= 1
    c.increment()
    dom.new_marker("mark").mark()
    dom.new_marker("mark").mark()
    rows = json.loads(prof.dumps(format="json"))
    return sorted((r["domain"], r["name"], r["count"]) for r in rows), \
        {(r["domain"], r["name"]): r for r in rows}


def test_scripted_objects_give_the_jax_rows():
    jrows, jby = _scripted(jprof)
    trows, tby = _scripted(profiler)
    assert trows == jrows
    assert ("app", "frame", 3) in trows and ("app", "items", 4) in trows
    # a counter row's total is its last value, as in the JAX table
    assert tby[("app", "items")]["total_us"] == \
        jby[("app", "items")]["total_us"] == 5.0
    table = profiler.dumps()
    assert table.splitlines()[0].split()[:3] == ["Domain", "Name", "Count"]
    profiler.dumps(reset=True)
    assert json.loads(profiler.dumps(format="json")) == []


def _mlps():
    jmx.random.seed(5)
    jnet = jgluon.nn.HybridSequential(prefix="mlp_")
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(4))
    jnet.initialize()
    with jautograd.pause(train_mode=False):
        jnet(jmx.nd.zeros((1, 8)))
    tnet = gluon.nn.HybridSequential(prefix="mlp_")
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    return jnet, convert.params_from_numpy(tnet, arrays, ctx=CPU)


def test_record_op_rows_equal_jax(tmp_path):
    jnet, tnet = _mlps()
    x = onp.random.RandomState(0).randn(4, 8).astype("f")
    jx, tx = jmx.nd.array(x), mx.nd.array(x, ctx=CPU)
    rows = {}
    for key, prof, run, ag in (("jax", jprof, lambda: jnet(jx), jautograd),
                               ("port", profiler, lambda: tnet(tx),
                                autograd)):
        prof.set_config(profile_imperative=True,
                        filename=str(tmp_path / f"{key}.json"))
        prof.dumps(reset=True)
        prof.resume()  # the host gate alone: no device trace opened
        with ag.pause():
            run()
        prof.pause()
        rows[key] = sorted(
            (r["domain"], r["name"], r["count"])
            for r in json.loads(prof.dumps(format="json")))
    assert rows["port"] and rows["port"] == rows["jax"]
    assert all(d == "operator" for d, _, _ in rows["port"])


def _train_step(net, x, y):
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()


def test_device_trace_on_the_cpu_and_trace_top(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    _, tnet = _mlps()
    rs = onp.random.RandomState(1)
    x = mx.nd.array(rs.randn(4, 8).astype("f"), ctx=CPU)
    y = mx.nd.array(rs.randint(0, 4, 4).astype("f"), ctx=CPU)
    fname = str(tmp_path / "prof.json")
    profiler.set_config(filename=fname, profile_all=True)
    telemetry.reset_trace()
    profiler.set_state("run")
    assert profiler.is_running()
    with telemetry.span("step", cat="test"):
        _train_step(tnet, x, y)
    profiler.set_state("stop")
    dev = profiler.device_trace_path()
    assert dev == str(tmp_path / "prof_device.json")
    doc = json.load(open(dev))
    ops = [e for e in doc["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    names = {e["name"] for e in ops}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
    assert "aten::addmm" in names or "aten::linear" in names
    # the host trace: profiler events + telemetry spans + samples
    assert profiler.dump() == fname
    host = json.load(open(fname))
    kinds = {e["ph"] for e in host["traceEvents"]}
    assert {"X", "M", "C"} <= kinds
    spans = {e["name"] for e in host["traceEvents"] if e["ph"] == "X"}
    assert "step" in spans and "fully_connected" in spans
    assert any(e["name"].startswith("fused_step/")
               for e in host["traceEvents"] if e["ph"] == "C")
    # trace_top reads the device trace (the CPU operators here)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert trace_top.main([str(tmp_path), "-n", "5"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == f"# {dev}"
    assert lines[2].split() == ["self_ms", "%", "count", "op"]
    assert 1 <= len(lines[3:]) <= 5
    by_name = io.StringIO()
    with contextlib.redirect_stdout(by_name):
        trace_top.main([dev, "--by", "name", "-n", "50"])
    assert any("aten::" in ln for ln in by_name.getvalue().splitlines())


def test_trace_top_prefers_the_cards_kernels():
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50.0},
        {"ph": "X", "cat": "kernel", "dur": 30.0,
         "name": "void decode_attention_kernel<128>(float const*)"},
        {"ph": "X", "cat": "kernel", "dur": 10.0,
         "name": "void decode_attention_kernel<64>(float const*)"},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 5.0},
        {"ph": "i", "cat": "kernel", "name": "instant"},
    ]
    dev = trace_top.device_op_events(events)
    assert [e["dur"] for e in dev] == [30.0, 10.0, 5.0]
    tot, cnt = trace_top.summarize(dev)
    assert tot["decode_attention_kernel"] == 40.0
    assert cnt["decode_attention_kernel"] == 2
    assert trace_top.device_op_events(events[:1]) == events[:1]


def test_stop_without_a_trace_and_pause_resume():
    profiler.set_config(filename="")
    profiler.start()
    assert profiler.is_running() and profiler._state["device_trace"] is None
    profiler.pause()
    assert not profiler.is_running() and not profiler.imperative_on()
    profiler.resume()
    profiler.stop()
    assert not profiler.is_running()
    with pytest.raises(ValueError):
        profiler.set_config(no_such_option=1)


def test_counter_views_read_the_registry():
    from mxnet_tpu_torch import pipeline
    from mxnet_tpu_torch.gluon import fused_step

    assert profiler.pipeline_counters() == pipeline.pipeline_counters()
    fs = fused_step.fused_step_stats()
    got = profiler.fused_step_counters()
    assert {k: got[k] for k in fs} == fs
    for view in (profiler.serving_counters, profiler.resilience_counters,
                 profiler.graph_opt_counters, profiler.fusion_counters,
                 profiler.quantize_counters):
        assert isinstance(view(), dict)
    assert set(profiler.lock_check_counters()) == {
        "out_of_rank", "cycles", "edges", "self_deadlock",
        "violations_dropped"}
