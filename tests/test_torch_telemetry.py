"""The port's telemetry (``mxnet_tpu_torch/telemetry/``) against the JAX
package's, on the CPU.

1. The tracer: the scripted cases of ``tests/test_telemetry.py`` (nesting
   and cross-thread causality, the error type, ring wraparound at the
   same capacity, the Chrome schema, level 0) run through both tracers;
   with timestamps, thread ids and span ids taken out, the events are
   equal: name, ``cat``, ``ph``, the parent's name, the trace id and the
   other args.
2. Serving: a 2-layer ``DecoderBlockLM`` of width 64, its weights
   carried across with ``convert``, serves the same four requests
   through ``DynamicBatcher`` over paged stores in both packages at
   ``MXNET_TELEMETRY=1``. For each request's trace id the set of (span name, parent name) is
   equal; the ``serving.decode_step`` spans equal the steps the batcher
   reports; the Prometheus serving block has the same metric names and
   labels, and its request and decode-step counts are equal.
3. Training: a small MLP through the Trainer's fused step fed by
   ``DeviceFeed`` at level 1 emits the JAX package's span names each
   step; at level 2 one eager forward's ``dispatch.<op>`` names equal
   the JAX ones; a bucketed reducer step records ``pipeline.grad_bucket``
   and ``pipeline.grad_flush``.
4. The registry: the port's family names are the JAX ones it has a
   subsystem for, each with the JAX keys (JAX-only keys listed below
   beside the slice that brings them), and counter samples are
   ``<family>/<counter>``.
5. Level 0 hands back the one shared null span and records nothing.
"""
import json
import os
import re
import threading

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import pipeline as jpipeline
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon import fused_step as jfused
from mxnet_tpu.models import DecoderBlockLM as JaxDecoderBlockLM
from mxnet_tpu.serving import metrics as jsm

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, convert, gluon, serving, telemetry
from mxnet_tpu_torch.gluon import fused_step as tfused
from mxnet_tpu_torch.models import DecoderBlockLM
from mxnet_tpu_torch.pipeline import AsyncGradReducer, DeviceFeed
from mxnet_tpu_torch.serving import metrics as tsm

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _clean_rings():
    jtel.reset_trace()
    telemetry.reset_trace()
    yield
    jtel.reset_trace()
    telemetry.reset_trace()


def _normalize(events):
    """Events without clocks, thread ids and span ids: the parent span
    id becomes the parent's name."""
    by_id = {e["args"]["span_id"]: e["name"] for e in events
             if "span_id" in e.get("args", {})}
    out = []
    for e in events:
        args = dict(e.get("args", {}))
        args.pop("span_id", None)
        if "parent" in args:
            args["parent"] = by_id.get(args["parent"], "?")
        out.append({"name": e["name"], "cat": e.get("cat"),
                    "ph": e["ph"], "args": args})
    return out


# ---------------------------------------------------------------------------
# 1. the tracer, case for case


def _script_nesting(tel):
    with tel.trace_context("t-abc") as tid:
        assert tid == "t-abc"
        with tel.span("outer", cat="test"):
            with tel.span("inner", cat="test") as sp:
                sp.set(marker=7)

            def work():
                with tel.span("worker", cat="test", trace_id=tid):
                    pass

            th = threading.Thread(target=work, name="test-worker")
            th.start()
            th.join()
    return tel.events()


def _script_error(tel):
    with pytest.raises(ValueError):
        with tel.span("doomed", cat="test"):
            raise ValueError("boom")
    return tel.events()


def _script_wrap(tel):
    tel.reset_trace(capacity=8)
    for i in range(12):
        tel.instant(f"ev{i}", cat="test")
    return tel.events()


def _script_schema(tel, path):
    with tel.span("alpha", cat="test", k=1):
        tel.instant("mark", cat="test")
    tel.dump_trace(str(path))
    return json.load(open(str(path)))


@pytest.mark.parametrize("case", ["nesting", "error", "wraparound"])
def test_tracer_cases_equal_jax(case, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    run = {"nesting": _script_nesting, "error": _script_error,
           "wraparound": _script_wrap}[case]
    got = {}
    for name, tel in (("jax", jtel), ("port", telemetry)):
        tel.reset_trace()
        got[name] = run(tel)
    assert _normalize(got["port"]) == _normalize(got["jax"])
    if case == "nesting":
        evs = {e["name"]: e for e in got["port"]}
        assert evs["worker"]["tid"] != evs["outer"]["tid"]
        assert telemetry.thread_names()[evs["worker"]["tid"]] == \
            "test-worker"
    if case == "wraparound":
        assert telemetry.dropped_spans() == jtel.dropped_spans() == 4
        assert telemetry.buffer_capacity() == jtel.buffer_capacity() == 8
        assert telemetry.build_trace(counters=False)["otherData"] == \
            jtel.build_trace(counters=False)["otherData"] == \
            {"dropped_spans": 4}


def test_chrome_trace_schema_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    docs = {name: _script_schema(tel, tmp_path / f"{name}.json")
            for name, tel in (("jax", jtel), ("port", telemetry))}
    for doc in docs.values():
        assert doc["displayTimeUnit"] == "ms"
        for e in doc["traceEvents"]:
            assert {"name", "ph", "pid"} <= set(e), e
            if e["ph"] in ("X", "i", "M"):
                assert "tid" in e
            if e["ph"] == "X":
                assert e["ts"] >= 0 and e["dur"] >= 0 and "cat" in e
            elif e["ph"] == "i":
                assert e["s"] == "t"
    kinds = {name: {e["ph"] for e in doc["traceEvents"]}
             for name, doc in docs.items()}
    assert kinds["port"] == kinds["jax"] == {"X", "i", "M", "C"}
    spans = {name: _normalize([e for e in doc["traceEvents"]
                               if e["ph"] in ("X", "i")])
             for name, doc in docs.items()}
    assert spans["port"] == spans["jax"]
    samples = [e for e in docs["port"]["traceEvents"] if e["ph"] == "C"]
    assert samples and all(
        re.fullmatch(r"[a-z_]+/.+", e["name"]) for e in samples)


def test_level0_is_the_shared_null_span(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    assert not telemetry.tracing()
    sp = telemetry.span("nope", cat="test")
    assert sp is telemetry.span("nope2", cat="test") is \
        telemetry.tracer._NULL
    with sp:
        sp.set(k=1)
    telemetry.instant("nope3", cat="test")
    with telemetry.trace_context("rid-1"):
        assert telemetry.current_trace_id() == "rid-1"
    assert telemetry.current_trace_id() is None
    assert telemetry.events() == [] and telemetry.dropped_spans() == 0


@pytest.mark.parametrize("value", [None, "", "0", "1", "2", "on"])
def test_level_follows_the_environment_as_jax_does(monkeypatch, value):
    """The level is read from the environment at every call, whichever
    way it was written, and parses as the JAX tracer's does."""
    if value is None:
        monkeypatch.delenv("MXNET_TELEMETRY", raising=False)
    else:
        monkeypatch.setenv("MXNET_TELEMETRY", value)
    assert telemetry.level() == jtel.level()
    os.environ["MXNET_TELEMETRY"] = "2"
    assert telemetry.level() == jtel.level() == 2
    del os.environ["MXNET_TELEMETRY"]
    assert telemetry.level() == jtel.level() == 0
    assert telemetry.span("nope", cat="test") is telemetry.tracer._NULL


def test_level0_leaves_the_fused_step_and_serving_silent(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    net, trainer = _port_mlp(_jax_mlp()[0])
    x, y = _batches(1)[0]
    _port_step(net, trainer, nd_cpu(x), nd_cpu(y))
    assert telemetry.events() == []


# ---------------------------------------------------------------------------
# 2. decode serving through DynamicBatcher, both packages

VOCAB, EMBED, LAYERS, HEADS, MAXLEN = 32, 64, 2, 2, 16


def _jax_decoder():
    jmx.random.seed(21)
    net = JaxDecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                            num_heads=HEADS, max_len=MAXLEN, impl="lax",
                            prefix="decoder_")
    net.initialize()
    states = [jmx.nd.array(onp.zeros((1,) + s, dt), dtype=dt) for s, dt in
              zip(net.state_row_shapes(), net.state_row_dtypes())]
    with jautograd.pause(train_mode=False):
        net(jmx.nd.zeros((1, 1), dtype="int32"), *states)
    return net


def _port_decoder(jnet):
    net = DecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                         num_heads=HEADS, max_len=MAXLEN)
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    return convert.params_from_numpy(net, arrays, ctx=CPU)


def _serve(pkg, net, requests):
    """Each request under its own trace id, one after another, so every
    step has one member; returns (events, decode steps served)."""
    kw = {} if pkg is jserving else {"ctx": CPU}
    store = pkg.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=4,
        byte_budget=0, ttl_s=0, pageable=net.state_row_pageable(),
        page_tokens=4, **kw)
    sess = pkg.InferenceSession(net, input_shapes=[(1, 1)],
                                input_dtypes=["int32"], state_store=store,
                                buckets=[4], **kw)
    bat = pkg.DynamicBatcher(sess, max_batch_size=4, max_latency_ms=1.0,
                             timeout_ms=60e3, admission=False)
    tel = jtel if pkg is jserving else telemetry
    metrics = jsm if pkg is jserving else tsm
    try:
        metrics.reset_serving_counters()
        tel.reset_trace()
        outs = []
        for rid, sid, tok in requests:
            with tel.trace_context(rid):
                fut = bat.submit(tok, session_id=sid)
            outs.append(fut.result(timeout=60))
        events = tel.events()
        text = metrics.prometheus_text()
        steps = metrics.serving_stats()["decode_steps"]
    finally:
        bat.close()
        sess.close()
        store.close()
    return events, steps, text, outs


def _links(events, trace_id):
    """{(name, parent name)} of the spans stamped with ``trace_id``."""
    norm = _normalize(events)
    return {(n["name"], n["args"].get("parent"))
            for n, e in zip(norm, events)
            if e.get("args", {}).get("trace_id") == trace_id}


def _samples(text):
    """{metric name with labels: value} of a Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def test_decode_serving_spans_equal_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    # the port's serving exposition appends the fusion counters of
    # whatever ran earlier in the process too: start from none, so that
    # it holds the serving block alone whatever ran before in the worker
    from mxnet_tpu_torch import kernels

    kernels.reset_counters()
    rs = onp.random.RandomState(7)
    requests = [(f"req-{i}", f"s{i % 2}",
                 rs.randint(0, VOCAB, size=(1, 1)).astype("int32"))
                for i in range(4)]
    jnet = _jax_decoder()
    jev, jsteps, jtext, jouts = _serve(jserving, jnet, requests)
    tev, tsteps, ttext, touts = _serve(serving, _port_decoder(jnet),
                                       requests)
    for rid, _, _ in requests:
        links = _links(tev, rid)
        assert links == _links(jev, rid), rid
        assert {"serving.admission", "serving.queue_wait",
                "serving.decode_step"} <= {n for n, _ in links}
    # spans no request owns: the paged store's page allocations, on the
    # worker (one per session: both streams stay inside their first page)
    assert sorted(e["name"] for e in tev if "trace_id" not in e["args"]) \
        == sorted(e["name"] for e in jev if "trace_id" not in e["args"]) \
        == ["serving.page_alloc"] * 2
    decode = [e for e in tev if e["name"] == "serving.decode_step"]
    assert len(decode) == tsteps == jsteps == len(requests)
    assert telemetry.dropped_spans() == 0
    for j, t in zip(jouts, touts):
        onp.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    # the serving block; the JAX serving exposition also appends the
    # fusion counters of whatever ran earlier in the process
    js = {k: v for k, v in _samples(jtext).items()
          if k.startswith("mxnet_serving_")}
    ts = _samples(ttext)
    assert set(ts) == set(js)
    for key in ("mxnet_serving_requests_total",
                "mxnet_serving_decode_steps_total"):
        assert ts[key] == js[key] == len(requests)


def test_http_request_span_carries_the_trace_id(monkeypatch):
    """``serving.request`` on the handler thread and the batcher's
    spans on its worker share the client's ``X-Request-Id``."""
    import http.client

    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    jnet = _jax_decoder()
    net = _port_decoder(jnet)
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=2,
        byte_budget=0, ttl_s=0, ctx=CPU)
    sess = serving.InferenceSession(net, input_shapes=[(1, 1)],
                                    input_dtypes=["int32"],
                                    state_store=store, buckets=[2], ctx=CPU)
    bat = serving.DynamicBatcher(sess, max_batch_size=2, max_latency_ms=1.0,
                                 timeout_ms=60e3, admission=False)
    srv = serving.ModelServer(batcher=bat, port=0)
    srv.start()
    try:
        telemetry.reset_trace()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/predict",
                     json.dumps({"data": [[3]], "session_id": "h0"}),
                     {"Content-Type": "application/json",
                      "X-Request-Id": "http-1"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        assert resp.getheader("X-Request-Id") == "http-1"
    finally:
        srv.stop()
        bat.close()
        sess.close()
        store.close()
    mine = [e for e in telemetry.events()
            if e.get("args", {}).get("trace_id") == "http-1"]
    names = {e["name"] for e in mine}
    assert {"serving.request", "serving.admission", "serving.queue_wait",
            "serving.decode_step"} <= names, names
    assert len({e["tid"] for e in mine}) >= 2
    req = [e for e in mine if e["name"] == "serving.request"]
    assert req[0]["args"]["status"] == 200


# ---------------------------------------------------------------------------
# 3. training: the fused step fed by DeviceFeed, dispatch spans, buckets

IN, HID, OUT, BATCH, STEPS = 8, 16, 4, 4, 3


def nd_cpu(a):
    return mx.nd.array(a, ctx=CPU)


def _jax_mlp():
    jmx.random.seed(3)
    net = jgluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(jgluon.nn.Dense(HID, activation="relu"),
                jgluon.nn.Dense(OUT))
    net.initialize()
    with jautograd.pause(train_mode=False):
        net(jmx.nd.zeros((1, IN)))
    trainer = jgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
    return net, trainer


def _port_mlp(jnet):
    net = gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(gluon.nn.Dense(HID, activation="relu"),
                gluon.nn.Dense(OUT))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet._collect_params_with_prefix().items()}
    net = convert.params_from_numpy(net, arrays, ctx=CPU)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1, "momentum": 0.9})
    return net, trainer


def _batches(n):
    rs = onp.random.RandomState(11)
    return [(rs.randn(BATCH, IN).astype("f"),
             rs.randint(0, OUT, BATCH).astype("f")) for _ in range(n)]


def _jax_step(net, trainer, x, y):
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jautograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(BATCH)


def _port_step(net, trainer, x, y):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(BATCH)


def _train_spans(tel, feed, step_fn, net, trainer):
    """Per step, the names of the spans the step loop's thread emitted;
    and the prefetch_stage count."""
    main = threading.get_ident() % 100000
    tel.reset_trace()
    per_step, seen = [], 0
    it = iter(feed)
    while True:
        try:
            x, y = next(it)
        except StopIteration:
            break
        step_fn(net, trainer, x, y)
        evs = tel.events()
        per_step.append(sorted(e["name"] for e in evs[seen:]
                               if e["tid"] == main))
        seen = len(evs)
    staged = sum(e["name"] == "pipeline.prefetch_stage"
                 for e in tel.events())
    return per_step, staged


#: spans of the JAX fused step's first call that the port has no
#: counterpart for on the CPU: the port's ``fused_step.trace_compile`` is
#: its CUDA-graph capture, which runs on the card only
#: (``tests/test_torch_profiler.py`` and smoke phase 55 see it there).
#: Both packages persist the step through the compile cache's disk tier
#: (``compile_cache.disk_load``/``disk_store``): the JAX package its
#: executable, the port its plan
JAX_ONLY_FIRST_STEP = {"fused_step.trace_compile"}


def test_fused_step_with_device_feed_spans_equal_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    # an empty compile cache: both first steps miss and store
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("MXNET_FUSED_STEP", raising=False)
    # a step function cached by an earlier test would skip the resolve
    jfused.reset_fused_step_cache()
    tfused.reset_fused_step_cache()
    data = _batches(STEPS)
    jnet, jtr = _jax_mlp()
    tnet, ttr = _port_mlp(jnet)
    jfeed = jpipeline.DeviceFeed(
        [(jmx.nd.array(x), jmx.nd.array(y)) for x, y in data], depth=2)
    tfeed = DeviceFeed([(x, y) for x, y in data], depth=2, device=CPU)
    jsteps, jstaged = _train_spans(jtel, jfeed, _jax_step, jnet, jtr)
    tsteps, tstaged = _train_spans(telemetry, tfeed, _port_step, tnet, ttr)
    assert jstaged == tstaged == STEPS
    assert len(tsteps) == len(jsteps) == STEPS
    first_j = [n for n in jsteps[0] if n not in JAX_ONLY_FIRST_STEP]
    assert tsteps[0] == first_j
    assert "fused_step.resolve" in tsteps[0]
    for j, t in zip(jsteps[1:], tsteps[1:]):
        assert t == j == ["fused_step.execute", "pipeline.feed_wait"]
    # the same arithmetic on both sides, while tracing
    for (k, jp), (_, tp) in zip(
            sorted(jnet._collect_params_with_prefix().items()),
            sorted(tnet._collect_params_with_prefix().items())):
        onp.testing.assert_allclose(tp.data().asnumpy(),
                                    jp.data().asnumpy(), rtol=1e-5,
                                    atol=1e-6, err_msg=k)


def test_level2_dispatch_span_names_equal_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "2")
    jnet, _ = _jax_mlp()
    tnet, _ = _port_mlp(jnet)
    x = onp.random.RandomState(5).randn(BATCH, IN).astype("f")
    names = {}
    jx, tx = jmx.nd.array(x), nd_cpu(x)
    for key, tel, run in (("jax", jtel, lambda: jnet(jx)),
                          ("port", telemetry, lambda: tnet(tx))):
        tel.reset_trace()
        with (jautograd if key == "jax" else autograd).pause():
            run()
        names[key] = [e["name"] for e in tel.events()
                      if e["name"].startswith("dispatch.")]
    assert names["port"] and names["port"] == names["jax"]
    assert all(e["cat"] == "dispatch" for e in telemetry.events()
               if e["name"].startswith("dispatch."))


def test_level1_records_no_dispatch_span(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    tnet, _ = _port_mlp(_jax_mlp()[0])
    telemetry.reset_trace()
    with autograd.pause():
        tnet(nd_cpu(onp.ones((2, IN), "f")))
    assert not [e for e in telemetry.events()
                if e["name"].startswith("dispatch.")]


def test_bucketed_reducer_step_records_both_grad_sync_spans(monkeypatch):
    """The reducer holds the first layer: its gradients go out in buckets
    during backward; the second layer's reach the step unreduced and
    ``flush`` reduces them there."""
    monkeypatch.setenv("MXNET_TELEMETRY", "1")
    monkeypatch.setenv("MXNET_ASYNC_GRAD_SYNC", "1")
    tnet, _ = _port_mlp(_jax_mlp()[0])
    params = list(tnet.collect_params().values())
    first = [p for p in params if p.name.startswith("mlp_dense0")]
    assert 0 < len(first) < len(params)
    reducer = AsyncGradReducer(first, bucket_bytes=1,
                               reduce_fn=lambda flat: flat * 1.0).attach()
    x, y = _batches(1)[0]
    telemetry.reset_trace()
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(tnet(nd_cpu(x)),
                                                    nd_cpu(y))
    loss.backward()
    fresh = reducer.flush([p.grad() for p in params])
    reducer.detach()
    spans = {}
    for e in telemetry.events():
        spans.setdefault(e["name"], []).append(e)
    assert len(spans["pipeline.grad_bucket"]) == len(first)
    (flush,) = spans["pipeline.grad_flush"]
    assert flush["cat"] == "pipeline"
    assert flush["args"]["grads"] == fresh == len(params) - len(first)
    assert all(e["args"]["bytes"] > 0 for e in spans["pipeline.grad_bucket"])


# ---------------------------------------------------------------------------
# 4. the registry

#: JAX families whose subsystem the port lacks: not registered
JAX_ONLY_FAMILIES = {
    "sharding": "sharding/, slice 9b",
    "eager_jit_cache": "no counterpart: the port has no dispatch "
                       "executable cache",
}

#: per family, the JAX keys the port lacks, and why
JAX_ONLY_KEYS = {
    # both steps sit on the JAX package's CountedLRUCache; the port's
    # ``fallbacks`` stays 0 (its step captures its graph or raises)
    "fused_step": set(),
    # the per-bucket serving breakers that demote a bucket: slice 9b
    "resilience": {"breaker_demotions"},
    "pipeline": set(),
    "graph_opt": set(),
    "graph_verify": set(),
    "quantize": set(),
    "serving": set(),
    "compile_cache": set(),
    "artifact": set(),
    "autotune": set(),
    "fleet": set(),
}


def _jax_snapshot():
    from mxnet_tpu.telemetry import metrics as jm

    jm._bootstrap_probes()
    return jtel.snapshot()


def _port_snapshot():
    from mxnet_tpu_torch.telemetry import metrics as tm

    tm._bootstrap_probes()
    return telemetry.snapshot()


def test_registry_families_are_the_jax_ones_the_port_has():
    # families a test made for itself (``test_roundtrip``) aside
    jfam, tfam = ({f for f in snap if not f.startswith("test_")}
                  for snap in (_jax_snapshot(), _port_snapshot()))
    shared = {"fused_step", "pipeline", "serving", "graph_opt", "fusion",
              "quantize", "resilience", "compile_cache", "artifact",
              "autotune", "fleet", "graph_verify"}
    assert shared <= jfam and shared <= tfam
    assert jfam - tfam - {"lock_check"} == set(JAX_ONLY_FAMILIES)
    assert not (tfam & set(JAX_ONLY_FAMILIES))


@pytest.mark.parametrize("family", sorted(JAX_ONLY_KEYS))
def test_registry_family_has_the_jax_keys(family):
    jkeys = set(_jax_snapshot()[family])
    tkeys = set(_port_snapshot()[family])
    assert jkeys - tkeys == JAX_ONLY_KEYS[family]


def test_counter_samples_are_family_slash_counter():
    samples = telemetry.counter_samples()
    assert samples
    fams = set(_port_snapshot())
    for s in samples:
        fam, _, counter = s["name"].partition("/")
        assert fam in fams and counter and s["ph"] == "C"
        assert s["args"] == {counter: s["args"][counter]}


def test_prometheus_exposition_unifies_training_and_serving():
    text = telemetry.prometheus_text()
    assert "mxnet_serving_requests_total" in text
    assert "mxnet_serving_request_latency_seconds" in text
    assert "mxnet_pipeline_" in text and "mxnet_fused_step_" in text
    assert "mxnet__graph_opt_passes" not in text


def test_registry_counter_family_roundtrip():
    fam = telemetry.counter_family("test_roundtrip", {"hits": 0})
    fam.reset()
    fam.add("hits")
    fam.add("hits", 2)
    fam.set("gauge", 7)
    assert telemetry.family_snapshot("test_roundtrip") == \
        {"hits": 3, "gauge": 7}
    assert telemetry.counter_family("test_roundtrip") is fam
    assert "mxnet_test_roundtrip_hits 3" in telemetry.prometheus_text()
    fam.reset()
    assert telemetry.family_snapshot("test_roundtrip")["hits"] == 0


def test_labeled_lines_equal_jax():
    from mxnet_tpu.telemetry import metrics as jm
    from mxnet_tpu_torch.telemetry import metrics as tm

    rows = [({"replica": "r0", "zone": 'a"b'}, 3), ({"replica": "r1"}, 1.5),
            ({"replica": "r2"}, "skip")]
    assert tm.labeled_lines("fleet_load", rows, "load") == \
        jm.labeled_lines("fleet_load", rows, "load")
    assert tm.labeled_lines("x", []) == []


def test_existing_getters_keep_their_values():
    from mxnet_tpu_torch import kernels, pipeline
    from mxnet_tpu_torch.analysis import graph_opt, quantize
    from mxnet_tpu_torch.gluon import fused_step

    snap = _port_snapshot()
    assert snap["pipeline"] == pipeline.pipeline_counters()
    assert snap["graph_opt"] == graph_opt.counters()
    assert snap["quantize"] == quantize.counters()
    assert snap["fusion"] == kernels.counters()
    fs = fused_step.fused_step_stats()
    assert {k: snap["fused_step"][k] for k in fs} == fs
