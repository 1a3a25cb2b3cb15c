"""The port's ModelRepository and ModelServer, on the CPU.

- Canary routing takes exactly ``fraction`` of eligible (non-critical,
  stateless) requests, by the reference's counter rule.
- Injected ``serving_execute`` failures on the canary roll it back
  through its breaker, and every client still gets the incumbent's
  answer.
- ``promote`` migrates live decode sessions: the streams continue
  BITWISE equal to a run with no promote (one bucket, so every step
  runs the same shapes; the two versions hold the same weights).
- The HTTP front end: every endpoint, every status of the error map.
"""
import http.client
import io
import json
import threading

import numpy as onp
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, serving
from mxnet_tpu_torch.models import DecoderBlockLM
from mxnet_tpu_torch.resilience import faults

VOCAB, EMBED, LAYERS, HEADS, MAXLEN = 32, 16, 2, 2, 16
TIMEOUT_S = 60


def _dense_session(seed, scale=1.0):
    mx.random.seed(seed)
    net = gluon.nn.Dense(4, in_units=6)
    net.initialize(ctx=mx.cpu())
    if scale != 1.0:
        w = net.weight.data()
        w[:] = w * scale
    return serving.InferenceSession(net, input_shapes=[(1, 6)],
                                    buckets=[1, 4], ctx=mx.cpu())


def _decoder():
    mx.random.seed(16)
    net = DecoderBlockLM(VOCAB, embed_dim=EMBED, num_layers=LAYERS,
                         num_heads=HEADS, max_len=MAXLEN)
    net.initialize(ctx=mx.cpu())
    return net


_STORES = []  # the stores the decode sessions use, closed by ``repo``


def _decode_session(net, page_tokens=4):
    store = serving.SessionStateStore(
        net.state_row_shapes(), net.state_row_dtypes(), max_sessions=4,
        byte_budget=0, ttl_s=0, pageable=net.state_row_pageable(),
        page_tokens=page_tokens, ctx=mx.cpu())
    _STORES.append(store)
    return serving.InferenceSession(
        net, input_shapes=[(1, 1)], input_dtypes=["int32"],
        state_store=store, buckets=[4], ctx=mx.cpu())


@pytest.fixture
def repo():
    made = []

    def build(**kw):
        kw.setdefault("admission", False)
        kw.setdefault("max_latency_ms", 1.0)
        kw.setdefault("timeout_ms", TIMEOUT_S * 1e3)
        r = serving.ModelRepository(**kw)
        made.append(r)
        return r

    yield build
    for r in made:
        r.close()
    while _STORES:
        _STORES.pop().close()


@pytest.mark.parametrize("fraction", [0.25, 0.1, 0.5])
def test_canary_takes_exactly_its_fraction(repo, fraction):
    r = repo(canary_min_requests=10 ** 6)
    r.deploy("m", _dense_session(1))
    r.deploy("m", _dense_session(1), canary_fraction=fraction)
    serving.METRICS.reset()
    x = onp.ones((1, 6), "float32")
    for k in range(40):
        r.predict("m", x, slo_class="critical")  # never rides the canary
        r.predict("m", x, slo_class="best_effort" if k % 2 else "standard")
    snap = serving.METRICS.snapshot()
    assert snap["canary_requests"] == int(40 * fraction)
    assert r.model_states()["m"]["canary"]["successes"] == int(40 * fraction)
    assert r.model_states()["m"]["state"] == "canary"


def test_injected_canary_failures_roll_back_transparently(repo):
    """fraction 1.0 sends every standard request to the canary; the seam
    fires on every second execution, i.e. on each canary run after the
    first, whose fallback to the incumbent is the next (clean) call.
    Two failures trip the breaker (threshold 2): rolled back, and every
    answer was the incumbent's."""
    r = repo(canary_threshold=2, canary_min_requests=10 ** 6)
    inc = _dense_session(2)
    r.deploy("m", inc)
    r.deploy("m", _dense_session(2), canary_fraction=1.0)
    serving.METRICS.reset()
    x = onp.random.RandomState(0).randn(1, 6).astype("float32")
    want = inc.predict(x).asnumpy()
    with faults.inject("serving_execute", every=2):
        got = [r.predict("m", x) for _ in range(3)]
    got.append(r.predict("m", x))  # rolled back: the incumbent serves
    for g in got:
        assert onp.array_equal(g, want)
    st = r.model_states()["m"]
    assert st["state"] == "rolled_back" and "canary" not in st
    assert "breaker tripped after 2" in st["last_transition"]
    snap = serving.METRICS.snapshot()
    assert (snap["canary_failures"], snap["canary_fallbacks"],
            snap["canary_rollbacks"]) == (2, 2, 1)
    assert r.healthz()["status"] == "degraded"


def test_canary_promotes_after_clean_requests(repo):
    r = repo(canary_min_requests=3)
    r.deploy("m", _dense_session(3))
    v2 = r.deploy("m", _dense_session(3), canary_fraction=1.0)
    x = onp.ones((1, 6), "float32")
    for _ in range(3):
        r.predict("m", x)
    st = r.model_states()["m"]
    assert st["state"] == "serving" and st["active_version"] == v2


def test_model_swap_fault_aborts_promote(repo):
    r = repo(canary_min_requests=10 ** 6)
    r.deploy("m", _dense_session(4))
    r.deploy("m", _dense_session(4))
    with faults.inject("model_swap", every=1):
        with pytest.raises(faults.InjectedFault):
            r.promote("m")
    assert r.model_states()["m"]["active_version"] == 1


def _run_streams(r, name, streams, promote_at=None, deploy=None):
    """Drive the streams step by step (one step of every stream per
    round); before round ``promote_at`` deploy ``deploy()`` and promote
    it. Returns every step's logits."""
    out = {sid: [] for sid in streams}
    for k in range(max(map(len, streams.values()))):
        if k == promote_at:
            r.deploy(name, deploy())
            r.promote(name)
        futs = {sid: r.submit(name, toks[k], session_id=sid)
                for sid, toks in streams.items() if k < len(toks)}
        for sid, f in futs.items():
            out[sid].append(onp.asarray(f.result(timeout=TIMEOUT_S)))
    return out


def test_promote_migrates_live_sessions_bitwise(repo):
    net = _decoder()
    rs = onp.random.RandomState(9)
    streams = {f"s{i}": [rs.randint(0, VOCAB, (1, 1)).astype("int32")
                         for _ in range(n)] for i, n in enumerate((7, 12, 5))}
    plain = repo()
    plain.deploy("lm", _decode_session(net))
    want = _run_streams(plain, "lm", streams)
    moved = repo()
    moved.deploy("lm", _decode_session(net))
    serving.METRICS.reset()
    # v2 on another page geometry: the payload is dense rows
    got = _run_streams(moved, "lm", streams, promote_at=4,
                       deploy=lambda: _decode_session(net, page_tokens=8))
    assert serving.METRICS.snapshot()["resumed_sessions"] == 3
    assert moved.model_states()["lm"]["active_version"] == 2
    for sid in streams:
        for g, w in zip(got[sid], want[sid]):
            assert onp.array_equal(g, w)
    info = moved.model_states()["lm"]["session_state"]
    assert info["sessions"] == 3 and info["page_tokens"] == 8


def test_export_bundle_names_its_slice(repo):
    # bundles exist now (tests/test_torch_artifact.py exports and
    # imports one); a Gluon block on the CPU has no program and loads no
    # kernel library, so there is nothing to bundle and the export says so
    r = repo()
    r.deploy("m", _dense_session(5))
    with pytest.raises(mx.MXNetError, match="nothing to bundle"):
        r.export_bundle("m", "/nonexistent")


# -- the HTTP front end ------------------------------------------------------

class _Boom(gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        raise RuntimeError("model exploded")


def _serve(repo, admission):
    net = _decoder()
    r = repo(timeout_ms=TIMEOUT_S * 1e3, admission=admission)
    r.deploy("dense", _dense_session(6))
    r.deploy("lm", _decode_session(net))
    boom = serving.InferenceSession(_Boom(), input_shapes=[(1, 6)],
                                    buckets=[1], warm=False, ctx=mx.cpu())
    r.deploy("boom", boom)
    return serving.ModelServer(repository=r, port=0).start()


@pytest.fixture
def server(repo):
    """The front end with admission off. Admission sheds a standard
    request once the rolling p99 of the requests in this process, any
    earlier test's included, passes its 100 ms SLO, as it does on a
    loaded host; these tests check routes and statuses, not that."""
    srv = _serve(repo, admission=False)
    yield srv
    srv.stop()


@pytest.fixture
def admitting_server(repo):
    """The front end with admission on, its latency window emptied first
    so only this test's own requests move the headroom."""
    serving.METRICS.reset()
    srv = _serve(repo, admission=True)
    yield srv
    srv.stop()


@pytest.fixture
def blown_latency_window():
    """What a loaded host leaves behind: critical requests far slower
    than the 100 ms SLO in the rolling window, so the latency headroom
    is 0. Emptied again afterwards, so no later test meets it."""
    for _ in range(8):
        serving.METRICS.observe_request(1.0, slo_class="critical")
    yield
    serving.METRICS.reset()


def _call(srv, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                      timeout=TIMEOUT_S)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _post(srv, path, doc, **headers):
    return _call(srv, "POST", path, json.dumps(doc).encode(),
                 {"Content-Type": "application/json", **headers})


def test_http_predict_json_npy_and_default_route(server):
    x = onp.random.RandomState(1).randn(2, 6).astype("float32")
    want = server.repository.predict("dense", x)
    code, hdr, body = _post(server, "/models/dense/predict",
                            {"data": x.tolist()}, **{"X-Request-Id": "r1"})
    doc = json.loads(body)
    assert code == 200 and hdr["X-Request-Id"] == "r1"
    assert doc["shapes"] == [[2, 4]]
    onp.testing.assert_allclose(doc["outputs"][0], want, rtol=1e-6)
    buf = io.BytesIO()
    onp.save(buf, x)
    code, hdr, body = _call(server, "POST", "/predict", buf.getvalue(),
                            {"Content-Type": "application/x-npy"})
    assert code == 200 and hdr["Content-Type"] == "application/x-npy"
    assert onp.array_equal(onp.load(io.BytesIO(body)), want)
    assert "X-Request-Id" in hdr  # minted when the client sent none


def test_http_decode_stream_with_session_header(server):
    net = server.repository._models["lm"].versions[1].session
    toks = [onp.array([[t]], "int32") for t in (3, 7, 1)]
    states = [onp.zeros((1,) + s, dt) for s, dt in
              zip(net._block.state_row_shapes(),
                  net._block.state_row_dtypes())]
    for tok in toks:
        code, _, body = _post(server, "/models/lm/predict",
                              {"data": tok.tolist()},
                              **{"X-Session-Id": "http-1",
                                 "X-SLO-Class": "critical"})
        assert code == 200
        out, states = net.step(tok, states=states)
        assert onp.array_equal(onp.asarray(json.loads(body)["outputs"][0],
                                           "float32"), out.asnumpy())


def test_http_error_mapping(server):
    x = [[0.0] * 6]
    cases = [
        (_post(server, "/models/dense/predict", {"nope": 1}), 400),
        (_post(server, "/models/dense/predict", {"data": x},
               **{"X-SLO-Class": "gold"}), 400),
        (_post(server, "/models/dense/predict", {"data": [[1.0] * 5]}), 400),
        (_call(server, "POST", "/models/dense/predict", b"{",
               {"Content-Type": "application/json"}), 400),
        (_post(server, "/models/nope/predict", {"data": x}), 404),
        (_call(server, "GET", "/nowhere"), 404),
        (_post(server, "/models/boom/predict", {"data": x}), 500),
        (_post(server, "/models/dense/predict", {"data": x},
               **{"X-Timeout-Ms": "0.000001"}), 504),
    ]
    for (code, hdr, body), want in cases:
        assert code == want, (want, body)
        doc = json.loads(body)
        # POSTs carry a request id (GETs have none, as in the reference)
        assert "error" in doc and \
            doc["request_id"] == hdr.get("X-Request-Id")
    # a stream whose state went away: 503 with Retry-After
    _post(server, "/models/lm/predict", {"data": [[1]]},
          **{"X-Session-Id": "gone"})
    server.repository._models["lm"].versions[1].session.state_store.evict(
        "gone")
    code, hdr, body = _post(server, "/models/lm/predict", {"data": [[2]]},
                            **{"X-Session-Id": "gone"})
    assert code == 503 and "Retry-After" in hdr
    assert "evicted" in json.loads(body)["error"]


def test_http_shed_best_effort_while_critical_passes(admitting_server):
    server = admitting_server
    x = {"data": [[0.5] * 6]}
    serving.METRICS.reset()
    with faults.inject("serving_admission", every=1):
        code, hdr, body = _post(server, "/models/dense/predict", x,
                                **{"X-SLO-Class": "best_effort"})
        assert code == 503 and float(hdr["Retry-After"]) > 0
        assert json.loads(body)["retry_after_s"] > 0
        code, _, _ = _post(server, "/models/dense/predict", x,
                           **{"X-SLO-Class": "critical"})
        assert code == 200
    code, _, body = _call(server, "GET", "/metrics")
    text = body.decode()
    assert code == 200
    assert 'mxnet_serving_class_shed_total{slo_class="best_effort"} 1' in text
    assert 'mxnet_serving_class_responses_total{slo_class="critical"} 1' \
        in text


def test_http_latency_window_blown_sheds_standard_not_critical(
        admitting_server, blown_latency_window):
    """The load the other HTTP tests no longer depend on: with the
    window's p99 past the SLO, admission sheds a standard request and
    still admits a critical one."""
    x = {"data": [[0.5] * 6]}
    code, hdr, body = _post(admitting_server, "/models/dense/predict", x)
    assert code == 503 and "SLO headroom" in json.loads(body)["error"]
    code, _, _ = _post(admitting_server, "/models/dense/predict", x,
                       **{"X-SLO-Class": "critical"})
    assert code == 200


def test_http_predict_passes_with_the_latency_window_blown(
        server, blown_latency_window):
    x = onp.random.RandomState(2).randn(1, 6).astype("float32")
    code, _, body = _post(server, "/models/dense/predict",
                          {"data": x.tolist()})
    assert code == 200, body
    onp.testing.assert_allclose(json.loads(body)["outputs"][0],
                                server.repository.predict("dense", x),
                                rtol=1e-6)


def test_http_healthz_models_and_graceful_stop(admitting_server):
    server = admitting_server
    code, _, body = _call(server, "GET", "/healthz")
    doc = json.loads(body)
    assert code == 503 and doc["warm"] is False  # boom never warmed
    assert set(doc["queue_depths"]) == set(serving.SLO_CLASSES)
    assert doc["models"]["lm"]["session_state"]["page_tokens"] == 4
    assert doc["slo"]["enabled"] is True
    code, _, body = _call(server, "GET", "/models")
    doc = json.loads(body)
    assert code == 200 and doc["default"] == "dense"
    assert sorted(doc["models"]) == ["boom", "dense", "lm"]
    # requests in flight at stop() still complete
    res = []
    t = threading.Thread(target=lambda: res.append(_post(
        server, "/models/dense/predict", {"data": [[1.0] * 6]})))
    t.start()
    t.join(TIMEOUT_S)
    server.stop()
    assert not t.is_alive() and res[0][0] == 200
    with pytest.raises(OSError):
        _call(server, "GET", "/healthz")


def test_single_session_server(repo):
    sess = _dense_session(8)
    srv = serving.ModelServer(sess, port=0).start()
    try:
        code, _, body = _call(srv, "GET", "/healthz")
        doc = json.loads(body)
        assert code == 200 and doc["warm"] and doc["state"] is None
        code, _, _ = _call(srv, "GET", "/models")
        assert code == 404
        code, _, body = _post(srv, "/predict", {"inputs": [[[1.0] * 6]]})
        assert code == 200 and json.loads(body)["shapes"] == [[1, 4]]
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="exactly one"):
        serving.ModelServer()


# -- int8 canaries (twins of tests/test_quantized_serving.py:92-199) ---------

def _mlp(seed):
    mx.random.seed(seed)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(ctx=mx.cpu())
    with mx.autograd.pause(train_mode=False):
        net(mx.nd.zeros((1, 8), ctx=mx.cpu()))
    return net


def _int8(net):
    from mxnet_tpu_torch.contrib.quantization import quantize_net_graph

    calib = [mx.nd.array(onp.random.RandomState(i).rand(4, 8)
                         .astype("float32"), ctx=mx.cpu()) for i in range(3)]
    return quantize_net_graph(net, calib_data=calib, calib_mode="naive")


def _mlp_session(block):
    return serving.InferenceSession(block, input_shapes=[(1, 8)],
                                    buckets=[1, 2, 4], ctx=mx.cpu())


def _x8(seed):
    return onp.random.RandomState(seed).rand(1, 8).astype("float32")


def _fp32(net, x):
    with mx.autograd.pause(train_mode=False):
        return net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()


class _Corrupt:
    """An int8 version gone numerically wrong: it executes cleanly and
    at normal latency, and answers 8 times too large — only the shadow
    accuracy gate can see it."""

    def __init__(self, inner, scale=8.0):
        self._inner = inner
        self._scale = scale

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict(self, *arrs):
        out = self._inner.predict(*arrs)
        if isinstance(out, (list, tuple)):
            return type(out)(o * self._scale for o in out)
        return out * self._scale


def _wait_state(r, name, state, timeout_s=10.0):
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = r.model_states()[name]
        if st["state"] == state:
            return st
        time.sleep(0.01)
    raise AssertionError(f"{name} never reached {state!r}: "
                         f"{r.model_states()[name]}")


def test_int8_session_serves_accurately(repo):
    from mxnet_tpu_torch.serving.repository import _rel_deviation

    net = _mlp(3)
    r = repo()
    r.deploy("q", _mlp_session(_int8(net)))
    for i in range(3):
        out = r.submit("q", _x8(i)).result(timeout=TIMEOUT_S)
        assert _rel_deviation(out, _fp32(net, _x8(i))) < 0.1


def test_int8_and_fp32_versions_coexist(repo):
    """The float32 model and its int8 version deploy side by side in one
    repository, each serving its own answers."""
    from mxnet_tpu_torch.serving.repository import _rel_deviation

    net = _mlp(4)
    r = repo()
    r.deploy("fp32", _mlp_session(net))
    r.deploy("int8", _mlp_session(_int8(net)))
    x = _x8(40)
    a = r.predict("fp32", x)
    b = r.predict("int8", x)
    assert onp.array_equal(a.asnumpy() if hasattr(a, "asnumpy") else a,
                           _fp32(net, x))
    assert 0 < _rel_deviation(b, a) < 0.1
    assert set(r.model_states()) == {"fp32", "int8"}


def test_clean_int8_canary_auto_promotes(repo, monkeypatch):
    from mxnet_tpu_torch.serving.repository import _rel_deviation

    monkeypatch.setenv("MXNET_QUANTIZE_SHADOW", "1.0")
    monkeypatch.setenv("MXNET_QUANTIZE_SHADOW_TOL", "0.1")
    serving.reset_serving_counters()
    net = _mlp(5)
    r = repo(canary_min_requests=6, canary_fraction=1.0)
    r.deploy("m", _mlp_session(net))
    assert r.deploy("m", _mlp_session(_int8(net))) == 2
    for i in range(6):
        out = r.submit("m", _x8(10 + i),
                       slo_class="standard").result(timeout=TIMEOUT_S)
        assert _rel_deviation(out, _fp32(net, _x8(10 + i))) < 0.1
    st = _wait_state(r, "m", "serving")
    assert st["active_version"] == 2
    stats = serving.serving_stats()
    assert stats["canary_promotions"] == 1
    assert stats["canary_shadow_checks"] >= 1
    assert stats.get("canary_shadow_mismatches", 0) == 0
    assert stats["canary_rollbacks"] == 0


def test_wrong_int8_canary_rolls_back_through_the_shadow(repo, monkeypatch):
    monkeypatch.setenv("MXNET_QUANTIZE_SHADOW", "1.0")
    monkeypatch.setenv("MXNET_QUANTIZE_SHADOW_TOL", "0.1")
    serving.reset_serving_counters()
    net = _mlp(6)
    r = repo(canary_threshold=3, canary_fraction=1.0,
             canary_min_requests=1000)
    r.deploy("m", _mlp_session(net))
    r.deploy("m", _Corrupt(_mlp_session(_int8(net))))
    futs = [r.submit("m", _x8(30 + i), slo_class="standard")
            for i in range(6)]
    for f in futs:
        f.result(timeout=TIMEOUT_S)  # no client-visible failure
    st = _wait_state(r, "m", "rolled_back")
    assert st["active_version"] == 1
    assert "shadow accuracy deviation" in st["last_transition"]
    stats = serving.serving_stats()
    assert stats["canary_rollbacks"] == 1
    assert stats["canary_shadow_mismatches"] >= 3
    assert stats["canary_failures"] == 0
    out = r.submit("m", _x8(99)).result(timeout=TIMEOUT_S)
    assert onp.array_equal(out, _fp32(net, _x8(99)))


def test_shadow_gate_off_by_default(repo, monkeypatch):
    monkeypatch.delenv("MXNET_QUANTIZE_SHADOW", raising=False)
    serving.reset_serving_counters()
    net = _mlp(7)
    r = repo(canary_fraction=1.0, canary_min_requests=1000)
    r.deploy("m", _mlp_session(net))
    r.deploy("m", _Corrupt(_mlp_session(_int8(net))))
    for i in range(4):
        r.submit("m", _x8(i), slo_class="standard").result(timeout=TIMEOUT_S)
    assert serving.serving_stats().get("canary_shadow_checks", 0) == 0
    assert r.model_states()["m"]["state"] == "canary"
