"""The replica fleet (``serving/fleet.py``): the port against the JAX
package.

The twins of ``tests/test_fleet.py`` run the port's ``FleetRouter``
against fake replica HTTP servers (stdlib, in-process): the
consistent-hash ring, membership and gossip, affinity and drain with
session migration, parked requests, least-loaded routing with transport
retry, probe ejection and recovery, fleet admission, the shadow canary
and the router's HTTP surface. Beside them: ``_hash64`` and
``_HashRing.lookup`` over 10,000 keys (and the keys remapped when a
replica leaves) equal the JAX package's, and the two routers, driven
through one request sequence against the same fake replicas, choose the
same replicas, park and migrate the same sessions and end with equal
``fleet`` counters. One test spawns two real replica processes on the
CPU (a small decoder; the port's child does not pin the CPU, the test
asks for it) and drains one mid-stream: every stream's greedy tokens
equal one in-process session's.
"""
import json
import os
import pickle
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as onp
import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import fleet as jfleet

from mxnet_tpu_torch import serving
from mxnet_tpu_torch.serving import FleetRouter, fleet_counters
from mxnet_tpu_torch.serving.fleet import _HashRing, _hash64
from mxnet_tpu_torch.telemetry import metrics as tmetrics

_ROUTERS = []


@pytest.fixture(autouse=True)
def _fresh():
    serving.reset_fleet_counters()
    jserving.reset_fleet_counters()
    # the fleet's admission reads the process's serving latencies: an
    # earlier test's slow requests must not shed these
    serving.METRICS.reset()
    jserving.METRICS.reset()
    yield
    while _ROUTERS:  # close admission probes even on assert failure
        _ROUTERS.pop().stop()
    serving.reset_fleet_counters()
    jserving.reset_fleet_counters()


def _router(cls=FleetRouter, **kw):
    fr = cls(port=0, **kw)
    _ROUTERS.append(fr)
    return fr


# ---------------------------------------------------------------------------
# fake replica: the replica HTTP contract, no jax involved

class _FakeReplica:
    """Answers /healthz, /predict, and the /admin state endpoints the
    way a ModelServer replica does; records restores."""

    def __init__(self, name, outputs=None, depth=0, capacity=8,
                 export=None):
        self.name = name
        self.outputs = outputs if outputs is not None else [[1.0, 2.0]]
        self.depth = depth
        self.capacity = capacity
        self.export = export  # None -> 409 (stateless replica)
        self.restored = []
        self.predicts = 0
        fake = self

        class _H(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _send(self, code, body,
                      ctype="application/json"):
                if isinstance(body, (dict, list)):
                    body = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {
                        "warm": True, "queue_depth": fake.depth,
                        "queue_capacity": fake.capacity})
                elif self.path == "/admin/export_state":
                    if fake.export is None:
                        self._send(409, {"error": "stateless"})
                    else:
                        self._send(200, pickle.dumps(fake.export),
                                   ctype="application/octet-stream")
                else:
                    self._send(404, {"error": "no route"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                if self.path == "/admin/restore_state":
                    payload = pickle.loads(body)
                    fake.restored.append(payload)
                    self._send(200, {"restored":
                                     len(payload["sessions"])})
                else:
                    fake.predicts += 1
                    self._send(200, {
                        "outputs": fake.outputs, "replica": fake.name,
                        "sid": self.headers.get("X-Session-Id")})

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), _H)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join()


@pytest.fixture()
def fakes():
    reps = []
    yield lambda *a, **kw: reps.append(_FakeReplica(*a, **kw)) or \
        reps[-1]
    for r in reps:
        r.stop()


def _routed(fr, sid=None, slo="standard", path="/predict"):
    status, _, _, body = fr.forward_request(
        path, b'{"data": [[1.0]]}', slo, sid,
        {"Content-Type": "application/json",
         "X-Session-Id": sid or ""})
    return status, json.loads(body)


# ---------------------------------------------------------------------------
# consistent-hash ring

def test_hash_ring_distribution_and_minimal_remap():
    ring = _HashRing(vnodes=64)
    assert ring.lookup("anything") is None  # empty ring
    for n in ("a", "b", "c"):
        ring.add(n)
    assert len(ring) == 3 and "b" in ring
    keys = [f"sess-{i}" for i in range(300)]
    owners = {k: ring.lookup(k) for k in keys}
    assert set(owners.values()) == {"a", "b", "c"}, \
        "64 vnodes must spread keys over every replica"
    ring.remove("b")
    for k in keys:
        if owners[k] == "b":
            assert ring.lookup(k) in ("a", "c")
        else:  # the consistent-hash property: survivors keep keys
            assert ring.lookup(k) == owners[k]
    ring.add("b")  # re-join lands the same arcs: pins come back
    assert all(ring.lookup(k) == owners[k] for k in keys)


def test_hash_ring_stable_across_instances():
    """sha-based points: a restarted router re-derives the SAME
    placement (hash() would re-shard every process)."""
    r1, r2 = _HashRing(8), _HashRing(8)
    for n in ("x", "y"):
        r1.add(n)
        r2.add(n)
    assert _hash64("x#0") == _hash64("x#0")
    assert all(r1.lookup(f"k{i}") == r2.lookup(f"k{i}")
               for i in range(64))


# ---------------------------------------------------------------------------
# telemetry: labeled exposition lines

def test_labeled_lines_escaping_and_types():
    rows = [({"replica": 'a"b\\c\nd'}, 1),
            ({"replica": "ok"}, True),       # bool -> int
            ({"replica": "skip"}, "nan?")]   # non-numeric dropped
    lines = tmetrics.labeled_lines("fleet_replica_up", rows, "help")
    text = "\n".join(lines)
    assert '# TYPE mxnet_fleet_replica_up gauge' in text
    assert 'mxnet_fleet_replica_up{replica="a\\"b\\\\c\\nd"} 1' in text
    assert 'mxnet_fleet_replica_up{replica="ok"} 1' in text
    assert "skip" not in text
    assert tmetrics.labeled_lines("empty", []) == []


# ---------------------------------------------------------------------------
# membership + gossip

def test_membership_gossip_and_healthz(fakes):
    a = fakes("a", depth=2, capacity=8)
    b = fakes("b", depth=3, capacity=8)
    fr = _router()
    fr.add_replica("a", a.url)
    fr.add_replica("b", b.url)
    with pytest.raises(ValueError, match="already in fleet"):
        fr.add_replica("a", a.url)
    fr.probe_once()
    assert fr._gossip_depth() == 5
    assert fr._gossip_capacity() == 16
    doc = fr.healthz()
    assert doc["status"] == "ok" and doc["warm"]
    assert doc["queue_depth"] == 5
    assert doc["queue_capacity"] == 16
    assert doc["replicas"]["b"]["state"] == "serving"
    assert doc["replicas"]["b"]["breaker"] == "closed"
    assert fleet_counters()["joins"] == 2
    assert fr.remove("b").name == "b"
    assert "b" not in fr._ring and fr.remove("b") is None


def test_add_replica_unreachable_never_joins():
    fr = _router()
    with pytest.raises(TimeoutError, match="did not warm"):
        fr.add_replica("ghost", "http://127.0.0.1:9",
                       timeout_s=0.3)
    assert fr.replicas() == {}  # a failed join leaves no record


# ---------------------------------------------------------------------------
# stateful affinity + drain migration

def test_stateful_affinity_pins_and_drain_migrates(fakes):
    payload = {"format": 1, "state_shapes": [[6]],
               "state_dtypes": ["float32"], "sessions": {}}
    a = fakes("a", export=payload)
    b = fakes("b", export={**payload, "sessions": {}})
    fr = _router()
    fr.add_replica("a", a.url)
    fr.add_replica("b", b.url)
    sids = [f"s{i}" for i in range(8)]
    homes = {}
    for sid in sids:
        status, doc = _routed(fr, sid=sid)
        assert status == 200
        homes[sid] = doc["replica"]
        for _ in range(3):  # affinity: every step lands on the pin
            assert _routed(fr, sid=sid)[1]["replica"] == homes[sid]
    assert set(homes.values()) == {"a", "b"}
    # drain a: its pinned sessions migrate to b, dense-row form
    a_sids = [s for s in sids if homes[s] == "a"]
    a.export = {**payload,
                "sessions": {s: {"steps": 4, "states": [[0.0] * 6]}
                             for s in a_sids}}
    moved = fr.drain("a")
    assert moved == len(a_sids)
    assert [sorted(p["sessions"]) for p in b.restored] == \
        [sorted(a_sids)]
    assert sorted(fr.replicas()) == ["b"]
    for sid in sids:  # every stream (moved or not) now steps on b
        assert _routed(fr, sid=sid)[1]["replica"] == "b"
    c = fleet_counters()
    assert c["drains"] == 1
    assert c["drained_sessions"] == len(a_sids)
    assert c["affinity_moves"] >= len(a_sids)
    assert c["transport_errors"] == 0


def test_drain_without_peer_restores_the_replica(fakes):
    payload = {"format": 1, "state_shapes": [[2]],
               "state_dtypes": ["float32"],
               "sessions": {"u": {"steps": 1, "states": [[0.0, 0.0]]}}}
    a = fakes("a", export=payload)
    fr = _router()
    fr.add_replica("a", a.url)
    assert _routed(fr, sid="u")[0] == 200
    with pytest.raises(RuntimeError, match="no serving peer"):
        fr.drain("a")
    # failed drain is a no-op: state never left the replica
    assert fr.replicas()["a"]["state"] == "serving"
    assert "a" in fr._ring
    assert _routed(fr, sid="u")[1]["replica"] == "a"
    with pytest.raises(KeyError):
        fr.drain("nope")


def test_stateful_requests_park_through_a_drain(fakes):
    a = fakes("a")
    b = fakes("b")
    fr = _router(drain_timeout_ms=5000.0)
    fr.add_replica("a", a.url)
    fr.add_replica("b", b.url)
    sid = next(s for s in (f"s{i}" for i in range(64))
               if _routed(fr, sid=s)[1]["replica"] == "a")
    rep = fr._replicas["a"]
    with fr._lock:  # freeze mid-drain without timing games
        rep.state = "draining"
        ev = fr._drain_events["a"] = threading.Event()
    out = {}

    def _step():
        out["reply"] = _routed(fr, sid=sid)

    t = threading.Thread(target=_step)
    t.start()
    deadline = time.monotonic() + 5.0
    while fleet_counters()["blocked_on_drain"] < 1:
        assert time.monotonic() < deadline, "request never parked"
        time.sleep(0.01)
    assert "reply" not in out  # parked, not failed
    with fr._lock:  # migration lands the pin on b, drain completes
        fr._sessions[sid] = "b"
        rep.state = "left"
        fr._replicas.pop("a")
        fr._drain_events.pop("a")
    ev.set()
    t.join(timeout=5)
    assert out["reply"][0] == 200
    assert out["reply"][1]["replica"] == "b"
    assert fleet_counters()["drain_timeouts"] == 0


def test_parked_request_times_out_503(fakes):
    a = fakes("a")
    fr = _router(drain_timeout_ms=100.0)
    fr.add_replica("a", a.url)
    sid = "stuck"
    assert _routed(fr, sid=sid)[0] == 200
    with fr._lock:
        fr._replicas["a"].state = "draining"
        fr._drain_events["a"] = threading.Event()  # never set
    status, doc = _routed(fr, sid=sid)
    assert status == 503 and "draining" in doc["error"]
    assert fleet_counters()["drain_timeouts"] == 1


# ---------------------------------------------------------------------------
# stateless routing: least-loaded, retry, ejection, recovery

def test_stateless_least_loaded_and_transport_retry(fakes):
    a = fakes("a", depth=5)
    b = fakes("b", depth=0)
    fr = _router(retries=2)
    fr.add_replica("a", a.url)
    fr.add_replica("b", b.url)
    fr.probe_once()
    assert _routed(fr)[1]["replica"] == "b"  # least gossiped depth
    b.stop()  # transport failure -> bounded cross-replica retry
    status, doc = _routed(fr)
    assert status == 200 and doc["replica"] == "a"
    c = fleet_counters()
    assert c["retries"] == 1 and c["transport_errors"] == 1
    a.stop()  # both down: excluded-then-empty pool answers 503
    status, doc = _routed(fr)
    assert status == 503
    assert "unreachable" in doc["error"] or "no serving" in doc["error"]


def test_probe_ejection_and_recovery(fakes):
    a = fakes("a")
    b = fakes("b")
    fr = _router()
    fr.add_replica("a", a.url)
    fr.add_replica("b", b.url)
    a.stop()
    for _ in range(5):  # breaker threshold (default 5)
        fr.probe_once()
    snap = fr.replicas()["a"]
    assert snap["state"] == "ejected"
    assert "a" not in fr._ring and "b" in fr._ring
    assert fleet_counters()["ejections"] == 1
    assert fr.healthz()["status"] == "degraded"
    for _ in range(4):  # ejected replica takes no traffic
        assert _routed(fr)[1]["replica"] == "b"
    # the process comes back: the next successful probe rejoins it
    revived = _FakeReplica("a")
    try:
        with fr._lock:  # re-point the record (same name, new port)
            fr._replicas["a"].url = revived.url
        fr.probe_once()
        assert fr.replicas()["a"]["state"] == "serving"
        assert "a" in fr._ring
        assert fleet_counters()["recoveries"] == 1
    finally:
        revived.stop()


def test_fleet_admission_sheds_standard_not_critical(fakes):
    a = fakes("a", depth=8, capacity=8)  # gossiped queue full
    fr = _router()
    fr.add_replica("a", a.url)
    fr.probe_once()
    from mxnet_tpu_torch.serving import ShedLoad

    with pytest.raises(ShedLoad):
        fr.forward_request("/predict", b"{}", "standard", None, {})
    assert _routed(fr, slo="critical")[0] == 200  # never shed


# ---------------------------------------------------------------------------
# fleet canary: shadow gate, rollback, client never sees it

def test_canary_shadow_mismatch_rolls_back(fakes):
    inc = fakes("inc", outputs=[[1.0, 1.0]])
    bad = fakes("bad", outputs=[[100.0, -3.0]])
    fr = _router(canary_fraction=1.0, canary_threshold=1,
                 shadow_tol=0.1)
    fr.add_replica("inc", inc.url)
    fr.add_replica("bad", bad.url, canary=True)
    for _ in range(6):
        status, doc = _routed(fr)
        assert status == 200
        assert doc["replica"] == "inc", \
            "client answers must come from the incumbent"
    assert not fr.canary_active
    c = fleet_counters()
    assert c["shadow_checks"] >= 1
    assert c["shadow_mismatches"] >= 1
    assert c["canary_rollbacks"] == 1
    assert c["canary_requests"] == 1, \
        "rollback must stop shadow traffic immediately"


def test_canary_agreement_serves_and_critical_skips_it(fakes):
    inc = fakes("inc", outputs=[[1.0, 2.0]])
    good = fakes("good", outputs=[[1.0, 2.0]])
    fr = _router(canary_fraction=1.0, canary_threshold=1,
                 shadow_tol=0.1)
    fr.add_replica("inc", inc.url)
    fr.add_replica("good", good.url, canary=True)
    assert _routed(fr)[1]["replica"] == "good", \
        "an agreeing canary's reply is the promoted answer"
    assert fr.canary_active
    before = fleet_counters()["canary_requests"]
    assert _routed(fr, slo="critical")[1]["replica"] == "inc"
    assert fleet_counters()["canary_requests"] == before, \
        "critical traffic never routes through the canary pair"


# ---------------------------------------------------------------------------
# the router's own HTTP surface + prometheus exposition

def test_router_http_surface_and_metrics(fakes):
    a = fakes("a")
    fr = _router().start()
    fr.add_replica("a", a.url)
    base = fr.address
    with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
        doc = json.loads(r.read())
    assert r.status == 200 and doc["role"] == "router"
    assert doc["replicas"]["a"]["state"] == "serving"
    req = urllib.request.Request(
        base + "/predict", data=b'{"data": [[1.0]]}',
        headers={"Content-Type": "application/json",
                 "X-Request-Id": "trace-42"})
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.headers["X-Request-Id"] == "trace-42", \
            "trace ids must propagate router -> client"
        assert json.loads(r.read())["replica"] == "a"
    assert a.predicts == 1
    with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
        text = r.read().decode()
    assert "mxnet_fleet_requests 1" in text
    assert 'mxnet_fleet_replica_up{replica="a"} 1' in text
    assert 'mxnet_fleet_replica_state{canary="false",replica="a",' \
        'state="serving"} 1' in text
    assert text.count("# TYPE mxnet_fleet gauge") == 1, \
        "the exposition block must replace the flat gauge pass"
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(base + "/nope", timeout=10)
    assert ei.value.code == 404
    bad = urllib.request.Request(
        base + "/predict", data=b'{"slo_class": "warp-speed"}',
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(bad, timeout=10)
    assert ei.value.code == 400




# ---------------------------------------------------------------------------
# the port against the JAX package

def test_hash64_and_ring_lookups_equal_jax_over_10000_keys():
    keys = [f"session-{i}" for i in range(10000)]
    assert [_hash64(k) for k in keys[:500]] == \
        [jfleet._hash64(k) for k in keys[:500]]
    ring, jring = _HashRing(64), jfleet._HashRing(64)
    for n in ("r0", "r1", "r2", "r3"):
        ring.add(n)
        jring.add(n)
    owners = [ring.lookup(k) for k in keys]
    assert owners == [jring.lookup(k) for k in keys]
    assert set(owners) == {"r0", "r1", "r2", "r3"}
    ring.remove("r2")
    jring.remove("r2")
    moved = [k for k, o in zip(keys, owners) if ring.lookup(k) != o]
    assert moved == [k for k, o in zip(keys, owners)
                     if jring.lookup(k) != o]
    # only the leaver's keys move
    assert moved == [k for k, o in zip(keys, owners) if o == "r2"]


def _sequence(cls, counters, make_fake):
    """One request sequence through a router of ``cls``: stateful
    streams pinned and stepped, stateless requests, a drain of "a"
    with its sessions migrated, a parked request released by the drain,
    and steps after it. Returns (replica of each reply, restored
    payloads on b, the fleet counters)."""
    payload = {"format": 1, "state_shapes": [[4]],
               "state_dtypes": ["float32"], "sessions": {}}
    a = make_fake("a", export=dict(payload), depth=0)
    b = make_fake("b", export=dict(payload), depth=3)
    fr = _router(cls, drain_timeout_ms=5000.0)
    fr.add_replica("a", a.url)
    fr.add_replica("b", b.url)
    fr.probe_once()
    seen = []
    sids = [f"s{i}" for i in range(12)]
    for rnd in range(3):
        for sid in sids:
            seen.append(_routed(fr, sid=sid)[1]["replica"])
        seen.append(_routed(fr)[1]["replica"])  # least-loaded: a
    a_sids = sorted(s for s, r in fr._sessions.items() if r == "a")
    a.export = {**payload, "sessions": {
        s: {"steps": 3, "states": [[0.5] * 4]} for s in a_sids}}
    moved = fr.drain("a")
    assert moved == len(a_sids)
    for sid in sids:
        seen.append(_routed(fr, sid=sid)[1]["replica"])
    return seen, [sorted(p["sessions"]) for p in b.restored], counters()


def test_two_routers_make_the_same_choices_and_counts(fakes):
    port = _sequence(FleetRouter, fleet_counters, fakes)
    jax = _sequence(jfleet.FleetRouter, jfleet.fleet_counters, fakes)
    assert port[0] == jax[0]
    assert port[1] == jax[1] and port[1][0]
    assert port[2] == jax[2]
    assert port[2]["drained_sessions"] == len(port[1][0])


def _park_sequence(cls, counters, make_fake):
    """A stateful request parked on a replica mid-drain, released when
    the drain lands its pin on b; a second parked past its deadline."""
    a = make_fake("a")
    b = make_fake("b")
    fr = _router(cls, drain_timeout_ms=3000.0)
    fr.add_replica("a", a.url)
    fr.add_replica("b", b.url)
    sid = next(s for s in (f"s{i}" for i in range(64))
               if _routed(fr, sid=s)[1]["replica"] == "a")
    rep = fr._replicas["a"]
    with fr._lock:
        rep.state = "draining"
        ev = fr._drain_events["a"] = threading.Event()
    out = {}
    t = threading.Thread(target=lambda: out.update(r=_routed(fr, sid=sid)))
    t.start()
    deadline = time.monotonic() + 5.0
    while counters()["blocked_on_drain"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with fr._lock:
        fr._sessions[sid] = "b"
        rep.state = "left"
        fr._replicas.pop("a")
        fr._drain_events.pop("a")
    ev.set()
    t.join(timeout=5)
    return out["r"][1]["replica"], counters()


def test_two_routers_park_the_same_sessions(fakes):
    port = _park_sequence(FleetRouter, fleet_counters, fakes)
    jax = _park_sequence(jfleet.FleetRouter, jfleet.fleet_counters, fakes)
    assert port == jax
    assert port[0] == "b" and port[1]["blocked_on_drain"] == 1


# ---------------------------------------------------------------------------
# two real replicas on the CPU, a drain mid-stream

DECODE = dict(kind="decode", cfg=dict(vocab_size=40, embed_dim=16,
                                      num_layers=2, num_heads=2, max_len=32),
              seed=7, rows=8, buckets=[1, 2, 4, 8], page_tokens=4,
              budget=0, ctx="cpu")


def _step(port, sid, tok):
    import io

    buf = io.BytesIO()
    onp.save(buf, onp.array([[tok]], "int32"))
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npy", "X-Session-Id": sid})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return onp.load(io.BytesIO(resp.read()), allow_pickle=False)


def test_two_real_replicas_drain_mid_stream(tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.serving import spawn_replica
    from mxnet_tpu_torch.tools import deploy_chain as dc

    env = {"DEPLOY_CHAIN_SPEC": json.dumps(DECODE),
           "MXNET_HOME": str(tmp_path / "home")}
    procs = {}
    threads = [threading.Thread(target=lambda n=n: procs.update(
        {n: spawn_replica(f"{dc.__name__}:decode_replica", env=env,
                          timeout_s=180)})) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fr = _router().start()
    try:
        for n in ("a", "b"):
            fr.add_replica(n, procs[n].url, process=procs[n])
        rs = onp.random.RandomState(3)
        sids = [f"t{i}" for i in range(6)]
        first = {s: int(rs.randint(40)) for s in sids}
        tok, got, pins = dict(first), {s: [] for s in sids}, []
        live_a = moved = None
        for k in range(8):
            if k == 4:
                live_a = sum(v == "a" for v in fr._sessions.values())
                moved = fr.drain("a")
            for s in sids:
                out = _step(fr.port, s, tok[s])[0]
                got[s].append(out)
                tok[s] = int(out.argmax())
            pins.append(dict(fr._sessions))
        assert moved == live_a and live_a > 0
        assert fleet_counters()["drained_sessions"] == live_a
        for s in sids:  # one home until the drain, b after it
            assert len({p[s] for p in pins[:4]}) == 1
            assert all(p[s] == "b" for p in pins[4:])
    finally:
        fr.stop(stop_replicas=True)
    sess = dc.build_session(DECODE, mx.cpu())
    for s in sids:
        toks, ref = dc.greedy_decode(sess, [first[s]], 8)
        assert [int(g.argmax()) for g in got[s]] == toks[0].tolist()
        onp.testing.assert_allclose(onp.stack(got[s]), ref[0], rtol=0,
                                    atol=1e-5)
    sess.close()
