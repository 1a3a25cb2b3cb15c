"""Replica fleet behind one front door: consistent-hash routing,
bundle-warm replicas and live-session drain.

The PyTorch counterpart of ``mxnet_tpu/serving/fleet.py``, stdlib only.
A :class:`FleetRouter` owns the client-facing HTTP surface and fans out
to N replica servers (:class:`~.server.ModelServer`, each over one
session):

- **Consistent-hash session affinity.** A decode stream's state lives
  in ONE replica's state store, so every step of a stream lands on the
  replica holding it: session ids hash onto a ring of
  ``MXNET_FLEET_VNODES`` virtual nodes per replica (:func:`_hash64`,
  :class:`_HashRing`, the JAX package's, point for point); the first
  routed step pins ``sid -> replica``, and a drain moves pins without
  moving hashes. Stateless requests go to the least-loaded serving
  replica (its gossiped queue depth), with bounded cross-replica retry
  on a transport failure.
- **Fleet-wide SLO admission**: the serving admission ladder
  (:class:`~.admission.AdmissionController`) over the aggregate queue
  depth gossiped from each replica's ``/healthz``.
- **Lifecycle.** *Join*: :func:`spawn_replica` starts a replica process
  that imports a bundle (``artifact.import_bundle``) before its
  ``warmup()``, so it builds no kernel library and runs no graph
  optimizer (it still captures its CUDA graphs); the router probes
  ``/healthz`` until it is warm before it enters the ring. *Drain*: stop
  routing to it (its sessions' requests park at the router), wait for
  its queue to empty, move its live decode state to the ring successors
  through ``/admin/export_state`` and ``/admin/restore_state`` (dense
  rows, which cross page geometries and int8 stores), re-pin, release
  the parked requests. *Eject*: a replica whose probe breaker
  (:class:`~..resilience.breaker.CircuitBreaker`) opens leaves the ring
  until a probe succeeds.
- **Fleet canary**: ``MXNET_SERVING_CANARY_FRACTION`` of non-critical
  stateless traffic also runs on a canary replica as a shadow pair; the
  canary's answer replaces the incumbent's only when it agrees within
  ``MXNET_QUANTIZE_SHADOW_TOL``; the canary breaker leaving "closed"
  rolls all traffic back.

Several replicas may share one card: each is its own process with its
own CUDA context. The replica child does not pin the CPU (the JAX
package's child sets ``JAX_PLATFORMS=cpu``): it runs where its factory
builds its session, on the card unless the factory asks for the CPU.

Observability: the ``fleet`` counter family (the JAX package's 22
counters) and per-replica labeled series ride ``/metrics``;
``X-Request-Id`` trace ids propagate router -> replica.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import logging
import os
import pickle
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref
from http.server import BaseHTTPRequestHandler

from ..resilience.breaker import CircuitBreaker
from ..telemetry import metrics as _tmetrics
from ..telemetry import tracer as _telem
from ..utils import locks as _locks
from .admission import AdmissionController, ShedLoad, normalize_class
from .repository import _rel_deviation
from .server import HTTPServer

__all__ = ["FleetRouter", "Replica", "ReplicaProcess", "spawn_replica",
           "fleet_counters", "reset_fleet_counters"]

_MAX_BODY = 64 * 1024 * 1024  # matches the replica-side bound

#: fleet router counters (telemetry registry: ride profiler.dump() and
#: the unified /metrics exposition)
_FLEET = _tmetrics.counter_family("fleet", {
    "requests": 0,          # POSTs reaching the router's routing logic
    "routed": 0,            # replies served from a replica
    "shed": 0,              # fleet-wide admission 503s
    "no_replica": 0,        # 503: no serving replica available
    "retries": 0,           # stateless re-route after transport failure
    "transport_errors": 0,  # failed replica connections (request path)
    "blocked_on_drain": 0,  # stateful requests parked on a drain event
    "drain_timeouts": 0,    # parked requests that gave up (503)
    "joins": 0, "ejections": 0, "recoveries": 0, "probes": 0,
    "drains": 0, "drained_sessions": 0, "affinity_moves": 0,
    "canary_requests": 0, "canary_fallbacks": 0,
    "shadow_checks": 0, "shadow_mismatches": 0, "canary_rollbacks": 0})

#: live routers for the per-replica exposition (weak: a dropped router
#: must not be kept alive by /metrics)
_ROUTERS = weakref.WeakSet()


def fleet_counters():
    return dict(_FLEET.snapshot())


def reset_fleet_counters():
    _FLEET.reset()


class _TransportError(Exception):
    """A replica connection failed (refused/reset/timeout) — distinct
    from an HTTP error status, which is a ROUTED reply to pass
    through."""


# -- consistent-hash ring ---------------------------------------------------


def _hash64(key):
    """Stable 64-bit point on the ring (sha256 prefix — NOT ``hash()``,
    which is salted per process and would re-shard every restart)."""
    return int.from_bytes(
        hashlib.sha256(key.encode("utf-8")).digest()[:8], "big")


class _HashRing:
    """Consistent-hash ring with virtual nodes. ``vnodes`` points per
    replica smooth the key distribution; adding or removing one
    replica only remaps the keys that hashed to its arcs (the
    property that makes join/drain cheap). Not thread-safe — the
    router serializes access under its lock."""

    def __init__(self, vnodes):
        self._vnodes = max(int(vnodes), 1)
        self._points = []  # sorted [(point, name)]
        self._names = set()

    def add(self, name):
        if name in self._names:
            return
        self._names.add(name)
        for i in range(self._vnodes):
            bisect.insort(self._points, (_hash64(f"{name}#{i}"), name))

    def remove(self, name):
        if name not in self._names:
            return
        self._names.discard(name)
        self._points = [p for p in self._points if p[1] != name]

    def __contains__(self, name):
        return name in self._names

    def __len__(self):
        return len(self._names)

    def lookup(self, key):
        """The replica owning ``key``: first ring point clockwise from
        the key's hash (wrapping). None on an empty ring."""
        if not self._points:
            return None
        i = bisect.bisect_right(self._points,
                                (_hash64(key), "\uffff"))
        return self._points[i % len(self._points)][1]


# -- replica record ---------------------------------------------------------


class Replica:
    """Router-side record of one replica: address, lifecycle state
    (``joining -> serving -> draining -> left``, with ``ejected`` as
    the probe-breaker detour), the last gossiped health document, and
    the per-replica probe breaker. Mutated only under the router
    lock."""

    __slots__ = ("name", "url", "canary", "state", "breaker", "health",
                 "warm", "depth", "capacity", "requests", "process")

    def __init__(self, name, url, canary=False, process=None):
        self.name = name
        self.url = url.rstrip("/")
        self.canary = bool(canary)
        self.state = "joining"
        self.breaker = CircuitBreaker(name=f"fleet.{name}")
        self.health = {}
        self.warm = False
        self.depth = 0
        self.capacity = 1
        self.requests = 0
        self.process = process  # optional ReplicaProcess (owned)

    def snapshot(self):
        return {"name": self.name, "url": self.url,
                "canary": self.canary, "state": self.state,
                "warm": self.warm, "queue_depth": self.depth,
                "queue_capacity": self.capacity,
                "requests": self.requests,
                "breaker": self.breaker.state}


class _FleetLoad:
    """Quacks like the batcher slice ``AdmissionController`` reads —
    aggregate gossiped queue depth/capacity over serving replicas.
    ``session`` stays None: slot headroom is a per-replica concern
    (each replica's own admission already folds it in)."""

    session = None

    def __init__(self, router):
        self._router = router

    def qsize(self):
        return self._router._gossip_depth()

    def queue_capacity(self):
        return self._router._gossip_capacity()


# -- the router -------------------------------------------------------------


class FleetRouter:
    """The fleet's front door: one HTTP listener fanning out to N
    replicas. ``port=0`` binds an ephemeral port (tests); read it
    back via ``.port`` after ``start()``. Replicas enter via
    :meth:`add_replica` (optionally spawned by :func:`spawn_replica`)
    and leave via :meth:`drain` (graceful, migrates live sessions) or
    :meth:`remove` (immediate)."""

    def __init__(self, host=None, port=None, *, vnodes=None,
                 probe_ms=None, retries=None, timeout_ms=None,
                 drain_timeout_ms=None, canary_fraction=None,
                 shadow_tol=None, canary_threshold=None):
        from .. import env as _env

        self._host = host if host is not None else _env.get_str(
            "MXNET_SERVING_HOST", "127.0.0.1")
        self._port = int(port if port is not None else 0)
        self._probe_s = float(
            probe_ms if probe_ms is not None else
            _env.get_float("MXNET_FLEET_PROBE_MS", 100.0)) / 1e3
        self._retries = int(
            retries if retries is not None else
            _env.get_int("MXNET_FLEET_RETRIES", 2))
        self._timeout_s = float(
            timeout_ms if timeout_ms is not None else
            _env.get_float("MXNET_FLEET_TIMEOUT_MS", 30000.0)) / 1e3
        self._drain_timeout_s = float(
            drain_timeout_ms if drain_timeout_ms is not None else
            _env.get_float("MXNET_FLEET_DRAIN_TIMEOUT_MS",
                           10000.0)) / 1e3
        self._canary_fraction = float(
            canary_fraction if canary_fraction is not None else
            _env.get_float("MXNET_SERVING_CANARY_FRACTION", 0.1))
        self._shadow_tol = float(
            shadow_tol if shadow_tol is not None else
            _env.get_float("MXNET_QUANTIZE_SHADOW_TOL", 0.1))
        # guards: _replicas, _ring, _sessions, _tick, _drain_events,
        # guards: _canary_active
        self._lock = _locks.RankedLock("serving.fleet")
        self._replicas = {}      # name -> Replica
        self._ring = _HashRing(
            vnodes if vnodes is not None else
            _env.get_int("MXNET_FLEET_VNODES", 64))
        self._sessions = {}      # sid -> replica name (affinity pins)
        self._tick = 0           # canary counter-routing clock
        self._drain_events = {}  # name -> Event (set when drain done)
        self._canary_active = True
        self._canary_breaker = CircuitBreaker(
            threshold=(canary_threshold if canary_threshold is not None
                       else _env.get_int(
                           "MXNET_SERVING_CANARY_THRESHOLD", 3)),
            name="fleet.canary")
        self._admission = AdmissionController(_FleetLoad(self))
        self._httpd = None
        self._thread = None
        self._probe_stop = threading.Event()
        self._probe_thread = None
        _ROUTERS.add(self)

    # -- lifecycle -----------------------------------------------------

    def start(self):
        """Bind, serve, and start the gossip probe loop; returns
        self."""
        if self._httpd is not None:
            return self
        router = self

        class _Handler(_FleetHandler):
            fleet = router

        self._httpd = HTTPServer((self._host, self._port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mxnet-fleet-router", daemon=True)
        self._thread.start()
        self._probe_stop.clear()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="mxnet-fleet-probe",
            daemon=True)
        self._probe_thread.start()
        return self

    @property
    def port(self):
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    @property
    def address(self):
        return f"http://{self._host}:{self.port}"

    def stop(self, stop_replicas=False):
        """Stop probing and listening. Replica processes the router
        spawned are stopped only with ``stop_replicas=True`` — by
        default the caller owns them."""
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join()
            self._probe_thread = None
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._admission.close()
        if stop_replicas:
            with self._lock:
                procs = [r.process for r in self._replicas.values()
                         if r.process is not None]
            for proc in procs:
                proc.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- membership ----------------------------------------------------

    def add_replica(self, name, url, canary=False, process=None,
                    wait_warm=True, timeout_s=120.0):
        """Join ``url`` to the fleet as ``name``. With ``wait_warm``
        (default) the call blocks until the replica's ``/healthz``
        answers 200+warm — a cold replica never enters the ring, so
        clients never eat its compiles."""
        rep = Replica(name, url, canary=canary, process=process)
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already in fleet")
            self._replicas[name] = rep  # joining: visible, unrouted
        if wait_warm:
            try:
                self._wait_warm(rep, timeout_s)
            except BaseException:
                with self._lock:
                    self._replicas.pop(name, None)
                raise
        with self._lock:
            rep.state = "serving"
            self._ring.add(name)
        _FLEET.add("joins")
        return rep

    def _wait_warm(self, rep, timeout_s):
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                status, doc = self._http_health(rep)
            except _TransportError:
                status, doc = None, {}
            if status == 200 and doc.get("warm"):
                with self._lock:
                    rep.health = doc
                    rep.warm = True
                    rep.depth = int(doc.get("queue_depth", 0) or 0)
                    rep.capacity = max(
                        int(doc.get("queue_capacity", 1) or 1), 1)
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"replica {rep.name!r} at {rep.url} did not warm "
                    f"within {timeout_s:.0f}s (last status {status})")
            time.sleep(0.05)

    def remove(self, name):
        """Immediate removal (no migration — use :meth:`drain` for
        graceful). Pinned sessions re-pin by ring on their next step
        (their server-side state is gone: the stream restarts)."""
        with self._lock:
            rep = self._replicas.pop(name, None)
            if rep is None:
                return None
            self._ring.remove(name)
            rep.state = "left"
            ev = self._drain_events.pop(name, None)
        if ev is not None:
            ev.set()
        return rep

    def replicas(self):
        with self._lock:
            return {n: r.snapshot() for n, r in self._replicas.items()}

    # -- gossip / probe loop -------------------------------------------

    def _probe_loop(self):
        while not self._probe_stop.wait(self._probe_s):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — probe loop must survive
                logging.exception("fleet: probe loop error")

    def probe_once(self):
        """One gossip round: GET every replica's ``/healthz``; update
        depth/warm, feed the per-replica breaker, eject on open,
        recover on a successful probe. Public so tests drive gossip
        deterministically without the timer."""
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.state in ("joining", "serving", "draining",
                                   "ejected")]
        for rep in reps:
            _FLEET.add("probes")
            try:
                status, doc = self._http_health(rep)
            except _TransportError:
                rep.breaker.record_failure()
                with self._lock:
                    if rep.state == "serving" and \
                            rep.breaker.state != "closed":
                        self._eject_locked(rep)
                continue
            # any HTTP answer (200 warm, 503 warming) is a live
            # process: reset the breaker
            rep.breaker.record_success()
            with self._lock:
                rep.health = doc
                rep.warm = bool(doc.get("warm"))
                rep.depth = int(doc.get("queue_depth", 0) or 0)
                rep.capacity = max(
                    int(doc.get("queue_capacity",
                                rep.capacity) or 1), 1)
                if rep.state == "ejected":
                    rep.state = "serving"
                    self._ring.add(rep.name)
                    _FLEET.add("recoveries")
                    logging.warning("fleet: replica %s recovered",
                                    rep.name)

    def _eject_locked(self, rep):
        rep.state = "ejected"
        self._ring.remove(rep.name)
        _FLEET.add("ejections")
        logging.warning(
            "fleet: ejected replica %s (probe breaker %s)",
            rep.name, rep.breaker.state)

    def _gossip_depth(self):
        with self._lock:
            return sum(r.depth for r in self._replicas.values()
                       if r.state == "serving")

    def _gossip_capacity(self):
        with self._lock:
            caps = [r.capacity for r in self._replicas.values()
                    if r.state == "serving"]
        return sum(caps) if caps else 1

    # -- drain (graceful leave with live-session migration) ------------

    def drain(self, name, timeout_s=None):
        """Gracefully remove ``name``: stop routing new work to it
        (requests for its pinned sessions PARK at the router), wait
        for its queue to empty, export its live decode state, restore
        each session onto its ring successor (dense-row form — the
        peer may run a different page geometry), re-pin, release the
        parked requests, and drop the replica. Returns the number of
        sessions migrated. On any failure the replica is restored to
        serving — its state never left it, so nothing is lost."""
        timeout = timeout_s if timeout_s is not None else \
            self._drain_timeout_s
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                raise KeyError(f"no replica {name!r} in fleet")
            if rep.state != "serving":
                raise ValueError(
                    f"replica {name!r} is {rep.state}, not serving")
            rep.state = "draining"
            self._ring.remove(name)
            ev = self._drain_events[name] = threading.Event()
        _FLEET.add("drains")
        try:
            moved = self._migrate(rep, timeout)
        except BaseException:
            with self._lock:
                rep.state = "serving"
                self._ring.add(name)
                self._drain_events.pop(name, None)
            ev.set()  # parked requests resume against the same pin
            raise
        with self._lock:
            rep.state = "left"
            self._replicas.pop(name, None)
            self._drain_events.pop(name, None)
        ev.set()
        logging.info("fleet: drained replica %s (%d sessions moved)",
                     name, moved)
        return moved

    def _migrate(self, rep, timeout):
        deadline = time.monotonic() + timeout
        # 1) the router is the only ingress, so once marked draining
        # no new work arrives; wait for in-flight work to finish
        while True:
            try:
                status, doc = self._http_health(rep)
            except _TransportError as e:
                raise RuntimeError(
                    f"drain: replica {rep.name} unreachable: {e}") \
                    from e
            if int(doc.get("queue_depth", 0) or 0) == 0:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"drain: replica {rep.name} queue did not empty "
                    f"within {timeout:.1f}s")
            time.sleep(0.02)
        # 2) export the live decode state
        status, _, _, body = self._forward(
            rep, "GET", "/admin/export_state", None, {})
        if status == 409:
            return 0  # stateless replica: nothing to migrate
        if status != 200:
            raise RuntimeError(
                f"drain: export_state on {rep.name} answered {status}")
        payload = pickle.loads(body)
        sessions = payload.get("sessions", {})
        if not sessions:
            return 0
        # 3) partition by ring successor (the ring already excludes
        # the drainee) and restore each shard onto its new home
        with self._lock:
            shards = {}
            for sid in sessions:
                tname = self._ring.lookup(sid)
                target = self._replicas.get(tname) \
                    if tname is not None else None
                if target is None or target.state != "serving":
                    raise RuntimeError(
                        "drain: no serving peer to migrate live "
                        "sessions to")
                shards.setdefault(tname, []).append(sid)
            targets = {n: self._replicas[n] for n in shards}
        moved = 0
        for tname, sids in shards.items():
            sub = {"format": payload.get("format", 1),
                   "state_shapes": payload.get("state_shapes"),
                   "state_dtypes": payload.get("state_dtypes"),
                   "sessions": {sid: sessions[sid] for sid in sids}}
            data = pickle.dumps(sub,
                                protocol=pickle.HIGHEST_PROTOCOL)
            status, _, _, rbody = self._forward(
                targets[tname], "POST", "/admin/restore_state", data,
                {"Content-Type": "application/octet-stream"})
            if status != 200:
                raise RuntimeError(
                    f"drain: restore_state on {tname} answered "
                    f"{status}: {rbody[:200]!r}")
            moved += int(json.loads(rbody).get("restored", 0))
            with self._lock:
                for sid in sids:
                    self._sessions[sid] = tname
                    _FLEET.add("affinity_moves")
        _FLEET.add("drained_sessions", moved)
        return moved

    # -- request routing -----------------------------------------------

    def forward_request(self, path, body, slo_class, session_id,
                        headers):
        """Route one client POST. Raises
        :class:`~.admission.ShedLoad` (handler maps
        to 503 + Retry-After); otherwise returns the replica reply as
        ``(status, content_type, extra_headers, body)``."""
        _FLEET.add("requests")
        self._admission.check(slo_class)
        if session_id is not None:
            return self._route_stateful(path, body, headers,
                                        session_id)
        return self._route_stateless(path, body, headers, slo_class)

    def _route_stateful(self, path, body, headers, sid):
        """Affinity routing: the stream's state lives on exactly one
        replica. No cross-replica retry — a transport failure is a
        503 (the probe loop will eject the replica; the client
        restarts its stream, which then re-pins by ring)."""
        deadline = time.monotonic() + self._drain_timeout_s
        while True:
            ev = None
            target = None
            with self._lock:
                pinned = self._sessions.get(sid)
                rep = self._replicas.get(pinned) \
                    if pinned is not None else None
                if rep is not None and rep.state == "serving":
                    target = rep
                elif rep is not None and rep.state == "draining":
                    ev = self._drain_events.get(pinned)
                if target is None and ev is None:
                    # unpinned, or the pinned replica is gone: (re-)
                    # place by ring
                    tname = self._ring.lookup(sid)
                    cand = self._replicas.get(tname) \
                        if tname is not None else None
                    if cand is not None and cand.state == "serving":
                        if pinned is not None and pinned != tname:
                            _FLEET.add("affinity_moves")
                        self._sessions[sid] = tname
                        target = cand
                if target is not None:
                    target.requests += 1
            if target is not None:
                try:
                    reply = self._forward(target, "POST", path, body,
                                          headers)
                except _TransportError as e:
                    _FLEET.add("transport_errors")
                    target.breaker.record_failure()
                    return (503, "application/json", {},
                            json.dumps({
                                "error": f"replica {target.name} "
                                         f"unreachable: {e}",
                                "request_id": headers.get(
                                    "X-Request-Id"),
                                "retry_after_s": 0.1}).encode())
                target.breaker.record_success()
                _FLEET.add("routed")
                return reply
            if ev is not None:
                # the stream's home is mid-drain: park until its
                # state lands on the successor, then re-resolve
                _FLEET.add("blocked_on_drain")
                if not ev.wait(max(deadline - time.monotonic(), 0.0)):
                    _FLEET.add("drain_timeouts")
                    return (503, "application/json", {},
                            json.dumps({
                                "error": "session home is draining; "
                                         "retry",
                                "request_id": headers.get(
                                    "X-Request-Id"),
                                "retry_after_s": 0.1}).encode())
                continue
            _FLEET.add("no_replica")
            return (503, "application/json", {},
                    json.dumps({
                        "error": "no serving replica in fleet",
                        "request_id": headers.get("X-Request-Id"),
                        "retry_after_s": 0.5}).encode())

    def _route_stateless(self, path, body, headers, slo_class):
        """Least-loaded routing with bounded cross-replica retry on
        transport failure, plus canary counter-routing."""
        canary_rep = None
        if slo_class != "critical":
            with self._lock:
                if self._canary_active and self._canary_fraction > 0:
                    canaries = [r for r in self._replicas.values()
                                if r.canary and r.state == "serving"]
                    if canaries:
                        # deterministic counter routing: exactly
                        # fraction f of ticks flip the bucket
                        self._tick += 1
                        f = min(self._canary_fraction, 1.0)
                        if int(self._tick * f) != \
                                int((self._tick - 1) * f):
                            canary_rep = min(
                                canaries,
                                key=lambda r: (r.depth, r.name))
        excluded = set()
        for attempt in range(self._retries + 1):
            with self._lock:
                pool = [r for r in self._replicas.values()
                        if r.state == "serving" and not r.canary and
                        r.name not in excluded]
                if not pool:  # canary-only fleet: better than a 503
                    pool = [r for r in self._replicas.values()
                            if r.state == "serving" and
                            r.name not in excluded]
                rep = min(pool, key=lambda r: (r.depth, r.name)) \
                    if pool else None
                if rep is not None:
                    rep.requests += 1
            if rep is None:
                _FLEET.add("no_replica")
                return (503, "application/json", {},
                        json.dumps({
                            "error": "no serving replica in fleet",
                            "request_id": headers.get("X-Request-Id"),
                            "retry_after_s": 0.5}).encode())
            try:
                reply = self._forward(rep, "POST", path, body, headers)
            except _TransportError:
                _FLEET.add("transport_errors")
                rep.breaker.record_failure()
                excluded.add(rep.name)
                if attempt < self._retries:
                    _FLEET.add("retries")
                    continue
                return (503, "application/json", {},
                        json.dumps({
                            "error": "all fleet replicas unreachable",
                            "request_id": headers.get("X-Request-Id"),
                            "retry_after_s": 0.5}).encode())
            rep.breaker.record_success()
            if canary_rep is not None and canary_rep.name != rep.name:
                reply = self._shadow_canary(canary_rep, reply, path,
                                            body, headers)
            _FLEET.add("routed")
            return reply
        raise AssertionError("unreachable")  # pragma: no cover

    def _shadow_canary(self, canary, incumbent_reply, path, body,
                       headers):
        """Shadow-pair canary: the canary answers only when it agrees
        with the incumbent (the shadow accuracy gate). Every failure
        mode — transport, 5xx, shadow mismatch — falls back to the
        incumbent reply, so the client NEVER sees a canary fault."""
        _FLEET.add("canary_requests")
        with self._lock:
            canary.requests += 1
        try:
            creply = self._forward(canary, "POST", path, body, headers)
        except _TransportError:
            _FLEET.add("canary_fallbacks")
            self._canary_failure("transport error")
            return incumbent_reply
        cstatus, _, _, cbody = creply
        istatus, _, _, ibody = incumbent_reply
        if cstatus != 200:
            _FLEET.add("canary_fallbacks")
            if cstatus >= 500:
                self._canary_failure(f"HTTP {cstatus}")
            return incumbent_reply
        if istatus != 200:
            # the incumbent itself failed (shed/backpressure): that IS
            # the fleet's answer — nothing to compare against
            return incumbent_reply
        _FLEET.add("shadow_checks")
        try:
            dev = _rel_deviation(json.loads(cbody).get("outputs"),
                                 json.loads(ibody).get("outputs"))
        except Exception:  # noqa: BLE001 — malformed reply == mismatch
            dev = float("inf")
        if dev > self._shadow_tol:
            _FLEET.add("shadow_mismatches")
            _FLEET.add("canary_fallbacks")
            self._canary_failure(f"shadow deviation {dev:.4g}")
            return incumbent_reply
        self._canary_breaker.record_success()
        return creply

    def _canary_failure(self, why):
        self._canary_breaker.record_failure()
        rolled = False
        with self._lock:
            if self._canary_active and \
                    self._canary_breaker.state != "closed":
                self._canary_active = False
                rolled = True
        if rolled:
            _FLEET.add("canary_rollbacks")
            logging.warning(
                "fleet: canary rolled back (%s); all traffic to "
                "incumbents", why)

    @property
    def canary_active(self):
        with self._lock:
            return self._canary_active

    # -- HTTP plumbing (never under the lock) --------------------------

    def _forward(self, rep, method, path, body, headers):
        """One replica call. HTTP error statuses are ROUTED replies
        (returned); connection failures raise
        :class:`_TransportError`."""
        req = urllib.request.Request(rep.url + path, data=body,
                                     headers=dict(headers),
                                     method=method)
        try:
            with urllib.request.urlopen(
                    req, timeout=self._timeout_s) as resp:
                return (resp.status,
                        resp.headers.get("Content-Type",
                                         "application/json"),
                        self._passthrough(resp.headers), resp.read())
        except urllib.error.HTTPError as e:
            data = e.read()
            return (e.code,
                    e.headers.get("Content-Type", "application/json"),
                    self._passthrough(e.headers), data)
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise _TransportError(f"{rep.name}: {e}") from e

    @staticmethod
    def _passthrough(hdrs):
        out = {}
        ra = hdrs.get("Retry-After")
        if ra is not None:
            out["Retry-After"] = ra
        return out

    def _http_health(self, rep):
        try:
            with urllib.request.urlopen(
                    rep.url + "/healthz",
                    timeout=self._timeout_s) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(e.read() or b"{}")
            except ValueError:
                doc = {}
            return e.code, doc
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise _TransportError(f"{rep.name}: {e}") from e

    # -- observability -------------------------------------------------

    def healthz(self):
        """The router's own /healthz document: per-replica states, the
        aggregate queue picture, and the fleet-wide SLO block."""
        slo = self._admission.snapshot()
        with self._lock:
            reps = {n: r.snapshot()
                    for n, r in self._replicas.items()}
            sessions = len(self._sessions)
            canary_active = self._canary_active
        serving = [r for r in reps.values() if r["state"] == "serving"]
        warm = bool(serving) and all(r["warm"] for r in serving)
        status = "ok" if warm else "warming"
        if warm and any(r["state"] in ("ejected", "draining")
                        for r in reps.values()):
            status = "degraded"
        return {"status": status, "warm": warm, "role": "router",
                "replicas": reps, "sessions": sessions,
                "canary_active": canary_active,
                "queue_depth": sum(r["queue_depth"] for r in serving),
                "queue_capacity": (sum(r["queue_capacity"]
                                       for r in serving)
                                   if serving else 1),
                "slo": slo}

    def _replica_rows(self):
        with self._lock:
            return [(r.name, r.state, r.warm, r.depth, r.requests,
                     r.canary) for r in self._replicas.values()]


# -- prometheus exposition --------------------------------------------------


def _render_fleet():
    """The ``fleet`` exposition block: flat router counters (this
    block REPLACES the family's gauge pass, so they must render here)
    plus per-replica labeled series across live routers."""
    lines = ["# HELP mxnet_fleet fleet router counters",
             "# TYPE mxnet_fleet gauge"]
    snap = _FLEET.snapshot()
    for key in sorted(snap):
        lines.append(f"mxnet_fleet_{key} {snap[key]}")
    up, depth, reqs, states = [], [], [], []
    for router in list(_ROUTERS):
        for name, state, warm, d, n, canary in router._replica_rows():
            lab = {"replica": name}
            up.append((lab, 1 if state == "serving" else 0))
            depth.append((lab, d))
            reqs.append((lab, n))
            states.append(({"replica": name, "state": state,
                            "canary": "true" if canary else "false"},
                           1))
    lines += _tmetrics.labeled_lines(
        "fleet_replica_up", up, "replica serving and in the ring")
    lines += _tmetrics.labeled_lines(
        "fleet_replica_queue_depth", depth,
        "last gossiped replica queue depth")
    lines += _tmetrics.labeled_lines(
        "fleet_replica_requests", reqs,
        "requests routed to this replica")
    lines += _tmetrics.labeled_lines(
        "fleet_replica_state", states, "replica lifecycle state")
    return "\n".join(lines)


_tmetrics.register_exposition("fleet", _render_fleet)


# -- the router's HTTP handler ----------------------------------------------


class _FleetHandler(BaseHTTPRequestHandler):
    fleet = None  # bound per-router by FleetRouter.start
    protocol_version = "HTTP/1.1"
    _request_id = None
    _status = None

    def log_message(self, fmt, *args):
        logging.debug("fleet http: " + fmt, *args)

    def _reply(self, code, body, content_type="application/json",
               headers=None):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self._request_id is not None:
            self.send_header("X-Request-Id", self._request_id)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code, message, retry_after_s=None):
        doc = {"error": message, "request_id": self._request_id,
               "retry_after_s": retry_after_s}
        headers = {}
        if retry_after_s is not None:
            headers["Retry-After"] = f"{max(retry_after_s, 0.0):.3f}"
        self._reply(code, doc, headers=headers)

    def do_GET(self):
        fr = self.fleet
        if self.path == "/healthz":
            doc = fr.healthz()
            self._reply(200 if doc["warm"] else 503, doc)
        elif self.path == "/fleet":
            # the operator view: same document, always 200 (asking
            # "who is in the fleet" must work while warming)
            self._reply(200, fr.healthz())
        elif self.path == "/metrics":
            self._reply(200, _tmetrics.prometheus_text().encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._error(404, f"no route {self.path!r}")

    def do_POST(self):
        self._request_id = (self.headers.get("X-Request-Id") or
                            _telem.new_trace_id())
        with _telem.trace_context(self._request_id):
            with _telem.span("fleet.request", cat="serving",
                             path=self.path) as sp:
                self._do_post()
                sp.set(status=self._status)

    def _do_post(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._error(400, "bad Content-Length")
            return
        if length <= 0 or length > _MAX_BODY:
            self._error(400, f"body length {length} out of bounds "
                             f"(max {_MAX_BODY})")
            return
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or
                 "application/json").split(";")[0].strip().lower()
        slo_class = self.headers.get("X-SLO-Class")
        timeout_ms = self.headers.get("X-Timeout-Ms")
        session_id = self.headers.get("X-Session-Id")
        if ctype == "application/json":
            # peek at the body for routing keys (body wins, like the
            # replica surface); an unparseable body still routes —
            # the replica answers the canonical 400 envelope
            try:
                doc = json.loads(body)
                if isinstance(doc, dict):
                    slo_class = doc.get("slo_class", slo_class)
                    timeout_ms = doc.get("timeout_ms", timeout_ms)
                    session_id = doc.get("session_id", session_id)
            except ValueError:
                pass
        try:
            slo_class = normalize_class(slo_class)
        except ValueError as e:
            self._error(400, str(e))
            return
        headers = {"Content-Type": self.headers.get("Content-Type") or
                   "application/json",
                   "X-SLO-Class": slo_class,
                   "X-Request-Id": self._request_id}
        if timeout_ms is not None:
            headers["X-Timeout-Ms"] = str(timeout_ms)
        if session_id is not None:
            headers["X-Session-Id"] = str(session_id)
        fr = self.fleet
        try:
            status, rctype, extra, rbody = fr.forward_request(
                self.path, body, slo_class,
                str(session_id) if session_id is not None else None,
                headers)
        except ShedLoad as e:
            _FLEET.add("shed")
            self._error(503, str(e),
                        retry_after_s=max(e.retry_after_s, 0.0))
            return
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            logging.exception("fleet: routing failed")
            self._error(500, f"{type(e).__name__}: {e}")
            return
        self._reply(status, rbody, content_type=rctype,
                    headers=extra)


# -- replica subprocess helpers ---------------------------------------------

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

_CHILD_BOOT = (
    "import sys; sys.path.insert(0, {root!r})\n"
    "from mxnet_tpu_torch.serving.fleet import _replica_child\n"
    "_replica_child({factory!r}, {bundle!r})\n")


class ReplicaProcess:
    """Handle on a replica subprocess from :func:`spawn_replica`: the
    base URL, the ready document the child printed (``warm``: its
    ``warmup()`` report; ``compile``: its ``compile_cache`` counters
    over import, construction and warmup — zero ``kernel_builds``,
    ``retraces`` and ``calibrations`` prove a bundle-warm join built
    nothing), and a graceful ``stop()`` (close the child's stdin; it
    shuts its server down and exits)."""

    def __init__(self, proc, url, port, ready):
        self.proc = proc
        self.url = url
        self.port = port
        self.ready = ready

    @property
    def alive(self):
        return self.proc.poll() is None

    def stop(self, timeout_s=30.0):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def kill(self):
        """Hard kill — the fleet tests' stand-in for a crashed
        replica (probe ejection drills)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def spawn_replica(factory, bundle=None, env=None, timeout_s=300.0):
    """Start one replica subprocess serving ``factory`` — a
    ``"module:function"`` returning a built
    :class:`~.session.InferenceSession`. With ``bundle=`` the child
    imports the bundle (programs and kernel libraries) before it builds
    the session, so with an empty ``MXNET_COMPILE_CACHE_DIR`` in ``env``
    and no ``nvcc`` the join builds nothing. The child runs on the card
    unless its factory asks for the CPU. Blocks until the child prints
    its ready line; returns a :class:`ReplicaProcess`."""
    child_env = dict(os.environ)
    child_env.update(env or {})
    code = _CHILD_BOOT.format(root=_REPO_ROOT, factory=factory,
                              bundle=bundle)
    proc = subprocess.Popen(
        [sys.executable, "-c", code], env=child_env, cwd=_REPO_ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    got = {}

    def _read():
        got["line"] = proc.stdout.readline()

    reader = threading.Thread(target=_read, daemon=True)
    reader.start()
    reader.join(timeout_s)
    line = got.get("line")
    if not line:
        proc.kill()
        try:
            err = proc.stderr.read()
        except Exception:  # noqa: BLE001 — already failing
            err = ""
        raise RuntimeError(
            "replica child did not become ready within "
            f"{timeout_s:.0f}s: {err[-2000:]}")
    ready = json.loads(line)
    port = int(ready["port"])
    return ReplicaProcess(proc, f"http://127.0.0.1:{port}", port,
                          ready)


def _replica_child(factory, bundle=None):
    """Subprocess entry point (see :data:`_CHILD_BOOT`): import the
    bundle, build the session via ``factory``, warm it, serve on an
    ephemeral port, print ONE json ready line, then block until the
    parent closes stdin. The counters cover the whole join: a factory
    that quantizes or optimizes shows it."""
    import importlib

    from .. import artifact as _artifact
    from .server import ModelServer

    if bundle:
        _artifact.import_bundle(bundle)
    mod, _, fn = factory.partition(":")
    session = getattr(importlib.import_module(mod), fn)()
    warm = session.warmup()
    srv = ModelServer(session=session, port=0).start()
    sys.stdout.write(json.dumps({
        "port": srv.port,
        "warm": {k: v for k, v in warm.items() if k != "buckets"},
        "compile": _tmetrics.family_snapshot("compile_cache")}) + "\n")
    sys.stdout.flush()
    try:
        sys.stdin.read()  # parent closes stdin to stop us
    except KeyboardInterrupt:  # pragma: no cover
        pass
    srv.stop()
