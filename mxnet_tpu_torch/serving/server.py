"""Stdlib HTTP front end: JSON / npy inference over ThreadingHTTPServer.

The PyTorch counterpart of ``mxnet_tpu/serving/server.py``, stdlib only.

- ``POST /predict`` — ``application/json`` body ``{"data": <nested
  list>}`` (or ``{"inputs": [<list>, ...]}`` for multi-input models)
  returns ``{"outputs": [...], "shapes": [...]}``; a raw
  ``application/x-npy`` body returns the first output as npy bytes.
  ``POST /models/<name>/predict`` targets one model of a
  :class:`~.repository.ModelRepository`. The SLO class, deadline and
  stream ride the ``X-SLO-Class`` / ``X-Timeout-Ms`` / ``X-Session-Id``
  headers or the JSON fields ``slo_class`` / ``timeout_ms`` /
  ``session_id`` (the body wins). ``X-Request-Id`` is adopted (or
  minted) and echoed on every response.
- ``GET /healthz`` — warm state (200 once every bucket is ready, 503
  before) with per-class queue depths, the SLO-headroom block, the
  state store's stats and, in repository mode, per-model canary status.
- ``GET /models`` — repository mode: the model/version/canary listing.
- ``GET /metrics`` — the serving registry's Prometheus text.

Error mapping: validation ``ValueError`` -> 400; an admission shed
(:class:`~.admission.ShedLoad`) -> 503 with ``Retry-After``; a state
eviction (:class:`~.state.SessionEvicted`) -> 503 with ``Retry-After``;
queue backpressure (:class:`~.batcher.ServerBusy`) or an open circuit
-> 503; a deadline (:class:`~.batcher.RequestTimeout` or a result-wait
timeout) -> 504; anything else -> 500. ``stop()`` is graceful: the
listener closes first, then the batcher drains. Each POST is a
``serving.request`` span under its ``X-Request-Id`` as trace id, which
the batcher carries to its worker's spans; ``GET /metrics`` serves the
telemetry registry's unified exposition.

The fleet's drain (``serving/fleet.py``) uses two internal endpoints
of a single-session server: ``GET /admin/export_state`` answers the
state store's ``export_state`` payload (dense rows, whatever the page
geometry) as a pickle, and ``POST /admin/restore_state`` restores one
into this replica's store (quantizing into int8 pages when the store
keeps them) and answers ``{"restored": n}``; both answer 409 without a
state store.
"""
from __future__ import annotations

import io
import json
import logging
import pickle
import threading
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as onp

from ..base import getenv
from ..resilience.breaker import CircuitOpen
from ..telemetry import metrics as _tmetrics
from ..telemetry import tracer as _telem
from .admission import ShedLoad, normalize_class
from .batcher import DynamicBatcher, RequestTimeout, ServerBusy
from .metrics import METRICS
from .state import SessionEvicted

__all__ = ["ModelServer"]


class HTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for concurrent
    clients: socketserver's default of 5 drops the SYNs past it, and a
    client's kernel retransmits a dropped SYN only after a second (the
    fleet's router sends a replica every concurrent stream's step at
    once)."""

    request_queue_size = 128
    daemon_threads = True

_MAX_BODY = 64 * 1024 * 1024  # 64 MiB request-body bound
# the drain's restore carries live sessions' dense rows: a GPT-2-small
# session is 75.5 MB whatever its length, so the internal admin surface
# takes up to 16 GiB
_ADMIN_MAX_BODY = 16 * 1024 ** 3


class ModelServer:
    """HTTP serving endpoint over an InferenceSession / DynamicBatcher
    / ModelRepository.

    ``ModelServer(session)`` owns a batcher built from the
    ``MXNET_SERVING_*`` knobs; pass ``batcher=`` to share an existing
    one (it will NOT be closed on ``stop()``); pass ``repository=`` to
    front a multi-model :class:`ModelRepository` (closed on ``stop()``
    — the server is its lifecycle owner, engine.close() order).
    ``port=0`` binds an ephemeral port (tests); read it back via
    ``server.port`` after ``start()``."""

    def __init__(self, session=None, batcher=None, repository=None,
                 host=None, port=None):
        if sum(x is not None for x in (session, batcher,
                                       repository)) != 1:
            raise ValueError("exactly one of session= / batcher= / "
                             "repository= is required")
        self.repository = repository
        self._own_batcher = batcher is None and repository is None
        if repository is not None:
            self.batcher = None
            self.session = None
        else:
            self.batcher = batcher or DynamicBatcher(session)
            self.session = session or self.batcher.session
        self._host = host if host is not None else getenv(
            "MXNET_SERVING_HOST", "127.0.0.1")
        self._port = int(port if port is not None else getenv(
            "MXNET_SERVING_PORT", 8080, int))
        self._httpd = None
        self._thread = None

    # -- lifecycle -----------------------------------------------------

    def start(self):
        """Bind and serve in a daemon thread; returns self."""
        if self._httpd is not None:
            return self
        server = self

        class _Handler(_ServingHandler):
            model_server = server

        self._httpd = HTTPServer((self._host, self._port), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mxnet-serving-http", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self):
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    @property
    def address(self):
        return f"http://{self._host}:{self.port}"

    def stop(self):
        """Graceful shutdown: close the listener (stop accepting),
        then drain the batcher (owned batchers only). Idempotent."""
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._own_batcher:
            self.batcher.close()
        if self.repository is not None:
            self.repository.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class _ServingHandler(BaseHTTPRequestHandler):
    model_server = None  # bound per-server by ModelServer.start
    protocol_version = "HTTP/1.1"
    _request_id = None  # set per-request at the top of do_POST
    _status = None      # last reply's status code (span attr)

    # -- plumbing ------------------------------------------------------

    def log_message(self, fmt, *args):  # default: stderr spam
        logging.debug("serving http: " + fmt, *args)

    def _reply(self, code, body, content_type="application/json",
               headers=None):
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if self._request_id is not None:
            # echoed on EVERY response, success or error, so a client
            # log line joins the server's
            self.send_header("X-Request-Id", self._request_id)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code, message, headers=None, retry_after_s=None):
        """One error envelope for every failure class: ``error`` +
        ``request_id`` (when the request reached routing) +
        ``retry_after_s`` (the backoff hint, null when retrying can't
        help — 400s, timeouts). A non-null hint also rides the
        standard ``Retry-After`` header for clients that only read
        headers."""
        doc = {"error": message,
               "request_id": self._request_id,
               "retry_after_s": retry_after_s}
        if retry_after_s is not None:
            headers = dict(headers or {})
            headers.setdefault("Retry-After",
                               f"{max(retry_after_s, 0.0):.3f}")
        self._reply(code, doc, headers=headers)

    # -- GET -----------------------------------------------------------

    def do_GET(self):
        srv = self.model_server
        if self.path == "/healthz":
            if srv.repository is not None:
                doc = srv.repository.healthz()
                self._reply(200 if doc["warm"] else 503, doc)
                return
            session = srv.session
            # a degraded-but-warm replica still answers 200 (it
            # serves), so the LB keeps it while operators see the
            # "degraded" status
            if hasattr(session, "health_snapshot"):
                snap = session.health_snapshot()
            else:
                snap = {"warm": True, "buckets": [],
                        "degraded_buckets": [], "open_buckets": []}
            warm = bool(snap["warm"])
            status = "ok" if warm else "warming"
            if warm and (snap["degraded_buckets"]
                         or snap["open_buckets"]):
                status = "degraded"
            adm = getattr(srv.batcher, "admission", None)
            store = getattr(session, "state_store", None)
            # 503 until warm so a status-code health check (the
            # standard LB kind) keeps traffic off a cold replica
            self._reply(200 if warm else 503, {
                "status": status,
                "warm": warm,
                "buckets": list(snap["buckets"]),
                "degraded_buckets": snap["degraded_buckets"],
                "open_buckets": snap["open_buckets"],
                "queue_depth": srv.batcher.qsize(),
                "queue_capacity": srv.batcher.queue_capacity(),
                # how much SLO headroom is left (1.0 idle .. 0.0 blown)
                # and who is shedding
                "queue_depths": srv.batcher.qsize_by_class(),
                "slo": adm.snapshot() if adm is not None else None,
                # stateful serving: live session-state pool occupancy
                "state": store.stats() if store is not None else None})
        elif self.path == "/admin/export_state":
            store = getattr(srv.session, "state_store", None) \
                if srv.session is not None else None
            if store is None:
                self._error(409, "no session state store behind this "
                                 "server (stateless or repository "
                                 "mode)")
                return
            payload = pickle.dumps(store.export_state(),
                                   protocol=pickle.HIGHEST_PROTOCOL)
            self._reply(200, payload,
                        content_type="application/octet-stream")
        elif self.path == "/models":
            if srv.repository is None:
                self._error(404, "no model repository behind this "
                                 "server")
                return
            self._reply(200, {
                "default": srv.repository.default_model,
                "models": srv.repository.model_states()})
        elif self.path == "/metrics":
            # the unified exposition: the serving block and every
            # training-side counter family
            self._reply(200, _tmetrics.prometheus_text().encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._error(404, f"no route {self.path!r}")

    # -- POST ----------------------------------------------------------

    def _route_model(self):
        """Resolve the POST path to a model name (repository mode) or
        None (single-session mode). Raises LookupError for unroutable
        paths."""
        srv = self.model_server
        if self.path in ("/predict", "/invocations"):
            if srv.repository is not None:
                name = srv.repository.default_model
                if name is None:
                    raise LookupError("repository has no models")
                return name
            return None
        parts = self.path.strip("/").split("/")
        if (len(parts) == 3 and parts[0] == "models" and
                parts[2] in ("predict", "invocations") and
                srv.repository is not None):
            if parts[1] not in srv.repository.models():
                raise LookupError(f"unknown model {parts[1]!r}")
            return parts[1]
        raise LookupError(f"no route {self.path!r}")

    def do_POST(self):
        # request-scoped trace propagation: adopt the client's
        # X-Request-Id (minting one when absent), scope every span of
        # this request to it (on this thread by trace_context, across the
        # queue by the batcher's request), and echo it on the response,
        # errors included
        self._request_id = (self.headers.get("X-Request-Id") or
                            _telem.new_trace_id())
        with _telem.trace_context(self._request_id):
            with _telem.span("serving.request", cat="serving",
                             path=self.path) as sp:
                self._do_post()
                sp.set(status=self._status)

    def _restore_state(self):
        """``POST /admin/restore_state``: a pickled ``export_state``
        payload (possibly a repartitioned subset) lands in this replica's
        state store."""
        srv = self.model_server
        store = getattr(srv.session, "state_store", None) \
            if srv.session is not None else None
        if store is None:
            self._error(409, "no session state store behind this "
                             "server (stateless or repository mode)")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._error(400, "bad Content-Length")
            return
        if length <= 0 or length > _ADMIN_MAX_BODY:
            self._error(400, f"body length {length} out of bounds "
                             f"(max {_ADMIN_MAX_BODY})")
            return
        try:
            payload = pickle.loads(self.rfile.read(length))
            restored = store.restore_state(payload)
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            self._error(400, f"unrestorable state payload: "
                             f"{type(e).__name__}: {e}")
            return
        self._reply(200, {"restored": int(restored)})

    def _do_post(self):
        if self.path == "/admin/restore_state":
            self._restore_state()
            return
        try:
            model = self._route_model()
        except LookupError as e:
            self._error(404, str(e))
            return
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
        # SLO class + deadline ride headers for every content type;
        # JSON bodies may override (body wins — it travels with the
        # payload through proxies that strip custom headers)
        slo_class = self.headers.get("X-SLO-Class")
        timeout_ms = self.headers.get("X-Timeout-Ms")
        session_id = self.headers.get("X-Session-Id")
        try:
            if ctype == "application/x-npy":
                inputs = [onp.load(io.BytesIO(body), allow_pickle=False)]
                as_npy = True
            else:
                doc = json.loads(body)
                if isinstance(doc, dict):
                    slo_class = doc.get("slo_class", slo_class)
                    timeout_ms = doc.get("timeout_ms", timeout_ms)
                    session_id = doc.get("session_id", session_id)
                if isinstance(doc, dict) and "inputs" in doc:
                    inputs = [onp.asarray(x) for x in doc["inputs"]]
                elif isinstance(doc, dict) and "data" in doc:
                    inputs = [onp.asarray(doc["data"])]
                else:
                    raise ValueError(
                        'JSON body must carry "data" or "inputs"')
                as_npy = False
            slo_class = normalize_class(slo_class)
            timeout_ms = float(timeout_ms) if timeout_ms is not None \
                else None
        except ValueError as e:
            self._error(400, f"unparseable request body: {e}")
            return
        srv = self.model_server
        kw = {} if session_id is None else {"session_id": session_id}
        try:
            if model is not None:
                outs = srv.repository.predict(
                    model, *inputs, timeout_ms=timeout_ms,
                    slo_class=slo_class, **kw)
            else:
                outs = srv.batcher.predict(
                    *inputs, timeout_ms=timeout_ms, slo_class=slo_class,
                    **kw)
        except ValueError as e:
            self._error(400, str(e))
            return
        except ShedLoad as e:
            # admission control said no BEFORE queueing: fast 503 with
            # the backoff hint — a well-behaved client honors it
            METRICS.bump("rejected")
            self._error(503, str(e),
                        retry_after_s=max(e.retry_after_s, 0.0))
            return
        except SessionEvicted as e:
            # the stream's state slot is gone (TTL/LRU/injected): a
            # clean retryable 503 — the client re-opens its stream and
            # replays; ordered before the plain ServerBusy mapping
            # (SessionEvicted subclasses it)
            self._error(503, str(e), retry_after_s=0.0)
            return
        except (ServerBusy, CircuitOpen) as e:
            # both are "back off and retry later": queue backpressure,
            # or this bucket's circuit is open during its cooldown
            self._error(503, str(e), retry_after_s=0.05)
            return
        except (RequestTimeout, _FutureTimeout) as e:
            self._error(504, str(e) or "request timed out")
            return
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            logging.exception("serving: predict failed")
            self._error(500, f"{type(e).__name__}: {e}")
            return
        outs = outs if isinstance(outs, tuple) else (outs,)
        outs = [onp.asarray(o) for o in outs]  # batcher yields host arrays
        if as_npy:
            buf = io.BytesIO()
            onp.save(buf, outs[0])
            self._reply(200, buf.getvalue(),
                        content_type="application/x-npy")
        else:
            self._reply(200, {
                "outputs": [o.tolist() for o in outs],
                "shapes": [list(o.shape) for o in outs]})
