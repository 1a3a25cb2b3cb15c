"""Multi-model repository: N models x versions, canary rollout,
auto-rollback, session migration.

The PyTorch counterpart of ``mxnet_tpu/serving/repository.py``. Each
(model, version) owns its own
:class:`~.batcher.DynamicBatcher`, so tenants never share a queue.

``deploy(name, session)`` registers a version. The FIRST version of a
model activates at once; later versions start as a **canary**: exactly
``fraction`` of eligible requests (deterministic counter routing, no
RNG) run on it while the incumbent keeps the rest. ``critical``
requests and stateful requests (``session_id``: their state lives in
the incumbent's store) never ride a canary.

Rollback goes through a :class:`~..resilience.breaker.CircuitBreaker`:
every canary execution failure, every sustained latency regression
against the incumbent (``MXNET_SERVING_CANARY_LATENCY_X``) and every
failed shadow comparison (``MXNET_QUANTIZE_SHADOW`` of canary requests
also run on the incumbent, diffed against
``MXNET_QUANTIZE_SHADOW_TOL``) is a ``record_failure``; the breaker
leaving "closed" IS the rollback. A canary failure is transparent to
the client: the request re-runs on the incumbent. After
``MXNET_SERVING_CANARY_MIN_REQUESTS`` clean completions the canary is
promoted by an atomic swap (the ``model_swap`` fault seam; rollback has
none). ``promote`` migrates the incumbent's live sessions into the new
version's store (``export_state`` / ``restore_state``), so a rollout
drops no mid-stream decode (``resumed_sessions``).

Deployment bundles (``export_bundle``) wait for the artifact layer.
"""
from __future__ import annotations

import logging
import threading
import time

from ..base import MXNetError, getenv
from ..resilience import faults as _faults
from ..resilience.breaker import CircuitBreaker
from .batcher import DynamicBatcher
from .metrics import METRICS, SLO_CLASSES

__all__ = ["ModelRepository"]

#: EMA smoothing for the incumbent/canary latency comparison
_LAT_ALPHA = 0.2
#: canary latency samples required before the regression check fires
_MIN_LAT_SAMPLES = 8
#: how long a promote waits for the incumbent's accepted steps to finish
#: before it migrates the live sessions
_QUIESCE_S = 60.0


def _rel_deviation(a, b):
    """max |a-b| / max |b| across (possibly nested) outputs — the
    shadow-check distance between a canary answer and the incumbent's.
    Normalizing by the incumbent's max keeps the tolerance meaningful
    for logits near zero, where elementwise relative error explodes."""
    import numpy as onp

    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return float("inf")
        return max((_rel_deviation(x, y) for x, y in zip(a, b)),
                   default=0.0)
    a = onp.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a,
                    dtype="float64")
    b = onp.asarray(b.asnumpy() if hasattr(b, "asnumpy") else b,
                    dtype="float64")
    if a.shape != b.shape:
        return float("inf")
    denom = max(float(onp.max(onp.abs(b))), 1e-12) if b.size else 1.0
    return float(onp.max(onp.abs(a - b))) / denom if a.size else 0.0


class _Version:
    __slots__ = ("version", "session", "batcher")

    def __init__(self, version, session, batcher):
        self.version = version
        self.session = session
        self.batcher = batcher


class _Model:
    """One named model: its versions, the active pointer, and live
    canary state. ``lock`` is an RLock — promotion runs from a worker
    callback that already holds it. The incumbent's latency average has
    its own lock, so a request's completion never waits on ``lock``
    (a promote holds it while the incumbent drains)."""

    def __init__(self, name):
        self.name = name
        # guards: versions, active, canary, canary_fraction,
        # canary_breaker, canary_successes, canary_lat_ema
        self.lock = threading.RLock()
        # guards: incumbent_lat_ema
        self.stats_lock = threading.Lock()
        self.versions = {}  # version -> _Version
        self.active = None
        self.canary = None
        self.canary_fraction = 0.0
        self.canary_breaker = None
        self.canary_successes = 0
        self.canary_failures = 0
        self.canary_lat_ema = None
        self.incumbent_lat_ema = None
        self._tick = 0  # deterministic canary routing counter
        self._shadow_tick = 0  # deterministic shadow-check sampling
        self.state = "empty"
        self.last_transition = "created"


class ModelRepository:
    """Host N models x versions behind per-model dynamic batchers.

    ``batcher_kwargs`` (max_batch_size, max_latency_ms, ...) apply to
    every batcher the repository builds. The first model deployed
    becomes the default (the bare ``/predict`` route)."""

    def __init__(self, canary_fraction=None, canary_min_requests=None,
                 canary_threshold=None, canary_latency_x=None,
                 **batcher_kwargs):
        # guards: _models, _default, _closed
        self._lock = threading.Lock()
        self._models = {}
        self._default = None
        self._closed = False
        self._batcher_kwargs = dict(batcher_kwargs)
        self._canary_fraction = float(
            canary_fraction if canary_fraction is not None else
            getenv("MXNET_SERVING_CANARY_FRACTION", 0.1, float))
        self._canary_min_requests = int(
            canary_min_requests if canary_min_requests is not None else
            getenv("MXNET_SERVING_CANARY_MIN_REQUESTS", 50, int))
        self._canary_threshold = int(
            canary_threshold if canary_threshold is not None else
            getenv("MXNET_SERVING_CANARY_THRESHOLD", 3, int))
        self._canary_latency_x = float(
            canary_latency_x if canary_latency_x is not None else
            getenv("MXNET_SERVING_CANARY_LATENCY_X", 3.0, float))
        # shadow accuracy gate (round 19): a fraction of canary
        # requests ALSO run on the incumbent and the outputs are
        # compared — the int8-rollout guard, where a quantized canary
        # can be fast AND wrong, which neither the failure nor the
        # latency check would ever catch
        self._shadow_fraction = min(1.0, max(0.0, getenv(
            "MXNET_QUANTIZE_SHADOW", 0.0, float)))
        self._shadow_tol = getenv("MXNET_QUANTIZE_SHADOW_TOL", 0.1, float)

    # -- registration / lifecycle --------------------------------------

    @property
    def default_model(self):
        with self._lock:
            return self._default

    def models(self):
        with self._lock:
            return sorted(self._models)

    def _model(self, name):
        with self._lock:
            m = self._models.get(name)
            deployed = sorted(self._models)
        if m is None:
            raise MXNetError(
                f"unknown model {name!r} (deployed: "
                f"{', '.join(deployed) or 'none'})")
        return m

    def deploy(self, name, session, version=None, canary_fraction=None):
        """Register a model version; returns the version number. The
        first version of ``name`` activates immediately (atomic, via
        the ``model_swap`` seam); later versions start as a canary
        taking ``canary_fraction`` of non-critical traffic."""
        with self._lock:
            if self._closed:
                raise MXNetError("repository is closed")
            m = self._models.setdefault(name, _Model(name))
            if self._default is None:
                self._default = name
        try:
            return self._deploy_under_model_lock(
                m, name, session, version, canary_fraction)
        except Exception:
            # a failed FIRST activation (model_swap fault, batcher
            # construction) must not leave a half-registered model
            # behind; repository lock before model lock, as everywhere
            with self._lock:
                with m.lock:
                    if not m.versions:
                        self._models.pop(name, None)
                        if self._default == name:
                            self._default = next(
                                iter(sorted(self._models)), None)
            raise

    def _deploy_under_model_lock(self, m, name, session, version,
                                 canary_fraction):
        with m.lock:
            ver = int(version) if version is not None else \
                (max(m.versions) + 1 if m.versions else 1)
            if ver in m.versions:
                raise MXNetError(
                    f"model {name!r} version {ver} already deployed")
            if m.canary is not None:
                raise MXNetError(
                    f"model {name!r} already has canary v{m.canary} in "
                    "flight; promote or roll it back first")
            if getattr(session, "label", None) is None and \
                    hasattr(session, "label"):
                session.label = f"{name}@v{ver}"
            vh = _Version(ver, session,
                          DynamicBatcher(session, **self._batcher_kwargs))
            if m.active is None:
                # first version: activate or die
                try:
                    self._activate_locked(m, ver, {ver: vh})
                except Exception:
                    vh.batcher.close()
                    raise
                m.versions[ver] = vh
                m.state = "serving"
                return ver
            m.versions[ver] = vh
            m.canary = ver
            m.canary_fraction = float(
                canary_fraction if canary_fraction is not None
                else self._canary_fraction)
            m.canary_breaker = CircuitBreaker(
                threshold=self._canary_threshold,
                name=f"canary {name}@v{ver}")
            m.canary_successes = 0
            m.canary_failures = 0
            m.canary_lat_ema = None
            with m.stats_lock:
                m.incumbent_lat_ema = None
            m._tick = 0
            m._shadow_tick = 0
            m.state = "canary"
            m.last_transition = f"canary v{ver} deployed"
            METRICS.bump("canary_deploys")
            return ver

    # kept as an alias: "add a model" reads better at call sites that
    # never roll versions
    add = deploy

    def _activate_locked(self, m, version, versions=None):
        """Atomic active-pointer swap, the ``model_swap`` fault seam.
        An injected fire aborts BEFORE the pointer moves — the
        incumbent stays active and in-flight requests are untouched."""
        _faults.maybe_fail("model_swap")
        m.active = version
        m.last_transition = f"v{version} activated"
        METRICS.bump("model_swaps")

    def promote(self, name):
        """Promote the canary to active (atomic hot-swap). The old
        version's batcher stays alive — rollback after promote is
        instant re-activation. When both versions are stateful, the
        incumbent's live sessions MIGRATE into the successor's state
        store under the model lock (submit also takes it), so no request
        can observe the new active version without its state. Unlike the
        reference, the port first waits (up to a minute) for the steps
        the incumbent already accepted: a step still queued there would
        otherwise advance a state after it was exported, and the stream
        would continue from the stale copy."""
        m = self._model(name)
        with m.lock:
            if m.canary is None:
                raise MXNetError(f"model {name!r} has no canary to "
                                 "promote")
            incumbent = m.versions.get(m.active)
            if self._stateful_pair(incumbent, m.versions[m.canary]) and \
                    not incumbent.batcher.wait_idle(_QUIESCE_S):
                logging.warning(
                    "serving: model %s promote: the incumbent still had "
                    "steps in flight after %.0f s; migrating anyway",
                    name, _QUIESCE_S)
            self._activate_locked(m, m.canary)
            m.canary = None
            m.canary_breaker = None
            m.state = "serving"
            m.last_transition = f"canary v{m.active} promoted"
            METRICS.bump("canary_promotions")
            self._migrate_sessions_locked(
                m, incumbent, m.versions[m.active])
            logging.info("serving: model %s canary v%d promoted",
                         name, m.active)

    @staticmethod
    def _stateful_pair(src_vh, dst_vh):
        src = getattr(getattr(src_vh, "session", None), "state_store", None)
        dst = getattr(getattr(dst_vh, "session", None), "state_store", None)
        return src is not None and dst is not None and src is not dst

    @staticmethod
    def _migrate_sessions_locked(m, src_vh, dst_vh):
        """Hand the outgoing version's live session state to the new
        active one. Failures are logged, never raised — the swap
        already happened, and an un-migrated session surfaces as a
        clean retryable SessionEvicted on its next step, not a torn
        promote."""
        src = getattr(getattr(src_vh, "session", None),
                      "state_store", None)
        dst = getattr(getattr(dst_vh, "session", None),
                      "state_store", None)
        if src is None or dst is None or src is dst:
            return
        try:
            n = dst.restore_state(src.export_state())
            if n:
                logging.info(
                    "serving: model %s promote migrated %d live "
                    "session(s) to v%d", m.name, n, dst_vh.version)
        except Exception:  # noqa: BLE001 — promote must not unwind
            logging.exception(
                "serving: model %s promote could not migrate live "
                "sessions to v%d", m.name, dst_vh.version)

    def rollback(self, name, reason="operator request"):
        """Cancel the canary; all traffic returns to the incumbent.
        Deliberately seam-free and unconditional — the escape hatch
        must always work."""
        m = self._model(name)
        with m.lock:
            if m.canary is None:
                return
            ver, m.canary = m.canary, None
            m.canary_breaker = None
            m.state = "rolled_back"
            m.last_transition = f"canary v{ver} rolled back: {reason}"
            METRICS.bump("canary_rollbacks")
            logging.warning("serving: model %s canary v%d rolled back "
                            "(%s)", name, ver, reason)

    def export_bundle(self, name, path, version=None):
        """Deployment bundles need the artifact layer (``torch.export``
        / AOTInductor packages), which comes with slice 10 of the port;
        this raises."""
        raise MXNetError(
            "ModelRepository.export_bundle is not ported yet: deployment "
            "bundles need the artifact layer, slice 10 of the port")

    def close(self):
        """Drain every batcher of every version (engine.close()
        order), then release session resources (a stateful session's
        state-store metrics probe). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            models = list(self._models.values())
        for m in models:
            with m.lock:
                versions = list(m.versions.values())
            for vh in versions:
                vh.batcher.close()
                close = getattr(vh.session, "close", None)
                if close is not None:
                    close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the request path ----------------------------------------------

    def submit(self, name, *inputs, timeout_ms=None, slo_class=None,
               block=False, session_id=None):
        """Route one request: canary slice (deterministic, non-critical
        only) or incumbent. Returns a Future; canary execution
        failures fall back to the incumbent transparently. A stateful
        request (``session_id``) never rides the canary — its state
        slot lives in the incumbent's store."""
        from .admission import normalize_class

        m = self._model(name)
        cls = normalize_class(slo_class)
        with m.lock:
            if m.active is None:
                raise MXNetError(f"model {name!r} has no active version")
            incumbent = m.versions[m.active]
            canary = m.versions.get(m.canary) \
                if m.canary is not None else None
            use_canary = False
            if canary is not None and cls != SLO_CLASSES[0] and \
                    session_id is None:
                # counter routing: request k rides the canary iff the
                # integer part of k*fraction advanced — exactly
                # fraction of eligible traffic, deterministically
                # (stateful requests are not eligible and do not tick)
                m._tick += 1
                f = m.canary_fraction
                use_canary = int(m._tick * f) != int((m._tick - 1) * f)
        if not use_canary:
            t0 = time.monotonic()
            kw = {} if session_id is None else \
                {"session_id": session_id}
            fut = incumbent.batcher.submit(
                *inputs, timeout_ms=timeout_ms, slo_class=cls,
                block=block, **kw)
            if canary is not None:
                # sample incumbent latency while a canary is under
                # evaluation — the baseline for the regression check
                fut.add_done_callback(
                    lambda f: self._note_incumbent(m, f, t0))
            return fut
        return self._submit_canary(m, canary, incumbent, inputs,
                                   timeout_ms, cls, block)

    def predict(self, name, *inputs, timeout_ms=None, slo_class=None,
                session_id=None):
        """Blocking convenience over :meth:`submit`."""
        fut = self.submit(name, *inputs, timeout_ms=timeout_ms,
                          slo_class=slo_class, session_id=session_id)
        return fut.result(timeout=60.0)

    def _submit_canary(self, m, canary, incumbent, inputs, timeout_ms,
                       cls, block):
        from concurrent.futures import Future

        METRICS.bump("canary_requests")
        outer = Future()
        t0 = time.monotonic()
        shadow = None
        if self._shadow_fraction > 0.0:
            with m.lock:
                # same counter routing as the canary slice: exactly
                # shadow_fraction of canary requests get a duplicate
                # incumbent run to diff against, no RNG flakes
                m._shadow_tick += 1
                sf = self._shadow_fraction
                take = int(m._shadow_tick * sf) != \
                    int((m._shadow_tick - 1) * sf)
            if take:
                try:
                    shadow = incumbent.batcher.submit(
                        *inputs, timeout_ms=timeout_ms, slo_class=cls)
                except Exception:  # noqa: BLE001 — shadow is advisory;
                    # a full incumbent queue must not fail the request
                    shadow = None
        try:
            inner = canary.batcher.submit(
                *inputs, timeout_ms=timeout_ms, slo_class=cls,
                block=block)
        except ValueError:
            raise  # invalid input — the model didn't fail
        except Exception:  # noqa: BLE001 — backpressure/shed on the
            # canary lane must not surface to the client; the
            # incumbent takes the request (no health accounting — a
            # full queue is load, not model badness)
            return incumbent.batcher.submit(
                *inputs, timeout_ms=timeout_ms, slo_class=cls,
                block=block)

        def _done(f):
            err = f.exception()
            if err is None:
                if shadow is not None:
                    shadow.add_done_callback(
                        lambda g: self._shadow_check(
                            m, canary.version, f, g))
                self._canary_success(m, canary.version,
                                     time.monotonic() - t0)
                if outer.set_running_or_notify_cancel():
                    outer.set_result(f.result())
                return
            self._canary_failure(m, canary.version, err)
            # transparent fallback: the client sees the incumbent's
            # answer, the canary's failure lives only in metrics
            METRICS.bump("canary_fallbacks")
            try:
                fb = incumbent.batcher.submit(
                    *inputs, timeout_ms=timeout_ms, slo_class=cls)
            except Exception as e2:  # noqa: BLE001 — delivered on future
                if outer.set_running_or_notify_cancel():
                    outer.set_exception(e2)
                return
            fb.add_done_callback(lambda g: self._chain(g, outer))

        inner.add_done_callback(_done)
        return outer

    @staticmethod
    def _chain(src, dst):
        if not dst.set_running_or_notify_cancel():
            return
        err = src.exception()
        if err is None:
            dst.set_result(src.result())
        else:
            dst.set_exception(err)

    # -- canary health accounting --------------------------------------

    def _note_incumbent(self, m, fut, t0):
        if fut.exception() is not None:
            return
        dt = time.monotonic() - t0
        with m.stats_lock:
            prev = m.incumbent_lat_ema
            m.incumbent_lat_ema = dt if prev is None else \
                (1 - _LAT_ALPHA) * prev + _LAT_ALPHA * dt

    def _canary_success(self, m, version, dt):
        promote = False
        with m.lock:
            if m.canary != version:
                return  # already promoted/rolled back
            m.canary_successes += 1
            prev = m.canary_lat_ema
            m.canary_lat_ema = dt if prev is None else \
                (1 - _LAT_ALPHA) * prev + _LAT_ALPHA * dt
            # sustained latency regression counts against the breaker
            # too — a canary that "works" at 10x latency is a failed
            # rollout, and routing the verdict through the breaker
            # keeps ONE rollback mechanism
            with m.stats_lock:
                incumbent_ema = m.incumbent_lat_ema
            if (m.canary_successes >= _MIN_LAT_SAMPLES and
                    incumbent_ema is not None and
                    m.canary_lat_ema >
                    self._canary_latency_x * incumbent_ema):
                m.canary_breaker.record_failure()
                if m.canary_breaker.state != "closed":
                    self._rollback_locked(
                        m, f"latency regression ({m.canary_lat_ema * 1e3:.1f}"
                           f" ms vs incumbent {incumbent_ema * 1e3:.1f} ms)")
                    return
            if (m.canary_successes >= self._canary_min_requests and
                    m.canary_breaker.state == "closed"):
                promote = True
        if promote:
            try:
                self.promote(m.name)
            except Exception as e:  # noqa: BLE001 — keep serving on the
                # incumbent; an aborted swap (model_swap fault) leaves
                # the canary under evaluation and the next clean
                # completion retries the promotion
                logging.warning("serving: model %s auto-promote failed "
                                "(%s: %s); canary stays under "
                                "evaluation", m.name,
                                type(e).__name__, e)

    def _shadow_check(self, m, version, canary_fut, shadow_fut):
        """The MXNET_QUANTIZE_SHADOW accuracy gate: diff one canary
        answer against the incumbent's for the same inputs. A relative
        deviation past MXNET_QUANTIZE_SHADOW_TOL is ``record_failure``
        on the canary breaker — same single rollback mechanism as
        execution failures and latency regressions — so a quantized
        canary that is fast but numerically wrong still rolls back with
        zero client-visible errors (the client already has its
        answer)."""
        if shadow_fut.exception() is not None:
            return  # incumbent trouble is not canary badness
        METRICS.bump("canary_shadow_checks")
        try:
            dev = _rel_deviation(canary_fut.result(),
                                 shadow_fut.result())
        except Exception:  # noqa: BLE001 — advisory path, never raise
            logging.exception("serving: model %s shadow comparison "
                              "failed", m.name)
            return
        if dev <= self._shadow_tol:
            return
        METRICS.bump("canary_shadow_mismatches")
        with m.lock:
            if m.canary != version:
                return
            m.canary_breaker.record_failure()
            if m.canary_breaker.state != "closed":
                self._rollback_locked(
                    m, f"shadow accuracy deviation {dev:.4f} > "
                       f"tolerance {self._shadow_tol:g}")

    def _canary_failure(self, m, version, err):
        with m.lock:
            if m.canary != version:
                return
            m.canary_failures += 1
            METRICS.bump("canary_failures")
            m.canary_breaker.record_failure()
            # the breaker leaving "closed" IS the rollback trigger —
            # with MXNET_RESILIENCE=0 breakers never trip and canaries
            # only roll back by operator hand, documented behavior
            if m.canary_breaker.state != "closed":
                self._rollback_locked(
                    m, f"breaker tripped after {m.canary_failures} "
                       f"failure(s) ({type(err).__name__}: {err})")

    def _rollback_locked(self, m, reason):
        ver, m.canary = m.canary, None
        m.canary_breaker = None
        m.state = "rolled_back"
        m.last_transition = f"canary v{ver} rolled back: {reason}"
        METRICS.bump("canary_rollbacks")
        logging.warning("serving: model %s canary v%d auto-rollback "
                        "(%s)", m.name, ver, reason)

    # -- observability -------------------------------------------------

    def model_states(self):
        """{name: lifecycle snapshot} — the /healthz ``models`` block."""
        with self._lock:
            models = dict(self._models)
        out = {}
        for name, m in sorted(models.items()):
            with m.lock:
                info = {
                    "state": m.state,
                    "active_version": m.active,
                    "versions": sorted(m.versions),
                    "last_transition": m.last_transition,
                }
                if m.canary is not None:
                    info["canary"] = {
                        "version": m.canary,
                        "fraction": m.canary_fraction,
                        "successes": m.canary_successes,
                        "failures": m.canary_failures,
                        "breaker": m.canary_breaker.state,
                    }
                vh = m.versions.get(m.active)
            if vh is not None:
                sess = vh.session
                if hasattr(sess, "health_snapshot"):
                    snap = sess.health_snapshot()
                else:
                    snap = {"warm": True, "degraded_buckets": [],
                            "open_buckets": []}
                info["warm"] = bool(snap["warm"])
                store = getattr(sess, "state_store", None)
                if store is not None:
                    info["session_state"] = store.stats()
                info["degraded_buckets"] = list(
                    snap["degraded_buckets"])
                info["open_buckets"] = list(snap["open_buckets"])
            out[name] = info
        return out

    def healthz(self):
        """Aggregate health: per-model lifecycle + queue depths per
        SLO class + the live SLO headroom block (minimum across every
        version batcher's admission controller)."""
        models = self.model_states()
        warm = all(i.get("warm", True) for i in models.values())
        degraded = any(i.get("degraded_buckets") or i.get("open_buckets")
                       or i["state"] == "rolled_back"
                       for i in models.values())
        depths = dict.fromkeys(SLO_CLASSES, 0)
        slo = None
        with self._lock:
            all_models = list(self._models.values())
        for m in all_models:
            with m.lock:
                versions = list(m.versions.values())
            for vh in versions:
                for cls, n in vh.batcher.qsize_by_class().items():
                    depths[cls] = depths.get(cls, 0) + n
                adm = getattr(vh.batcher, "admission", None)
                if adm is not None:
                    snap = adm.snapshot()
                    if slo is None or snap["headroom"] < slo["headroom"]:
                        slo = snap
        status = "ok" if warm else "warming"
        if warm and degraded:
            status = "degraded"
        return {
            "status": status,
            "warm": warm,
            "models": models,
            "queue_depth": sum(depths.values()),
            "queue_depths": depths,
            "slo": slo,
        }
