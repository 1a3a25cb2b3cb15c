"""Remote artifact-cache tier: a fleet-shared store behind the same
fingerprints as the local disk tier.

The PyTorch counterpart of ``mxnet_tpu/artifact/remote.py``. A replica
that misses its local entry consults the remote store before building;
a building replica publishes what it built, so across a fleet each
program is built once. The blobs are the local tier's JSON envelopes
verbatim, adopted into the local directory and re-validated by
``disk_load`` (format and salt), so a stale or corrupt remote entry is
a removed miss.

Two backends, chosen by the ``MXNET_ARTIFACT_REMOTE`` URL scheme:

- ``file:///shared/dir`` — a shared directory; writes are tmp +
  ``os.replace`` atomic, like the local tier;
- ``http(s)://host[:port]`` — ``GET``/``PUT /artifacts/<fp>`` against an
  artifact service (:class:`ArtifactCacheServer` is a stdlib reference
  implementation).

Every round trip runs under a bounded
:class:`~..resilience.retry.RetryPolicy` and one
:class:`~..resilience.breaker.CircuitBreaker` per URL: a flaky or down
cache host degrades to a local build, which the counters record
(``remote_errors``, ``remote_skipped``); nothing computed changes.
"""
from __future__ import annotations

import os
import threading

from ..utils import compile_cache as _cc
from ..utils import locks as _locks
from ._counters import STATS

__all__ = ["remote_url", "fetch", "publish", "publish_path",
           "reset_remote_state", "ArtifactCacheServer"]


# ---------------------------------------------------------------------------
# knobs

def remote_url():
    """MXNET_ARTIFACT_REMOTE: the remote store URL (``file://`` dir or
    ``http(s)://`` service); unset/empty = no remote tier."""
    from .. import env as _env

    return _env.get_str("MXNET_ARTIFACT_REMOTE") or None


def publish_enabled():
    """MXNET_ARTIFACT_REMOTE_PUBLISH (default on): whether locally
    compiled artifacts are pushed to the remote store. Read-only
    replicas (canaries pinned to a blessed artifact set) turn it
    off."""
    from .. import env as _env

    return _env.get_bool("MXNET_ARTIFACT_REMOTE_PUBLISH", True)


def _timeout_s():
    from .. import env as _env

    return _env.get_int("MXNET_ARTIFACT_REMOTE_TIMEOUT_MS", 2000) / 1e3


def _max_bytes():
    """MXNET_ARTIFACT_REMOTE_MAX_MB: byte bound on the remote store
    (default 512 MB; 0 = unbounded). Enforced by whoever owns the
    bytes: the publishing replica for a ``file://`` directory, the
    server process for the HTTP store."""
    from .. import env as _env

    cap_mb = _env.get_int("MXNET_ARTIFACT_REMOTE_MAX_MB", 512)
    return cap_mb * 1024 * 1024 if cap_mb > 0 else 0


def _gc_max_age_s():
    """MXNET_ARTIFACT_GC_MAX_AGE_S: age bound on remote-store entries
    (default 0 = no age bound). A dead fingerprint on a shared mount
    is never re-published, so only age — not the byte cap — can
    reclaim it once the fleet stops fetching it."""
    from .. import env as _env

    return _env.get_int("MXNET_ARTIFACT_GC_MAX_AGE_S", 0)


def _protected_fps():
    from . import bundle as _bundle

    return _bundle.protected_fingerprints()


def _policy():
    from .. import env as _env
    from ..resilience.retry import RetryPolicy

    return RetryPolicy(
        max_attempts=_env.get_int("MXNET_ARTIFACT_REMOTE_RETRIES", 2),
        base_ms=25.0, max_ms=250.0, name="artifact_remote")


# one breaker per configured URL: repointing the knob (tests, operator
# failover) must not inherit the old host's failure streak
# guards: _STATE
_LOCK = _locks.RankedLock("artifact.remote.breakers")
_STATE = {"breaker": None, "url": None}


def _breaker():
    from ..resilience.breaker import CircuitBreaker

    url = remote_url()
    with _LOCK:
        if _STATE["breaker"] is None or _STATE["url"] != url:
            _STATE["breaker"] = CircuitBreaker(name="artifact_remote")
            _STATE["url"] = url
        return _STATE["breaker"]


def breaker_state():
    """The remote-tier breaker state ('closed' | 'open' | 'half-open')."""
    return _breaker().state


def reset_remote_state():
    """Forget the breaker and its failure streak (tests)."""
    with _LOCK:
        _STATE["breaker"] = None
        _STATE["url"] = None


# ---------------------------------------------------------------------------
# backends (return None for a definitive miss; raise for transient
# failures — only raises are retried/counted against the breaker)

def _http_url(url, fp):
    return url.rstrip("/") + "/artifacts/" + fp


def _fetch_backend(url, fp):
    if url.startswith("file://"):
        path = os.path.join(url[len("file://"):], fp + _cc.SUFFIX)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(
                urllib.request.Request(_http_url(url, fp)),
                timeout=_timeout_s()) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


_GC_EVERY = 32
_gc_tick = [0]


def _maybe_gc_file(directory):
    """Bound a ``file://`` store the way the local tier bounds its
    directory (``compile_cache._maybe_prune``): every ``_GC_EVERY``-th
    publish, (1) entries older than MXNET_ARTIFACT_GC_MAX_AGE_S are
    removed whatever the byte total, then (2) if the entries' total
    still exceeds MXNET_ARTIFACT_REMOTE_MAX_MB, oldest-used entries
    (mtime) go down to 80% of the cap. Fingerprints referenced by a
    live bundle manifest (``bundle.protected_fingerprints``) are never
    evicted by either pass. Every step tolerates a concurrent pruner
    on another replica: a stat or remove that loses the race is
    skipped, never raised — a shared NFS mount has many writers and no
    coordinator."""
    import time

    _gc_tick[0] += 1
    if _GC_EVERY > 1 and _gc_tick[0] % _GC_EVERY != 1:
        return
    cap = _max_bytes()
    max_age = _gc_max_age_s()
    if cap <= 0 and max_age <= 0:
        return  # 0 = unbounded, explicitly
    entries = []
    try:
        with os.scandir(directory) as it:
            for e in it:
                if not e.name.endswith(_cc.SUFFIX):
                    continue
                try:
                    st = e.stat()
                except OSError:
                    continue  # pruned/replaced by a concurrent replica
                entries.append((st.st_mtime, st.st_size, e.path,
                                e.name[:-len(_cc.SUFFIX)]))
    except OSError:
        return  # directory unreadable/gone: nothing to bound
    total = sum(sz for _, sz, _, _ in entries)
    protected = None  # resolved lazily: most sweeps evict nothing
    ran = [False]

    def _evict(sz, path, age_pass):
        if not ran[0]:
            ran[0] = True
            STATS.add("gc_runs")
        try:
            os.remove(path)
        except OSError:
            return False  # a concurrent pruner won the race
        STATS.add("gc_evicted")
        if age_pass:
            STATS.add("gc_age_evicted")
        STATS.add("gc_bytes", sz)
        return True

    entries.sort()  # oldest-used first
    if max_age > 0:
        cutoff = time.time() - max_age
        protected = _protected_fps()
        survivors = []
        for mtime, sz, path, fp in entries:
            if mtime >= cutoff:
                survivors.append((mtime, sz, path, fp))
            elif fp in protected:
                STATS.add("gc_protected")
                survivors.append((mtime, sz, path, fp))
            elif _evict(sz, path, age_pass=True):
                total -= sz
            # a lost remove race: the entry is gone either way
        entries = survivors
    if cap <= 0 or total <= cap:
        return
    if protected is None:
        protected = _protected_fps()
    for _, sz, path, fp in entries:
        if fp in protected:
            STATS.add("gc_protected")
            continue
        if _evict(sz, path, age_pass=False):
            total -= sz
        if total <= cap * 0.8:
            break


def _publish_backend(url, fp, blob):
    if url.startswith("file://"):
        directory = url[len("file://"):]
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, fp + _cc.SUFFIX)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        _maybe_gc_file(directory)
        return
    import urllib.request

    req = urllib.request.Request(_http_url(url, fp), data=blob,
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=_timeout_s()):
        pass


# ---------------------------------------------------------------------------
# the guarded public seam

def fetch(fp):
    """The envelope blob for ``fp`` from the remote store, or None —
    covering miss, no remote configured, breaker open, and transient
    errors after retries (all of which degrade to local compile)."""
    url = remote_url()
    if url is None or fp is None:
        return None
    br = _breaker()
    if not br.allow():
        STATS.add("remote_skipped")
        return None
    try:
        blob = _policy().run(_fetch_backend, url, fp)
    except Exception:
        br.record_failure()
        STATS.add("remote_errors")
        return None
    br.record_success()
    if blob is None:
        STATS.add("remote_misses")
        return None
    STATS.add("remote_hits")
    STATS.add("fetch_bytes", len(blob))
    return blob


def publish(fp, blob):
    """Push an envelope blob under ``fp``; True on success. Best
    effort with the same retry/breaker discipline as :func:`fetch` —
    a failed publish never breaks the caller (the artifact is already
    in the local tier)."""
    url = remote_url()
    if url is None or fp is None or not publish_enabled():
        return False
    br = _breaker()
    if not br.allow():
        STATS.add("remote_skipped")
        return False
    try:
        _policy().run(_publish_backend, url, fp, blob)
    except Exception:
        br.record_failure()
        STATS.add("publish_errors")
        return False
    br.record_success()
    STATS.add("remote_publishes")
    STATS.add("publish_bytes", len(blob))
    return True


def publish_path(fp, path):
    """Publish the local cache entry at ``path`` (an envelope file)."""
    if remote_url() is None or fp is None or not publish_enabled():
        return False
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return False
    return publish(fp, blob)


# ---------------------------------------------------------------------------
# reference server (tests, benchmarks, single-host fleets)

class ArtifactCacheServer:
    """In-process artifact store speaking the HTTP backend protocol:
    ``GET /artifacts/<fp>`` -> 200 blob | 404, ``PUT /artifacts/<fp>``
    -> 201. Stdlib ``ThreadingHTTPServer`` on an ephemeral port.

    ``fail_requests = N`` makes the next N requests answer 503 — the
    flaky-host drill the retry/breaker seam is tested against.

    The store is byte-bounded (``max_bytes``; default the
    MXNET_ARTIFACT_REMOTE_MAX_MB knob, 0 = unbounded): a PUT that
    pushes the total over the cap evicts least-recently-ACCESSED
    entries first (a GET hit refreshes recency — the server-side
    mirror of the mtime-refresh the ``file://`` pruner keys on). It
    mirrors the ``file://`` pruner's other two rules: entries
    untouched for ``max_age_s`` (default the
    MXNET_ARTIFACT_GC_MAX_AGE_S knob) are dropped on the next PUT
    whatever the byte total, and fingerprints referenced by a live
    bundle manifest are never evicted by either pass."""

    def __init__(self, host="127.0.0.1", max_bytes=None,
                 max_age_s=None, clock=None):
        import collections
        import http.server
        import time

        self.store = collections.OrderedDict()  # fp -> blob, LRU order
        self.max_bytes = _max_bytes() if max_bytes is None \
            else int(max_bytes)
        self.max_age_s = _gc_max_age_s() if max_age_s is None \
            else int(max_age_s)
        self._clock = clock or time.monotonic
        self._stamps = {}  # fp -> last-access clock reading
        self.store_bytes = 0
        self.gc_evicted = 0
        # guards: store, store_bytes, gc_evicted, _stamps
        self._store_lock = _locks.RankedLock("artifact.server.store")
        self.fail_requests = 0
        self.requests = 0
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                """Silence per-request stderr logging."""

            def _fingerprint(self):
                prefix = "/artifacts/"
                return self.path[len(prefix):] \
                    if self.path.startswith(prefix) else None

            def _gate(self):
                outer.requests += 1
                if outer.fail_requests > 0:
                    outer.fail_requests -= 1
                    self.send_response(503)
                    self.end_headers()
                    return False
                return True

            def do_GET(self):
                if not self._gate():
                    return
                fp = self._fingerprint()
                with outer._store_lock:
                    blob = outer.store.get(fp)
                    if blob is not None:
                        outer.store.move_to_end(fp)  # refresh recency
                        outer._stamps[fp] = outer._clock()
                if blob is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_PUT(self):
                if not self._gate():
                    return
                fp = self._fingerprint()
                if fp is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length") or 0)
                blob = self.rfile.read(n)
                # resolved outside the store lock: may read bundle
                # files from disk
                protected = _protected_fps() \
                    if outer.max_age_s > 0 or outer.max_bytes > 0 \
                    else frozenset()
                with outer._store_lock:
                    old = outer.store.pop(fp, None)
                    if old is not None:
                        outer.store_bytes -= len(old)
                    outer.store[fp] = blob
                    outer.store_bytes += len(blob)
                    outer._stamps[fp] = outer._clock()
                    ran = [False]

                    def evict(victim, age_pass):
                        if not ran[0]:
                            ran[0] = True
                            STATS.add("gc_runs")
                        ev = outer.store.pop(victim)
                        outer._stamps.pop(victim, None)
                        outer.store_bytes -= len(ev)
                        outer.gc_evicted += 1
                        STATS.add("gc_evicted")
                        if age_pass:
                            STATS.add("gc_age_evicted")
                        STATS.add("gc_bytes", len(ev))

                    # age pass: drop entries nobody touched within the
                    # bound, whatever the byte total (never the entry
                    # just written, never a live-bundle fingerprint)
                    if outer.max_age_s > 0:
                        cutoff = outer._clock() - outer.max_age_s
                        for victim in [k for k, t in
                                       outer._stamps.items()
                                       if t < cutoff and k != fp]:
                            if victim in protected:
                                STATS.add("gc_protected")
                                continue
                            evict(victim, age_pass=True)
                    # size pass: evict coldest-accessed until back
                    # under the cap (never the entry just written or a
                    # protected fingerprint, however large)
                    if outer.max_bytes > 0 and \
                            outer.store_bytes > outer.max_bytes:
                        for victim in list(outer.store):
                            if outer.store_bytes <= outer.max_bytes \
                                    or len(outer.store) <= 1:
                                break
                            if victim == fp:
                                continue
                            if victim in protected:
                                STATS.add("gc_protected")
                                continue
                            evict(victim, age_pass=False)
                self.send_response(201)
                self.end_headers()

        self._httpd = http.server.ThreadingHTTPServer((host, 0),
                                                      _Handler)
        self._thread = None

    @property
    def url(self):
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="artifact-cache",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
