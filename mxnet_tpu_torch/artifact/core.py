"""CompiledArtifact: one abstraction from salt declaration to a program
loaded from the nearest tier.

The PyTorch counterpart of ``mxnet_tpu/artifact/core.py``. Every
persisted program of the port — a serving bucket's optimized graph, the
calibrated int8 graph, the fused step's update plan — goes through one
lifecycle: compose a canonical fingerprint (cache key + declared salt
providers + code digests), probe the local disk tier, probe the remote
tier, else build and persist through both. A call site builds one
``CompiledArtifact`` and calls :meth:`resolve`, or the split
:meth:`load`/:meth:`store` pair when the build happens elsewhere (a
graph optimized inside a forward).
"""
from __future__ import annotations

import os
import threading

from ..utils import compile_cache as _cc
from . import remote as _remote
from . import salts as _salts
from ._counters import STATS

__all__ = ["CompiledArtifact"]


def _adopt_blob(fp, blob):
    """Write a remotely fetched envelope into the local cache dir
    (atomic, like ``disk_store``); True on success."""
    try:
        directory = _cc.cache_dir()
        os.makedirs(directory, exist_ok=True)
        path = _cc._entry_path(fp)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


class CompiledArtifact:
    """One persisted program: fingerprint + tiered load/store.

    Parameters
    ----------
    kind : str
        Namespace of the producing site ('serving', 'quantize',
        'fused_step', ...).
    key : hashable
        The in-memory cache key. ``None`` makes the artifact
        memory-only, as does a key with no process-stable form.
    code_of : tuple
        Functions (bytecode digests) or files (contents) the program is
        made from.
    salts : tuple of str
        Declared salt-provider names, resolved in order against
        ``salt_ctx``.
    salt_ctx : dict
        Context the providers read.
    """

    __slots__ = ("kind", "key", "code_of", "salts", "salt_ctx",
                 "_fp", "_fp_resolved")

    def __init__(self, kind, key, code_of=(), salts=(), salt_ctx=None):
        self.kind = kind
        self.key = key
        self.code_of = tuple(code_of)
        self.salts = tuple(salts)
        self.salt_ctx = dict(salt_ctx or {})
        self._fp = None
        self._fp_resolved = False

    @property
    def fingerprint(self):
        """Hex fingerprint, or None (memory-only). Empty provider
        contributions are dropped before folding, so declaring an
        inactive provider leaves the key as it was."""
        if not self._fp_resolved:
            if self.key is None:
                self._fp = None
            else:
                salted = tuple(t for t in _salts.resolve_salts(
                    self.salts, self.salt_ctx) if t)
                key = ((self.key, ("salts",) + salted) if salted
                       else self.key)
                self._fp = _cc.fingerprint(self.kind, key,
                                           code_of=self.code_of)
            self._fp_resolved = True
        return self._fp

    def load(self):
        """``(payload, meta, source)`` from the nearest warm tier, or
        None. ``source`` is 'disk' or 'remote'; a remote hit is adopted
        into the local tier and re-validated by ``disk_load``, so a
        stale remote entry is removed and is a miss."""
        fp = self.fingerprint
        if fp is None:
            return None
        loaded = _cc.disk_load(fp)
        if loaded is not None:
            return loaded[0], loaded[1], "disk"
        blob = _remote.fetch(fp)
        if blob is None or not _adopt_blob(fp, blob):
            return None
        loaded = _cc.disk_load(fp)
        if loaded is None:
            STATS.add("remote_corrupt")
            return None
        return loaded[0], loaded[1], "remote"

    def store(self, payload, meta=None):
        """Persist ``payload`` to the local tier and (when configured)
        publish it to the remote store; True when the local write
        completed."""
        fp = self.fingerprint
        ok = _cc.disk_store(fp, payload, meta=meta,
                            key_repr=f"{self.kind}:{self.key!r}"[:512])
        if ok:
            _remote.publish_path(fp, _cc._entry_path(fp))
        return ok

    def resolve(self, build, meta=None):
        """Load from the nearest tier, else ``build()`` the payload and
        persist it. Returns ``(payload, meta, source)``, ``source`` in
        {'disk', 'remote', 'build'}. ``meta`` may be a zero-argument
        callable evaluated after a fresh build."""
        loaded = self.load()
        if loaded is not None:
            return loaded
        payload = build()
        m = dict(meta() if callable(meta) else (meta or {}))
        self.store(payload, meta=m)
        return payload, m, "build"
