"""Deployment bundles: a model version's programs and kernel libraries
as one file.

The PyTorch counterpart of ``mxnet_tpu/artifact/bundle.py``.
``export_bundle`` packs the local envelopes for a set of fingerprints
(every bucket program a warmed ``InferenceSession`` resolved, the
calibrated int8 graph it was built from) and the kernel libraries its
graphs launch (``kernels/_build.py``, each ``.so`` with its sidecar)
into one pickle file; ``import_bundle`` unpacks them into the importing
process's compile-cache directory and kernel-library directory. A
replica warm-started from a bundle builds nothing with ``nvcc`` and runs
no graph optimizer, quantize pass or calibration before its first
response: it still captures its CUDA graphs at ``warmup()``, which no
bundle can carry.

The bundle carries the exporter's compatibility salt
(``compile_cache._salt``: format, torch, CUDA, the card's capability,
the port's version). An importer with another salt skips every entry
and reports ``stale=True``.

Fingerprints named by a bundle this process exported or imported (or by
the bundle files ``MXNET_ARTIFACT_GC_PROTECT`` lists) are pinned
against the remote store's garbage collection.
"""
from __future__ import annotations

import os
import pickle

from ..base import MXNetError
from ..utils import compile_cache as _cc
from ..utils import locks as _locks
from ._counters import STATS

__all__ = ["BUNDLE_FORMAT", "export_bundle", "import_bundle",
           "protected_fingerprints", "reset_protected_fingerprints"]

BUNDLE_FORMAT = 1

# guards: _PROTECTED, _PROTECT_FILES
_PROT_LOCK = _locks.RankedLock("artifact.bundle.protected")
_PROTECTED = set()
_PROTECT_FILES = {}  # path -> (mtime, size, frozenset(fps))


def _knob_bundle_paths():
    """``MXNET_ARTIFACT_GC_PROTECT``: ``os.pathsep``-separated bundle
    paths whose manifests pin their fingerprints."""
    from .. import env as _env

    raw = _env.get_str("MXNET_ARTIFACT_GC_PROTECT") or ""
    return [p for p in raw.split(os.pathsep) if p]


def _bundle_fps(path):
    """The fingerprints a bundle file names, cached by (mtime, size).
    An unreadable file protects nothing."""
    try:
        st = os.stat(path)
        key = (st.st_mtime, st.st_size)
    except OSError:
        return frozenset()
    with _PROT_LOCK:
        cached = _PROTECT_FILES.get(path)
        if cached is not None and cached[:2] == key:
            return cached[2]
    try:
        with open(path, "rb") as f:
            envelope = pickle.load(f)
        fps = frozenset(envelope.get("entries", {}))
    except Exception:
        fps = frozenset()
    with _PROT_LOCK:
        _PROTECT_FILES[path] = key + (fps,)
    return fps


def protected_fingerprints():
    """Every fingerprint pinned against remote-store GC."""
    with _PROT_LOCK:
        out = set(_PROTECTED)
    for path in _knob_bundle_paths():
        out |= _bundle_fps(path)
    return out


def _register_protected(fps):
    with _PROT_LOCK:
        _PROTECTED.update(fps)


def reset_protected_fingerprints():
    """Forget every in-process pin and the knob-file cache (tests)."""
    with _PROT_LOCK:
        _PROTECTED.clear()
        _PROTECT_FILES.clear()


def export_bundle(path, fingerprints, manifest=None, libraries=()):
    """Pack the local entries for ``fingerprints`` and the kernel
    libraries named in ``libraries`` (source names, e.g.
    ``"decode_attention"``) into one bundle at ``path`` (atomic write).
    Entries missing locally are reported, not fatal; a library that was
    never built here raises. Returns ``{"path", "entries", "libraries",
    "missing", "bytes"}``."""
    from ..kernels import _build

    entries = {}
    missing = []
    for fp in sorted(set(f for f in fingerprints if f)):
        try:
            with open(_cc._entry_path(fp), "rb") as f:
                entries[fp] = f.read()
        except OSError:
            missing.append(fp)
    libs = _build.library_files(sorted(set(libraries)))
    envelope = {"format": BUNDLE_FORMAT, "salt": _cc._salt(),
                "manifest": dict(manifest or {}), "entries": entries,
                "libraries": libs}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(envelope, f)
    os.replace(tmp, path)
    STATS.add("bundle_exports")
    _register_protected(entries)
    return {"path": path, "entries": len(entries),
            "libraries": sorted({n.rsplit("-", 1)[0] for n in libs}),
            "missing": missing, "bytes": os.path.getsize(path)}


def _write_atomic(dest, blob):
    tmp = f"{dest}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, dest)
        return True
    except OSError:
        return False


def import_bundle(path):
    """Unpack a bundle: programs into the compile-cache directory,
    kernel libraries into the library directory. Returns ``{"written",
    "skipped", "libraries", "manifest", "stale"}``; ``stale=True`` means
    the exporter's salt does not match this process (nothing written).
    Raises ``MXNetError`` for a file that is not a bundle."""
    from ..kernels import _build

    try:
        with open(path, "rb") as f:
            envelope = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        raise MXNetError(f"cannot read bundle {path!r}: {e}") from e
    if not isinstance(envelope, dict) \
            or envelope.get("format") != BUNDLE_FORMAT:
        raise MXNetError(
            f"{path!r} is not a format-{BUNDLE_FORMAT} artifact bundle")
    entries = envelope.get("entries", {})
    libs = envelope.get("libraries", {})
    manifest = envelope.get("manifest", {})
    if envelope.get("salt") != _cc._salt():
        STATS.add("bundle_imports")
        STATS.add("bundle_entries_skipped", len(entries) + len(libs))
        return {"written": 0, "skipped": len(entries) + len(libs),
                "libraries": 0, "manifest": manifest, "stale": True}
    directory = _cc.cache_dir()
    os.makedirs(directory, exist_ok=True)
    _register_protected(entries)
    written = skipped = 0
    for fp, blob in entries.items():
        if _write_atomic(os.path.join(directory, fp + _cc.SUFFIX), blob):
            written += 1
        else:
            skipped += 1
    libdir = _build.library_dir()
    os.makedirs(libdir, exist_ok=True)
    lib_written = 0
    for fname, blob in libs.items():
        if _write_atomic(os.path.join(libdir, os.path.basename(fname)),
                         blob):
            lib_written += 1
        else:
            skipped += 1
    STATS.add("bundle_imports")
    STATS.add("bundle_entries_written", written + lib_written)
    STATS.add("bundle_entries_skipped", skipped)
    return {"written": written, "skipped": skipped,
            "libraries": lib_written, "manifest": manifest,
            "stale": False}
