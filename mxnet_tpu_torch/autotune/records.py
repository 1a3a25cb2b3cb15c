"""TuningRecord store: memory, disk and remote tiers behind artifact
fingerprints.

The PyTorch counterpart of ``mxnet_tpu/autotune/records.py``. A record
is the persisted answer to one measured decision — JSON of ``{version,
decision, key, choice, speedup, ...}``, the JAX package's fields —
filed under the fingerprint of ``("autotune", (RECORD_VERSION,
decision, key))``. The fingerprint folds the torch, CUDA, card and port
versions, so a record measured on one stack is unreachable (a miss, not
a wrong answer) on another, and the CPU and the card file records apart.

Tiers, cheapest first: memory; one ``<fp>.atr`` file per record under
``MXNET_AUTOTUNE_DIR`` (default ``$MXNET_HOME/autotune``), written
atomically; the artifact layer's remote backends
(``artifact/remote.py``), whose hits are written through to disk. A
corrupt or version-drifted record never breaks a consult: it counts
``record_corrupt``, the disk file is removed, and the consult goes on
to the next tier.

This module also owns the ``autotune`` salt provider
(:func:`fingerprint_salt`): the records a process can consult fold into
the fingerprints that declare the salt, and it contributes ``()`` when
none is active.
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager

from ..base import MXNetError
from ..utils import compile_cache as _cc
from ..utils import locks as _locks
from . import registry as _registry

__all__ = ["RECORD_VERSION", "records_dir", "record_fingerprint",
           "consult", "store_record", "trial", "trial_active",
           "active_entries", "fingerprint_salt", "reset_record_state"]

#: bumped when the record schema changes; folded into the fingerprint,
#: so old-schema records become unreachable instead of misparsed
RECORD_VERSION = 1

_SUFFIX = ".atr"

# guards: _CACHE, _TRIALS, _SCAN — dict ops only; every disk/remote
# round-trip happens OUTSIDE this lock
_LOCK = _locks.RankedLock("autotune.records")
_CACHE = {}   # fp -> validated record dict (loaded/stored this process)
_TRIALS = {}  # fp -> (decision, key, choice): tuner overrides
_SCAN = {"dir": None, "mtime": None}


def _count(name, n=1):
    from . import _count as count

    count(name, n)


# ---------------------------------------------------------------------------
# keys and paths

def records_dir():
    """MXNET_AUTOTUNE_DIR, defaulting to $MXNET_HOME/autotune."""
    from .. import env as _env

    d = _env.get_str("MXNET_AUTOTUNE_DIR")
    if d:
        return d
    home = _env.get_str("MXNET_HOME",
                        os.path.join(os.path.expanduser("~"), ".mxnet"))
    return os.path.join(home, "autotune")


_FP_MEMO = {}


def record_fingerprint(decision, key):
    """Stable fingerprint a record for ``(decision, key)`` is filed
    under, or None when the key has no process-stable form (such a
    decision stays heuristic). Version drift (torch, CUDA, card, port,
    RECORD_VERSION) moves the fingerprint, so stale records age out as
    misses. Memoized: the salt is fixed for the process, and consults
    sit on op paths."""
    try:
        return _FP_MEMO[(decision, key)]
    except (KeyError, TypeError):
        pass
    fp = _cc.fingerprint("autotune", (RECORD_VERSION, str(decision), key))
    try:
        _FP_MEMO[(decision, key)] = fp
    except TypeError:
        pass
    return fp


def _path(fp):
    return os.path.join(records_dir(), fp + _SUFFIX)


# ---------------------------------------------------------------------------
# validation

def _validate(rec, decision=None):
    """Structural validity of a parsed record; ``decision`` cross-checks
    the fingerprint's claim when the consult knows it."""
    if not isinstance(rec, dict):
        return False
    if rec.get("version") != RECORD_VERSION:
        return False
    if not isinstance(rec.get("decision"), str) or "choice" not in rec:
        return False
    if decision is not None and rec["decision"] != str(decision):
        return False
    try:
        point = _registry.get_point(rec["decision"])
    except MXNetError:
        return True  # not declared in this process; fingerprint vouches
    choice = rec["choice"]
    if isinstance(choice, list):  # JSON round-trips tuples as lists
        choice = tuple(choice)
    return choice in point.candidates


def _parse(blob, decision=None):
    """Record dict from raw bytes, or None (corrupt)."""
    try:
        rec = json.loads(blob.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None
    return rec if _validate(rec, decision) else None


def _drop_corrupt(fp, where):
    _count("record_corrupt")
    if where == "disk":
        try:
            os.remove(_path(fp))
        except OSError:
            pass


def _choice_of(rec):
    choice = rec["choice"]
    return tuple(choice) if isinstance(choice, list) else choice


# ---------------------------------------------------------------------------
# consult path

def consult(decision, key):
    """The tuned choice for ``(decision, key)`` or None: trial override,
    then memory, disk, remote (remote hits written through to disk).
    Never raises on bad stored state — corrupt tiers degrade to the
    next one."""
    fp = record_fingerprint(decision, key)
    if fp is None:
        return None
    with _LOCK:
        trial_hit = _TRIALS.get(fp)
        rec = _CACHE.get(fp)
    if trial_hit is not None:
        return trial_hit[2]
    if rec is not None:
        return _choice_of(rec)

    # disk tier
    path = _path(fp)
    blob = None
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError:
        blob = None
    if blob is not None:
        rec = _parse(blob, decision)
        if rec is None:
            _drop_corrupt(fp, "disk")
        else:
            _count("record_load")
            with _LOCK:
                _CACHE[fp] = rec
            return _choice_of(rec)

    # remote tier
    from ..artifact import remote as _remote

    blob = _remote.fetch(fp)
    if blob is None:
        return None
    rec = _parse(blob, decision)
    if rec is None:
        _drop_corrupt(fp, "remote")
        return None
    _count("record_load")
    _write_disk(fp, blob)  # write-through: next restart hits disk
    with _LOCK:
        _CACHE[fp] = rec
    return _choice_of(rec)


# ---------------------------------------------------------------------------
# store path

def _write_disk(fp, blob):
    d = records_dir()
    try:
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{fp}.{os.getpid()}.tmp")
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, _path(fp))
        return True
    except OSError:
        return False


def store_record(decision, key, choice, extra=None):
    """Persist the measured winner for ``(decision, key)``: disk, then
    remote publish (best effort, gated by the artifact publish knob).
    Returns the stored record dict, or None when the key is not
    fingerprintable."""
    fp = record_fingerprint(decision, key)
    if fp is None:
        return None
    rec = {"version": RECORD_VERSION, "decision": str(decision),
           "key": repr(key), "choice": choice}
    rec.update(extra or {})
    rec["stack"] = _stack()
    if not _validate(rec, decision):
        raise MXNetError(
            f"refusing to store invalid record for {decision!r}: "
            f"choice {choice!r} is outside the declared candidates")
    blob = (json.dumps(rec, indent=2, sort_keys=True) + "\n").encode()
    _write_disk(fp, blob)
    _count("record_store")
    from ..artifact import remote as _remote

    _remote.publish(fp, blob)
    with _LOCK:
        _CACHE[fp] = rec
    return rec


# ---------------------------------------------------------------------------
# trial overrides (the tuner measuring a candidate)

@contextmanager
def trial(decision, key, choice):
    """Scoped override: within the block, consults of ``(decision,
    key)`` return ``choice`` and the autotune salt carries it — so a
    candidate's executable never collides with the incumbent's."""
    fp = record_fingerprint(decision, key)
    if fp is None:
        raise MXNetError(
            f"cannot trial {decision!r}: key {key!r} has no "
            "process-stable fingerprint")
    entry = (str(decision), key, choice)
    with _LOCK:
        if fp in _TRIALS:
            raise MXNetError(
                f"nested trial for {decision!r} key {key!r}")
        _TRIALS[fp] = entry
    try:
        yield
    finally:
        with _LOCK:
            _TRIALS.pop(fp, None)


def trial_active():
    """True when any trial override is in force (tests, diagnostics)."""
    with _LOCK:
        return bool(_TRIALS)


# ---------------------------------------------------------------------------
# salt provider

def _stack():
    """The stack a record was measured on (the compile cache's salt: the
    format, torch, CUDA, the card, the port), stored beside the JAX
    fields. A directory may hold records of other stacks, or the JAX
    package's under the same default path: they are unreachable by
    fingerprint, and the scan leaves them out of the salt (and on
    disk)."""
    return _cc.encode_value(_cc._salt())


def _scan_disk():
    """Fold every on-disk record of this stack into the memory tier,
    guarded by the directory mtime (one stat per call when nothing
    changed). The scan is authoritative for disk-backed entries: a
    cleared directory drops them from the salt again."""
    d = records_dir()
    try:
        mtime = os.stat(d).st_mtime_ns
    except OSError:
        mtime = None
    with _LOCK:
        if _SCAN["dir"] == d and _SCAN["mtime"] == mtime:
            return
    loaded = {}
    corrupt = []
    if mtime is not None:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            names = []
        for fn in names:
            if not fn.endswith(_SUFFIX):
                continue
            fp = fn[:-len(_SUFFIX)]
            try:
                with open(os.path.join(d, fn), "rb") as fh:
                    blob = fh.read()
            except OSError:
                continue
            try:
                stack = json.loads(blob.decode("utf-8")).get("stack")
            except (ValueError, UnicodeDecodeError, AttributeError):
                continue  # not readable: the consult of its key removes it
            if stack != _stack():
                continue  # another stack's (or the JAX package's) record
            rec = _parse(blob)
            if rec is None:
                corrupt.append(fp)
            else:
                loaded[fp] = rec
    for fp in corrupt:
        _drop_corrupt(fp, "disk")
    with _LOCK:
        _CACHE.clear()
        _CACHE.update(loaded)
        _SCAN["dir"], _SCAN["mtime"] = d, mtime


def active_entries():
    """Sorted, process-stable (decision, key-repr, choice-repr) tuples
    for every record this process can consult — disk records plus live
    trial overrides (overrides shadow a record under the same
    fingerprint)."""
    _scan_disk()
    with _LOCK:
        entries = {fp: (rec["decision"], rec.get("key", ""),
                        repr(_choice_of(rec)))
                   for fp, rec in _CACHE.items()}
        for fp, (decision, key, choice) in _TRIALS.items():
            entries[fp] = (decision, repr(key), "trial:" + repr(choice))
    return tuple(sorted(entries.values()))


def fingerprint_salt(ctx=None):
    """The ``autotune`` salt provider: ``()`` when the subsystem is off
    or no record is active — CompiledArtifact folds declared salts only
    when non-empty, so record-absent fingerprints stay byte-identical
    to the pre-autotune scheme and warm disk caches stay warm."""
    from . import mode

    if mode() == "0":
        return ()
    entries = active_entries()
    if not entries:
        return ()
    return ("autotune", RECORD_VERSION) + entries


# ---------------------------------------------------------------------------

def reset_record_state():
    """Forget the memory tier + trial overrides (tests). Disk files are
    untouched — remove the directory to clear those."""
    with _LOCK:
        _CACHE.clear()
        _TRIALS.clear()
        _SCAN["dir"] = _SCAN["mtime"] = None
    _FP_MEMO.clear()
