"""Persistent program cache and shape bucketing.

The PyTorch counterpart of ``mxnet_tpu/utils/compile_cache.py``. The
JAX package persists XLA executables here. The port compiles no graph
into machine code: what it builds before a first response, and what can
outlive a process, is

- **a program**: a symbol graph after the graph optimizer and the
  quantize pass, with their fusion and lowering decisions (the serving
  buckets, ``serving/session.py``), the calibrated int8 graph
  (``contrib/quantization.py``), or the fused step's update plan
  (``gluon/fused_step.py``). It is stored as a JSON envelope — format
  version, salt, key repr, meta, payload — the port's counterpart of
  the ``.mxc`` pickle, under ``<fingerprint>.mxj``;
- **a kernel library**: each ``csrc/<name>.cu`` built by ``nvcc``
  (``kernels/_build.py``), keyed through :func:`fingerprint` as well.

A CUDA graph cannot be serialized: every process captures its graphs
again, and :func:`note_capture` counts them (``captures``), beside
``retraces`` (graph-optimizer, quantize-pass and trace runs),
``kernel_builds`` (``nvcc`` runs) and ``calibrations``. A warm process
shows zero of all but the captures.

**Disk tier.** :func:`fingerprint` derives a stable key from an
in-memory cache key, salted with the torch, CUDA, card and port
versions and a format version (:func:`_salt`). :func:`disk_store`
writes atomically (tmp + ``os.replace``); :func:`disk_load` treats a
corrupt or version-drifted entry as a miss and removes it.
``MXNET_COMPILE_CACHE_MAX_MB`` bounds the directory
(:func:`_maybe_prune`, oldest-used first).

**Shape bucketing.** :func:`plan_bucketing` rounds the batch axis of
eligible eager op dispatches up to a bucket boundary
(``MXNET_SHAPE_BUCKETS``: ``pow2`` or ``mult:N``; off by default). Only
ops of the ``_BATCH_SAFE`` table are bucketed — ops whose output rows
depend only on the matching input rows, so padding rows with zeros and
slicing the output back is row-bitwise identical — and only outside
``autograd.record()``. ``ndarray.registry.invoke`` pads the inputs and
slices the outputs (:func:`pad_batch`/:func:`slice_batch`). The port
has no dispatch executables, so a bucket saves nothing but the shape
churn a caller downstream may key on; the knob is kept for the JAX
package's users.

The JAX package's ``counting_jit``, ``aot_compile`` and
``_ensure_jax_fallback_cache`` have no counterpart (nothing is jitted).
Knobs: ``MXNET_COMPILE_CACHE=0`` disables the disk tier,
``MXNET_COMPILE_CACHE_DIR`` moves it (default
``$MXNET_HOME/compile_cache``) and, with it, the kernel libraries
(default ``build/mxnet_tpu_torch/``). Counters: the ``compile_cache``
family (:func:`compile_cache_stats`).
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import threading

import numpy as onp

from ..telemetry import metrics as _telemetry
from ..telemetry import tracer as _telem

__all__ = ["cache_enabled", "cache_dir", "fingerprint", "code_digest",
           "disk_load", "disk_store", "note_retrace", "note_capture",
           "note_kernel_build", "note_calibration", "load_or_compile",
           "encode_value", "decode_value", "bucket_spec", "bucket_size",
           "plan_bucketing", "register_batch_safe", "pad_batch",
           "slice_batch", "compile_cache_stats",
           "reset_compile_cache_counters"]

FORMAT_VERSION = 1
SUFFIX = ".mxj"


def _zero_stats():
    return {"disk_hits": 0, "disk_misses": 0, "disk_writes": 0,
            "disk_corrupt": 0, "disk_evicted": 0, "prunes": 0,
            "serialize_skips": 0, "retraces": 0,
            "bucketed_calls": 0, "padded_rows": 0, "true_rows": 0,
            # the port's own: what a warm process still does (captures)
            # and what it must never do again (builds, calibrations)
            "captures": 0, "kernel_builds": 0, "calibrations": 0}


_STATS = _telemetry.counter_family("compile_cache", _zero_stats())


def _bump(name, n=1):
    _STATS.add(name, n)


def compile_cache_stats():
    """Disk-tier, retrace, capture, build and bucketing counters.
    ``pad_ratio`` is padded rows / true rows over all bucketed
    dispatches (0.0 when nothing was bucketed)."""
    st = _STATS.snapshot()
    st["pad_ratio"] = (st["padded_rows"] / st["true_rows"]
                       if st["true_rows"] else 0.0)
    st["enabled"] = cache_enabled()
    return st


def reset_compile_cache_counters():
    """Zero the counters (tests, benchmarks). The disk contents stay."""
    _STATS.reset()


def note_retrace(label=None):
    """Count one graph-optimizer, quantize-pass or trace run."""
    del label
    _bump("retraces")


def note_capture():
    """Count one CUDA-graph capture (``context.cuda_graph``)."""
    _bump("captures")


def note_kernel_build(n=1):
    """Count ``n`` kernel libraries compiled by ``nvcc``."""
    _bump("kernel_builds", n)


def note_calibration():
    """Count one int8 calibration run over calibration batches."""
    _bump("calibrations")


# ---------------------------------------------------------------------------
# knobs

def cache_enabled():
    """``MXNET_COMPILE_CACHE`` (default on); 0 disables the disk tier.
    Read per use."""
    from .. import env as _env

    return _env.get_bool("MXNET_COMPILE_CACHE", True)


def cache_dir():
    """``MXNET_COMPILE_CACHE_DIR``, defaulting to
    ``$MXNET_HOME/compile_cache`` (``$MXNET_HOME`` defaults to
    ``~/.mxnet``)."""
    from .. import env as _env

    d = _env.get_str("MXNET_COMPILE_CACHE_DIR")
    if d:
        return d
    home = _env.get_str("MXNET_HOME",
                        os.path.join(os.path.expanduser("~"), ".mxnet"))
    return os.path.join(home, "compile_cache")


# ---------------------------------------------------------------------------
# fingerprinting

class _Unstable(Exception):
    """A key component has no process-stable canonical form."""


def _canon(v):
    """Process-stable canonical form of a cache-key component. Anything
    whose repr is not reproducible across processes raises ``_Unstable``
    and the key is not persisted: an over-eager canonicalization that
    mapped two computations to one fingerprint would serve the wrong
    program."""
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return v
    if isinstance(v, float):
        return ("f", v.hex())
    if isinstance(v, complex):
        return ("c", v.real.hex(), v.imag.hex())
    if isinstance(v, type):
        return ("cls", v.__module__, v.__qualname__)
    if isinstance(v, onp.dtype):
        return ("dt", str(v))
    if isinstance(v, (onp.bool_, onp.integer, onp.floating)):
        return ("np", str(v.dtype), v.item())
    if isinstance(v, slice):
        return ("sl", _canon(v.start), _canon(v.stop), _canon(v.step))
    if isinstance(v, (tuple, list)):
        return (type(v).__name__,) + tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return ("d",) + tuple(sorted((str(k), _canon(x))
                                     for k, x in v.items()))
    if isinstance(v, frozenset):
        return ("fs",) + tuple(sorted(repr(_canon(x)) for x in v))
    mod = type(v).__module__
    if mod == "torch" and type(v).__name__ in ("dtype", "device"):
        return ("torch", str(v))
    name = getattr(v, "name", None)
    if name is not None and type(v).__name__ in ("dtype", "type"):
        return ("dt", str(name))
    raise _Unstable(type(v).__name__)


_SALT = []


def _capability():
    """The card's compute capability, or None without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return None
    return tuple(torch.cuda.get_device_capability())


def _salt():
    """The compatibility salt of every fingerprint: the format version,
    torch's and CUDA's versions, the card's compute capability and the
    port's version (computed once per process)."""
    if not _SALT:
        import torch

        from .. import __version__ as fw_version

        _SALT.append((FORMAT_VERSION, "torch", torch.__version__,
                      torch.version.cuda, _capability(), fw_version))
    return _SALT[0]


def fingerprint(kind, key, code_of=()):
    """Stable hex fingerprint of an in-memory cache key, or None when a
    component has no process-stable form (that entry stays memory-only).
    ``kind`` namespaces the producing cache. ``code_of`` lists what the
    cached program was made from: functions (their bytecode digests) or
    file paths (their contents, e.g. a kernel's source), so editing an
    implementation invalidates its entries instead of serving the old
    one."""
    try:
        canon = (_salt(), str(kind), _canon(key),
                 tuple(code_digest(f) for f in code_of))
    except _Unstable:
        return None
    return hashlib.sha256(repr(canon).encode()).hexdigest()


_CODE_DIGESTS = {}


def code_digest(fn):
    """Digest of a function's bytecode, recursing into nested code
    objects, or of a file's contents when ``fn`` is a path. Defaults and
    closure cells are not covered: key material must ride the key."""
    if isinstance(fn, (str, os.PathLike)):
        with open(fn, "rb") as f:
            return ("file", os.path.basename(str(fn)),
                    hashlib.sha256(f.read()).hexdigest())
    code = getattr(fn, "__code__", None)
    if code is None:
        return ("nocode", getattr(fn, "__module__", ""),
                getattr(fn, "__qualname__", repr(type(fn))))
    cached = _CODE_DIGESTS.get(code)
    if cached is not None:
        return cached
    h = hashlib.sha256()

    def feed(c):
        h.update(c.co_code)
        h.update(repr((c.co_names, c.co_varnames,
                       c.co_consts and tuple(
                           x for x in c.co_consts
                           if isinstance(x, (type(None), bool, int, float,
                                             complex, str, bytes, tuple))
                       ))).encode())
        for const in c.co_consts:
            if isinstance(const, type(c)):
                feed(const)

    feed(code)
    digest = ("code", h.hexdigest())
    _CODE_DIGESTS[code] = digest
    return digest


# ---------------------------------------------------------------------------
# payload encoding: JSON with type tags, lossless for the values programs
# carry (floats by their hex, tuples apart from lists, numpy arrays)

def encode_value(v):
    """``v`` as a JSON-able value that :func:`decode_value` turns back
    into an equal one; raises ``_Unstable`` for anything else."""
    if v is None or isinstance(v, (bool, str)):
        return v
    if isinstance(v, int) and not isinstance(v, bool):
        return v
    if isinstance(v, float):
        return {"f": v.hex()}
    if isinstance(v, tuple):
        return {"t": [encode_value(x) for x in v]}
    if isinstance(v, list):
        return {"l": [encode_value(x) for x in v]}
    if isinstance(v, dict):
        return {"d": [[encode_value(k), encode_value(x)]
                      for k, x in v.items()]}
    if isinstance(v, (onp.bool_, onp.integer, onp.floating)):
        return {"ns": str(v.dtype), "v": encode_value(v.item())}
    if isinstance(v, onp.ndarray):
        arr = onp.ascontiguousarray(v)
        return {"a": str(arr.dtype), "s": list(arr.shape),
                "b": base64.b64encode(arr.tobytes()).decode("ascii")}
    mod = type(v).__module__
    if mod == "torch" and type(v).__name__ == "dtype":
        return {"td": str(v)}
    raise _Unstable(type(v).__name__)


def decode_value(v):
    if not isinstance(v, (dict, list)):
        return v
    if isinstance(v, list):
        raise ValueError("untagged list in an encoded value")
    if "f" in v:
        return float.fromhex(v["f"])
    if "t" in v:
        return tuple(decode_value(x) for x in v["t"])
    if "l" in v:
        return [decode_value(x) for x in v["l"]]
    if "d" in v:
        return {decode_value(k): decode_value(x) for k, x in v["d"]}
    if "ns" in v:
        return onp.dtype(v["ns"]).type(decode_value(v["v"]))
    if "a" in v:
        return onp.frombuffer(base64.b64decode(v["b"]),
                              dtype=v["a"]).reshape(v["s"]).copy()
    if "td" in v:
        import torch

        return getattr(torch, v["td"].split(".", 1)[1])
    raise ValueError(f"unknown tag in an encoded value: {sorted(v)}")


# ---------------------------------------------------------------------------
# disk tier

def _entry_path(fp):
    return os.path.join(cache_dir(), fp + SUFFIX)


def envelope_valid(env):
    """Whether a parsed envelope is of this format and this process's
    salt."""
    return isinstance(env, dict) and env.get("format") == FORMAT_VERSION \
        and env.get("salt") == encode_value(_salt())


def disk_load(fp):
    """``(payload, meta)`` of the entry under ``fp``, or None. Any
    failure — missing file, truncated JSON, version drift — is a miss;
    a corrupt file is removed so it does not fail every later start."""
    if fp is None or not cache_enabled():
        return None
    with _telem.span("compile_cache.disk_load", cat="io",
                     fp=fp[:16]) as sp:
        out = _disk_load_inner(fp)
        sp.set(hit=out is not None)
        return out


def _disk_load_inner(fp):
    path = _entry_path(fp)
    if not os.path.exists(path):
        _bump("disk_misses")
        return None
    # a transient IO fault (resilience/faults.py) degrades to a MISS,
    # outside the corruption handler below, which deletes the file
    from ..resilience import faults as _faults

    try:
        _faults.maybe_fail("compile_cache_io")
    except Exception:
        _bump("disk_misses")
        return None
    try:
        with open(path, "rb") as f:
            env = json.loads(f.read().decode("utf-8"))
        if not envelope_valid(env):
            raise ValueError("compile-cache version mismatch")
        payload = decode_value(env["payload"])
        meta = decode_value(env.get("meta", {"d": []}))
    except Exception:
        _bump("disk_corrupt")
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    try:
        os.utime(path)  # recency: pruning evicts the oldest-used first
    except OSError:
        pass
    _bump("disk_hits")
    return payload, meta


def disk_store(fp, payload, meta=None, key_repr=None):
    """Write ``payload`` under ``fp``; True on a completed write. A
    payload :func:`encode_value` cannot carry counts as a
    ``serialize_skip``; IO problems are a skipped write, never a broken
    caller."""
    if fp is None or not cache_enabled():
        return False
    with _telem.span("compile_cache.disk_store", cat="io",
                     fp=fp[:16]) as sp:
        ok = _disk_store_inner(fp, payload, meta, key_repr)
        sp.set(written=ok)
        return ok


def _disk_store_inner(fp, payload, meta, key_repr):
    try:
        blob = json.dumps({"format": FORMAT_VERSION,
                           "salt": encode_value(_salt()),
                           "key_repr": key_repr,
                           "meta": encode_value(dict(meta or {})),
                           "payload": encode_value(payload)}).encode()
    except (_Unstable, TypeError, ValueError):
        _bump("serialize_skips")
        return False
    try:
        from ..resilience import faults as _faults

        _faults.maybe_fail("compile_cache_io")
        directory = cache_dir()
        os.makedirs(directory, exist_ok=True)
        path = _entry_path(fp)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)  # atomic: concurrent writers race safely
    except Exception:
        return False
    _bump("disk_writes")
    _maybe_prune(directory)
    return True


_PRUNE_EVERY = 32
_prune_tick = [0]


def _maybe_prune(directory):
    """Every ``_PRUNE_EVERY``-th write, if the entries exceed
    ``MXNET_COMPILE_CACHE_MAX_MB`` (default 1024; 0 = unbounded), remove
    the oldest-used (mtime, refreshed on every load) down to 80% of the
    cap. A concurrent pruner's lost races are skipped."""
    _prune_tick[0] += 1
    if _PRUNE_EVERY > 1 and _prune_tick[0] % _PRUNE_EVERY != 1:
        return
    from .. import env as _env

    cap_mb = _env.get_int("MXNET_COMPILE_CACHE_MAX_MB", 1024)
    if cap_mb <= 0:
        return
    entries = []
    try:
        with os.scandir(directory) as it:
            for e in it:
                if not e.name.endswith(SUFFIX):
                    continue
                try:
                    st = e.stat()
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, e.path))
    except OSError:
        return
    total = sum(sz for _, sz, _ in entries)
    cap = cap_mb * 1024 * 1024
    if total <= cap:
        return
    _bump("prunes")
    entries.sort()
    for _, sz, path in entries:
        try:
            os.remove(path)
        except OSError:
            continue
        _bump("disk_evicted")
        total -= sz
        if total <= cap * 0.8:
            break


def load_or_compile(fp, build, meta=None):
    """Load the entry under ``fp``, else call ``build()`` for the
    payload and persist it. Returns ``(payload, meta, from_disk)``.
    ``meta`` may be a dict or a zero-argument callable evaluated after
    the build. ``fp=None`` builds memory-only."""
    loaded = disk_load(fp)
    if loaded is not None:
        return loaded[0], loaded[1], True
    payload = build()
    m = dict(meta() if callable(meta) else (meta or {}))
    disk_store(fp, payload, meta=m)
    return payload, m, False


# ---------------------------------------------------------------------------
# shape bucketing

_SPEC_CACHE = {}


def bucket_spec():
    """Parsed ``MXNET_SHAPE_BUCKETS``: None (off, the default),
    ``("pow2",)`` or ``("mult", N)``; ``1`` means pow2."""
    from .. import env as _env

    raw = _env.get_str("MXNET_SHAPE_BUCKETS")
    if raw is None:
        return None
    spec = _SPEC_CACHE.get(raw)
    if spec is None:
        spec = _parse_spec(raw)
        _SPEC_CACHE[raw] = spec
    return spec or None


def _parse_spec(raw):
    raw = raw.strip()
    if raw in ("", "0", "false", "False", "off"):
        return ()
    if raw in ("1", "pow2", "true", "True", "on"):
        return ("pow2",)
    if raw.startswith("mult:"):
        try:
            n = int(raw.split(":", 1)[1])
        except ValueError:
            n = 0
        if n > 1:
            return ("mult", n)
    import logging

    logging.warning("invalid MXNET_SHAPE_BUCKETS=%r; bucketing disabled "
                    "(expected 0 | pow2 | mult:N)", raw)
    return ()


def bucket_size(n, spec):
    """Bucket boundary for a batch of ``n`` rows under ``spec``."""
    if n <= 1:
        return n
    if spec[0] == "pow2":
        b = 1
        while b < n:
            b <<= 1
        return b
    return -(-n // spec[1]) * spec[1]


# op -> bucketing rule, the JAX package's table. "ew": elementwise or
# broadcast — every max-rank operand whose axis 0 equals the batch is
# padded; lower-rank and axis0 == 1 operands pass through. ("row",
# (slots...), guard): only those operand slots carry the batch on axis
# 0 (rank >= 2), and ``guard(config, datas)`` vetoes configs that mix
# rows. Ops not in the table are never bucketed.

def _softmax_axis_ok(config, datas):
    if config.get("use_length") or config.get("length") is not None:
        return False
    axis = config.get("axis", -1)
    if not isinstance(axis, int):
        return False
    return axis % datas[0].ndim != 0


def _dot_rowwise(config, datas):
    return not config.get("transpose_a", False)


def _fc_flatten(config, datas):
    return bool(config.get("flatten", True))


_BATCH_SAFE = {
    "broadcast_add": "ew", "broadcast_sub": "ew", "broadcast_mul": "ew",
    "broadcast_div": "ew", "broadcast_power": "ew",
    "broadcast_maximum": "ew", "broadcast_minimum": "ew",
    "elemwise_add": "ew", "elemwise_sub": "ew", "elemwise_mul": "ew",
    "elemwise_div": "ew",
    "tanh": "ew", "sigmoid": "ew", "relu": "ew", "exp": "ew", "log": "ew",
    "sqrt": "ew", "square": "ew", "abs": "ew", "negative": "ew",
    "clip": "ew",
    "activation": ("row", (0,), None),
    "fully_connected": ("row", (0,), _fc_flatten),
    "flatten": ("row", (0,), None),
    "softmax": ("row", (0,), _softmax_axis_ok),
    "log_softmax": ("row", (0,), _softmax_axis_ok),
    "dot": ("row", (0,), _dot_rowwise),
}


def register_batch_safe(opname, rule):
    """Declare an op safe for batch-axis bucketing (see ``_BATCH_SAFE``
    for the row-independence contract)."""
    _BATCH_SAFE[opname] = rule


_ARR = object()  # placeholder for array operands during bind_partial


def _bound_config(opname, arg_template, kwargs):
    """The op's config as its body sees it: kwargs plus positional
    literals bound to their names through the op signature; None when
    binding fails (an unresolvable config vetoes)."""
    merged = dict(kwargs)
    if all(t[0] == "arr" for t in arg_template):
        return merged
    from ..ndarray.registry import get_op

    opdef = get_op(opname)
    if opdef is None:
        return None
    try:
        import inspect

        pos = [_ARR if t[0] == "arr" else t[1] for t in arg_template]
        bound = inspect.signature(opdef.fn).bind_partial(*pos)
    except TypeError:
        return None
    for name, val in bound.arguments.items():
        if val is not _ARR and name not in merged:
            merged[name] = val
    return merged


def plan_bucketing(opname, datas, arg_template, kwargs):
    """``(padded_batch, true_batch, pad_slots)`` when this dispatch
    should run at a bucket's batch, else None. ``datas`` are the array
    operands (anything with ``ndim`` and ``shape``), ``arg_template``
    the positional arguments as ``("arr", i)`` / ``("lit", value)``."""
    spec = bucket_spec()
    if spec is None or not datas:
        return None
    rule = _BATCH_SAFE.get(opname)
    if rule is None:
        return None
    if rule == "ew":
        ndim = max(d.ndim for d in datas)
        if ndim == 0:
            return None
        batch = max((d.shape[0] for d in datas if d.ndim == ndim),
                    default=0)
        if batch <= 1:
            return None
        slots = []
        for i, d in enumerate(datas):
            if d.ndim == ndim and d.shape[0] == batch:
                slots.append(i)
            elif d.ndim == ndim and d.shape[0] != 1:
                return None
        if not slots:
            return None
    else:
        _, arg_slots, guard = rule
        slots = [s for s in arg_slots if s < len(datas)]
        if not slots:
            return None
        if any(datas[s].ndim < 2 for s in slots):
            return None
        if guard is not None:
            config = _bound_config(opname, arg_template, kwargs)
            if config is None:
                return None
            try:
                if not guard(config, datas):
                    return None
            except Exception:
                return None
        batch = datas[slots[0]].shape[0]
        if batch <= 1:
            return None
        if any(datas[s].shape[0] != batch for s in slots):
            return None
    padded = bucket_size(batch, spec)
    if padded == batch:
        return None
    return padded, batch, tuple(slots)


def pad_batch(data, padded):
    """Zero-pad axis 0 of a tensor (or numpy array) up to ``padded``."""
    n = data.shape[0]
    if n == padded:
        return data
    if isinstance(data, onp.ndarray):
        return onp.concatenate(
            [data, onp.zeros((padded - n,) + data.shape[1:], data.dtype)])
    import torch

    return torch.cat([data, data.new_zeros((padded - n,) +
                                           tuple(data.shape[1:]))], 0)


def slice_batch(data, padded, true):
    """Undo :func:`pad_batch` on an output whose axis 0 is the padded
    batch."""
    if data.ndim and data.shape[0] == padded:
        return data[:true]
    return data


def note_bucketed(padded, true):
    _bump("bucketed_calls")
    _bump("padded_rows", padded - true)
    _bump("true_rows", true)
