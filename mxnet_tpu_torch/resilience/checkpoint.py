"""CheckpointManager: crash-consistent snapshots of the whole training
state, on one device.

The PyTorch counterpart of ``mxnet_tpu/resilience/checkpoint.py``
without its mesh half (per-device shard files, ``_extract_shards``,
``_reassemble``, ``_replace_per_plan``: slice 9b). A snapshot holds
what a mid-epoch resume needs to continue bitwise as if nothing had
happened:

- the parameters, by name (batch norm's running statistics are
  parameters);
- the Trainer's optimizer state tree and its counters (``num_update``,
  ``begin_num_update``, the per-index counts), the AMP loss scaler
  (scale, window position, factor, window) and the fused step's skip
  total, through the Trainer's own walk (``Trainer._state_capture``);
- the random stream: the global seed and every device generator's state
  (``random._capture_state``), so dropout after a resume draws the
  uninterrupted run's masks;
- a kvstore's values and its updater's states;
- a serving ``SessionStateStore``'s live sessions (``session_state=``);
- the caller's data cursor and ``extra`` payload.

**Layout and crash consistency**, as in the JAX package: a checkpoint is
a directory ``ckpt-%012d`` holding ``state.pkl`` and ``manifest.json``
(format, salt, step, cursor, and each file's bytes and sha256 salted with
the format version, the port's version, torch's version and the device
type). It is written under ``.tmp-*`` with every file ``fsync``-ed, then
renamed into place, so a crash leaves only a ``.tmp-*`` directory (the
next manager deletes it). ``latest_valid`` passes over a checkpoint whose
hashes or salt do not match, with a warning and ``ckpt_corrupt_skipped``:
a checkpoint made on the card does not validate on the CPU, and one made
by another build of the port or of torch validates nowhere.

**Tensors are mutable here.** The JAX capture holds references, since jax
arrays are immutable; the port's parameters and optimizer states are
written in place by the fused step's CUDA graph. So an asynchronous
capture copies every leaf on the device, in one batched copy
(``torch._foreach_copy_``) on the step's stream, and records an event
after it: the step thread pays that copy and nothing else (no host sync;
the fused step's device counters ride in the same copy instead of being
read back). The writer thread makes its own stream wait on the event,
copies into pinned host memory, then pickles, hashes and writes. A
synchronous save copies to the host at once.

**Restores write in place.** The fused step's graph, a hybridized block's
graphs and an executor's graphs read fixed addresses, so every restored
parameter and optimizer state is ``copy_``-ed into its own storage and
the fused step's device counters are re-seeded in place at the next
step; a generator keeps its object (``set_state``). A restore onto a
network that lacks a saved parameter, or holds it at another shape or
dtype, raises :class:`MXNetError` naming the parameter.

**Async writes.** One persistent writer thread over a queue bounded at
two (a save that finds it full waits, counted as ``ckpt_async_waits``);
a write that fails surfaces at the next ``save`` or ``wait`` and is never
dropped. ``MXNET_CKPT_DIR``, ``MXNET_CKPT_KEEP`` and ``MXNET_CKPT_ASYNC``
give the defaults. The write is the ``checkpoint.write`` telemetry span,
the restore ``checkpoint.restore``; the fault seam is
``checkpoint_write``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import queue as _queue
import shutil
import threading
import time

import numpy as onp
import torch

from ..base import MXNetError, getenv

__all__ = ["CheckpointManager"]

FORMAT_VERSION = 1
_PAYLOAD = "state.pkl"
_MANIFEST = "manifest.json"


def _log():
    return logging.getLogger(__name__)


def _salt(device_type):
    """What a checkpoint's hashes are salted with: a checkpoint of another
    format, build of the port, build of torch or device type does not
    validate (the JAX salt's ``jax.__version__`` and ``default_backend()``
    are torch's version and the state's device type here)."""
    from .. import __version__ as port_version

    return [FORMAT_VERSION, port_version, torch.__version__,
            str(device_type)]


class _Bfloat16:
    """A bfloat16 tensor's bits on the host: numpy has no bfloat16, so
    the int16 view travels, bit for bit."""

    __slots__ = ("bits",)

    def __init__(self, bits):
        self.bits = bits

    def __reduce__(self):
        return (_Bfloat16, (self.bits,))


class _Ref:
    """A leaf's place in a snapshot tree until its host copy fills it."""

    __slots__ = ("index",)

    def __init__(self, index):
        self.index = index


class _Job:
    """One capture on its way to disk: the tree, its leaves (device copies
    with the events that end them, or host leaves already) and the
    salt."""

    __slots__ = ("snap", "leaves", "events", "salt")

    def __init__(self, snap, leaves, events, salt):
        self.snap, self.leaves, self.events, self.salt = \
            snap, leaves, events, salt


def _bulk_copy(tensors):
    """Device copies of ``tensors`` in one batched copy on each device's
    current stream (the step's), and an event recorded after it per
    device. CPU tensors are cloned."""
    copies = [torch.empty_like(t) for t in tensors]
    if copies:
        with torch.no_grad():
            torch._foreach_copy_(copies, tensors)
    events = {}
    for t in copies:
        if t.is_cuda and t.device not in events:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
            events[t.device] = ev
    return copies, events


def _host_leaf(t):
    """A CPU tensor as what the payload pickles: a numpy array, or the
    bits of a bfloat16 one."""
    if t.dtype == torch.bfloat16:
        return _Bfloat16(t.view(torch.int16).numpy())
    return t.numpy()


def _to_host(tensors, events, streams):
    """Host leaves of ``tensors``. Device tensors are copied into pinned
    memory on a side stream of their device (from ``streams``) that first
    waits on the capture's event, and the host waits on that stream
    alone; with no event (a synchronous save) the copies run on the
    current stream, after the step's work."""
    host = [None] * len(tensors)
    pending = {}
    for i, t in enumerate(tensors):
        if not t.is_cuda:
            host[i] = _host_leaf(t.detach())
            continue
        ev = events.get(t.device)
        if ev is None:
            host[i] = _host_leaf(t.detach().cpu())
            continue
        side = streams.get(t.device)
        if side is None:
            side = streams[t.device] = torch.cuda.Stream(t.device)
        if t.device not in pending:
            side.wait_event(ev)
            pending[t.device] = side
        with torch.cuda.stream(side):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
        host[i] = h
    for side in pending.values():
        side.synchronize()
    return [_host_leaf(h) if isinstance(h, torch.Tensor) else h
            for h in host]


def _fill(tree, host):
    """``tree`` with every :class:`_Ref` replaced by its host leaf."""
    if isinstance(tree, _Ref):
        return host[tree.index]
    if isinstance(tree, dict):
        return {k: _fill(v, host) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, host) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_fill(v, host) for v in tree)
    return tree


def _tensor(leaf):
    """A payload leaf as a CPU tensor (no copy where numpy allows)."""
    if isinstance(leaf, _Bfloat16):
        return _tensor(leaf.bits).view(torch.bfloat16)
    arr = onp.asarray(leaf)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # ascontiguousarray would make 0-d 1-d
    return torch.from_numpy(arr)


def _map_state(state, fn):
    if state is None:
        return None
    if isinstance(state, tuple):
        return tuple(_map_state(s, fn) for s in state)
    return fn(state)


class _HashingWriter:
    """A file's ``write`` that also feeds the salted hash and counts the
    bytes, so the payload streams to disk as it is pickled (arrays go
    straight from their buffers: no second copy of the snapshot)."""

    def __init__(self, f, salt):
        self._f = f
        self._h = hashlib.sha256()
        self._h.update(repr(salt).encode())
        self.nbytes = 0

    def write(self, b):
        self._h.update(b)
        self.nbytes += memoryview(b).nbytes
        return self._f.write(b)

    def hexdigest(self):
        return self._h.hexdigest()


def _file_hash(path, salt, chunk=1 << 24):
    """(bytes, salted sha256) of a file, read in chunks."""
    h = hashlib.sha256()
    h.update(repr(salt).encode())
    n = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
            n += len(b)
    return n, h.hexdigest()


def _fsync_write(path, blob):
    with open(path, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    """Atomic, validated, keep-last-N checkpoints (see the module
    docstring).

    Parameters
    ----------
    directory : str, optional — the checkpoints' root (made if absent);
        default ``MXNET_CKPT_DIR``, else ``$MXNET_HOME/checkpoints``
    trainer : gluon.Trainer, optional — its parameters, optimizer state,
        counters and loss scaler
    params : list of Parameter, optional — the parameter set (default:
        the trainer's)
    kvstore : KVStore, optional — its values and updater states
    keep : int — how many checkpoints stay (default ``MXNET_CKPT_KEEP``,
        3; 0 keeps every one)
    async_mode : bool — write on the writer thread (default
        ``MXNET_CKPT_ASYNC``, on)
    include_prng : bool — the random stream's position (default True)
    session_state : serving.SessionStateStore, optional — every live
        serving session's state rows, resumed into it on restore
    """

    def __init__(self, directory=None, trainer=None, params=None,
                 kvstore=None, keep=None, async_mode=None,
                 include_prng=True, session_state=None):
        if directory is None:
            directory = getenv("MXNET_CKPT_DIR", "")
        if not directory:
            home = getenv("MXNET_HOME", os.path.join(
                os.path.expanduser("~"), ".mxnet"))
            directory = os.path.join(home, "checkpoints")
        self.directory = directory
        self.trainer = trainer
        self._params = params
        self.kvstore = kvstore
        self.keep = int(keep if keep is not None else
                        getenv("MXNET_CKPT_KEEP", 3, int))
        self.async_mode = bool(async_mode if async_mode is not None else
                               getenv("MXNET_CKPT_ASYNC", True, bool))
        self.include_prng = bool(include_prng)
        self.session_state = session_state
        #: device bytes of the last capture's copies (0 for a synchronous
        #: save, which copies to the host at once)
        self.last_snapshot_bytes = 0
        self._q = None  # the writer's bounded queue, made at first use
        self._writer = None
        self._write_error = None
        self._streams = {}  # device -> the writer's copy stream
        os.makedirs(self.directory, exist_ok=True)
        self._clean_stale_tmp()

    # -- layout --------------------------------------------------------

    def _dir_for(self, step):
        return os.path.join(self.directory, f"ckpt-{int(step):012d}")

    def list_steps(self):
        """Every checkpoint step on disk (valid or not), ascending."""
        steps = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return steps
        for name in names:
            if name.startswith("ckpt-"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(steps)

    def _clean_stale_tmp(self):
        """Delete the ``.tmp-*`` directories a killed writer left."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _attached_params(self):
        if self._params is not None:
            return self._params
        return None if self.trainer is None else self.trainer._params

    def _device_type(self):
        """The device type of the state this manager snapshots: its
        parameters', else the session store's, else the store's values',
        else the default context's."""
        for p in self._attached_params() or ():
            if p._ndarray is not None:
                return p._ndarray.data.device.type
        if self.session_state is not None:
            return self.session_state.device.type
        if self.kvstore is not None:
            for v in self.kvstore._store.values():
                return v._data.device.type
        from ..context import current_context

        return "cpu" if current_context().device_type != "gpu" else "cuda"

    # -- validation ----------------------------------------------------

    def validate(self, step):
        """True when the checkpoint at ``step`` is complete and every
        file's salted hash matches its manifest."""
        d = self._dir_for(step)
        try:
            with open(os.path.join(d, _MANIFEST)) as f:
                manifest = json.load(f)
            if manifest.get("format") != FORMAT_VERSION:
                return False
            salt = manifest.get("salt")
            if salt != _salt(self._device_type()):
                return False
            for fname, info in manifest.get("files", {}).items():
                if _file_hash(os.path.join(d, fname), salt) != \
                        (info.get("bytes"), info.get("sha256")):
                    return False
            return True
        except (OSError, ValueError, KeyError, AttributeError):
            return False

    def latest_valid(self):
        """The newest step whose checkpoint validates, or None; each
        invalid one passed over is a warning and ``ckpt_corrupt_skipped``."""
        from . import _count

        for step in reversed(self.list_steps()):
            if self.validate(step):
                return step
            _count("ckpt_corrupt_skipped")
            _log().warning(
                "checkpoint %s is corrupt or incomplete; falling back to "
                "the previous one", self._dir_for(step))
        return None

    # -- capture -------------------------------------------------------

    def _capture(self, step, cursor, extra):
        """The state tree now, with a :class:`_Ref` for every tensor leaf,
        and the leaves: device copies in one batch (async) or host copies
        (sync)."""
        refs = []

        def leaf(x):
            refs.append((x.data if hasattr(x, "asnumpy") else x).detach())
            return _Ref(len(refs) - 1)

        snap = {"step": int(step), "cursor": dict(cursor or {}),
                "extra": extra, "trainer": None, "params": None,
                "prng": None, "kvstore": None, "session_state": None}
        if self.session_state is not None:
            # host rows already: pickled as they are
            snap["session_state"] = self.session_state.export_state()
        if self.trainer is not None:
            snap["trainer"] = self.trainer._state_capture(leaf)
        params = self._attached_params()
        if params is not None:
            snap["params"] = [(p.name, leaf(p._ndarray.data))
                              for p in params if p._ndarray is not None]
        if self.include_prng:
            from .. import random as _random

            snap["prng"] = _random._capture_state()
        if self.kvstore is not None:
            snap["kvstore"] = self._capture_kvstore(self.kvstore, leaf)
        salt = _salt(self._device_type())
        if self.async_mode:
            copies, events = _bulk_copy(refs)
            self.last_snapshot_bytes = sum(
                t.numel() * t.element_size() for t in copies if t.is_cuda)
            return _Job(snap, copies, events, salt)
        self.last_snapshot_bytes = 0
        return _Job(snap, _to_host(refs, {}, self._streams), None, salt)

    @staticmethod
    def _capture_kvstore(kv, leaf):
        from ..ndarray import sparse as _sp

        if kv._async_mode:
            kv._async_flush()  # pending pushes land in the snapshot
        if kv._ps is not None:
            kv._ps.flush()
        values = {}
        for k, v in kv._store.items():
            if isinstance(v, _sp.BaseSparseNDArray):
                v = v.todense()
            values[k] = leaf(v.data)
        updater = kv._updater
        states = None
        if updater is not None and hasattr(updater, "get_states"):
            states = updater.get_states(dump_optimizer=False)
        return {"values": values, "updater_states": states}

    # -- write ---------------------------------------------------------

    def save(self, step, cursor=None, extra=None):
        """Snapshot now; write inline (sync) or hand the snapshot to the
        writer thread (async; with two already queued the save waits,
        counted as ``ckpt_async_waits``). Raises a pending writer
        failure first. Returns the directory the write lands in."""
        from . import _count

        self._raise_pending()
        job = self._capture(step, cursor, extra)
        if self.async_mode:
            q = self._ensure_writer()
            try:
                q.put_nowait(job)
            except _queue.Full:
                _count("ckpt_async_waits")
                q.put(job)
            _count("ckpt_async_saves")
        else:
            self._write(job)
        return self._dir_for(step)

    def wait(self):
        """Block until every queued write finished; raise the first
        failure."""
        if self._q is not None:
            self._q.join()
        self._raise_pending()

    def _ensure_writer(self):
        """The writer thread, made at first use. It holds the manager
        weakly, so a dropped manager (and the trainer it holds) can be
        collected; its finalizer posts the None that ends the thread."""
        if self._q is None:
            import weakref

            q = self._q = _queue.Queue(maxsize=2)
            ref = weakref.ref(self)

            def loop():
                while True:
                    job = q.get()
                    try:
                        if job is None:
                            return
                        mgr = ref()
                        if mgr is None:
                            return
                        try:
                            mgr._write(job)
                        except BaseException as e:  # noqa: BLE001
                            # surfaced at the next save() or wait()
                            if mgr._write_error is None:
                                mgr._write_error = e
                        finally:
                            del mgr, job
                    finally:
                        q.task_done()

            self._writer = threading.Thread(
                target=loop, name="mxnet-ckpt-writer", daemon=True)
            self._writer.start()
            weakref.finalize(self, q.put, None)
        return self._q

    def _raise_pending(self):
        err, self._write_error = self._write_error, None
        if err is not None:
            raise MXNetError(
                f"background checkpoint write failed: {err}") from err

    def _write(self, job):
        from ..telemetry import tracer as _telem

        with _telem.span("checkpoint.write", cat="checkpoint",
                         step=job.snap["step"],
                         mode="async" if self.async_mode else "sync"):
            self._write_inner(job)

    def _write_inner(self, job):
        from . import _count
        from . import faults as _faults
        from ..gluon.trainer import state_resolve

        t0 = time.perf_counter()
        _faults.maybe_fail("checkpoint_write")
        leaves = job.leaves
        if job.events is not None:
            leaves = _to_host(leaves, job.events, self._streams)
        snap = _fill(job.snap, leaves)
        job.leaves = leaves = None  # the device copies go here
        if snap["trainer"] is not None:
            state_resolve(snap["trainer"])
        step = job.snap["step"]
        salt = job.salt
        final = self._dir_for(step)
        tmp = os.path.join(
            self.directory,
            f".tmp-ckpt-{step}-{os.getpid()}-{threading.get_ident()}")
        os.makedirs(tmp)
        try:
            with open(os.path.join(tmp, _PAYLOAD), "wb") as f:
                w = _HashingWriter(f, salt)
                pickle.dump(snap, w, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            del snap
            manifest = {"format": FORMAT_VERSION, "salt": salt, "step": step,
                        "cursor": job.snap["cursor"],
                        "files": {_PAYLOAD: {"sha256": w.hexdigest(),
                                             "bytes": w.nbytes}}}
            _fsync_write(os.path.join(tmp, _MANIFEST),
                         json.dumps(manifest).encode())
            if os.path.exists(final):  # a step saved again: replace it
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic: no torn checkpoint is visible
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _count("ckpt_saves")
        _count("ckpt_bytes", w.nbytes)
        _count("ckpt_write_s", time.perf_counter() - t0)
        self._prune()

    def _prune(self):
        from . import _count

        if self.keep <= 0:
            return
        for step in self.list_steps()[:-self.keep]:
            shutil.rmtree(self._dir_for(step), ignore_errors=True)
            _count("ckpt_pruned")

    # -- restore -------------------------------------------------------

    def load(self, step=None):
        """The raw payload of a checkpoint (default: the latest valid one),
        its leaves host arrays. Raises when none validates."""
        if step is None:
            step = self.latest_valid()
            if step is None:
                raise MXNetError(
                    f"no valid checkpoint under {self.directory!r}")
        elif not self.validate(step):
            raise MXNetError(f"checkpoint {self._dir_for(step)!r} is "
                             "missing or corrupt")
        with open(os.path.join(self._dir_for(step), _PAYLOAD), "rb") as f:
            return pickle.load(f)  # a file the port wrote and validated

    def restore(self, step=None):
        """Restore the latest valid (or the given) checkpoint into the
        attached trainer, parameters, store, random stream and session
        store, in place. Returns ``{"step", "cursor", "extra"}`` for the
        caller's data pipeline. Pending writes are joined first."""
        from ..telemetry import tracer as _telem

        with _telem.span("checkpoint.restore", cat="checkpoint") as sp:
            out = self._restore_inner(step)
            sp.set(step=out["step"])
            return out

    def _restore_inner(self, step):
        from . import _count

        self.wait()
        payload = self.load(step)
        if payload.get("params") is not None:
            self._restore_params(payload["params"])
        if payload.get("trainer") is not None and self.trainer is not None:
            tr = dict(payload["trainer"])
            tr["states"] = [_map_state(s, _tensor) for s in tr["states"]]
            self.trainer._state_restore(tr)
        if payload.get("prng") is not None and self.include_prng:
            from .. import random as _random

            _random._restore_state(payload["prng"])
        if payload.get("kvstore") is not None and self.kvstore is not None:
            self._restore_kvstore(self.kvstore, payload["kvstore"])
        if payload.get("session_state") is not None and \
                self.session_state is not None:
            self.session_state.restore_state(payload["session_state"])
        _count("ckpt_restores")
        return {"step": payload["step"], "cursor": payload["cursor"],
                "extra": payload.get("extra")}

    def _restore_params(self, saved):
        params = self._attached_params()
        if params is None:
            return
        by_name = {p.name: p for p in params}
        missing = [name for name, _ in saved if name not in by_name]
        if missing:
            raise MXNetError(
                "checkpoint parameters not present in the attached group: "
                f"{missing} (model/trainer mismatch?)")
        host = [(by_name[name], _tensor(val)) for name, val in saved]
        for p, t in host:
            if p._ndarray is not None:
                var = p._ndarray.data
                if tuple(var.shape) != tuple(t.shape) or \
                        var.dtype != t.dtype:
                    raise MXNetError(
                        f"checkpoint parameter {p.name!r} is "
                        f"{tuple(t.shape)} {t.dtype}, the network's is "
                        f"{tuple(var.shape)} {var.dtype}")
        for p, t in host:
            p.set_data(t)  # into the parameter's own storage

    @staticmethod
    def _restore_kvstore(kv, payload):
        from .. import ndarray as nd
        from ..context import Context, resolve_device
        from ..ndarray import sparse as _sp

        dev = None
        for k, val in payload["values"].items():
            t = _tensor(val)
            stored = kv._store.get(k)
            if stored is None:
                kv._store[k] = nd.NDArray(t.to(resolve_device(None)))
            elif isinstance(stored, _sp.BaseSparseNDArray):
                dev = stored._data.device
                kv._store[k] = nd.NDArray(t.to(dev)).tostype(stored.stype)
            else:
                dev = stored.data.device
                with torch.no_grad():
                    stored.data.copy_(t)
        states = payload.get("updater_states")
        updater = kv._updater
        if states is not None and updater is not None and \
                hasattr(updater, "set_states"):
            if dev is None:
                updater.set_states(states)
            else:
                with Context.from_device(dev):
                    updater.set_states(states)

    # -- lifecycle -----------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
