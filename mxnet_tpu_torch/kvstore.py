"""KVStore: parameter aggregation and broadcast.

The PyTorch counterpart of ``mxnet_tpu/kvstore.py`` (reference:
kvstore.cc:40-73 Create, kvstore_local.h PushImpl, comm.h,
kvstore_nccl.h, kvstore_dist.h). Types:

- ``local``, ``device``, ``nccl`` — one process: a list push is summed
  (``parallel.group_all_reduce`` when the values sit one on each of
  several devices, else serially in list order) and the updater, if
  any, runs on the sum;
- ``dist_sync``, ``dist_device_sync`` — every rank of the process group
  (``tools/launch.py``) pushes; ``_apply_update`` all-reduces the
  aggregate over the ranks (``parallel.all_reduce``: NCCL or gloo by
  the launcher's rule) before the updater runs, so every rank holds the
  same value;
- ``dist_async`` — ``push`` returns at once. In one process a
  background applier thread applies the pushes in order; ``pull`` and
  ``barrier`` wait for this process's pending pushes (read-your-writes)
  and re-raise an applier failure. Across processes each push goes to
  the parameter server on rank 0 (``kvstore_ps.py``), which applies it
  alone, as it arrives.

``MXNET_KVSTORE_ASYNC=1`` applies a local store's pushes on the applier
thread too (counted as ``kvstore_async_pushes`` in
``pipeline.pipeline_counters()``). ``create`` reads
``MXNET_KVSTORE_GC_TYPE``/``_THRESHOLD`` for 2-bit compression, which
quantizes every dense push with per-source error-feedback residuals.
``MXNET_KVSTORE_BIGARRAY_BOUND`` row-shards a big value over a
process's local devices in the JAX package; a rank here holds one
device, where the JAX package changes no layout either, so the knob is
not read.

Sparse values (``ndarray/sparse.py``), as in the JAX package: a list
push of ``row_sparse`` gradients is summed with ``sparse.elemwise_add``
(duplicate rows merged, sorted), and compression and the device-group
reduce skip sparse values; the updater gets the sparse aggregate (the
optimizers' lazy row updates), and without one a sparse aggregate is
added into the stored value, which then becomes that sum. ``pull``
densifies a sparse stored value; ``row_sparse_pull`` writes each
requested row of the value, gathered densely, into ``out``. A ``dist*``
store across more than one process refuses a sparse push: the JAX
package's all-reduce sums a sparse value's values position by position,
which is right only where every rank holds the same rows, and a correct
sparse reduce is not written yet (ROADMAP).
"""
from __future__ import annotations

import datetime
import itertools
import logging

import torch

from .base import MXNetError, getenv
from . import ndarray as nd
from .ndarray import NDArray
from .ndarray import sparse as _sp

__all__ = ["KVStore", "create"]


class KVStore:
    """Reference: include/mxnet/kvstore.h:59-438."""

    def __init__(self, kv_type="local"):
        from . import pipeline as _pl

        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._residuals = {}  # (key, source index) -> residual
        self._async_mode = False
        self._async_q = None
        self._async_thread = None
        self._async_err = None
        self._ps = None
        self._pipeline_async = False  # the MXNET_KVSTORE_ASYNC opt-in
        nproc = self.num_workers
        if kv_type == "dist_async":
            if nproc == 1:
                self._async_mode = True
            else:
                from .kvstore_ps import AsyncParamServer

                self._ps = AsyncParamServer(self.rank,
                                            lambda: self._updater)
        elif _pl.kvstore_async_enabled() and (
                not kv_type.startswith("dist") or nproc == 1):
            # collectives reordered onto a free thread would deadlock
            # across ranks, so a multi-process dist store stays synchronous
            self._async_mode = True
            self._pipeline_async = True

    # -- the async applier --------------------------------------------------

    def _async_submit(self, k, agg):
        import queue
        import threading
        import weakref

        self._check_async_error()
        if self._async_thread is None:
            import atexit

            self._async_q = queue.Queue()
            ref = weakref.ref(self)

            def flush_at_exit():
                kv = ref()
                if kv is None:
                    return
                try:  # pushes after the last pull still apply
                    kv._async_flush()
                except Exception as e:
                    logging.getLogger(__name__).warning(
                        "dist_async flush at exit failed: %s", e)

            atexit.register(flush_at_exit)
            q = self._async_q

            # the thread holds the store only weakly, so a dropped store
            # (and its values) can be collected; its finalizer sends the
            # None that ends the thread
            def drain():
                while True:
                    item = q.get()
                    try:
                        if item is None:
                            return
                        kv = ref()
                        if kv is None:
                            return
                        try:
                            kv._apply_update(*item)
                        except Exception as e:  # re-raised at pull/barrier
                            kv._async_err = kv._async_err or e
                        finally:
                            del kv
                    finally:
                        q.task_done()

            self._async_thread = threading.Thread(
                target=drain, name="kvstore-async", daemon=True)
            self._async_thread.start()
            weakref.finalize(self, q.put, None)
        self._async_q.put((k, agg))
        if self._pipeline_async:
            from . import pipeline as _pl

            _pl._count("kvstore_async_pushes")

    def _async_flush(self):
        """Wait for this process's pending pushes; re-raise the first
        failure among them."""
        if self._async_q is not None:
            self._async_q.join()
        self._check_async_error()

    def _check_async_error(self):
        if self._async_err is not None:
            err, self._async_err = self._async_err, None
            raise MXNetError(
                f"asynchronous kvstore update failed: {err}") from err

    # -- queries ------------------------------------------------------------

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        """The worker's rank (reference kvstore.h:365): the process's rank
        in the group for a dist store, else 0."""
        if self._type.startswith("dist"):
            from . import _rendezvous as rdv

            return rdv.rank()
        return 0

    @property
    def num_workers(self):
        if self._type.startswith("dist"):
            from . import _rendezvous as rdv

            return rdv.world_size()
        return 1

    @property
    def backend(self):
        """The process group's backend (``"nccl"`` or ``"gloo"``) for a
        dist store across processes, else None."""
        if self._type.startswith("dist"):
            from . import _rendezvous as rdv

            return rdv.backend()
        return None

    _dead_probe_seq = itertools.count(1)

    def num_dead_node(self, node_id=0):
        """Reference: kvstore.h:380. A dead rank fails collectives
        outright, so this probes the rendezvous store with a key round
        trip: 0 when it answers, every peer but this one when it does
        not."""
        n = self.num_workers
        if not self._type.startswith("dist") or n <= 1:
            return 0
        from . import _rendezvous as rdv

        addr = rdv.coordinator()
        if addr is None:
            return 0
        import torch.distributed as dist

        try:
            client = dist.TCPStore(addr[0], addr[1], is_master=False,
                                   wait_for_workers=False,
                                   timeout=datetime.timedelta(seconds=10))
            key = f"mxpt/dead_probe/{self.rank}/{next(self._dead_probe_seq)}"
            client.set(key, "1")
            client.delete_key(key)
            return 0
        except Exception:
            return max(0, n - 1)

    # -- init, push, pull ---------------------------------------------------

    def _normalize(self, key, value):
        single = not isinstance(key, (list, tuple))
        keys = [key] if single else list(key)
        values = [value] if single else list(value)
        return keys, values, single

    def init(self, key, value):
        keys, values, _ = self._normalize(key, value)
        for k, v in zip(keys, values):
            k = str(k)
            if k in self._store:
                continue
            if isinstance(v, (list, tuple)):
                v = v[0]
            v = v.copy()
            self._store[k] = v
            if self._ps is not None:
                self._ps.init(k, v)

    def _compress(self, k, idx, grad):
        """One source's gradient through the 2-bit wire format and back,
        with its error-feedback residual (reference: kvstore_dist.h
        PushCompressed)."""
        deq, self._residuals[(k, idx)] = self._compression.roundtrip(
            grad.data, self._residuals.get((k, idx)))
        return NDArray(deq)

    def push(self, key, value, priority=0):
        """Sum the value (a list: one per device) and apply the updater
        if set (reference: kvstore_local.h:206 PushImpl)."""
        from . import parallel
        from .resilience import faults as _faults

        _faults.maybe_fail("kvstore_push")
        keys, values, _ = self._normalize(key, value)
        for k, v in zip(keys, values):
            k = str(k)
            if isinstance(v, (list, tuple)):
                vs = list(v)
                sparse = any(isinstance(x, _sp.BaseSparseNDArray)
                             for x in vs)
                if self._compression is not None and not sparse:
                    vs = [self._compress(k, i, x) for i, x in enumerate(vs)]
                agg = None
                if len(vs) > 1 and not sparse:
                    try:
                        agg = parallel.group_all_reduce(vs)[0]
                    except MXNetError:
                        agg = None  # the values share a device
                if agg is None:
                    agg = vs[0]
                    for x in vs[1:]:
                        # sparse values sum sparse (reference: comm.h:478)
                        agg = _sp.elemwise_add(agg, x) if sparse else \
                            agg + x
            else:
                agg = v
                if self._compression is not None and not isinstance(
                        agg, _sp.BaseSparseNDArray):
                    agg = self._compress(k, 0, agg)
            if k not in self._store:
                raise MXNetError(f"key {k} was not initialized")
            if self._ps is not None:
                if isinstance(agg, _sp.BaseSparseNDArray):
                    raise MXNetError(_SPARSE_DIST.format(
                        self._type, self.num_workers))
                self._ps.push(k, agg)
                continue
            if self._async_mode:
                self._async_submit(k, agg)
            else:
                self._apply_update(k, agg)

    def _apply_update(self, k, agg):
        from . import parallel

        sparse = isinstance(agg, _sp.BaseSparseNDArray)
        if self._type.startswith("dist"):
            if not sparse:
                agg = parallel.all_reduce(agg)
            elif self.num_workers > 1:
                raise MXNetError(_SPARSE_DIST.format(self._type,
                                                     self.num_workers))
        stored = self._store[k]
        if agg._data.device != stored._data.device:
            agg = agg.as_in_context(stored.context) if sparse else \
                NDArray(agg.data.to(stored.data.device))
        if self._updater is not None:
            self._updater(_key_to_int(k), agg, stored)
        elif sparse or isinstance(stored, _sp.BaseSparseNDArray):
            # the sum may change the stored rows or the format
            self._store[k] = _sp.elemwise_add(stored, agg)
        else:
            with torch.no_grad():
                stored.data.copy_(stored.data + agg.data)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the current values into ``out`` (an array or a list of
        them). A dist_async store first waits for this process's own
        pushes (read-your-writes)."""
        from .resilience import faults as _faults

        _faults.maybe_fail("kvstore_pull")
        if self._async_mode:
            self._async_flush()
        keys, outs, _ = self._normalize(key, out)
        for k, o in zip(keys, outs):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k} was not initialized")
            src = self._store[k]
            with torch.no_grad():
                if self._ps is not None:
                    src.data.copy_(torch.from_numpy(self._ps.pull(k)))
                if isinstance(src, _sp.BaseSparseNDArray):
                    src = src.todense()
                for t in (o if isinstance(o, (list, tuple)) else [o]):
                    t.data.copy_(src.data)

    def pushpull(self, key, value, out=None, priority=0):
        """Push then pull (reference: kvstore.h PushPull)."""
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` of each value, gathered densely: ``out``
        is rebound to a ``(len(row_ids),) + row shape`` array on the
        value's device, as the JAX store rebinds it (a sparse stored
        value is densified first)."""
        if self._async_mode:
            self._async_flush()
        keys, outs, _ = self._normalize(key, out)
        _, rids, _ = self._normalize(key, row_ids)
        for k, o, r in zip(keys, outs, rids):
            src = self._store[str(k)]
            if isinstance(src, _sp.BaseSparseNDArray):
                src = src.todense()
            targets = o if isinstance(o, (list, tuple)) else [o]
            rows = r if isinstance(r, (list, tuple)) else [r] * len(targets)
            for t, rid in zip(targets, rows):
                t._data = nd.take(src, rid, axis=0).data

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """The updater becomes ``optimizer``'s, run on the aggregated
        value once per key and push (reference: kvstore.py
        set_optimizer; kvstore_dist_server.h ApplyUpdates)."""
        from . import optimizer as opt

        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """Reference: kvstore.py set_gradient_compression. 2-bit
        quantization with error-feedback residuals for every later dense
        push; ``{"type": "none"}`` turns it off."""
        from .gradient_compression import GradientCompression

        params = dict(compression_params)
        ctype = params.pop("type", "2bit")
        self._residuals.clear()
        if ctype in (None, "none"):
            self._compression = None
            return
        self._compression = GradientCompression(type=ctype, **params)

    def barrier(self):
        """Reference: kvstore.h:391 Barrier: this process's pending pushes
        applied, then ``dist.barrier()`` across the ranks. Failures
        propagate."""
        if self._async_mode:
            self._async_flush()
        if self._ps is not None:
            self._ps.flush()
        if self._type.startswith("dist") and self.num_workers > 1:
            import torch.distributed as dist

            dist.barrier()

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._ps is not None:
            self._ps.flush()
        if self._updater is None:
            raise MXNetError("no optimizer is set")
        if self._async_mode:
            self._async_flush()
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer is set")
        from .context import Context

        with open(fname, "rb") as f:
            blob = f.read()
        # the states land on the device the values live on
        dev = next((v.data.device for v in self._store.values()), None)
        if dev is None:
            self._updater.set_states(blob)
        else:
            with Context.from_device(dev):
                self._updater.set_states(blob)


_SPARSE_DIST = ("a sparse push to a {} store across {} processes: the sum "
                "of row_sparse values over ranks (each with its own rows) "
                "is not written yet; densify with .tostype('default') "
                "first")


def _key_to_int(k):
    try:
        return int(k)
    except ValueError:
        return k


_VALID = ("local", "device", "nccl", "dist_sync", "dist_async",
          "dist_device_sync")


def create(name="local"):
    """Reference: src/kvstore/kvstore.cc:40-73 KVStore::Create. A dist
    type across processes needs the process group joined first
    (``tools/launch.py``); in one process it acts as one worker."""
    if name not in _VALID:
        raise MXNetError(f"unknown kvstore type {name}")
    kv = KVStore(name)
    gc_type = getenv("MXNET_KVSTORE_GC_TYPE", None)
    if gc_type:
        kv.set_gradient_compression({
            "type": gc_type,
            "threshold": getenv("MXNET_KVSTORE_GC_THRESHOLD", 0.5, float)})
    return kv
