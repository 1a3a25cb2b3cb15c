"""The asynchronous parameter server of a multi-process ``dist_async``.

The PyTorch counterpart of ``mxnet_tpu/kvstore_ps.py`` (reference:
src/kvstore/kvstore_dist_server.h, async mode): each worker's push is
applied to the server's copy alone, the moment the server takes it;
workers never wait for each other, and a worker's next pull sees its
own pushes (read-your-writes).

Transport: the process group's rendezvous ``TCPStore`` (the store every
``tools/launch.py`` job already runs on rank 0), in place of the JAX
package's coordinator key-value store. Each server opens its own client
connections to it (one for the caller's thread, one for the applier).
Keys, under a prefix of their own for each store made in the process:

  <p>/val/<key>/<v>       the value after the server's push v (npy bytes);
                          version 0 is the initial value
  <p>/seq/<key>           the push counter (``add``): a push takes the
                          next number, then writes its blob
  <p>/push/<key>/<seq>    one pending gradient, deleted once applied
  <p>/applied/<key>       the applied watermark; a pull waits until it
                          reaches the puller's own last push

Rank 0 runs the applier thread (the server); its updater is the one
that applies. It applies each key's pushes strictly in sequence: a
number taken whose blob has not landed yet (the pusher counts before it
sends) holds the key for up to ``MXNET_KVSTORE_GAP_TOLERANCE`` seconds
(30), after which the server gives that push up with a warning. Every
send goes through the retry policy (``resilience/retry.py``). Because
the server lives on rank 0, the ranks meet at ``kv.barrier()`` before
they exit, as ps-lite's Finalize is collective. The channel is sized for
control traffic: bulk synchronous training keeps ``dist_sync``.
"""
from __future__ import annotations

import datetime
import io
import logging
import threading
import time

import numpy as onp

from .base import MXNetError, getenv

_PREFIX = "mxps"

# each dist_async store of a process gets its own namespace; the ranks
# make their stores in the same order, so the numbers agree
_GENERATION = [0]

# versions of a key's value kept behind the newest, for pulls in flight
_KEEP = 3


def _ser(arr):
    buf = io.BytesIO()
    onp.save(buf, onp.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _deser(b):
    return onp.load(io.BytesIO(bytes(b)), allow_pickle=False)


def _client(timeout_s=120.0):
    """A new client connection to the rendezvous store."""
    import torch.distributed as dist

    from . import _rendezvous as rdv

    addr = rdv.coordinator()
    if addr is None:
        raise MXNetError("the dist_async parameter server needs the process "
                         "group joined (mxnet_tpu_torch.tools.launch)")
    return dist.TCPStore(addr[0], addr[1], is_master=False,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout_s))


def _serve_loop(ps_ref, stop):
    """The applier: holds the server only weakly, so a dropped store can
    be collected."""
    while not stop.is_set():
        ps = ps_ref()
        if ps is None:
            return
        busy = ps._sweep()
        del ps
        if not busy:
            time.sleep(0.005)


class AsyncParamServer:
    """A worker's handle; rank 0's also runs the applier."""

    def __init__(self, rank, get_updater):
        import atexit
        import weakref

        from .resilience import RetryPolicy

        _GENERATION[0] += 1
        self._prefix = f"{_PREFIX}{_GENERATION[0]}"
        self._c = _client()
        self._rank = rank
        self._get_updater = get_updater  # read at each apply
        self._last_seq = {}   # key -> this worker's last push number
        self._keys = []       # rank 0: keys in init order
        self._lock = threading.Lock()  # guards: _keys, _server_vals
        self._server_vals = {}
        self._stop = threading.Event()
        self._next_seq = {}   # rank 0: key -> next push number to apply
        self._gap_seen = {}   # rank 0: key -> when the gap was first seen
        self._gap_tolerance = getenv("MXNET_KVSTORE_GAP_TOLERANCE", 30.0,
                                     float)
        self._retry = RetryPolicy(name="kvstore_ps send")
        self._published = {}  # rank 0: key -> last version published
        self._history = {}    # rank 0: key -> versions published, oldest first
        self._thread = None
        ref = weakref.ref(self)

        def exit_flush():
            ps = ref()
            if ps is None:
                return
            try:  # the last pushes land before the applier stops
                ps.flush(timeout_s=30.0)
            except Exception as e:
                logging.getLogger(__name__).warning(
                    "dist_async exit flush failed: %s", e)
            ps.close()

        atexit.register(exit_flush)
        if rank == 0:
            self._sc = _client()
            self._thread = threading.Thread(
                target=_serve_loop, args=(ref, self._stop), daemon=True,
                name="kvstore-ps")
            self._thread.start()

    def _k(self, *parts):
        return "/".join((self._prefix,) + tuple(str(p) for p in parts))

    # -- the worker's side --------------------------------------------------

    def init(self, key, value):
        key = str(key)
        if self._rank == 0:
            val = onp.asarray(value.asnumpy() if hasattr(value, "asnumpy")
                              else value).copy()
            with self._lock:
                self._server_vals[key] = val
                self._keys.append(key)
            self._c.set(self._k("val", key, 0), _ser(val))
        else:
            # wait for the server's initial value, as a reference worker
            # waits for the server's init response
            self._c.wait([self._k("val", key, 0)],
                         datetime.timedelta(seconds=120))

    def push(self, key, grad):
        """Send and return. The push number is taken before the blob is
        sent; if every send fails, the number stays empty until the
        server's gap tolerance gives it up, and the caller gets the
        terminal ``RetryExhausted``."""
        from .resilience import faults as _faults

        key = str(key)
        _faults.maybe_fail("kvstore_push")
        seq = self._retry.run(self._c.add, self._k("seq", key), 1)
        blob = _ser(grad.asnumpy() if hasattr(grad, "asnumpy") else grad)
        self._retry.run(self._c.set, self._k("push", key, f"{seq:012d}"),
                        blob)
        self._last_seq[key] = seq

    def pull(self, key, timeout_s=120.0):
        """The value once the server has applied this worker's last push
        of ``key`` (a newer one if the server is ahead)."""
        key = str(key)
        want = self._last_seq.get(key, 0)
        deadline = time.monotonic() + timeout_s
        while True:
            applied = self._c.add(self._k("applied", key), 0)
            if applied >= want:
                vk = self._k("val", key, applied)
                # the version may have been retired by a newer publish:
                # then read the watermark again
                if self._c.check([vk]):
                    try:
                        return _deser(self._c.get(vk))
                    except Exception:  # retired between check and get
                        pass
            if time.monotonic() > deadline:
                raise MXNetError(
                    f"dist_async pull('{key}') timed out waiting for push "
                    f"{want} (applied {applied}): is rank 0 alive?")
            time.sleep(0.005)

    def flush(self, timeout_s=60.0):
        """Wait until every push of this worker has been applied."""
        for key in list(self._last_seq):
            self.pull(key, timeout_s)

    def close(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10)

    # -- the server (rank 0) ------------------------------------------------

    def _apply(self, key, grad):
        from . import ndarray as nd
        from .context import cpu
        from .kvstore import _key_to_int

        with self._lock:
            stored = self._server_vals[key]
        updater = self._get_updater()
        if updater is not None:
            snd = nd.array(stored, ctx=cpu())
            updater(_key_to_int(key), nd.array(grad, ctx=cpu()), snd)
            stored = snd.asnumpy()
        else:
            stored = stored + grad  # the reference server's default: sum
        with self._lock:
            self._server_vals[key] = stored

    def _sweep(self):
        """One pass of the applier: each key's pending pushes in order,
        then the new value and watermark. True when it applied any."""
        c = self._sc
        busy = False
        with self._lock:
            keys = list(self._keys)
        for key in keys:
            nxt = self._next_seq.get(key, 1)
            last = None
            while True:
                pk = self._k("push", key, f"{nxt:012d}")
                if not c.check([pk]):
                    taken = c.add(self._k("seq", key), 0)
                    if taken < nxt:
                        break  # nothing pending
                    # taken but not landed: wait, up to the tolerance
                    first = self._gap_seen.setdefault(key, time.monotonic())
                    if time.monotonic() - first <= self._gap_tolerance:
                        break
                    logging.getLogger(__name__).warning(
                        "dist_async server gives up push %d of key '%s' "
                        "after %.0f s (MXNET_KVSTORE_GAP_TOLERANCE); a slow "
                        "worker's push is lost", nxt, key,
                        self._gap_tolerance)
                    self._gap_seen.pop(key, None)
                    nxt += 1
                    continue
                try:
                    self._apply(key, _deser(c.get(pk)))
                except Exception as e:
                    # a poisoned gradient must not stop the server
                    logging.getLogger(__name__).warning(
                        "dist_async server dropped push %d of key '%s': %s",
                        nxt, key, e)
                c.delete_key(pk)
                self._gap_seen.pop(key, None)
                last = nxt
                nxt += 1
                busy = True
            self._next_seq[key] = nxt
            if last is not None:
                prev = self._published.get(key, 0)
                with self._lock:
                    val = self._server_vals[key]
                c.set(self._k("val", key, last), _ser(val))
                c.add(self._k("applied", key), last - prev)
                self._published[key] = last
                # retire a version only far behind the newest (version 0,
                # the one late workers wait for at init, stays)
                old = self._retired_before(key, last)
                for v in old:
                    c.delete_key(self._k("val", key, v))
        return busy

    def _retired_before(self, key, last):
        vs = self._history.setdefault(key, [])
        vs.append(last)
        out = []
        while len(vs) > _KEEP:
            out.append(vs.pop(0))
        return out
