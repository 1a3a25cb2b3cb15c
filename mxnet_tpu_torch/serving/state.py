"""Server-side session state: the memory of incremental decode.

The PyTorch counterpart of ``mxnet_tpu/serving/state.py:164-760``, in
row-slot mode. :class:`SessionStateStore` keeps one **slot** per live
session: for every state tensor the model threads, the store owns one
preallocated device tensor of shape ``(num_slots,) + row_shape``. A
decode batch gathers the live sessions' slots into a dense
``(occupancy, ...)`` block (``index_select``: a fresh tensor the step
may update in place), runs one step, and scatters the new states back
(``index_copy_``).

Policies, as in the reference:

- **Affinity** — a slot is ``in_flight`` while a step holds it; a
  session never has two steps in flight, and eviction never touches an
  in-flight slot.
- **TTL + LRU** — opening a session when every slot is taken first
  reclaims idle-expired sessions (``ttl_s``), then the least recently
  stepped one. An evicted session's next step raises
  :class:`SessionEvicted`, a retryable error for exactly that client.

The paged store (fixed-size KV pages behind page tables) and int8 pages
come with the next slice.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict

import numpy as onp
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..ndarray.ndarray import torch_dtype
from .batcher import ServerBusy
from .metrics import METRICS

__all__ = ["SessionStateStore", "SessionEvicted"]

#: evicted-session tombstones kept for clean error reporting
_TOMBSTONES = 4096


class SessionEvicted(ServerBusy):
    """This session's server-side state slot was reclaimed (idle TTL or
    LRU pressure); re-open the session and resume. Delivered to exactly
    the one client whose slot went away."""


class _Slot:
    """One live session's bookkeeping (its state lives in the pools)."""

    __slots__ = ("sid", "slot", "created", "last_used", "steps",
                 "in_flight")

    def __init__(self, sid, slot, now):
        self.sid = sid
        self.slot = slot
        self.created = now
        self.last_used = now
        self.steps = 0
        self.in_flight = False


def _env_number(name, default, kind):
    raw = os.environ.get(name)
    return kind(raw) if raw not in (None, "") else default


class SessionStateStore:
    """Slot-indexed, device-resident per-session state pool.

    Parameters
    ----------
    state_shapes : sequence of shape tuples — per-state ROW shapes (no
        batch axis), e.g. ``DecoderBlockLM.state_row_shapes()``
    state_dtypes : sequence of dtypes, optional (default float32)
    max_sessions : int, optional — slot count before the byte budget
        (default ``MXNET_SERVING_STATE_SLOTS``, 64)
    byte_budget : int, optional — pool byte cap that shrinks the slot
        count to fit; <= 0 disables it (default
        ``MXNET_SERVING_STATE_BUDGET_MB`` MiB, 64)
    ttl_s : float, optional — idle expiry; <= 0 disables it (default
        ``MXNET_SERVING_STATE_TTL_S``, 600)
    ctx : Context, optional — device of the pools (default: the current
        context)
    """

    def __init__(self, state_shapes, state_dtypes=None, max_sessions=None,
                 byte_budget=None, ttl_s=None, ctx=None):
        self.device = resolve_device(ctx)
        self.state_shapes = tuple(tuple(int(d) for d in s)
                                  for s in state_shapes)
        if not self.state_shapes:
            raise MXNetError("state_shapes must name at least one "
                             "state tensor")
        dts = state_dtypes or ["float32"] * len(self.state_shapes)
        if len(dts) != len(self.state_shapes):
            raise MXNetError("state_dtypes length must match "
                             "state_shapes")
        self.state_dtypes = tuple(onp.dtype(d) for d in dts)
        self.bytes_per_session = int(sum(
            int(onp.prod(s or (1,))) * dt.itemsize
            for s, dt in zip(self.state_shapes, self.state_dtypes)))
        slots = int(max_sessions if max_sessions is not None else
                    _env_number("MXNET_SERVING_STATE_SLOTS", 64, int))
        budget = int(byte_budget if byte_budget is not None else
                     _env_number("MXNET_SERVING_STATE_BUDGET_MB", 64, int)
                     * 1024 * 1024)
        if budget > 0:
            slots = min(slots, max(budget // self.bytes_per_session, 1))
        self.num_slots = max(slots, 1)
        self.ttl_s = float(ttl_s if ttl_s is not None else
                           _env_number("MXNET_SERVING_STATE_TTL_S", 600.0,
                                       float))
        # ONE preallocated device tensor per state row, slot-indexed
        self._pools = [
            torch.zeros((self.num_slots,) + s, dtype=torch_dtype(dt),
                        device=self.device)
            for s, dt in zip(self.state_shapes, self.state_dtypes)]
        # guards: _slots, _free, _evicted
        self._lock = threading.RLock()
        self._slots = OrderedDict()  # sid -> _Slot, LRU order
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._evicted = OrderedDict()  # sid -> reason (tombstones)
        self._occupancy_token = METRICS.register_occupancy_probe(
            lambda: self.occupancy)

    # -- introspection -------------------------------------------------

    @property
    def occupancy(self):
        with self._lock:
            return len(self._slots)

    def has(self, sid):
        with self._lock:
            return sid in self._slots

    def live_sessions(self):
        with self._lock:
            return list(self._slots)

    # -- lifecycle -----------------------------------------------------

    def open(self, sid, init_states=None):
        """Allocate (or return) the slot of ``sid``; returns the slot
        index. A fresh slot starts at zeros unless ``init_states``
        (per-state row arrays) seeds it; for an open session
        ``init_states`` rewrites its state. Reclaims TTL-expired, then
        LRU slots when full; raises :class:`ServerBusy` only when every
        slot is held by an in-flight step. An explicit open clears an
        eviction tombstone."""
        sid = str(sid)
        with self._lock:
            rec = self._slots.get(sid)
            if rec is None:
                if not self._free:
                    self._reclaim_locked()
                if not self._free:
                    raise ServerBusy(
                        f"no free session-state slot ({self.num_slots} "
                        "slots, all in flight); retry later")
                rec = _Slot(sid, self._free.pop(), time.monotonic())
                self._slots[sid] = rec
                self._evicted.pop(sid, None)
                if init_states is None:
                    # a reused slot still holds the previous tenant's
                    # state
                    with torch.inference_mode():
                        for pool in self._pools:
                            pool[rec.slot].zero_()
            if init_states is not None:
                if len(init_states) != len(self._pools):
                    raise MXNetError(
                        f"expected {len(self._pools)} state tensor(s), "
                        f"got {len(init_states)}")
                rows = []
                for i, s in enumerate(init_states):
                    row = torch.as_tensor(
                        onp.asarray(s, dtype=self.state_dtypes[i]))
                    if tuple(row.shape) != self.state_shapes[i]:
                        raise MXNetError(
                            f"state {i} row shape {tuple(row.shape)} "
                            f"!= expected {self.state_shapes[i]}")
                    rows.append(row)
                with torch.inference_mode():
                    for pool, row in zip(self._pools, rows):
                        pool[rec.slot].copy_(row)
            return rec.slot

    def open_for_step(self, sid):
        """The batcher's implicit open on a stream's first step. Unlike
        :meth:`open` it refuses evicted sessions, so a pipelined stream
        whose slot went away sees :class:`SessionEvicted` on every
        remaining step, never a silent restart from zero state."""
        with self._lock:
            if sid not in self._slots:
                reason = self._evicted.get(sid)
                if reason is not None:
                    raise SessionEvicted(
                        f"session {sid!r} state was evicted ({reason}); "
                        "re-open the session and retry")
            return self.open(sid)

    def _reclaim_locked(self):
        """Free one slot: every TTL-expired session first, then the LRU
        session. In-flight slots are never reclaimed."""
        now = time.monotonic()
        if self.ttl_s > 0:
            for sid in [s for s, r in self._slots.items()
                        if not r.in_flight and
                        now - r.last_used > self.ttl_s]:
                self._evict_locked(sid, "idle TTL expired")
        if self._free:
            return
        for sid, rec in self._slots.items():  # OrderedDict = LRU order
            if not rec.in_flight:
                self._evict_locked(sid, "LRU pressure (pool full)")
                return

    def _evict_locked(self, sid, reason):
        rec = self._slots.pop(sid)
        self._free.append(rec.slot)
        self._evicted[sid] = reason
        while len(self._evicted) > _TOMBSTONES:
            self._evicted.popitem(last=False)
        METRICS.bump("evictions")
        logging.info("serving: session %s evicted after %d step(s): %s",
                     sid, rec.steps, reason)

    def evict(self, sid, reason="operator request"):
        """Drop one session's state (no-op if unknown or in flight)."""
        with self._lock:
            rec = self._slots.get(sid)
            if rec is not None and not rec.in_flight:
                self._evict_locked(sid, reason)

    def acquire(self, sid):
        """Pin ``sid``'s slot for one decode step and return its record;
        enforces TTL expiry. Pair with :meth:`release`."""
        with self._lock:
            rec = self._slots.get(sid)
            if rec is None:
                reason = self._evicted.get(sid)
                if reason is not None:
                    raise SessionEvicted(
                        f"session {sid!r} state was evicted ({reason}); "
                        "re-open the session and retry")
                raise MXNetError(
                    f"unknown session {sid!r} (never opened on this "
                    "server)")
            if rec.in_flight:
                raise MXNetError(
                    f"session {sid!r} already has a step in flight "
                    "(affinity violation — one step at a time)")
            now = time.monotonic()
            if self.ttl_s > 0 and now - rec.last_used > self.ttl_s:
                self._evict_locked(sid, "idle TTL expired")
                raise SessionEvicted(
                    f"session {sid!r} state expired after "
                    f"{self.ttl_s:g}s idle; re-open the session and "
                    "retry")
            rec.in_flight = True
            rec.last_used = now
            self._slots.move_to_end(sid)
            return rec

    def release(self, rec, stepped=True):
        """Unpin a slot after its step batch resolves."""
        with self._lock:
            rec.in_flight = False
            if stepped:
                rec.steps += 1
                rec.last_used = time.monotonic()

    # -- the device path: gather / scatter -----------------------------

    def _index(self, slots):
        """Slot indices of slot records (the batcher's currency) or raw
        slot numbers, as a device index tensor."""
        idx = [it.slot if isinstance(it, _Slot) else int(it)
               for it in slots]
        with self._lock:
            live = {r.slot for r in self._slots.values()}
        bad = [i for i in idx if i not in live]
        if bad:
            raise MXNetError(f"slot(s) {bad} do not belong to a live "
                             "session")
        return torch.tensor(idx, dtype=torch.int64).to(self.device)

    def gather(self, slots, pad_to=None):
        """Dense ``(rows,) + row_shape`` tensors, one per state, for the
        given slot records: fresh copies the step may update in place.
        ``rows`` is the occupancy, or ``pad_to`` when that is larger; the
        padding rows are zeros, so a bucket-padded step needs no second
        copy."""
        idx = self._index(slots)
        n = len(idx)
        rows = max(n, int(pad_to or 0))
        out = []
        with torch.inference_mode():
            for pool in self._pools:
                dst = pool.new_empty((rows,) + tuple(pool.shape[1:]))
                torch.index_select(pool, 0, idx, out=dst[:n])
                dst[n:].zero_()
                out.append(dst)
        return out

    def scatter(self, slots, new_states):
        """Write a step's output states back into the slots."""
        idx = self._index(slots)
        with torch.inference_mode():
            for pool, ns in zip(self._pools, new_states):
                pool.index_copy_(0, idx, ns.to(pool.dtype))

    def read(self, sid):
        """Host copies of one session's state rows (tests, export)."""
        with self._lock:
            rec = self._slots.get(sid)
            if rec is None:
                raise MXNetError(f"unknown session {sid!r}")
            slot = rec.slot
        return [pool[slot].cpu().numpy() for pool in self._pools]

    def close(self):
        """Unregister the metrics probe (the pools are freed with the
        store)."""
        METRICS.unregister_occupancy_probe(self._occupancy_token)

    def __repr__(self):
        return (f"SessionStateStore(slots={self.num_slots}, "
                f"live={self.occupancy}, "
                f"bytes_per_session={self.bytes_per_session}, "
                f"ttl_s={self.ttl_s:g}, device={self.device})")
