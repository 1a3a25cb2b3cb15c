"""Server-side session state: the memory of incremental decode.

The PyTorch counterpart of ``mxnet_tpu/serving/state.py``, in row-slot
and paged mode. :class:`SessionStateStore` keeps one **slot** per live
session. Every state tensor the model threads lives in one preallocated
device tensor, a **pool**; a decode batch gathers the live sessions'
state into dense ``(occupancy, ...)`` rows, runs one step, and scatters
the new state back.

**Paged KV storage.** With ``page_tokens`` > 0
(``MXNET_SERVING_STATE_PAGE_TOKENS``), the state rows the model marks
*pageable* (``state_row_pageable()``: rows that grow along a leading
token axis, the K/V caches) are stored as fixed-size token pages in a
shared page pool. Each session keeps a page TABLE (logical page to
physical page); pages are allocated as the stream crosses page
boundaries, and physical page 0 is the **null page**, never written, so
an unallocated table entry gathers as exact zeros. Gather materializes
the same dense ``(occupancy, max_len, ...)`` rows as row-slot mode (so
paged and row-slot decode are bitwise equal), and scatter writes back
only the ONE page the step appended into: the decode cache contract is
append-only, every other page of the step's output is the page that was
gathered. The same byte budget therefore admits several times more
mixed-length streams.

**Int8 KV pages.** With ``kv_int8`` (``MXNET_SERVING_STATE_KV_INT8=1``)
the float32 pageable states are stored as symmetric per-page int8 codes
with one float32 scale per page (``analysis/quantize.py``'s
``kv_page_codes``): a quarter of the bytes, so the same budget holds
about four times the pages. :meth:`gather` dequantizes through the page
table into the dense float32 rows the step reads; :meth:`scatter`
re-quantizes the one appended page, whole, from the step's dense output
(every other page keeps its codes: re-quantizing untouched data would
only add error) and bumps the ``kv_pages_quantized`` counter. Export and
restore stay dense; a restore into an int8 store quantizes.

Gather and scatter are index ops on the pools (``index_select``,
``index_copy_``), the counterparts of the reference's jitted gather and
scatter. The pools are updated in place, never rebound, and
:meth:`gather` can write into tensors the caller owns (``out=``): the
session's static step inputs, which a captured CUDA graph reads.

Policies, as in the reference:

- **Affinity**: a slot is ``in_flight`` while a step holds it; eviction
  never touches an in-flight slot.
- **TTL + LRU under a byte budget**: opening a session when every slot
  is taken reclaims idle-expired sessions (``ttl_s``), then the least
  recently stepped one. Page exhaustion reclaims the same way, by whole
  sessions (evicting one frees all its pages and nothing of anyone
  else's). An evicted session's next step raises :class:`SessionEvicted`
  for exactly that client.
- **Checkpointable**: :meth:`export_state` / :meth:`restore_state`
  round-trip every live session as DENSE host rows, whatever the page
  geometry, so a payload restores under another ``page_tokens`` or into
  row-slot mode; a canary promote migrates live sessions with them.

The ``session_state_evict`` fault seam fires in :meth:`acquire`.
"""
from __future__ import annotations

import logging
import time
from collections import OrderedDict

import numpy as onp
import torch

from ..base import MXNetError, getenv
from ..context import host_to_device, resolve_device
from ..ndarray.ndarray import torch_dtype
from ..resilience import faults as _faults
from ..telemetry import tracer as _telem
from ..utils import locks as _locks
from .batcher import ServerBusy
from .metrics import METRICS

__all__ = ["SessionStateStore", "SessionEvicted"]

#: evicted-session tombstones kept for clean error reporting
_TOMBSTONES = 4096


class SessionEvicted(ServerBusy):
    """This session's server-side state was reclaimed (idle TTL, LRU
    pressure under the byte budget, or an injected fault); re-open the
    session and resume. HTTP 503 with ``Retry-After``, delivered to
    exactly the one client whose state went away."""


class _Slot:
    """One live session's bookkeeping (its state lives in the pools).
    ``table`` (paged stores only) maps logical page to physical page, 0
    being the null page; ``steps`` doubles as the token count for the
    page math: a decode step appends exactly one token."""

    __slots__ = ("sid", "slot", "created", "last_used", "steps",
                 "in_flight", "table")

    def __init__(self, sid, slot, now):
        self.sid = sid
        self.slot = slot
        self.created = now
        self.last_used = now
        self.steps = 0
        self.in_flight = False
        self.table = None


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
        (and page) count to fit; <= 0 disables it (default
        ``MXNET_SERVING_STATE_BUDGET_MB`` MiB, 64)
    ttl_s : float, optional — idle expiry; <= 0 disables it (default
        ``MXNET_SERVING_STATE_TTL_S``, 600)
    pageable : sequence of bool, optional — which state rows grow along
        a leading token axis (``state_row_pageable()``); stored as pages
        when ``page_tokens`` > 0
    page_tokens : int, optional — tokens per KV page (default
        ``MXNET_SERVING_STATE_PAGE_TOKENS``, 0 = row-slot mode)
    kv_int8 : bool, optional — store float32 pages as symmetric per-page
        int8 codes and one float32 scale per page (default
        ``MXNET_SERVING_STATE_KV_INT8``; paged stores only)
    label : str, optional — logging tag
    ctx : Context, optional — device of the pools (default: the current
        context)
    """

    def __init__(self, state_shapes, state_dtypes=None, max_sessions=None,
                 byte_budget=None, ttl_s=None, pageable=None,
                 page_tokens=None, kv_int8=None, label=None, ctx=None):
        self.device = resolve_device(ctx)
        self.label = label
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

        # -- page geometry --------------------------------------------
        self.page_tokens = int(
            page_tokens if page_tokens is not None else
            getenv("MXNET_SERVING_STATE_PAGE_TOKENS", 0, int))
        flags = tuple(bool(p) for p in pageable) if pageable else \
            (False,) * len(self.state_shapes)
        if len(flags) != len(self.state_shapes):
            raise MXNetError("pageable length must match state_shapes")
        self._pageable = flags if self.page_tokens > 0 else \
            (False,) * len(self.state_shapes)
        self.paged = any(self._pageable)
        self.kv_int8 = bool(
            kv_int8 if kv_int8 is not None else
            getenv("MXNET_SERVING_STATE_KV_INT8", False, bool)) and self.paged
        if self.paged:
            seqs = {self.state_shapes[i][0] if self.state_shapes[i]
                    else 0 for i, p in enumerate(self._pageable) if p}
            if len(seqs) != 1:
                raise MXNetError(
                    "pageable state rows must share one leading token "
                    f"axis; got lengths {sorted(seqs)}")
            self._seq = seqs.pop()
            if self._seq <= 0 or self._seq % self.page_tokens:
                raise MXNetError(
                    f"pageable token axis {self._seq} must be a "
                    f"positive multiple of page_tokens "
                    f"{self.page_tokens}")
            self._ppr = self._seq // self.page_tokens  # pages per row
        else:
            self._seq = 0
            self._ppr = 0
        # int8 page storage applies to the float32 pageable states only
        self._int8 = tuple(
            self.kv_int8 and p and dt == onp.dtype("float32")
            for p, dt in zip(self._pageable, self.state_dtypes))
        #: bytes one physical page costs across every pageable pool (an
        #: int8 page carries one float32 scale)
        self._page_bytes = int(sum(
            self.page_tokens * int(onp.prod(s[1:] or (1,)))
            * (1 if i8 else dt.itemsize) + (4 if i8 else 0)
            for s, dt, p, i8 in zip(self.state_shapes, self.state_dtypes,
                                    self._pageable, self._int8) if p))
        #: bytes one slot costs in the non-pageable pools
        self._slot_bytes = int(sum(
            int(onp.prod(s or (1,))) * dt.itemsize
            for s, dt, p in zip(self.state_shapes, self.state_dtypes,
                                self._pageable) if not p))

        slots = int(max_sessions if max_sessions is not None else
                    getenv("MXNET_SERVING_STATE_SLOTS", 64, int))
        budget = int(byte_budget if byte_budget is not None else
                     getenv("MXNET_SERVING_STATE_BUDGET_MB", 64, int)
                     * 1024 * 1024)
        if budget > 0:
            if self.paged:
                # a live stream costs its slot rows + at least one page
                slots = min(slots, max(
                    budget // max(self._slot_bytes + self._page_bytes, 1),
                    1))
            else:
                slots = min(slots, max(budget // self.bytes_per_session,
                                       1))
        self.num_slots = max(slots, 1)
        if self.paged:
            pages = ((budget - self.num_slots * self._slot_bytes)
                     // max(self._page_bytes, 1)) if budget > 0 else \
                self.num_slots * self._ppr
            self.num_pages = max(min(int(pages),
                                     self.num_slots * self._ppr), 1)
        else:
            self.num_pages = 0
        self.ttl_s = float(ttl_s if ttl_s is not None else
                           getenv("MXNET_SERVING_STATE_TTL_S", 600.0, float))
        # ONE preallocated device tensor per state: pageable states are
        # page-indexed (physical page 0 = the null page, all zeros), the
        # rest slot-indexed; an int8 pool has a float32 scale per page
        self._pools, self._scales = [], []
        for i, (s, dt) in enumerate(zip(self.state_shapes,
                                        self.state_dtypes)):
            shape = ((self.num_pages + 1, self.page_tokens) + s[1:]
                     if self._pageable[i] else (self.num_slots,) + s)
            self._pools.append(torch.zeros(
                shape, dtype=torch.int8 if self._int8[i] else torch_dtype(dt),
                device=self.device))
            self._scales.append(torch.zeros(
                (self.num_pages + 1,), dtype=torch.float32,
                device=self.device) if self._int8[i] else None)
        # guards: _slots, _free, _free_pages, _evicted, steps_total,
        # and the pools' contents
        self._lock = _locks.RankedRLock("serving.store")
        self._slots = OrderedDict()  # sid -> _Slot, LRU order
        self._free = list(range(self.num_slots - 1, -1, -1))
        # physical pages 1..num_pages (0 is the null page)
        self._free_pages = list(range(self.num_pages, 0, -1))
        self._evicted = OrderedDict()  # sid -> reason (tombstones)
        self.steps_total = 0
        self._occupancy_token = METRICS.register_occupancy_probe(
            lambda: len(self._slots))
        self._page_token = METRICS.register_page_probe(
            self._page_probe) if self.paged else None

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

    def stats(self):
        """Flat description for ``/healthz`` and admission probes."""
        with self._lock:
            st = {"sessions": len(self._slots),
                  "slots": self.num_slots,
                  "bytes_per_session": self.bytes_per_session,
                  "ttl_s": self.ttl_s,
                  "steps_total": self.steps_total}
            if self.paged:
                st.update({
                    "page_tokens": self.page_tokens,
                    "pages_total": self.num_pages,
                    "pages_free": len(self._free_pages),
                    "pages_used": self.num_pages - len(self._free_pages),
                    "page_bytes": self._page_bytes,
                    "kv_int8": self.kv_int8})
            return st

    def page_headroom(self):
        """Free fraction of the KV page pool, 0..1 (``None`` in row-slot
        mode); admission folds it like slot headroom."""
        if not self.paged:
            return None
        with self._lock:
            return len(self._free_pages) / max(self.num_pages, 1)

    def _page_probe(self):
        """Page-pool gauge sample for the metrics registry."""
        with self._lock:
            used = self.num_pages - len(self._free_pages)
            per = [int(onp.count_nonzero(r.table))
                   for r in self._slots.values() if r.table is not None]
        return {"pages_total": self.num_pages, "pages_used": used,
                "pages_per_session": per,
                "kv_bytes": used * self._page_bytes}

    # -- lifecycle -----------------------------------------------------

    def open(self, sid, init_states=None, _resumed=False, tokens=None):
        """Allocate (or return) the slot of ``sid``; returns the slot
        index. A fresh slot starts at zeros unless ``init_states``
        (per-state DENSE row arrays, whatever the page geometry) seeds
        it; for an open session ``init_states`` rewrites its state.
        ``tokens`` bounds how many leading positions of pageable rows
        are live (restore passes the session's step count); ``None``
        backs every page. Reclaims TTL-expired, then LRU slots when full;
        raises :class:`ServerBusy` only when every slot (or page) is
        held by an in-flight step. An explicit open clears an eviction
        tombstone."""
        sid = str(sid)
        with self._lock, torch.inference_mode():
            rec = self._slots.get(sid)
            if rec is None:
                if not self._free:
                    self._reclaim_locked()
                if not self._free:
                    raise ServerBusy(
                        f"no free session-state slot ({self.num_slots} "
                        "slots, all in flight); retry later")
                rec = _Slot(sid, self._free.pop(), time.monotonic())
                if self.paged:
                    rec.table = onp.zeros(self._ppr, dtype=onp.int64)
                self._slots[sid] = rec
                self._evicted.pop(sid, None)
                # a reused slot still holds the previous tenant's state
                # (a fresh page table is all null pages: nothing to do)
                if init_states is None:
                    for i, pool in enumerate(self._pools):
                        if not self._pageable[i]:
                            pool[rec.slot].zero_()
            if init_states is not None:
                if len(init_states) != len(self._pools):
                    raise MXNetError(
                        f"expected {len(self._pools)} state tensor(s), "
                        f"got {len(init_states)}")
                rows = []
                for i, s in enumerate(init_states):
                    row = onp.asarray(s, dtype=self.state_dtypes[i])
                    if tuple(row.shape) != self.state_shapes[i]:
                        raise MXNetError(
                            f"state {i} row shape {tuple(row.shape)} "
                            f"!= expected {self.state_shapes[i]}")
                    rows.append(host_to_device(torch.from_numpy(
                        onp.ascontiguousarray(row)), self.device))
                npages = 0
                if self.paged:
                    t = self._seq if tokens is None else \
                        max(0, min(int(tokens), self._seq))
                    npages = -(-t // self.page_tokens) if t else 0
                    self._release_pages_locked(rec)
                    self._alloc_pages_locked(rec, npages)
                    dest = self._device_index(rec.table[:npages])
                for i, row in enumerate(rows):
                    if not self._pageable[i]:
                        self._pools[i][rec.slot].copy_(row)
                    elif npages:
                        pages = row.reshape((self._ppr, self.page_tokens)
                                            + self.state_shapes[i][1:])
                        self._write_pages(i, dest, pages[:npages])
            if _resumed:
                METRICS.bump("resumed_sessions")
            return rec.slot

    def open_for_step(self, sid):
        """The batcher's implicit open on a stream's first step. Unlike
        :meth:`open` it refuses evicted sessions, so a pipelined stream
        whose state went away sees :class:`SessionEvicted` on every
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

    def _reclaim_pages_locked(self, needed, exclude=None):
        """Refill the free pages to ``needed``: TTL-expired sessions
        first, then whole LRU sessions (a victim is never split).
        In-flight sessions and ``exclude`` (the allocating session) are
        never victims."""
        now = time.monotonic()
        if self.ttl_s > 0:
            for sid in [s for s, r in self._slots.items()
                        if not r.in_flight and s != exclude and
                        now - r.last_used > self.ttl_s]:
                self._evict_locked(sid, "idle TTL expired")
        while len(self._free_pages) < needed:
            victim = next(
                (s for s, r in self._slots.items()
                 if not r.in_flight and s != exclude), None)
            if victim is None:
                return
            self._evict_locked(victim, "LRU page pressure (pool full)")

    def _release_pages_locked(self, rec):
        """Return every physical page of ``rec``'s table to the free list
        (zeroed at its next allocation)."""
        if rec.table is None:
            return
        for p in rec.table:
            if p:
                self._free_pages.append(int(p))
        rec.table[:] = 0

    def _alloc_pages_locked(self, rec, npages):
        """Back logical pages ``0..npages-1`` of ``rec`` with physical
        pages, reclaiming (TTL, then whole LRU sessions) on exhaustion;
        raises :class:`ServerBusy` when the pool cannot supply them.
        Fresh pages are zeroed in every pageable pool: a recycled page
        never leaks the previous tenant's KV."""
        missing = [j for j in range(npages) if not rec.table[j]]
        if not missing:
            return
        with _telem.span("serving.page_alloc", cat="serving",
                         sid=rec.sid, pages=len(missing)):
            if len(self._free_pages) < len(missing):
                self._reclaim_pages_locked(len(missing), exclude=rec.sid)
            if len(self._free_pages) < len(missing):
                raise ServerBusy(
                    f"no free KV pages ({self.num_pages} pages, "
                    f"{len(self._free_pages)} free, {len(missing)} "
                    "needed; every other stream is in flight); retry "
                    "later")
            got = [self._free_pages.pop() for _ in missing]
            for j, p in zip(missing, got):
                rec.table[j] = p
            dest = self._device_index(got)
            with torch.inference_mode():
                for i, pool in enumerate(self._pools):
                    if self._pageable[i]:
                        pool.index_fill_(0, dest, 0)
                        if self._scales[i] is not None:
                            self._scales[i].index_fill_(0, dest, 0.0)

    def _evict_locked(self, sid, reason):
        rec = self._slots.pop(sid)
        self._free.append(rec.slot)
        self._release_pages_locked(rec)
        self._evicted[sid] = reason
        while len(self._evicted) > _TOMBSTONES:
            self._evicted.popitem(last=False)
        METRICS.bump("evictions")
        logging.info("serving%s: session %s evicted after %d step(s): %s",
                     f" {self.label}" if self.label else "", sid,
                     rec.steps, reason)

    def evict(self, sid, reason="operator request"):
        """Drop one session's state (no-op if unknown or in flight)."""
        with self._lock:
            rec = self._slots.get(sid)
            if rec is not None and not rec.in_flight:
                self._evict_locked(sid, reason)

    def acquire(self, sid):
        """Pin ``sid``'s slot for one decode step and return its record.
        The ``session_state_evict`` fault seam fires here (a fire evicts
        THIS session and raises :class:`SessionEvicted`); TTL expiry is
        enforced here; a paged store backs the page this step appends
        into, which may evict an idle LRU session or raise
        :class:`ServerBusy`. Pair with :meth:`release`."""
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
            try:
                _faults.maybe_fail("session_state_evict")
            except _faults.InjectedFault as e:
                self._evict_locked(sid, f"injected fault ({e})")
                raise SessionEvicted(
                    f"session {sid!r} state was evicted (injected "
                    "fault); re-open the session and retry") from e
            now = time.monotonic()
            if self.ttl_s > 0 and now - rec.last_used > self.ttl_s:
                self._evict_locked(sid, "idle TTL expired")
                raise SessionEvicted(
                    f"session {sid!r} state expired after "
                    f"{self.ttl_s:g}s idle; re-open the session and "
                    "retry")
            if self.paged:
                # this step appends token ``steps``: back its page
                self._alloc_pages_locked(rec, self._page_of(rec) + 1)
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
                self.steps_total += 1

    # -- the device path: gather / scatter -----------------------------

    def _page_of(self, rec):
        """The logical page the session's next step appends into."""
        return min(rec.steps // self.page_tokens, self._ppr - 1)

    def _resolve_locked(self, items):
        """Slot records (the batcher's currency) or raw slot numbers, as
        records of live sessions."""
        recs, by_slot = [], None
        for it in items:
            if isinstance(it, _Slot):
                recs.append(it)
                continue
            if by_slot is None:
                by_slot = {r.slot: r for r in self._slots.values()}
            rec = by_slot.get(int(it))
            if rec is None:
                raise MXNetError(f"slot {int(it)} does not belong to a "
                                 "live session")
            recs.append(rec)
        return recs

    def _write_pages(self, i, dest, pages):
        """Write float32 ``pages`` (n, page_tokens, ...) of state ``i`` to
        the physical pages ``dest``: as they are, or as int8 codes and
        scales (counted in ``kv_pages_quantized``)."""
        if self._scales[i] is None:
            self._pools[i].index_copy_(0, dest, pages)
            return
        from ..analysis import quantize as _quantize

        q, scale = _quantize.kv_page_codes(pages)
        self._pools[i].index_copy_(0, dest, q)
        self._scales[i].index_copy_(0, dest, scale)
        _quantize._count("kv_pages_quantized", int(pages.shape[0]))

    def _read_pages(self, i, index, out=None):
        """The pages ``index`` of state ``i`` as float32 (dequantized from
        an int8 pool), into ``out`` when given."""
        pool = self._pools[i]
        if self._scales[i] is None:
            return torch.index_select(pool, 0, index, out=out)
        from ..analysis import quantize as _quantize

        return _quantize.dequantize_kv_pages(
            pool.index_select(0, index),
            self._scales[i].index_select(0, index), out=out)

    def _device_index(self, values):
        return host_to_device(
            torch.from_numpy(onp.asarray(values, onp.int64)), self.device)

    def gather(self, slots, pad_to=None, out=None):
        """Dense ``(rows,) + row_shape`` tensors, one per state, for the
        given slot records: the live sessions' state in rows ``[:n]``
        and zeros after. Pageable states materialize through each
        session's page table (an unallocated entry gathers the null
        page: zeros). ``out`` — tensors of at least ``n`` rows that the
        caller owns (the session's static step inputs) — receives the
        rows in place and is returned; otherwise fresh tensors of
        ``max(n, pad_to)`` rows are. Either way the step may update
        them in place."""
        with self._lock, torch.inference_mode():
            recs = self._resolve_locked(slots)
            n = len(recs)
            if out is None:
                rows = max(n, int(pad_to or 0))
                out = [torch.empty((rows,) + s, dtype=torch_dtype(dt),
                                   device=self.device)
                       for s, dt in zip(self.state_shapes,
                                        self.state_dtypes)]
            idx = self._device_index([r.slot for r in recs])
            tables = self._device_index(
                onp.concatenate([r.table for r in recs])) \
                if self.paged else None
            for i, (pool, dst) in enumerate(zip(self._pools, out)):
                if dst.shape[0] < n or tuple(dst.shape[1:]) != \
                        self.state_shapes[i]:
                    raise MXNetError(
                        f"gather: out[{i}] {tuple(dst.shape)} cannot hold "
                        f"{n} rows of {self.state_shapes[i]}")
                if self._pageable[i]:
                    self._read_pages(i, tables, out=dst[:n].view(
                        (n * self._ppr,) + tuple(pool.shape[1:])))
                else:
                    torch.index_select(pool, 0, idx, out=dst[:n])
                dst[n:].zero_()
        return out

    def scatter(self, slots, new_states):
        """Write a step's output states (rows ``[:n]`` of each) back into
        the pools. A pageable state writes back ONLY the page this step
        appended into."""
        with self._lock, torch.inference_mode():
            recs = self._resolve_locked(slots)
            n = len(recs)
            idx = self._device_index([r.slot for r in recs])
            if self.paged:
                pidx = [self._page_of(r) for r in recs]
                dest = onp.asarray([int(r.table[p]) for r, p in
                                    zip(recs, pidx)], onp.int64)
                if not dest.all():
                    raise MXNetError(
                        "scatter into an unbacked KV page (acquire() "
                        "must precede the step that appends)")
                dest = self._device_index(dest)
                # the appended page of row r is page r*ppr + pidx[r] of
                # the step's (n * ppr, page_tokens, ...) page view
                flat = self._device_index(
                    [r * self._ppr + p for r, p in enumerate(pidx)])
            for i, (pool, ns) in enumerate(zip(self._pools, new_states)):
                ns = ns[:n].to(torch_dtype(self.state_dtypes[i]))
                if self._pageable[i]:
                    pages = ns.reshape((n * self._ppr,)
                                       + tuple(pool.shape[1:]))
                    self._write_pages(i, dest, pages.index_select(0, flat))
                else:
                    pool.index_copy_(0, idx, ns)

    def _dense_rows(self, rec):
        """Host copies of one session's state rows, densified through its
        page table (read and export are always dense rows)."""
        rows = []
        for i, pool in enumerate(self._pools):
            if self._pageable[i]:
                pg = self._read_pages(i, self._device_index(rec.table))
                rows.append(pg.reshape(
                    (self._seq,) + self.state_shapes[i][1:]).cpu().numpy())
            else:
                rows.append(pool[rec.slot].cpu().numpy())
        return rows

    def read(self, sid):
        """Host copies of one session's state rows (tests, export)."""
        with self._lock:
            rec = self._slots.get(sid)
            if rec is None:
                raise MXNetError(f"unknown session {sid!r}")
            return self._dense_rows(rec)

    # -- checkpoint / migration ----------------------------------------

    def export_state(self):
        """Host snapshot of every live session: DENSE rows whatever the
        page geometry, so the payload restores under another
        ``page_tokens`` and into row-slot stores."""
        with self._lock:
            sessions = {rec.sid: {"steps": rec.steps,
                                  "states": self._dense_rows(rec)}
                        for rec in self._slots.values()}
        return {"format": 1,
                "state_shapes": [list(s) for s in self.state_shapes],
                "state_dtypes": [str(dt) for dt in self.state_dtypes],
                "sessions": sessions}

    def restore_state(self, payload):
        """Re-open every session of an :meth:`export_state` payload
        (checkpoint restore, or live migration at a canary promote).
        Returns the number of sessions resumed; each bumps
        ``resumed_sessions``. A shape mismatch raises. A session's step
        count bounds its pages in a paged store."""
        if payload is None:
            return 0
        shapes = tuple(tuple(s) for s in payload.get("state_shapes", ()))
        if shapes != self.state_shapes:
            raise MXNetError(
                f"session-state payload shapes {shapes} do not match "
                f"this store's {self.state_shapes}; cannot resume")
        restored = 0
        for sid, ent in payload.get("sessions", {}).items():
            with self._lock:
                if not self._free and sid not in self._slots:
                    self._reclaim_locked()
                if not self._free and sid not in self._slots:
                    logging.warning(
                        "serving: session-state restore ran out of "
                        "slots; %s (and later sessions) not resumed", sid)
                    break
                try:
                    self.open(sid, init_states=ent["states"],
                              _resumed=True, tokens=ent.get("steps"))
                except ServerBusy:
                    logging.warning(
                        "serving: session-state restore ran out of KV "
                        "pages; %s (and later sessions) not resumed", sid)
                    break
                self._slots[sid].steps = int(ent.get("steps", 0))
            restored += 1
        return restored

    def close(self):
        """Unregister the metrics probes (the pools are freed with the
        store)."""
        METRICS.unregister_occupancy_probe(self._occupancy_token)
        if self._page_token is not None:
            METRICS.unregister_page_probe(self._page_token)

    def __repr__(self):
        paged = (f", page_tokens={self.page_tokens}, "
                 f"pages={self.num_pages}") if self.paged else ""
        return (f"SessionStateStore(slots={self.num_slots}, "
                f"live={self.occupancy}, "
                f"bytes_per_session={self.bytes_per_session}, "
                f"ttl_s={self.ttl_s:g}{paged}, device={self.device})")


# -- artifact-layer salt provider -------------------------------------------

def fingerprint_salt(ctx):
    """The ``paged_state`` contribution to a decode step's program:
    page geometry and int8-KV storage re-key it; a row-slot store (and
    every stateless program) contributes nothing."""
    if not ctx.get("paged"):
        return ()
    return ("paged_state", int(ctx.get("page_tokens", 0)),
            bool(ctx.get("kv_int8", False)))


from ..artifact import salts as _artifact_salts  # noqa: E402

_artifact_salts.register_salt_provider("paged_state", fingerprint_salt)
