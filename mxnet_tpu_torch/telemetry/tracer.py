"""Span tracer: the causal-timeline half of the telemetry subsystem.

The PyTorch counterpart of ``mxnet_tpu/telemetry/tracer.py``
(reference analog: MXNet's engine profiler, ``MXSetProfilerConfig`` /
``MXDumpProfile``). The spans are host-side seams (dispatch, the fused
step, pipeline stages, the serving request lifecycle); the card's
kernels live in the device trace ``profiler`` takes with
``torch.profiler``. Nested and parallel spans with parent/child links
export to Perfetto.

Design constraints, in order:

1. **Zero cost when off.** ``MXNET_TELEMETRY=0`` (the default) adds one
   env-dict lookup and an integer compare to a seam: no allocation, no
   lock. ``span(...)`` returns one shared no-op context manager.
2. **Never block the hot path.** The buffer is a bounded
   ``deque(maxlen=...)`` ring: appends are O(1) and GIL-atomic, and when
   full the OLDEST event drops. Drops are counted (``dropped_spans``),
   never waited on. No span reads the card: nothing here synchronizes
   a stream or copies a tensor to the host.
3. **Causality.** Each thread keeps a span stack: a span opened inside
   another records it as parent. Across threads (a request's spans hop
   from the HTTP handler to the batcher's worker) causality rides the
   **trace id**, propagated via :func:`trace_context` or an explicit
   ``trace_id=`` argument and stamped into every span's args.

Levels (``MXNET_TELEMETRY``): ``0`` off; ``1`` structural spans (step,
batch, request lifecycle); ``2`` adds per-op eager dispatch and
per-rewrite-pass spans. Levels gate at span creation.

A span opened while a CUDA graph is being captured runs once, at the
capture; the seams therefore open their spans around a graph's replay,
never inside a captured body.

Clock: ``time.monotonic()`` everywhere, exported in microseconds
relative to the tracer epoch. The device trace keeps its own clock.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

__all__ = ["TELEMETRY_KNOB", "level", "tracing", "span", "instant",
           "emit_span", "trace_context", "current_trace_id",
           "new_trace_id", "events", "reset", "dropped_spans",
           "buffer_capacity", "thread_names"]

TELEMETRY_KNOB = "MXNET_TELEMETRY"
_BUFFER_KNOB = "MXNET_TELEMETRY_BUFFER"
_DEFAULT_CAPACITY = 65536


# ``os.environ``'s own mapping and the knob's key in it: a plain dict
# lookup, where ``os.environ.get`` of an unset name raises and catches
# a KeyError inside ``Mapping.get`` on every eager dispatch.
# ``os.environ[...] = ...`` and ``del`` (pytest's ``monkeypatch.setenv``
# among them) write through to this mapping.
try:
    _ENV_DATA = os.environ._data
    _ENV_KEY = os.environ.encodekey(TELEMETRY_KNOB)
except AttributeError:  # an interpreter whose environ lacks the mapping
    _ENV_DATA, _ENV_KEY = os.environ, TELEMETRY_KNOB


def level():
    """``MXNET_TELEMETRY`` as an int (0 off / 1 structural / 2 verbose).
    Read per call (the disabled tracer's hot-path cost IS this read,
    one dict lookup), so tests and benchmarks toggle it without
    reimport. Not routed through ``env.get_int``: that helper logs on
    garbage, and this runs on every dispatch."""
    v = _ENV_DATA.get(_ENV_KEY)
    if not v:
        return 0
    try:
        return int(v)
    except ValueError:
        return 1  # a set-but-garbled knob means "on"


def tracing(need=1):
    """True when spans at detail level ``need`` are being recorded."""
    return level() >= need


class _Ring:
    """Bounded drop-oldest event ring. ``deque.append`` is GIL-atomic,
    so the hot path takes no lock; the emitted counter is a plain int
    (exact single-threaded, may undercount under heavy cross-thread
    races — it guards a diagnostic, not an invariant)."""

    __slots__ = ("buf", "emitted")

    def __init__(self, capacity):
        self.buf = deque(maxlen=int(capacity))
        self.emitted = 0

    @property
    def dropped(self):
        return max(0, self.emitted - len(self.buf))


def _capacity():
    try:
        cap = int(os.environ.get(_BUFFER_KNOB, _DEFAULT_CAPACITY))
    except ValueError:
        cap = _DEFAULT_CAPACITY
    return max(16, cap)


#: tracer epoch: every exported ts is monotonic-µs since this instant
_EPOCH = time.monotonic()
_RING = _Ring(_capacity())
_SPAN_IDS = itertools.count(1)  # next() is GIL-atomic
_THREADS = {}  # tid -> thread name, for exporter "M" metadata events
_PID = os.getpid()
_monotonic = time.monotonic  # hot-path local binding


class _TLState(threading.local):
    """Per-thread tracer state. The subclass ``__init__`` runs once per
    thread on first touch, so the hot path reads plain attributes — a
    bare ``threading.local`` pays an AttributeError-guarded ``getattr``
    on every span from a thread that never opened a trace context."""

    def __init__(self):
        self.stack = []  # open span ids (lexical nesting)
        self.trace = []  # trace-id stack (trace_context scopes)
        self.tid = ident = threading.get_ident() % 100000
        # assignment, not setdefault: the OS reuses idents of exited
        # threads, and the stale owner's name must not shadow the
        # thread currently holding the ident
        _THREADS[ident] = threading.current_thread().name


_TLS = _TLState()


def _tid():
    return _TLS.tid


def thread_names():
    """{tid: thread name} of every thread that touched the tracer."""
    return dict(_THREADS)


def _stack():
    return _TLS.stack


# -- trace-id propagation ---------------------------------------------------

def new_trace_id():
    """A fresh request-scoped trace id (hex, cheap, unique enough for
    correlating one process's spans with its HTTP responses)."""
    return f"{_PID & 0xffff:04x}{next(_SPAN_IDS) & 0xffffff:06x}" \
           f"{int((time.monotonic() - _EPOCH) * 1e6) & 0xffffff:06x}"


class _TraceCtx:
    __slots__ = ("trace_id",)

    def __init__(self, trace_id):
        self.trace_id = trace_id

    def __enter__(self):
        _TLS.trace.append(self.trace_id)
        return self.trace_id

    def __exit__(self, *exc):
        st = _TLS.trace
        if st:
            st.pop()


def trace_context(trace_id=None):
    """Scope the calling thread to ``trace_id`` (generated when None):
    every span/instant emitted inside — and only inside — stamps it.
    The id itself is returned by ``__enter__`` so the HTTP layer can
    echo it back to the client."""
    return _TraceCtx(trace_id or new_trace_id())


def current_trace_id():
    """The calling thread's active trace id, or None."""
    st = _TLS.trace
    return st[-1] if st else None


# -- span emission ----------------------------------------------------------

def _emit(ev):
    ring = _RING
    ring.buf.append(ev)
    ring.emitted += 1


def emit_span(name, cat, t0, t1, trace_id=None, parent=None, **attrs):
    """Record a completed span from explicit ``time.monotonic()``
    endpoints — for durations measured before the tracer gets involved
    (a request's queue wait runs from ``t_submit``, stamped in
    ``submit()``, to batch formation in a worker thread). Honors the
    ambient trace context when ``trace_id`` is not given. No level
    check: the caller gates (it usually already knows)."""
    args = attrs
    tid = trace_id if trace_id is not None else current_trace_id()
    if tid is not None:
        args["trace_id"] = tid
    if parent is not None:
        args["parent"] = parent
    _emit({"name": name, "cat": cat, "ph": "X",
           "ts": (t0 - _EPOCH) * 1e6,
           "dur": max(0.0, (t1 - t0) * 1e6),
           "pid": _PID, "tid": _tid(), "args": args})


def instant(name, cat="event", need=1, trace_id=None, **attrs):
    """An instant event ('i', thread-scoped) at detail level ``need``.
    No-op (one env read) below that level."""
    if level() < need:
        return
    args = attrs
    tid = trace_id if trace_id is not None else current_trace_id()
    if tid is not None:
        args["trace_id"] = tid
    stack = _stack()
    if stack:
        args["parent"] = stack[-1]
    _emit({"name": name, "cat": cat, "ph": "i", "s": "t",
           "ts": (time.monotonic() - _EPOCH) * 1e6,
           "pid": _PID, "tid": _tid(), "args": args})


class _NullSpan:
    """The disabled path: one shared instance, no state, no clocks."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        """No-op attr sink (mirrors _Span.set)."""


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "trace_id", "args", "_t0", "_id",
                 "_parent")

    def __init__(self, name, cat, trace_id, args):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.args = args

    def set(self, **attrs):
        """Attach attributes discovered mid-span (cache hit/miss,
        batch rows) to the span being recorded."""
        self.args.update(attrs)

    def __enter__(self):
        stack = _TLS.stack
        self._parent = stack[-1] if stack else None
        self._id = sid = next(_SPAN_IDS)
        stack.append(sid)
        self._t0 = _monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _monotonic()
        tls = _TLS
        stack = tls.stack
        sid = self._id
        if stack and stack[-1] == sid:
            stack.pop()
        args = self.args
        args["span_id"] = sid
        if self._parent is not None:
            args["parent"] = self._parent
        tid = self.trace_id
        if tid is None:
            tr = tls.trace
            tid = tr[-1] if tr else None
        if tid is not None:
            args["trace_id"] = tid
        if exc_type is not None:
            args["error"] = exc_type.__name__
        ring = _RING
        ring.buf.append({"name": self.name, "cat": self.cat, "ph": "X",
                         "ts": (self._t0 - _EPOCH) * 1e6,
                         "dur": (t1 - self._t0) * 1e6,
                         "pid": _PID, "tid": tls.tid, "args": args})
        ring.emitted += 1
        return False


def span(name, cat="host", need=1, trace_id=None, **attrs):
    """The span context manager::

        with telemetry.span("serving.execute", cat="serving", rows=n):
            ...

    Below detail level ``need`` this returns a shared no-op — the
    disabled cost is the env read inside :func:`level`. Attributes are
    exported as the Chrome-trace event's ``args``; the ambient trace
    id (or an explicit ``trace_id=``) and the parent span id ride
    along, which is what makes one request's spans reconstructible
    across threads."""
    if level() < need:
        return _NULL
    return _Span(name, cat, trace_id, attrs)


# -- reading / lifecycle ----------------------------------------------------

def events():
    """Snapshot of the ring's events, oldest first (list copy; the
    ring keeps filling)."""
    return list(_RING.buf)


def dropped_spans():
    """Events evicted by ring wraparound since the last reset."""
    return _RING.dropped


def buffer_capacity():
    return _RING.buf.maxlen


def reset(capacity=None):
    """Drop all recorded events (tests, benchmarks); optionally resize
    the ring. Thread name registry survives — tids stay meaningful."""
    global _RING
    _RING = _Ring(capacity if capacity is not None else _capacity())
