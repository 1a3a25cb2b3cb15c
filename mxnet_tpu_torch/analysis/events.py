"""Dynamic-trace front end: record one eager forward as an event list.

The PyTorch counterpart of ``mxnet_tpu/analysis/events.py``. The Symbol
passes (``passes.py``) see a declared graph; hybridized blocks and
imperative code have no Symbol to walk. This front end records one
execution, every op dispatch with the identities of the memory it reads
and writes and the random streams it draws, into a :class:`GraphTrace`,
then runs dataflow passes over the events:

- ``key_reuse``: two stochastic dispatches that start from the same
  random stream (GV301). A stream is a generator's state when an op
  takes it (``random.generator``): the JAX package's keys become the
  port's ``torch.Generator`` states, and re-seeding a generator to a
  seed it already drew from replays the same stream;
- ``donation``: an in-place write into memory that a live autograd graph
  saved for backward (GV201), and one dispatch writing one buffer
  through two slots (GV202). Torch deletes no buffer, so reading memory
  after an in-place write is no fault in the port (the JAX package's
  use-after-donate): see ``donation.py``;
- ``dead_values``: op results that nothing consumed and that are not
  among the traced call's outputs (GV401).

Recording wraps ``ndarray.registry.invoke`` (every eager op, hybridized
block forward and symbol evaluation funnels through it) and
``random.generator`` (every random op takes its generator there). A
buffer is identified by its storage (``donation.storage_key``); an input
whose version counter moves during a dispatch was written in place.
Both hooks are removed on exit.
"""
from __future__ import annotations

import contextlib
import hashlib

import torch

from .diagnostics import DiagnosticReport
from .donation import _saved_holders, storage_key

__all__ = ["OpEvent", "GraphTrace", "record_trace", "verify_trace"]


class OpEvent:
    """One dispatched op: names + buffer identities + keys + donation."""

    __slots__ = ("index", "op", "inputs", "outputs", "keys", "donated",
                 "stochastic", "saved")

    def __init__(self, index, op, inputs=(), outputs=(), keys=(),
                 donated=(), stochastic=False, saved=()):
        self.index = index
        self.op = op
        self.inputs = tuple(inputs)    # buffer ids read
        self.outputs = tuple(outputs)  # buffer ids produced
        self.keys = tuple(keys)        # hashable stream fingerprints
        self.donated = tuple(donated)  # buffer ids written in place
        # of those, the ones a live autograd graph had saved at the write
        self.saved = tuple(saved)
        self.stochastic = stochastic or bool(keys)

    def __repr__(self):
        extra = ""
        if self.keys:
            extra += f" keys={len(self.keys)}"
        if self.donated:
            extra += f" donated={len(self.donated)}"
        return f"<OpEvent {self.index}:{self.op}{extra}>"


class GraphTrace:
    def __init__(self, subject=None):
        self.subject = subject
        self.events = []
        self.live_out = set()  # buffer ids returned from the traced call
        # events identify buffers by id(); keep every recorded array
        # alive for the trace's lifetime so a freed buffer's heap
        # address cannot be recycled into a later array and alias two
        # distinct buffers in the dataflow passes
        self._keepalive = []

    def add(self, op, inputs=(), outputs=(), keys=(), donated=(),
            stochastic=False, saved=()):
        ev = OpEvent(len(self.events), op, inputs, outputs, keys, donated,
                     stochastic, saved)
        self.events.append(ev)
        return ev

    def mark_outputs(self, arrays):
        """Declare the traced call's results (their buffers are live)."""
        for a in arrays:
            d = getattr(a, "_data", a)
            self._keepalive.append(d)
            self.live_out.add(storage_key(d))

    def __len__(self):
        return len(self.events)


def _key_fingerprint(gen):
    """Content identity of a random stream: the generator's device, seed
    and state when an op takes it. Two draws from one state draw the
    same numbers."""
    state = gen.get_state()
    return (str(gen.device), int(gen.initial_seed()),
            hashlib.sha1(state.numpy().tobytes()).hexdigest())


def _version(t):
    """``t``'s in-place write counter (None for an inference tensor,
    which keeps none)."""
    try:
        return t._version
    except RuntimeError:
        return None


@contextlib.contextmanager
def record_trace(subject=None):
    """Record every op dispatch and random-stream draw into a
    GraphTrace."""
    from .. import random as _mxrandom
    from ..ndarray import NDArray
    from ..ndarray import registry as _registry

    trace = GraphTrace(subject=subject)
    drawn = []  # streams drawn since the current dispatch began

    orig_generator = _mxrandom.generator

    def observed_generator(device):
        gen = orig_generator(device)
        drawn.append(_key_fingerprint(gen))
        return gen

    orig_invoke = _registry.invoke
    depth = [0]

    def recording_invoke(opdef, args, kwargs):
        if depth[0]:  # a nested dispatch (an op body calling ops)
            return orig_invoke(opdef, args, kwargs)
        depth[0] += 1
        start = len(drawn)
        ins = [a._data for a in args if isinstance(a, NDArray)]
        # `out` is a destination, not an input: including it would make
        # every out= dispatch read its own destination
        ins += [v._data for k, v in kwargs.items()
                if k != "out" and isinstance(v, NDArray)]
        trace._keepalive.extend(ins)
        in_ids = [storage_key(d) for d in ins]
        versions = [_version(d) for d in ins]
        out_arr = kwargs.get("out")
        written = []
        if isinstance(out_arr, NDArray) and \
                storage_key(out_arr._data) in in_ids:
            # out= aliases a real input: written in place over it
            written.append(storage_key(out_arr._data))
        saved_before = _saved_holders(set(in_ids))
        try:
            result = orig_invoke(opdef, args, kwargs)
        finally:
            depth[0] -= 1
        # an input written in place by the op body (an optimizer update)
        written += [k for k, d, v in zip(in_ids, ins, versions)
                    if _version(d) != v and k not in written]
        outs = result if isinstance(result, (list, tuple)) else [result]
        out_datas = [o._data for o in outs if isinstance(o, NDArray)]
        trace._keepalive.extend(out_datas)
        out_ids = [storage_key(d) for d in out_datas
                   if storage_key(d) not in written]
        trace.add(opdef.name, in_ids, out_ids, drawn[start:], written,
                  stochastic=not opdef.differentiable and
                  len(drawn) > start,
                  saved=[k for k in written if k in saved_before])
        return result

    _mxrandom.generator = observed_generator
    _registry.invoke = recording_invoke
    try:
        yield trace
    finally:
        _registry.invoke = orig_invoke
        _mxrandom.generator = orig_generator


# ---------------------------------------------------------------------------
# trace passes

def key_reuse_pass(trace, report):
    seen = {}  # fingerprint -> first event
    for ev in trace.events:
        for fp in ev.keys:
            first = seen.get(fp)
            if first is not None:
                report.emit(
                    "GV301",
                    f"PRNG key consumed by op '{first.op}' (event "
                    f"{first.index}) is consumed again by op '{ev.op}' "
                    f"(event {ev.index}) — both draw the same random "
                    "stream",
                    node=ev.op,
                    hint="split the key (mx.random.next_key / "
                         "key_provider) instead of reusing it")
            else:
                seen[fp] = ev


def donation_pass(trace, report):
    for ev in trace.events:
        for buf in ev.saved:
            report.emit(
                "GV201",
                f"op '{ev.op}' (event {ev.index}) writes in place into a "
                "tensor the live autograd graph saved for backward — the "
                "backward would read the written values",
                node=ev.op,
                hint="copy() the array before the in-place op, or run it "
                     "after backward()")
        if len(ev.donated) != len(set(ev.donated)):
            report.emit(
                "GV202",
                f"op '{ev.op}' (event {ev.index}) writes the same "
                "buffer through two argument slots",
                node=ev.op,
                hint="pass distinct arrays for out= and the aliased "
                     "operand")


def dead_value_pass(trace, report):
    consumed = set()
    for ev in trace.events:
        consumed.update(ev.inputs)
    for ev in trace.events:
        unused = [b for b in ev.outputs
                  if b not in consumed and b not in trace.live_out]
        if unused and len(unused) == len(ev.outputs):
            report.emit(
                "GV401",
                f"op '{ev.op}' (event {ev.index}) produces "
                f"{len(ev.outputs)} result(s) that nothing consumes",
                node=ev.op,
                hint="remove the dead computation")


TRACE_PASSES = {
    "key_reuse": key_reuse_pass,
    "donation": donation_pass,
    "dead_values": dead_value_pass,
}

DEFAULT_TRACE_PIPELINE = ("key_reuse", "donation", "dead_values")


def verify_trace(trace, passes=None, subject=None):
    """Run the trace passes; returns the (undispositioned) report."""
    report = DiagnosticReport(subject=subject or trace.subject)
    for name in (passes or DEFAULT_TRACE_PIPELINE):
        TRACE_PASSES[name](trace, report)
    return report
