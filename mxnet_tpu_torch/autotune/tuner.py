"""Budgeted candidate sweep: measure a decision's candidates and
persist the winner as a TuningRecord.

The PyTorch counterpart of ``mxnet_tpu/autotune/tuner.py``. Candidates
are priced against the heuristic-default workload with the
paired-median harness (``benchmark/_measure.py``). Each candidate's
workload is built, and each of its windows runs, under a
:func:`~.records.trial` override, so the candidate is consulted while
the graph is optimized and folded into the autotune salt (a trial
program never collides with the incumbent's).

Conservative by construction: it runs only under
``MXNET_AUTOTUNE=tune``; ``MXNET_AUTOTUNE_BUDGET_MS`` stops the sweep
between candidates; a candidate that fails (fault seam
``autotune_measure``, a build error) is skipped; the winner is stored
only when it beats the heuristic default by ``min_speedup``, else the
record pins the default with speedup 1.0.
"""
from __future__ import annotations

import time

from .. import telemetry
from ..base import MXNetError
from ..benchmark._measure import paired_speedup
from ..resilience import faults as _faults
from . import _count, mode, records, registry

__all__ = ["tune", "budget_default_ms"]


def budget_default_ms():
    """MXNET_AUTOTUNE_BUDGET_MS: wall-clock budget for one tune() sweep
    (default 60000; 0 = unbounded). Checked between candidates — a
    candidate in flight finishes its pairs."""
    from .. import env

    return env.get_int("MXNET_AUTOTUNE_BUDGET_MS", 60_000)


def tune(decision, key, make_measure, default_choice=None, pairs=3,
         reps=1, budget_ms=None, min_speedup=1.02):
    """Sweep ``decision``'s candidates for ``key``; persist and return
    the winning record.

    ``make_measure(choice)`` builds a fresh workload and returns a
    zero-arg callable giving a seconds-like cost per window.
    ``choice=None`` means the heuristic-default workload (no override);
    candidate builds run inside ``records.trial(decision, key,
    choice)`` and the trial is re-entered around each test window, so
    the value is consulted and salted while the candidate runs but
    never while the interleaved base windows run. Build cost stays
    outside measured windows; the returned callable may re-consult the
    decision (salt-aware caches do) — it sees the right value either
    way.

    ``default_choice`` names the candidate the heuristic currently
    picks for this key (when it lives in the candidate space): stored
    when no candidate clears ``min_speedup``, so the sweep always
    leaves a record behind and never pins a noise-only "win".
    """
    if mode() != "tune":
        raise MXNetError(
            "autotune.tune requires MXNET_AUTOTUNE=tune "
            f"(mode is {mode()!r}) — the default 'consult' never "
            "measures online")
    point = registry.get_point(decision)
    if default_choice is None and point.default in point.candidates:
        default_choice = point.default
    if budget_ms is None:
        budget_ms = budget_default_ms()
    t0 = time.perf_counter()
    base_fn = make_measure(None)
    measured, skipped, stopped = [], [], False
    last_err = None
    for choice in point.candidates:
        if budget_ms and measured \
                and (time.perf_counter() - t0) * 1e3 > budget_ms:
            stopped = True
            break
        try:
            _faults.maybe_fail("autotune_measure")
            with records.trial(decision, key, choice):
                test_inner = make_measure(choice)

            def test_fn(_inner=test_inner, _choice=choice):
                # the trial wraps each TEST window individually: the
                # paired harness interleaves base and test windows, and
                # a trial left open across a base window would make the
                # salt-aware caches rebuild the BASE workload under the
                # candidate — both sides would measure the same config
                with records.trial(decision, key, _choice):
                    return _inner()

            with telemetry.span("autotune.measure", cat="host",
                                decision=str(decision),
                                candidate=str(choice)):
                base_s, test_s, speedup = paired_speedup(
                    base_fn, test_fn, pairs, reps)
        except Exception as exc:
            _count("measure_failures")
            skipped.append(choice)
            last_err = exc
            continue
        _count("measurements")
        measured.append({"choice": choice, "speedup": speedup,
                         "base_s": base_s, "test_s": test_s})
    if not measured:
        raise MXNetError(
            f"tune({decision!r}) measured no candidate "
            f"(skipped: {skipped!r}; last error: {last_err!r})")

    best = max(measured, key=lambda m: m["speedup"])
    won = best["speedup"] >= min_speedup \
        and best["choice"] != default_choice
    if won:
        _count("wins")
        choice, speedup = best["choice"], best["speedup"]
    elif default_choice is not None:
        # nothing beat the heuristic by a real margin: pin the default
        # so future consults hit and behavior is bit-identical
        choice, speedup = default_choice, 1.0
    else:
        choice, speedup = best["choice"], best["speedup"]
    rec = records.store_record(decision, key, choice, extra={
        "speedup": round(speedup, 4),
        "won": won,
        "default_choice": default_choice,
        "pairs": pairs, "reps": reps,
        "budget_stopped": stopped,
        "measured": [{"choice": m["choice"],
                      "speedup": round(m["speedup"], 4)}
                     for m in measured],
        "skipped": skipped,
    })
    if rec is None:
        raise MXNetError(
            f"tune({decision!r}): key {key!r} is not fingerprintable")
    return rec
