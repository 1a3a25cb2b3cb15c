"""Shared paired-median measurement methodology.

The PyTorch counterpart of ``mxnet_tpu/benchmark/_measure.py``: measure
back-to-back (test, base) pairs and take the MEDIAN of the per-pair
ratios. Drift on a scale of seconds hits both halves of an adjacent
pair equally and cancels in the ratio; the pair order alternates so
drift within a pair cancels in the median too; each half takes the min
of ``reps`` windows, which filters one-sided preemption spikes. The
callables own their window's hygiene. On the card a window's callable
must synchronize the stream before it reads the clock (the autotuner's
measures do), or it times the launches and not the work.
"""
from __future__ import annotations

import statistics

__all__ = ["paired_overhead", "paired_speedup"]


def paired_overhead(measure_base, measure_test, pairs, reps=1):
    """Median of per-pair (test / base) ratios over adjacent
    alternating pairs; each half is the min of ``reps`` windows. Both
    callables return a seconds-like cost (lower is better). Returns
    ``(best_base, best_test, overhead_pct)`` where ``overhead_pct`` is
    ``(median ratio - 1) * 100`` — positive means the test side is
    slower."""
    best = {"base": float("inf"), "test": float("inf")}
    ratios = []
    for i in range(pairs):
        order = ("test", "base") if i % 2 == 0 else ("base", "test")
        got = {}
        for side in order:
            fn = measure_base if side == "base" else measure_test
            got[side] = min(fn() for _ in range(reps))
            best[side] = min(best[side], got[side])
        ratios.append(got["test"] / got["base"])
    overhead = (statistics.median(ratios) - 1.0) * 100
    return best["base"], best["test"], overhead


def paired_speedup(measure_base, measure_test, pairs, reps=1):
    """:func:`paired_overhead` reframed for the autotuner: returns
    ``(best_base, best_test, speedup)`` where ``speedup`` is the
    median per-pair base/test cost ratio — > 1 means the test config
    beats the base config."""
    best_base, best_test, overhead = paired_overhead(
        measure_base, measure_test, pairs, reps)
    return best_base, best_test, 100.0 / (100.0 + overhead)
