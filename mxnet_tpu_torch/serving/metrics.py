"""Serving metrics: counters and the execution-latency estimate.

The PyTorch counterpart of ``mxnet_tpu/serving/metrics.py``, cut to what
the stateful decode path records. One process-wide registry,
:data:`METRICS`, backs every session, store and batcher:

- counters: ``requests``, ``responses``, ``failures``, ``timeouts``,
  ``invalid``, ``rejected``, ``inline``, ``evictions``, and the decode
  counters ``decode_steps`` (fused continuous-batching step executions),
  ``bucket_execs``, ``padded_rows`` and ``true_rows`` (bucket padding
  overhead);
- ``exec_estimate_s``: a moving average of one step's host-timed
  execution, which the batcher's coalescing window subtracts from
  request deadlines;
- ``slot_occupancy``: live sessions, probed from each state store at
  read time.

Latency histograms, SLO classes and the Prometheus text come with a
later slice.
"""
from __future__ import annotations

import itertools
import threading

__all__ = ["ServingMetrics", "METRICS"]

_COUNTERS = ("requests", "responses", "failures", "timeouts", "invalid",
             "rejected", "inline", "evictions", "decode_steps",
             "bucket_execs", "padded_rows", "true_rows")


class ServingMetrics:
    """Thread-safe counter registry for the serving path."""

    def __init__(self):
        # guards: _counts, _exec_ema, _exec_n, _probes
        self._lock = threading.Lock()
        self._probes = {}
        self._tokens = itertools.count()
        self.reset()

    def reset(self):
        with self._lock:
            self._counts = dict.fromkeys(_COUNTERS, 0)
            self._exec_ema = 0.0
            self._exec_n = 0
            self._exec_total_s = 0.0

    def bump(self, name, n=1):
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(n)

    def observe_request(self, failed=False, timed_out=False):
        with self._lock:
            key = "failures" if failed else "responses"
            self._counts[key] += 1
            if timed_out:
                self._counts["timeouts"] += 1

    def observe_batch(self, rows, exec_s):
        """One executed step of ``rows`` live rows took ``exec_s``
        (host clock, synchronized)."""
        with self._lock:
            self._exec_n += 1
            self._exec_total_s += float(exec_s)
            a = 0.2 if self._exec_n > 1 else 1.0
            self._exec_ema = (1 - a) * self._exec_ema + a * float(exec_s)

    def exec_estimate_s(self):
        with self._lock:
            return self._exec_ema

    def register_occupancy_probe(self, probe):
        token = next(self._tokens)
        with self._lock:
            self._probes[token] = probe
        return token

    def unregister_occupancy_probe(self, token):
        with self._lock:
            self._probes.pop(token, None)

    def snapshot(self):
        """Counters, the step-time summary and the live slot occupancy."""
        with self._lock:
            snap = dict(self._counts)
            snap["exec_steps"] = self._exec_n
            snap["exec_mean_s"] = (self._exec_total_s / self._exec_n
                                   if self._exec_n else 0.0)
            probes = list(self._probes.values())
        snap["slot_occupancy"] = sum(p() for p in probes)
        return snap


METRICS = ServingMetrics()
