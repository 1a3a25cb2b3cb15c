"""Training-loop callbacks for ``Module.fit``.

The PyTorch counterpart of ``mxnet_tpu/callback.py``. Reference
surface: python/mxnet/callback.py (Speedometer, do_checkpoint,
module_checkpoint, log_train_metric, LogValidationMetricsCallback,
ProgressBar). The call contracts are fixed by the fit loop — epoch-end
callbacks receive ``(epoch, symbol, arg_params, aux_params)``, batch-end
callbacks a ``BatchEndParam`` namedtuple — but the machinery here is this
package's own: one periodic-trigger helper shared by everything periodic,
metric formatting in one place, and wall-clock via ``perf_counter``
(host time: the device may still be running the batch).
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "module_checkpoint",
           "log_train_metric", "LogValidationMetricsCallback", "ProgressBar"]


def _fires(index, period):
    """True on every `period`-th 1-based tick of a 0-based index."""
    return (index + 1) % period == 0


def _metric_pairs(metric):
    """(name, value) pairs of an EvalMetric, or () when there is none."""
    return tuple(metric.get_name_value()) if metric is not None else ()


def _fmt_pairs(pairs):
    return "\t".join(f"{n}={v:f}" for n, v in pairs)


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving `mod` every `period` epochs
    (reference: callback.py module_checkpoint)."""
    period = max(1, int(period))

    def _callback(epoch, sym=None, arg=None, aux=None):
        if _fires(epoch, period):
            mod.save_checkpoint(prefix, epoch + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing `prefix`-symbol.json / -NNNN.params
    every `period` epochs (reference: callback.py do_checkpoint)."""
    from .model import save_checkpoint

    period = max(1, int(period))

    def _callback(epoch, sym, arg, aux):
        if _fires(epoch, period):
            save_checkpoint(prefix, epoch + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the running training metric every
    `period` batches (reference: callback.py log_train_metric)."""

    def _callback(param):
        if param.nbatch % period != 0:
            return
        pairs = _metric_pairs(param.eval_metric)
        if not pairs:
            return
        logging.info("Iter[%d] Batch[%d] %s", param.epoch, param.nbatch,
                     _fmt_pairs((f"Train-{n}", v) for n, v in pairs))
        if auto_reset:
            param.eval_metric.reset()

    return _callback


class Speedometer:
    """Batch-end callback printing samples/sec (and optionally the
    running metric) every `frequent` batches (reference: callback.py
    Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None       # perf_counter at the last report/epoch start
        self._prev_batch = -1

    def __call__(self, param):
        if param.nbatch < self._prev_batch:
            self._mark = None   # new epoch: timing window restarts
        self._prev_batch = param.nbatch
        if self._mark is None:
            self._mark = time.perf_counter()
            return
        if param.nbatch % self.frequent != 0:
            return
        elapsed = time.perf_counter() - self._mark
        speed = (self.frequent * self.batch_size / elapsed) if elapsed \
            else float("inf")
        pairs = _metric_pairs(param.eval_metric)
        if pairs:
            if self.auto_reset:
                param.eval_metric.reset()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                         param.epoch, param.nbatch, speed, _fmt_pairs(pairs))
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)
        self._mark = time.perf_counter()


class LogValidationMetricsCallback:
    """Eval-end callback logging every validation metric
    (reference: callback.py LogValidationMetricsCallback)."""

    def __call__(self, param):
        pairs = _metric_pairs(param.eval_metric)
        for name, value in pairs:
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)


class ProgressBar:
    """Batch-end callback rendering a text progress bar
    (reference: callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.total = max(1, int(total))
        self.length = int(length)

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        done = int(round(self.length * frac))
        bar = "=" * done + "-" * (self.length - done)
        logging.info("[%s] %d%%\r", bar, int(round(100 * frac)))
