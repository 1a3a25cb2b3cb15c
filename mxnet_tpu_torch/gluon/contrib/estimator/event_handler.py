"""The estimator's event handlers (reference:
python/mxnet/gluon/contrib/estimator/event_handler.py).

The PyTorch counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``: the six event
mixins and the stopping, metric, validation, logging, checkpoint and
early-stopping handlers, with the JAX package's log lines and checkpoint
file names (``<prefix>-epoch<N>.params``, ``<prefix>-best.params``).
"""
from __future__ import annotations

import logging
import os
import time

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch/max_batch (reference: event_handler.py:78)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Updates training metrics each batch (reference:
    event_handler.py:126)."""

    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.train_metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs["pred"]
        label = kwargs["label"]
        loss = kwargs["loss"]
        for metric in self.train_metrics:
            if "loss" in metric.name.lower():
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Runs validation every `epoch_period` epochs (reference:
    event_handler.py:182)."""

    def __init__(self, val_data, eval_fn, val_metrics=None, epoch_period=1,
                 batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.val_metrics = val_metrics or []
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and \
                self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data,
                         val_metrics=self.val_metrics)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and \
                self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data,
                         val_metrics=self.val_metrics)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Logs metrics per epoch/interval (reference: event_handler.py:248)."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.batch_index = 0
        self.current_epoch = 0
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.time() - self.train_start
        self.logger.info("Train finished in %.2fs: %s", t,
                         self._fmt_metrics())

    def _fmt_metrics(self):
        return ", ".join("%s=%.6f" % m.get() for m in self.metrics)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.time() - self.epoch_start
        self.logger.info("Epoch %d finished in %.2fs: %s",
                         self.current_epoch, t, self._fmt_metrics())
        self.current_epoch += 1
        self.batch_index = 0

    def batch_end(self, estimator, *args, **kwargs):
        if isinstance(self.log_interval, int) and \
                (self.batch_index + 1) % self.log_interval == 0:
            self.logger.info("Epoch %d batch %d: %s", self.current_epoch,
                             self.batch_index + 1, self._fmt_metrics())
        self.batch_index += 1


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Saves model/trainer state periodically, tracking a monitored metric
    (reference: event_handler.py:358)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="auto", save_best=False, epoch_period=1,
                 max_checkpoints=5):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.max_checkpoints = max_checkpoints
        self.current_epoch = 0
        self.saved = []
        if mode == "auto" and monitor is not None:
            mode = "max" if "acc" in monitor.name.lower() else "min"
        self.mode = mode
        self.best = None
        os.makedirs(model_dir, exist_ok=True)

    def _better(self, value):
        if self.best is None:
            return True
        return value > self.best if self.mode == "max" else \
            value < self.best

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.current_epoch % self.epoch_period:
            return
        path = os.path.join(
            self.model_dir,
            f"{self.model_prefix}-epoch{self.current_epoch}.params")
        estimator.net.save_parameters(path)
        self.saved.append(path)
        while len(self.saved) > self.max_checkpoints:
            old = self.saved.pop(0)
            if os.path.isfile(old):
                os.remove(old)
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            if self._better(value):
                self.best = value
                estimator.net.save_parameters(os.path.join(
                    self.model_dir, f"{self.model_prefix}-best.params"))


class EarlyStoppingHandler(TrainBegin, EpochEnd):
    """Stops when the monitored metric stops improving (reference:
    event_handler.py:570)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto"):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        if mode == "auto":
            mode = "max" if "acc" in monitor.name.lower() else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.best = None
        self.wait = 0
        self.stop_training = False

    def epoch_end(self, estimator, *args, **kwargs):
        _, value = self.monitor.get()
        improved = self.best is None or (
            value - self.best > self.min_delta if self.mode == "max"
            else self.best - value > self.min_delta)
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True
