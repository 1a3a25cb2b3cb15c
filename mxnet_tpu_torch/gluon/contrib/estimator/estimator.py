"""The Gluon Fit API's ``Estimator`` (reference:
python/mxnet/gluon/contrib/estimator/estimator.py:40,236, the 1.5
release's ``Estimator.fit``).

The PyTorch counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``: the same handler
order, metric names and stopping rules. Each batch is a recorded
forward, ``backward`` and ``Trainer.step(batch size)``, so a hybridized
net replays its CUDA graphs and the Trainer its fused step, as in a
loop written by hand.
"""
from __future__ import annotations

from .... import autograd
from ....metric import Loss as LossMetric, Accuracy, EvalMetric
from .event_handler import (LoggingHandler, MetricHandler, StoppingHandler,
                            ValidationHandler)

__all__ = ["Estimator"]


class Estimator:
    """Trains ``net`` against ``loss`` with ``trainer`` (default: Adam at
    1e-3), tracking ``metrics`` (default: accuracy) and the loss."""

    def __init__(self, net, loss, metrics=None, trainer=None, context=None):
        self.net = net
        self.loss = loss
        mets = metrics if metrics is not None else [Accuracy()]
        self.train_metrics = ([mets] if isinstance(mets, EvalMetric)
                              else list(mets))
        self.train_metrics.append(LossMetric(name="loss"))
        self.trainer = trainer
        if self.trainer is None:
            from ...trainer import Trainer

            self.trainer = Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 1e-3})

    def evaluate(self, val_data, val_metrics):
        for metric in val_metrics:
            metric.reset()
        if hasattr(val_data, "reset"):
            val_data.reset()
        for batch in val_data:
            data, label = self._unpack(batch)
            pred = self.net(data)
            loss = self.loss(pred, label)
            for metric in val_metrics:
                if "loss" in metric.name.lower():
                    metric.update(0, loss)
                else:
                    metric.update(label, pred)

    @staticmethod
    def _unpack(batch):
        from ....ndarray import NDArray

        if isinstance(batch, (list, tuple)):  # DataLoader-style pair
            return batch[0], batch[1]
        if isinstance(batch, NDArray):
            raise ValueError("batch must be (data, label) or a DataBatch")
        return batch.data[0], batch.label[0]  # DataBatch

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None):
        """Train for ``epochs`` epochs or ``batches`` batches (one epoch
        when neither is given), firing the handlers' events (reference:
        estimator.py:236 fit)."""
        if epochs is None and batches is None:
            epochs = 1
        handlers = list(event_handlers or [])
        stopper = StoppingHandler(max_epoch=epochs, max_batch=batches)
        handlers.append(stopper)
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(self.train_metrics))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            self.val_metrics = [type(m)() for m in self.train_metrics[:-1]]
            self.val_metrics.append(LossMetric(name="val_loss"))
            handlers.append(ValidationHandler(val_data, self.evaluate,
                                              self.val_metrics))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(metrics=self.train_metrics))

        def fire(kind, *args, **kwargs):
            for h in handlers:
                m = getattr(h, kind, None)
                if m is not None:
                    m(self, *args, **kwargs)

        fire("train_begin")
        while not self._stopped(handlers):
            fire("epoch_begin")
            if hasattr(train_data, "reset"):
                train_data.reset()
            for batch in train_data:
                data, label = self._unpack(batch)
                fire("batch_begin")
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                bs = data.shape[0]
                self.trainer.step(bs)
                fire("batch_end", pred=pred, label=label, loss=loss)
                if self._stopped(handlers):
                    break
            fire("epoch_end")
        fire("train_end")

    @staticmethod
    def _stopped(handlers):
        return any(getattr(h, "stop_training", False) for h in handlers)
