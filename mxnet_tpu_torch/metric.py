"""Streaming evaluation metrics.

The PyTorch counterpart of ``mxnet_tpu/metric.py`` (reference:
python/mxnet/metric.py: the registry, ``EvalMetric``, Accuracy, TopK,
F1, MCC, Perplexity, MAE, MSE, RMSE, CrossEntropy, NegativeLogLikelihood,
PearsonCorrelation, Loss, CustomMetric, Composite). The arithmetic is
numpy on the host, as in the JAX module: each update copies the batch's
predictions and labels off the device (``asnumpy``), once per batch.
"""
from __future__ import annotations

import math

import numpy as onp

_REGISTRY = {}

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register", "check_label_shapes"]


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")
    if wrap:
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
    return labels, preds


def _to_numpy(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def register(klass):
    """Register a metric class under its lower-cased name (a later
    registration of the name replaces the earlier)."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _lookup(name):
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"metric {name!r} not registered; known: "
                         f"{sorted(_REGISTRY)}") from None


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    if metric.lower() in _REGISTRY:  # a registered name as it stands
        return _REGISTRY[metric.lower()](*args, **kwargs)
    aliases = {"acc": "accuracy", "ce": "crossentropy",
               "nll_loss": "negativeloglikelihood",
               "top_k_accuracy": "topkaccuracy", "top_k_acc": "topkaccuracy",
               "pearsonr": "pearsoncorrelation",
               "composite": "compositeevalmetric"}
    key = aliases.get(metric.lower(),
                      metric.lower().replace("-", "").replace("_", ""))
    return _lookup(key)(*args, **kwargs)


class EvalMetric:
    """Base streaming metric (reference: metric.py EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def get_config(self):
        config = dict(self._kwargs)
        config.update({"metric": type(self).__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(name if isinstance(name, list) else [name])
            values.extend(value if isinstance(value, list) else [value])
        return names, values


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            if pred.ndim > label.ndim:
                pred = onp.argmax(pred, axis=self.axis)
            pred = pred.astype("int32").ravel()
            label = label.astype("int32").ravel()
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        self.name += "_%d" % top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            pred_idx = onp.argsort(-pred, axis=1)[:, :self.top_k]
            label = label.astype("int32")
            self.sum_metric += (pred_idx == label[:, None]).any(axis=1).sum()
            self.num_inst += len(label)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label).ravel(), _to_numpy(pred)
            pred = (pred[:, 1] > 0.5).astype("int32") if pred.ndim == 2 \
                else (pred > 0.5).astype("int32")
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            prec = self._tp / max(self._tp + self._fp, 1e-12)
            rec = self._tp / max(self._tp + self._fn, 1e-12)
            f1 = 2 * prec * rec / max(prec + rec, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = self._tn = 0.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label).ravel(), _to_numpy(pred)
            pred = (pred[:, 1] > 0.5).astype("int32") if pred.ndim == 2 \
                else (pred > 0.5).astype("int32")
            self._tp += ((pred == 1) & (label == 1)).sum()
            self._fp += ((pred == 1) & (label == 0)).sum()
            self._fn += ((pred == 0) & (label == 1)).sum()
            self._tn += ((pred == 0) & (label == 0)).sum()
            denom = math.sqrt((self._tp + self._fp) * (self._tp + self._fn)
                              * (self._tn + self._fp) * (self._tn + self._fn))
            mcc = (self._tp * self._tn - self._fp * self._fn) / max(denom, 1e-12)
            self.sum_metric = mcc
            self.num_inst = 1


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            label = label.astype("int32").ravel()
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = onp.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= onp.sum(onp.log(onp.maximum(1e-10, probs)))
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            if label.ndim == 1 and pred.ndim == 2 and pred.shape[1] == 1:
                pred = pred.ravel()
            self.sum_metric += onp.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            if label.ndim == 1 and pred.ndim == 2 and pred.shape[1] == 1:
                pred = pred.ravel()
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label).ravel(), _to_numpy(pred)
            probs = pred[onp.arange(label.shape[0]), label.astype("int64")]
            self.sum_metric += (-onp.log(probs + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label).ravel(), _to_numpy(pred).ravel()
            self.sum_metric += onp.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, list):
            for pred in preds:
                loss = _to_numpy(pred)
                self.sum_metric += loss.sum()
                self.num_inst += loss.size
        else:
            loss = _to_numpy(preds)
            self.sum_metric += loss.sum()
            self.num_inst += loss.size


@register
class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = getattr(feval, "__name__", "custom")
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label, pred = _to_numpy(label), _to_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval as a metric (reference: metric.py np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = name if name else getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)
