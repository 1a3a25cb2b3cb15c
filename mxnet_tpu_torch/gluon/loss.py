"""Gluon losses.

The PyTorch counterparts of ``mxnet_tpu/gluon/loss.py:34,56,115``
(reference: python/mxnet/gluon/loss.py): the ``Loss`` base,
``L2Loss`` and ``SoftmaxCrossEntropyLoss``, cut to what training
``TransformerLM`` and the trainer tests use. Each returns one loss per
sample: the mean over every axis but the batch axis.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Reference: loss.py _apply_weighting."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


def _mean_all_but_batch(F, loss, batch_axis):
    axes = tuple(i for i in range(loss.ndim) if i != batch_axis)
    if not axes:
        return loss
    return F.mean(loss, axis=axes)


class Loss(HybridBlock):
    """Base loss (reference: loss.py Loss)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return f"{type(self).__name__}(batch_axis={self._batch_axis}, " \
               f"w={self._weight})"

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """weight/2 * (label - pred)^2, per sample (reference: loss.py
    L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross-entropy of softmax(pred) along ``axis`` (reference: loss.py
    SoftmaxCrossEntropyLoss). ``sparse_label``: labels are class indices
    (picked with ``mode="clip"``), else distributions of pred's shape;
    ``from_logits``: ``pred`` is already a log-softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)

