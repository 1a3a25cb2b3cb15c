"""Gluon losses.

The PyTorch counterparts of ``mxnet_tpu/gluon/loss.py`` (reference:
python/mxnet/gluon/loss.py): the ``Loss`` base and every loss of the JAX
package's ``__all__`` — L2, L1, sigmoid binary cross-entropy (alias
``SigmoidBCELoss``), softmax cross-entropy (alias ``SoftmaxCELoss``),
KL divergence, CTC, Huber, hinge, squared hinge, logistic, triplet,
Poisson NLL and cosine embedding. Most return one loss per sample: the
mean over every axis but ``batch_axis``; ``TripletLoss``, ``CTCLoss``
and ``CosineEmbeddingLoss`` return the per-sample value itself and
``PoissonNLLLoss`` the mean over everything, as the JAX losses do.
``weight`` scales the loss and ``sample_weight`` multiplies it by
broadcasting. ``CTCLoss`` takes class 0 as the blank, the ``ctc_loss``
op's default, as the JAX layer does.
"""
from __future__ import annotations

import math

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss"]


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


def _softplus_of_neg_abs(F, x):
    """log(1 + exp(-|x|)), the stable tail of the logistic losses."""
    return F.activation(-F.abs(x), act_type="softrelu")


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


class L1Loss(Loss):
    """weight * |label - pred|, per sample (reference: loss.py L1Loss)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of sigmoid(pred), or of pred itself with
    ``from_sigmoid``; ``pos_weight`` weighs the positive term (reference:
    loss.py SigmoidBinaryCrossEntropyLoss)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    _softplus_of_neg_abs(F, pred)
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * \
                    (_softplus_of_neg_abs(F, pred) + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1. - pred + eps) * (1. - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """label * (log(label) - pred), with ``pred`` a log-probability
    (``from_logits``) or logits put through a log-softmax (reference:
    loss.py KLDivLoss)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


class CTCLoss(Loss):
    """Connectionist temporal classification over the ``ctc_loss`` op
    (reference: loss.py CTCLoss): ``pred`` in ``layout`` "NTC" or "TNC",
    ``label`` in ``label_layout`` "NT" or "TN", optional lengths; one
    loss per sample."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        batch_axis = label_layout.find("N")
        super().__init__(weight, batch_axis, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        loss = F.ctc_loss(pred, label, data_lengths=pred_lengths,
                          label_lengths=label_lengths,
                          use_data_lengths=pred_lengths is not None,
                          use_label_lengths=label_lengths is not None)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """|d| - rho/2 where |d| > rho, else d^2 / (2 rho) (reference:
    loss.py HuberLoss)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


class HingeLoss(Loss):
    """max(0, margin - pred * label), labels in {-1, 1} (reference:
    loss.py HingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred * label)^2 (reference: loss.py
    SquaredHingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


class LogisticLoss(Loss):
    """log(1 + exp(-pred * label)) for ``label_format`` "signed" labels
    in {-1, 1}, or the binary cross-entropy of labels in {0, 1}
    (reference: loss.py LogisticLoss)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + _softplus_of_neg_abs(F, pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return _mean_all_but_batch(F, loss, self._batch_axis)


class TripletLoss(Loss):
    """max(0, |pos - pred|^2 - |neg - pred|^2 + margin), summed over
    every axis but the batch (reference: loss.py TripletLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """The Poisson negative log-likelihood, with ``pred`` the log-rate
    (``from_logits``) or the rate; ``compute_full`` adds Stirling's term
    where the target exceeds 1; the mean over everything (reference:
    loss.py PoissonNLLLoss)."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = _reshape_like(F, target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = target * F.log(target + 1e-12) - target + \
                0.5 * F.log(2 * math.pi * (target + 1e-12))
            stirling = F.where(target <= 1, F.zeros_like(target), stirling)
            loss = loss + stirling
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CosineEmbeddingLoss(Loss):
    """1 - cos(input1, input2) for label 1, max(0, cos - margin) for
    label -1, the cosine over the last axis (reference: loss.py
    CosineEmbeddingLoss)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(F, input1, input2)
        cos = F.sum(input1 * input2, axis=-1) / (
            F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + 1e-12)
        label = label.reshape(cos.shape)
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)
