"""Losses of the port.

Counterpart of ``mxnet_tpu/gluon/loss.py:20-295``: the ``Loss`` base (a
scalar ``weight``, sample weighting through ``_apply_weighting``, the
mean over every axis but ``batch_axis``), ``L2Loss``, ``L1Loss``,
``SigmoidBinaryCrossEntropyLoss``, ``SoftmaxCrossEntropyLoss`` (sparse or
dense labels, logits or log-probabilities), ``KLDivLoss``, ``HuberLoss``,
``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``CosineEmbeddingLoss`` and ``PoissonNLLLoss``, each the reference's
expression over the registered ops. ``CTCLoss`` waits for its op
(ROADMAP.md, port queue 1, item 4).
"""
from __future__ import annotations

from ..base import MXNetError
from .block import HybridBlock

__all__ = ["Loss", "L1Loss", "L2Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss", "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CTCLoss", "CosineEmbeddingLoss",
           "PoissonNLLLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base of the losses: ``weight`` scales the loss, ``batch_axis`` is
    the axis the loss keeps."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"

    def _mean_over_nonbatch(self, F, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return F.mean(loss, axis=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (label - pred)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_over_nonbatch(F, loss)


class L1Loss(Loss):
    """``|label - pred|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (stable form) or, with
    ``from_sigmoid``, of probabilities; ``pos_weight`` weights the
    positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = F.reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + F.Activation(
                    -F.abs(pred), act_type="softrelu")
            else:
                log_weight = 1 + F.broadcast_mul(pos_weight - 1, label)
                loss = pred - pred * label + log_weight * (
                    F.Activation(-F.abs(pred), act_type="softrelu")
                    + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(F.broadcast_mul(F.log(pred + eps) * label,
                                         pos_weight)
                         + F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy of ``pred`` (logits, or log-probabilities
    with ``from_logits``) against ``label``: class ids shaped like
    ``pred`` without ``axis`` (``sparse_label``; floats are truncated,
    out-of-range ids clipped) or a distribution shaped like ``pred``.

    Sparse labels on logits take the reference's fused route, ``lse -
    pick``: the max and the pick read the logits in their own dtype, the
    exponentials and sums run in f32, so no normalised (N, classes)
    matrix is formed and the loss is f32."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if self._sparse_label and not self._from_logits:
            m32 = F.cast(F.max(pred, axis=self._axis, keepdims=True),
                         "float32")
            lse = F.log(F.sum(F.exp(F.cast(pred, "float32") - m32),
                              axis=self._axis, keepdims=True)) + m32
            loss = lse - F.cast(F.pick(pred, label, axis=self._axis,
                                       keepdims=True), "float32")
        else:
            if not self._from_logits:
                pred = F.log_softmax(pred, axis=self._axis)
            if self._sparse_label:
                loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
            else:
                label = F.reshape_like(label, pred)
                loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities (or
    logits, ``from_logits=False``)."""

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
        return self._mean_over_nonbatch(F, loss)


class HuberLoss(Loss):
    """Quadratic within ``rho`` of the label, linear beyond."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(F, loss)


class HingeLoss(Loss):
    """``relu(margin - pred * label)``, labels +-1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(F, loss)


class SquaredHingeLoss(Loss):
    """``relu(margin - pred * label)^2``, labels +-1."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(F, loss)


class LogisticLoss(Loss):
    """Logistic loss of logits; labels +-1 (``"signed"``) or 0/1
    (``"binary"``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = F.reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + F.Activation(
            -F.abs(pred), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(F, loss)


class TripletLoss(Loss):
    """``relu(|pos - pred|^2 - |neg - pred|^2 + margin)`` per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = F.reshape_like(positive, pred)
        negative = F.reshape_like(negative, pred)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification: its op is not ported yet."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        raise MXNetError("CTCLoss needs the CTCLoss op, not ported yet "
                         "(ROADMAP.md, port queue 1, item 4)")


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, ``relu(cos - margin)``
    otherwise."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        eps = 1e-12
        dot = F.sum(input1 * input2, axis=-1)
        n1 = F.sqrt(F.sum(F.square(input1), axis=-1) + eps)
        n2 = F.sqrt(F.sum(F.square(input2), axis=-1) + eps)
        cos = dot / (n1 * n2)
        label = label.reshape(tuple(cos.shape))
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of log-rates (``from_logits``) or
    rates, with Stirling's term under ``compute_full``; the mean over
    every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = F.reshape_like(target, pred)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = (target * F.log(target + epsilon) - target
                        + 0.5 * F.log(2 * 3.141592653589793
                                      * (target + epsilon)))
            stirling = F.where(target <= 1, F.zeros_like(target), stirling)
            loss = loss + stirling
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)
