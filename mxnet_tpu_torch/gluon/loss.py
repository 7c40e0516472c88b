"""Losses of the ResNet training path.

Counterpart of ``mxnet_tpu/gluon/loss.py``: the ``Loss`` base (a scalar
``weight``, sample weighting, the mean over every axis but the batch
axis) and ``SoftmaxCrossEntropyLoss`` (``:106-146``). The rest of the
zoo (L1, L2, sigmoid BCE, KL, Huber, hinge, CTC, ...) comes with the
Gluon core (ROADMAP.md, port queue 1, item 6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


class Loss(nn.Module):
    """Base of the losses: ``weight`` scales the loss, ``batch_axis`` is
    the axis the loss keeps."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def _weighting(self, loss, sample_weight=None):
        if sample_weight is not None:
            loss = loss * sample_weight
        if self._weight is not None:
            loss = loss * self._weight
        return loss

    def _mean_over_nonbatch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"


def _pick(data, label, axis):
    """``data``'s element at ``label`` along ``axis``, kept as size 1;
    labels (floats allowed) truncated to integers and clipped into range,
    as the reference's ``pick`` (mode ``"clip"``)."""
    idx = label.to(torch.int64).clamp(0, data.shape[axis] - 1)
    return data.gather(axis, idx.unsqueeze(axis))


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy of ``pred`` (logits, or log-probabilities
    with ``from_logits``) against ``label``: class ids shaped like
    ``pred`` without ``axis`` (``sparse_label``; floats are truncated) or
    a distribution shaped like ``pred``. Returns the per-sample loss, the
    mean over every non-batch axis.

    Sparse labels on logits take the reference's fused route: ``lse -
    pick``, where the max and the pick read the logits in their own dtype
    and the exponentials and sums run in f32, so no normalised (N,
    classes) matrix is formed and the loss is f32."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis % pred.dim()
        if self._sparse_label and not self._from_logits:
            m32 = pred.amax(dim=axis, keepdim=True).float()
            lse = torch.log(torch.exp(pred.float() - m32).sum(
                dim=axis, keepdim=True)) + m32
            loss = lse - _pick(pred, label, axis).float()
        else:
            if not self._from_logits:
                pred = F.log_softmax(pred, dim=axis)
            if self._sparse_label:
                loss = -_pick(pred, label, axis)
            else:
                loss = -(pred * label.reshape(pred.shape)).sum(
                    dim=axis, keepdim=True)
        return self._mean_over_nonbatch(self._weighting(loss, sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss
