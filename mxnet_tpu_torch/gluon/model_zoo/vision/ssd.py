"""The single-shot detector (counterpart of ``mxnet_tpu/gluon/model_zoo/
vision/ssd.py``): a downsampling trunk tapped at several scales, a class
and a box head per scale over ``MultiBoxPrior`` anchors, training
targets from ``MultiBoxTarget`` with hard-negative mining, and
``detect`` through ``MultiBoxDetection``, whose suppression is the
hand-written ``box_nms`` kernel on the card.

The module tree and the parameter prefixes are the reference's
(``trunk_``, ``stage{i}_``, ``cls{i}_``, ``box{i}_``), so one ``.params``
file serves both packages. ``hybrid_forward`` runs on NDArrays (``F`` =
``mx.nd``, a CUDA graph when hybridized) and on torch tensors (``F`` =
``tensor_ops``); ``targets`` and ``detect`` take either.
"""
from __future__ import annotations

from ....ndarray import NDArray
from ...block import HybridBlock, tensor_ops
from ... import nn
from ...loss import Loss

__all__ = ["SSD", "SSDMultiBoxLoss", "get_ssd", "ssd_toy"]


def _feature_trunk(base):
    """A small downsampling trunk; SSD taps it at several strides."""
    trunk = nn.HybridSequential(prefix="trunk_")
    with trunk.name_scope():
        filters = {"toy": (16, 32, 64), "small": (32, 64, 128)}[base]
        for f in filters:
            trunk.add(nn.Conv2D(f, 3, strides=2, padding=1),
                      nn.BatchNorm(), nn.Activation("relu"))
    return trunk


def _ops(x):
    from .... import ndarray

    return ndarray if isinstance(x, NDArray) else tensor_ops


class SSD(HybridBlock):
    """Multi-scale SSD head over a trunk. ``forward(x)`` gives (anchors
    (1, N, 4), cls_preds (B, N, C+1), box_preds (B, N*4)); ``detect(x)``
    decodes and suppresses to (B, N, 6)."""

    def __init__(self, num_classes, base="toy", num_scales=3,
                 sizes=None, ratios=None, nms_threshold=0.45,
                 nms_topk=400, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.num_classes = num_classes
        self.nms_threshold = nms_threshold
        self.nms_topk = nms_topk
        if sizes is None:
            # linearly spaced scales per feature map (the SSD paper's)
            sizes = [(0.2 + 0.6 * i / num_scales,
                      0.2 + 0.6 * (i + 0.5) / num_scales)
                     for i in range(num_scales)]
        if ratios is None:
            ratios = [(1.0, 2.0, 0.5)] * num_scales
        self._sizes = sizes
        self._ratios = ratios
        with self.name_scope():
            self.trunk = _feature_trunk(base)
            self.stages = []
            self.cls_heads = []
            self.box_heads = []
            for i in range(num_scales):
                a = len(sizes[i]) + len(ratios[i]) - 1
                if i > 0:
                    stage = nn.HybridSequential(prefix=f"stage{i}_")
                    with stage.name_scope():
                        stage.add(nn.Conv2D(64, 3, strides=2, padding=1),
                                  nn.BatchNorm(), nn.Activation("relu"))
                    self.register_child(stage, f"stage{i}")
                    self.stages.append(stage)
                ch = nn.Conv2D(a * (num_classes + 1), 3, padding=1,
                               prefix=f"cls{i}_")
                bh = nn.Conv2D(a * 4, 3, padding=1, prefix=f"box{i}_")
                self.register_child(ch, f"cls_head{i}")
                self.register_child(bh, f"box_head{i}")
                self.cls_heads.append(ch)
                self.box_heads.append(bh)

    def hybrid_forward(self, F, x):
        feats = [self.trunk(x)]
        for stage in self.stages:
            feats.append(stage(feats[-1]))
        anchors, cls_preds, box_preds = [], [], []
        for feat, ch, bh, sz, rt in zip(feats, self.cls_heads,
                                        self.box_heads, self._sizes,
                                        self._ratios):
            anchors.append(F.contrib.MultiBoxPrior(
                feat, sizes=tuple(sz), ratios=tuple(rt)))
            # (B, A*(C+1), H, W) -> (B, H*W*A, C+1)
            cls_preds.append(F.Reshape(
                F.transpose(ch(feat), axes=(0, 2, 3, 1)),
                shape=(0, -1, self.num_classes + 1)))
            box_preds.append(F.Reshape(
                F.transpose(bh(feat), axes=(0, 2, 3, 1)), shape=(0, -1)))
        return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=1),
                F.concat(*box_preds, dim=1))

    def targets(self, anchors, labels, cls_preds,
                negative_mining_ratio=3.0):
        """``MultiBoxTarget`` with the class-axis layout the op expects:
        ``(loc_target, loc_mask, cls_target)``."""
        F = _ops(cls_preds)
        return F.contrib.MultiBoxTarget(
            anchors, labels, F.transpose(cls_preds, axes=(0, 2, 1)),
            negative_mining_ratio=negative_mining_ratio)

    def detect(self, x, threshold=0.01):
        """Inference: decode and per-class NMS to (B, N, 6) rows
        ``[cls_id, score, x1, y1, x2, y2]`` (-1 = suppressed)."""
        anchors, cls_preds, box_preds = self(x)
        F = _ops(cls_preds)
        cls_prob = F.transpose(F.softmax(cls_preds, axis=-1),
                               axes=(0, 2, 1))
        return F.contrib.MultiBoxDetection(
            cls_prob, box_preds, anchors, threshold=threshold,
            nms_threshold=self.nms_threshold, nms_topk=self.nms_topk)


class SSDMultiBoxLoss(Loss):
    """Classification cross-entropy over the mined targets (class -1
    ignored) plus smooth-L1 localization, both over the positive count
    (reference: GluonCV's ``SSDMultiBoxLoss``)."""

    def __init__(self, lambd=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._lambd = lambd

    def hybrid_forward(self, F, cls_preds, loc_preds, cls_target,
                       loc_target, loc_mask):
        valid = F._greater_equal_scalar(cls_target, scalar=0.0)
        logp = F.log_softmax(cls_preds, axis=-1)
        picked = F.pick(logp, F._maximum_scalar(cls_target, scalar=0.0),
                        axis=-1)
        n_pos = F._maximum_scalar(
            F.sum(F._greater_scalar(cls_target, scalar=0.0)), scalar=1.0)
        cls_loss = -F.sum(F.where(valid, picked,
                                  F.zeros_like(picked))) / n_pos
        loc_loss = F.sum(F.smooth_l1(
            (loc_preds - loc_target) * loc_mask, scalar=1.0)) / n_pos
        total = cls_loss + self._lambd * loc_loss
        if self._weight is not None:
            total = total * self._weight
        return total


def get_ssd(num_classes, base="toy", **kwargs):
    return SSD(num_classes, base=base, **kwargs)


def ssd_toy(num_classes=4, **kwargs):
    """Test-sized SSD."""
    return SSD(num_classes, base="toy", **kwargs)
