"""SSD's MultiBox ops (counterpart of ``mxnet_tpu/ops/multibox.py``):
``MultiBoxPrior`` (``:18``), ``MultiBoxTarget`` (``:70``) and
``MultiBoxDetection`` (``:157``), registered under their ``_contrib_``
names and the short aliases.

The reference maps its target and detection functions over the images
(``jax.vmap``); here the batch is an axis written out, and every loop
runs over the ground truths or the matching rounds, never over images
or anchors. Nothing here reads a value back to the host, so a CUDA
graph can hold the prior and the detection's glue. Detection ends in
``box_nms`` (``ops/spatial.py``), whose suppression is the hand-written
kernel on the card. The targets and detections carry no gradient.

The traps that change bits against the reference, each kept here:
the prior's widths and heights are Python doubles rounded once to f32,
its centres ``(arange + offset) * step`` in f32, every size with the
first ratio and then the first size with the other ratios; the
matching claims the global best (anchor, truth) pair per round, ``argmax``'s
first at a tie; the hard-negative count ``(matched.sum() * ratio)`` is
truncated in f32, the negatives ranked by a stable sort over many tied
``-inf``, near-positives left to ``ignore_label``; detection deletes
``background_id`` at any index, keeps ``score > threshold`` and
suppresses above ``valid_thresh = max(threshold, 0)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.box_nms import corner_iou
from .elemwise import clip as _clip
from .registry import register
from .spatial import box_nms
from .tensor import amax

__all__ = ["multibox_prior", "multibox_target", "multibox_detection"]


def _f32(v) -> float:
    return float(np.float32(v))


@register("_contrib_MultiBoxPrior", aliases=["MultiBoxPrior"])
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes of one (B, C, H, W) feature map: (1, H*W*A, 4) f32
    corners in [0, 1] units, A = ``len(sizes) + len(ratios) - 1``, on
    ``data``'s device; ``clip`` clips them to [0, 1]."""
    h, w = data.shape[2], data.shape[3]
    sizes = [float(s) for s in sizes]
    ratios = [float(r) for r in ratios]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    dev = data.device
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + _f32(offsets[0])) * _f32(step_y)
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + _f32(offsets[1])) * _f32(step_x)
    r0 = ratios[0] ** 0.5
    wh = [(s * r0, s / r0) for s in sizes]
    wh += [(sizes[0] * r ** 0.5, sizes[0] / r ** 0.5) for r in ratios[1:]]
    cx, cy = cx[None, :], cy[:, None]
    anchors = []
    for bw, bh in wh:
        # half of the f32 width: exact, so a Python scalar of f32 value
        hw, hh = _f32(bw) / 2, _f32(bh) / 2
        anchors.append(torch.stack(torch.broadcast_tensors(
            cx - hw, cy - hh, cx + hw, cy + hh), dim=-1))
    boxes = torch.stack(anchors, dim=2).reshape(1, h * w * len(wh), 4)
    if clip:
        boxes = _clip(boxes, a_min=0.0, a_max=1.0)
    return boxes


def _corners_to_center(b):
    return torch.stack([(b[..., 0] + b[..., 2]) / 2,
                        (b[..., 1] + b[..., 3]) / 2,
                        (b[..., 2] - b[..., 0]).clamp_min(1e-12),
                        (b[..., 3] - b[..., 1]).clamp_min(1e-12)], dim=-1)


def _first_max(x, dim):
    """``(max, argmax)`` with ``argmax``'s first index at a tie."""
    idx = x.argmax(dim=dim)
    return x.gather(dim, idx.unsqueeze(dim)).squeeze(dim), idx


@register("_contrib_MultiBoxTarget", aliases=["MultiBoxTarget"])
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Training targets. ``anchor`` (1, N, 4) corners; ``label`` (B, M, 5)
    rows ``[cls, x1, y1, x2, y2]``, padded with class -1; ``cls_pred``
    (B, C+1, N), read by the hard-negative mining when
    ``negative_mining_ratio > 0``. Returns ``(loc_target (B, N*4),
    loc_mask (B, N*4), cls_target (B, N))``, class 0 the background and
    k+1 object class k.

    Each anchor takes its best truth by IoU (a match at
    ``overlap_threshold``); before that, M rounds each claim the global
    best remaining (anchor, truth) pair with IoU above 0 and retire both,
    so truths sharing a best anchor each get one. Mining keeps the
    ``max(matched * ratio, minimum_negative_samples)`` unmatched anchors
    of lowest background score that are not near a truth (IoU below
    ``negative_mining_thresh``) and sets the other unmatched ones to
    ``ignore_label``."""
    anchors = anchor.detach().reshape(-1, 4).float()
    lab = label.detach().float()
    batch, m = lab.shape[:2]
    n = anchors.shape[0]
    dev = anchors.device
    var = [_f32(v) for v in variances]
    a_ctr = _corners_to_center(anchors)
    valid = lab[..., 0] >= 0                                   # (B, M)
    gt = lab[..., 1:5]
    iou = corner_iou(anchors[None], gt)                        # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    best_iou, best_gt = _first_max(iou, 2)                     # (B, N)
    masked = torch.where(valid[:, None, :], iou, float("-inf"))
    claim = torch.full((batch, n), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    for _ in range(m):
        val, flat = _first_max(masked.reshape(batch, -1), 1)
        ai, gj = flat // m, flat % m
        ok = val > 0
        at = ok[:, None] & (rows == ai[:, None])
        claim = torch.where(at, gj[:, None], claim)
        masked = masked.masked_fill(
            at[:, :, None] | (ok[:, None] & (cols == gj[:, None]))[:, None],
            float("-inf"))
    forced = claim >= 0
    matched = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, claim, best_gt)
    g_ctr = _corners_to_center(gt.gather(1, gt_idx[..., None].expand(
        -1, -1, 4)))
    loc_t = torch.stack([
        (g_ctr[..., 0] - a_ctr[:, 0]) / a_ctr[:, 2] / var[0],
        (g_ctr[..., 1] - a_ctr[:, 1]) / a_ctr[:, 3] / var[1],
        torch.log(g_ctr[..., 2] / a_ctr[:, 2]) / var[2],
        torch.log(g_ctr[..., 3] / a_ctr[:, 3]) / var[3]], dim=-1)
    loc_t = torch.where(matched[..., None], loc_t, 0.0).reshape(batch, -1)
    loc_m = matched[..., None].expand(-1, -1, 4).float().reshape(batch, -1)
    cls_t = torch.where(matched, lab[..., 0].gather(1, gt_idx) + 1.0, 0.0)
    if negative_mining_ratio > 0:
        bg = cls_pred.detach().float()[:, 0]                   # (B, N)
        excluded = matched | (best_iou >= negative_mining_thresh)
        hardness = torch.where(excluded, float("-inf"), -bg)
        k = (matched.sum(dim=1).float() * _f32(negative_mining_ratio)) \
            .to(torch.int32).clamp_min(int(minimum_negative_samples))
        order = torch.argsort(-hardness, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, rows.expand(batch, -1).contiguous())
        keep_neg = ~matched & (rank < k[:, None])
        cls_t = torch.where(matched | keep_neg, cls_t, _f32(ignore_label))
    return loc_t, loc_m, cls_t


@register("_contrib_MultiBoxDetection", aliases=["MultiBoxDetection"])
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and suppress. ``cls_prob`` (B, C+1, N), ``loc_pred`` (B,
    N*4) center-variance offsets, ``anchor`` (1, N, 4). Returns (B, N, 6)
    rows ``[cls_id, score, x1, y1, x2, y2]`` sorted by score, -1 where
    suppressed, below ``threshold`` or past ``nms_topk``: each anchor's
    best class other than ``background_id`` (0-based among them),
    suppressed per class at ``nms_threshold`` (across classes with
    ``force_suppress``)."""
    anchors = anchor.detach().reshape(-1, 4).float()
    cp = cls_prob.detach().float()
    n = anchors.shape[0]
    a_ctr = _corners_to_center(anchors)
    var = [_f32(v) for v in variances]
    delta = loc_pred.detach().float().reshape(cp.shape[0], n, 4)
    cx = a_ctr[:, 0] + delta[..., 0] * var[0] * a_ctr[:, 2]
    cy = a_ctr[:, 1] + delta[..., 1] * var[1] * a_ctr[:, 3]
    bw = a_ctr[:, 2] * torch.exp(delta[..., 2] * var[2])
    bh = a_ctr[:, 3] * torch.exp(delta[..., 3] * var[3])
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2], dim=-1)
    if clip:
        boxes = _clip(boxes, a_min=0.0, a_max=1.0)
    bg = background_id % cp.shape[1]
    fg = torch.cat([cp[:, :bg], cp[:, bg + 1:]], dim=1)       # (B, C, N)
    cls_id = fg.argmax(dim=1).float()
    score = amax(fg, 1, False)
    keep = score > threshold
    rows = torch.cat([torch.where(keep, cls_id, -1.0)[..., None],
                      torch.where(keep, score, -1.0)[..., None], boxes],
                     dim=-1)
    return box_nms(rows, overlap_thresh=nms_threshold,
                   valid_thresh=max(threshold, 0.0), topk=nms_topk,
                   coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)
