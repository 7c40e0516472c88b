"""Greedy non-maximum suppression over score-sorted box rows: the
hand-written CUDA kernels (``csrc/box_nms.cu``) and their plain PyTorch
version, with the box geometry both the NMS and the box ops share.

No Pallas site: the reference's ``box_nms`` (``mxnet_tpu/ops/spatial.py
:80``) scans the sorted rows with ``lax.scan`` (``:113-121``), which XLA
compiles. Its glue stays in ``ops/spatial.py`` on both devices (the
stable sort by score, the gather, the truncation to ``min(n, topk)``
rows); :func:`box_nms_sorted` takes the sorted rows from there. For each
image, row i suppresses a later row j when their IoU (``_corner_iou``'s
order of operations) exceeds ``overlap_thresh`` and they share a class
(or ``id_index < 0``); a row is kept when its score exceeds
``valid_thresh`` and no kept row before it suppresses it. Kept rows come
out with their box in ``out_format``, every other row -1. The kernel's
header says what bounds it on an H100.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises, and the two agree bit for bit. :func:`nms_plan` picks the
route from the number of sorted rows m alone: up to 1,856 rows (SSD's
topk 400 among them) the ``shared`` route enqueues ONE kernel a call (a
thread block cluster per image keeps the image's suppression triangle in
one CTA's shared memory) and needs no scratch; above, the ``global``
route (the op's default ``topk=-1`` at SSD's 7,620 rows) enqueues TWO
(the tiles into scratch over the whole grid, then one sweep per image)
and allocates the triangle as scratch. Either route counts one launch per
call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..base import MXNetError
from . import _build

__all__ = ["corner_iou", "to_corner", "convert_format", "box_nms_sorted",
           "box_nms_sorted_reference", "nms_plan", "NmsPlan"]

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2 \
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]

_TILE = 64                      # rows and columns of a tile of the triangle
_SLOTS = 4                      # tiles a CTA computes at once
SMEM_LIMIT = 232448             # a CTA's shared memory on sm_90 (227 KB)
# the shared route's fixed part: four slots of 64 column boxes (six f32
# each) and one flag per warp of 512 threads. The layout is
# csrc/box_nms.cu's (cluster_smem, sweep_smem): mx_box_nms refuses a plan
# whose shared bytes differ from it.
_STAGE_BYTES = _SLOTS * _TILE * 6 * 4 + (_SLOTS * 2 * _TILE // 32) * 4


class NmsPlan(NamedTuple):
    """How :func:`box_nms_sorted` runs ``m`` sorted rows of ``batch``
    images on the card (``csrc/box_nms.cu``)."""
    route: str                  # "shared" or "global"
    shared_bytes: int           # dynamic shared memory of the sweeping CTA
    scratch_bytes: int          # device scratch a call allocates
    kernels: int                # kernels a call enqueues


@functools.lru_cache(maxsize=64)
def nms_plan(m: int, batch: int = 1) -> NmsPlan:
    """The route for ``m`` score-sorted rows (by ``m`` alone): ``shared``
    while an image's triangle of tiles (words (words + 1) / 2 tiles of 512
    bytes, words = ceil(m / 64)) and the route's fixed part fit one CTA's
    shared memory, which holds up to 1,856 rows; ``global`` above, its
    triangles in scratch."""
    words = -(-m // _TILE)
    tiles = words * (words + 1) // 2
    shared = tiles * _TILE * 8 + 2 * words * 8 + _STAGE_BYTES
    if shared <= SMEM_LIMIT:
        return NmsPlan("shared", shared, 0, 1)
    return NmsPlan("global", words * 8 * (3 if words > 32 else 2),
                   batch * tiles * _TILE * 8, 2)


def _clip0(v):
    """``jnp.clip(v, 0)``: +0 at or below 0 (``+ 0.0`` turns clamp's -0
    into +0), NaN kept."""
    return v.clamp_min(0.0) + 0.0


def corner_iou(a, b):
    """Pairwise IoU of corner boxes ``a`` (..., M, 4) and ``b`` (..., N,
    4), f32, in ``_corner_iou``'s order of operations (reference
    ``mxnet_tpu/ops/spatial.py:41``): 0 where the union is not above 0."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = _clip0(ix2 - ix1) * _clip0(iy2 - iy1)
    area_a = _clip0(ax2 - ax1) * _clip0(ay2 - ay1)
    area_b = _clip0(bx2 - bx1) * _clip0(by2 - by1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def to_corner(boxes, fmt):
    """``_to_corner``: center boxes (x, y, w, h) as corners."""
    if fmt == "corner":
        return boxes
    x, y, w, h = boxes.unbind(-1)
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def convert_format(boxes, src, dst):
    """``_convert_format``: corner <-> center."""
    if src == dst:
        return boxes
    if dst == "corner":
        return to_corner(boxes, src)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                       dim=-1)


def _check_format(fmt):
    if fmt not in ("corner", "center"):
        raise MXNetError(f"box_nms: box format {fmt!r} is not corner or "
                         "center")


def box_nms_sorted_reference(rows, n_out, *, overlap_thresh, valid_thresh,
                             coord_start, score_index, id_index,
                             in_format="corner", out_format="corner"):
    """Plain PyTorch NMS of ``rows`` (batch, m, k), f32, each image's rows
    sorted by score: returns (batch, n_out, k), the reference's scan row
    by row over the batch (``id_index < 0``: one class)."""
    batch, m, k = rows.shape
    boxes = to_corner(rows[..., coord_start:coord_start + 4], in_format)
    later = torch.ones(m, m, dtype=torch.bool, device=rows.device).triu(1)
    sup = (corner_iou(boxes, boxes) > overlap_thresh) & later
    if id_index >= 0:
        ids = rows[..., id_index]
        sup &= ids[..., :, None] == ids[..., None, :]
    valid = rows[..., score_index] > valid_thresh
    keep = torch.ones(batch, m, dtype=torch.bool, device=rows.device)
    for i in range(m):
        kept_i = keep[:, i] & valid[:, i]
        keep = keep & ~(kept_i[:, None] & sup[:, i])
    keep &= valid
    if out_format != in_format:
        rows = torch.cat([rows[..., :coord_start], convert_format(
            rows[..., coord_start:coord_start + 4], in_format, out_format),
            rows[..., coord_start + 4:]], dim=-1)
    out = rows.new_full((batch, n_out, k), -1.0)
    out[:, :m] = torch.where(keep[..., None], rows, -1.0)
    return out


def box_nms_sorted(rows, n_out, *, overlap_thresh, valid_thresh,
                   coord_start, score_index, id_index, in_format="corner",
                   out_format="corner"):
    """NMS of the score-sorted ``rows`` (batch, m, k) into (batch, n_out,
    k) rows, ``n_out >= m`` (rows m..n_out-1 are -1). See the module
    docstring; on the card one kernel (m <= 1,856) or two
    (:func:`nms_plan`), counted once in ``box_nms_sorted.launches``."""
    _check_format(in_format)
    _check_format(out_format)
    if rows.device.type == "cpu":
        return box_nms_sorted_reference(
            rows, n_out, overlap_thresh=overlap_thresh,
            valid_thresh=valid_thresh, coord_start=coord_start,
            score_index=score_index, id_index=id_index, in_format=in_format,
            out_format=out_format)
    if rows.device.type != "cuda":
        raise MXNetError(f"box_nms: unsupported device {rows.device}")
    if rows.dtype != torch.float32 or rows.dim() != 3 \
            or not rows.is_contiguous():
        raise MXNetError("box_nms: the sorted rows must be a contiguous "
                         "float32 (batch, m, k) tensor")
    batch, m, k = rows.shape
    out = torch.empty((batch, n_out, k), dtype=torch.float32,
                      device=rows.device)
    if batch == 0:
        return out
    if m == 0:
        return out.fill_(-1.0)
    # the entry point checks the columns and n_out >= m
    plan = nms_plan(m, batch)
    dev = rows.device
    scratch = None
    if plan.scratch_bytes:
        scratch = torch.empty(plan.scratch_bytes // 8, dtype=torch.int64,
                              device=dev)
    with torch.cuda.device(dev):
        _build.call("box_nms.cu", "mx_box_nms", _ARGS, "box_nms",
                    rows.data_ptr(), None if scratch is None
                    else scratch.data_ptr(), out.data_ptr(),
                    batch, m, n_out, k, coord_start, score_index, id_index,
                    int(in_format == "center"), int(out_format == "center"),
                    float(overlap_thresh), float(valid_thresh),
                    int(plan.route == "global"), plan.shared_bytes,
                    torch.cuda.current_stream(dev).cuda_stream)
    box_nms_sorted.launches += 1
    return out


box_nms_sorted.launches = 0
