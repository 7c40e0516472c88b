"""``ROIAlign``, the counterpart of ``roi_align`` in
``mxnet_tpu/ops/contrib.py`` (``:95-146``): Faster and Mask R-CNN's RoI
head, over the hand-written kernels of ``kernels/roi_align.py`` on the
card and their plain version on the CPU. The reference's other contrib
ops live where the port's paths first needed them (``ops/multibox.py``,
``ops/spatial.py``)."""
from __future__ import annotations

from ..kernels.roi_align import roi_align as _roi_align
from .registry import register

__all__ = ["roi_align"]


@register("_contrib_ROIAlign", aliases=["ROIAlign"])
def roi_align(data, rois, *, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False):
    """Bilinear RoI pooling of ``data`` (n, c, h, w) over ``rois`` (r, 5)
    ``[batch, x1, y1, x2, y2]``: (r, c, ph, pw), f32 (a bf16 map is
    promoted by the reference's f32 weights). Each bin averages
    ``sample_ratio`` squared samples (``<= 0`` means 2, the reference's
    rule, not MXNet's adaptive count); corners are clipped into the map
    before the weights are taken; ``aligned`` shifts by half a pixel with
    a 1e-6 least size. The batch column is truncated to an int; a
    negative one wraps once, then it clamps into range (a dynamic index).
    ``position_sensitive`` is accepted and ignored, as the reference
    ignores it. Differentiable in ``data`` and in the RoI coordinates
    (columns 1-4)."""
    del position_sensitive
    return _roi_align(data, rois, tuple(pooled_size), float(spatial_scale),
                      int(sample_ratio), bool(aligned))
