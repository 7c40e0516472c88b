"""ROIAlign: the hand-written CUDA kernels (``csrc/roi_align.cu``), forward
and backward, and their plain PyTorch version.

No Pallas site: the reference's ``roi_align`` (``mxnet_tpu/ops/contrib.py
:95-146``) gathers four clipped corners per sample under a ``vmap`` that
XLA fuses, and differentiates through it (data and RoI coordinates). The
plain version here is that function in PyTorch, RoIs taken in chunks so
that no (R, C, ph, pw, sr, sr) temporary outgrows ``_CHUNK_ELEMS``; its
gradient is autograd's, the RoI's through the port's ``clip`` (half the
gradient on a bound, as ``jnp.clip``'s and ``jnp.maximum``'s). The
kernel's header says what it computes and what bounds it on an H100.

:func:`roi_align` is the op's entry: a CPU tensor takes the plain
version; a CUDA tensor goes through :class:`_RoiAlign`, whose forward is
one ``roi_align_fwd_kernel`` launch (counted in ``roi_align.launches``)
and whose backward one ``roi_align_bwd_kernel`` launch (counted in
``roi_align_bwd.launches``), which also writes the RoIs' gradient when
they require one. Anything else raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["roi_align", "roi_align_bwd", "roi_align_reference",
           "roi_align_sample_ratio"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_CHUNK_ELEMS = 1 << 25         # a plain chunk's (rois, ph, pw, sr, sr, C)


def roi_align_sample_ratio(sample_ratio) -> int:
    """The reference's rule: ``sample_ratio <= 0`` means 2 (not MXNet's
    adaptive count)."""
    return int(sample_ratio) if sample_ratio > 0 else 2


def _batch_index(col, n):
    """``trunc(col)`` as a dynamic index into ``n`` images: a negative one
    wraps once, then it clamps into [0, n) (the reference's ``data[b]``
    inside ``vmap``)."""
    b = col.to(torch.int32).long()
    return torch.where(b < 0, b + n, b).clamp(0, n - 1)


def _frac(p, sr, device):
    """(p, sr) samples ``i + (j + 0.5) / sr`` formed in f64 and rounded to
    f32: the reference adds a weak-typed x64 constant. Formed on the CPU,
    where a division is one (torch's CUDA kernels multiply by a Python
    scalar's reciprocal instead)."""
    i = torch.arange(p, dtype=torch.float64)[:, None]
    j = (torch.arange(sr, dtype=torch.float64) + 0.5) / sr
    return (i + j).float().to(device)


def roi_align_reference(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
                        sample_ratio=-1, aligned=False):
    """Plain PyTorch ROIAlign of ``data`` (n, c, h, w) over ``rois`` (r, 5)
    f32: (r, c, ph, pw) in f32 (in data's dtype when that is f64),
    differentiable in both inputs."""
    from ..ops.elemwise import clip, true_div

    n, c, h, w = data.shape
    ph, pw = pooled_size
    sr = roi_align_sample_ratio(sample_ratio)
    off = 0.5 if aligned else 0.0
    min_size = 1e-6 if aligned else 1.0
    rois = rois.float()
    b = _batch_index(rois[:, 0].detach(), n)
    x1 = rois[:, 1] * spatial_scale - off
    y1 = rois[:, 2] * spatial_scale - off
    x2 = rois[:, 3] * spatial_scale - off
    y2 = rois[:, 4] * spatial_scale - off
    bin_w = true_div(clip(x2 - x1, a_min=min_size), pw)
    bin_h = true_div(clip(y2 - y1, a_min=min_size), ph)
    ys = y1[:, None, None] + _frac(ph, sr, data.device) * bin_h[:, None,
                                                                None]
    xs = x1[:, None, None] + _frac(pw, sr, data.device) * bin_w[:, None,
                                                                None]

    def axis(v, size):
        lo = clip(torch.floor(v), a_min=0, a_max=size - 1)
        hi = clip(lo + 1, a_min=0, a_max=size - 1)
        return lo.long(), hi.long(), clip(v - lo, a_min=0.0, a_max=1.0)

    y0, y1_, wy = axis(ys, h)                  # (r, ph, sr)
    x0, x1_, wx = axis(xs, w)                  # (r, pw, sr)
    img = data.permute(0, 2, 3, 1)             # (n, h, w, c): c contiguous
    per = max(1, _CHUNK_ELEMS // max(1, ph * pw * sr * sr * c))
    outs = []
    for s in range(0, rois.shape[0], per):
        sl = slice(s, s + per)
        bb = b[sl][:, None, None, None, None]
        ry0 = y0[sl][:, :, None, :, None]      # (m, ph, 1, sr, 1)
        ry1 = y1_[sl][:, :, None, :, None]
        rx0 = x0[sl][:, None, :, None, :]      # (m, 1, pw, 1, sr)
        rx1 = x1_[sl][:, None, :, None, :]
        wy1 = wy[sl][:, :, None, :, None, None]
        wx1 = wx[sl][:, None, :, None, :, None]
        v00 = img[bb, ry0, rx0]                # (m, ph, pw, sr, sr, c)
        v01 = img[bb, ry0, rx1]
        v10 = img[bb, ry1, rx0]
        v11 = img[bb, ry1, rx1]
        vals = (v00 * (1 - wy1) * (1 - wx1) + v01 * (1 - wy1) * wx1
                + v10 * wy1 * (1 - wx1) + v11 * wy1 * wx1)
        outs.append(vals.mean(dim=(3, 4)).permute(0, 3, 1, 2))
    if not outs:
        return data.new_zeros((0, c, ph, pw), dtype=torch.promote_types(
            data.dtype, torch.float32))
    return torch.cat(outs)


def _check(data, rois, what):
    if data.dtype not in _DTYPE_CODE or data.dim() != 4:
        raise MXNetError(f"{what}: the map must be a float32 or bfloat16 "
                         "(n, c, h, w) tensor")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise MXNetError(f"{what}: rois must be (r, 5) [batch, x1, y1, x2, "
                         "y2]")
    if rois.device != data.device:
        raise MXNetError(f"{what}: rois on {rois.device}, the map on "
                         f"{data.device}")


def _kernel_fwd(data, rois, ph, pw, sr, scale, aligned):
    n, c, h, w = data.shape
    r = rois.shape[0]
    out = torch.empty((r, c, ph, pw), dtype=torch.float32,
                      device=data.device)
    with torch.cuda.device(data.device):
        _build.call("roi_align.cu", "mx_roi_align_fwd", _FWD_ARGS,
                    "roi_align", data.data_ptr(), rois.data_ptr(),
                    out.data_ptr(), _DTYPE_CODE[data.dtype], n, c, h, w, r,
                    ph, pw, sr, float(scale), int(bool(aligned)),
                    torch.cuda.current_stream(data.device).cuda_stream)
    roi_align.launches += 1
    return out


def roi_align_bwd(grad, data, rois, pooled_size, spatial_scale,
                  sample_ratio=-1, aligned=False, rois_grad=False):
    """The backward kernel on CUDA tensors: (d data in data's dtype, d rois
    (r, 5) f32 or None) from the head gradient (r, c, ph, pw). One launch
    (``roi_align_bwd.launches``) after two memsets; a bf16 map's gradient
    is summed in f32 and cast once."""
    _check(data, rois, "roi_align_bwd")
    if data.device.type != "cuda":
        raise MXNetError("roi_align_bwd: the kernel takes CUDA tensors")
    n, c, h, w = data.shape
    ph, pw = pooled_size
    r = rois.shape[0]
    grad = grad.float().contiguous()
    data = data.contiguous()
    rois = rois.float().contiguous()
    if grad.shape != (r, c, ph, pw):
        raise MXNetError(f"roi_align_bwd: head gradient {tuple(grad.shape)}"
                         f" is not {(r, c, ph, pw)}")
    dd = torch.empty((n, c, h, w), dtype=torch.float32, device=data.device)
    dr = torch.empty((r, 5), dtype=torch.float32, device=data.device) \
        if rois_grad else None
    with torch.cuda.device(data.device):
        _build.call("roi_align.cu", "mx_roi_align_bwd", _BWD_ARGS,
                    "roi_align_bwd", grad.data_ptr(), data.data_ptr(),
                    rois.data_ptr(), dd.data_ptr(),
                    None if dr is None else dr.data_ptr(),
                    _DTYPE_CODE[data.dtype], n, c, h, w, r, ph, pw,
                    roi_align_sample_ratio(sample_ratio),
                    float(spatial_scale), int(bool(aligned)),
                    torch.cuda.current_stream(data.device).cuda_stream)
    roi_align_bwd.launches += 1
    return dd.to(data.dtype), dr


class _RoiAlign(torch.autograd.Function):
    """The kernels as one differentiable function of (data, rois)."""

    @staticmethod
    def forward(ctx, data, rois, cfg):
        ph, pw, sr, scale, aligned = cfg
        ctx.save_for_backward(data, rois)
        ctx.cfg = cfg
        return _kernel_fwd(data, rois, ph, pw, sr, scale, aligned)

    @staticmethod
    def backward(ctx, g):
        data, rois = ctx.saved_tensors
        ph, pw, sr, scale, aligned = ctx.cfg
        dd, dr = roi_align_bwd(g, data, rois, (ph, pw), scale, sr, aligned,
                               rois_grad=ctx.needs_input_grad[1])
        return (dd if ctx.needs_input_grad[0] else None), dr, None


def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, aligned=False):
    """ROIAlign of ``data`` (n, c, h, w) over ``rois`` (r, 5): (r, c, ph,
    pw) f32 (see the module docstring); on the card one forward kernel,
    and one backward kernel under autograd."""
    if data.device.type == "cpu":
        return roi_align_reference(data, rois, pooled_size, spatial_scale,
                                   sample_ratio, aligned)
    if data.device.type != "cuda":
        raise MXNetError(f"roi_align: unsupported device {data.device}")
    _check(data, rois, "roi_align")
    ph, pw = (int(v) for v in pooled_size)
    cfg = (ph, pw, roi_align_sample_ratio(sample_ratio), float(spatial_scale),
           bool(aligned))
    return _RoiAlign.apply(data.contiguous(), rois.float().contiguous(), cfg)


roi_align.launches = 0
roi_align_bwd.launches = 0
