"""Deformable, correlation and position-sensitive spatial ops, the
counterpart of ``mxnet_tpu/ops/deformable.py``: ``DeformableConvolution``
(``:30``), ``Correlation`` (``:95``) and ``PSROIPooling`` (``:144``).

``Correlation`` goes through the hand-written kernels of
``kernels/correlation.py`` on the card (their plain version on the CPU).
The other two are plain PyTorch on both devices: the deformable
convolution samples its (B, G, C/G, K, Ho, Wo) volume with the four
zero-padded gathers of ``ops/spatial.py`` in f32 and contracts it with
the filters in one ``torch.matmul`` per convolution group, as the
reference leaves that product to XLA outside any kernel; the
position-sensitive RoI pooling contracts separable row and column masks
in the order that never builds a per-RoI copy of the map.
"""
from __future__ import annotations

import torch

from ..kernels.correlation import correlation as _correlation
from .elemwise import true_div
from .registry import register
from .spatial import _bilinear_gather

__all__ = ["deformable_convolution", "correlation", "psroi_pooling"]


@register("_contrib_DeformableConvolution",
          aliases=["DeformableConvolution"])
def deformable_convolution(data, offset, weight, bias=None, *, kernel=(),
                           stride=(), dilate=(), pad=(), num_filter=1,
                           num_group=1, num_deformable_group=1,
                           no_bias=False, layout=None, workspace=1024):
    """Deformable convolution v1 over NCHW ``data`` (B, C, H, W):
    ``offset`` (B, 2 G kh kw, Ho, Wo) holds a (dy, dx) pair per tap and
    position for each of G deformable groups (each owning C / G
    channels); ``weight`` (O, C / num_group, kh, kw). Samples in f32,
    zero outside the map; the output in data's dtype, the bias added
    after the cast. Differentiable in data, offset, weight and bias."""
    b, c, h, w = data.shape
    kh, kw = kernel
    sh, sw = (stride or (1, 1))
    dh, dw = (dilate or (1, 1))
    ph, pw = (pad or (0, 0))
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    g = num_deformable_group
    cg = c // g
    kk = kh * kw
    dev = data.device
    oy = torch.arange(ho, device=dev) * sh - ph
    ox = torch.arange(wo, device=dev) * sw - pw
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    base_y = (oy[None, :, None] + ky.repeat_interleave(kw)[:, None, None]
              ).float()                                   # (K, Ho, 1)
    base_x = (ox[None, None, :] + kx.repeat(kh)[:, None, None]
              ).float()                                   # (K, 1, Wo)
    off = offset.reshape(b, g, kk, 2, ho, wo).float()
    sy = base_y + off[:, :, :, 0]                         # (B, G, K, Ho, Wo)
    sx = base_x + off[:, :, :, 1]
    img = data.float().reshape(b * g, cg, h, w)
    vol = _bilinear_gather(img, sx.reshape(b * g, kk, ho, wo),
                           sy.reshape(b * g, kk, ho, wo))  # (BG, Cg, K, ..)
    wmat = weight.reshape(num_filter, -1).float()
    cpg = c // num_group
    opg = num_filter // num_group
    col = vol.reshape(b, num_group, cpg * kk, ho * wo)
    out = torch.matmul(wmat.reshape(num_group, opg, cpg * kk), col)
    out = out.reshape(b, num_filter, ho, wo).to(data.dtype)
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


@register("Correlation", aliases=["correlation"])
def correlation(data1, data2, *, kernel_size=1, max_displacement=1,
                stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation layer over NCHW pairs: (B, D * D, Ho, Wo),
    D = 2 (max_displacement // stride2) + 1, each channel the mean over
    the channels and the kernel window of data1 times data2 displaced by
    ``stride2 * (i - max_displacement // stride2)`` (|a - b| when
    ``is_multiply`` is False), at the reference's output grid; in data1's
    dtype. Differentiable in both inputs."""
    return _correlation(data1, data2, kernel_size, max_displacement,
                        stride1, stride2, pad_size, is_multiply)


@register("_contrib_PSROIPooling", aliases=["psroipooling"])
def psroi_pooling(data, rois, *, spatial_scale=1.0, output_dim=1,
                  pooled_size=7, group_size=0):
    """Position-sensitive RoI pooling (R-FCN): ``data`` (B, output_dim *
    gs^2, H, W), ``rois`` (R, 5) ``[batch, x1, y1, x2, y2]``; bin (iy, ix)
    of output channel o averages channel group (gy, gx) = (iy gs // ps,
    ix gs // ps) over the integer pixels of ``[floor(start), ceil(end))``
    (corners rounded half to even before scaling, as ``jnp.round``), 0
    where a bin is empty: (R, output_dim, ps, ps) in data's dtype. The
    column masks contract with each image's routed maps first, one
    batched product over the bins' columns, then the row masks, so no
    (O, ps, ps, H, W) volume is built per RoI. The batch column is
    truncated, wraps once if negative, and clamps into range.
    Differentiable in data."""
    gs = int(group_size) or int(pooled_size)
    ps = int(pooled_size)
    b, cd, h, w = data.shape
    o = int(output_dim)
    dev = data.device
    r = rois.detach().float()
    bi = r[:, 0].to(torch.int32).long()
    bi = torch.where(bi < 0, bi + b, bi).clamp(0, b - 1)
    x1 = torch.round(r[:, 1]) * spatial_scale
    y1 = torch.round(r[:, 2]) * spatial_scale
    x2 = torch.round(r[:, 3] + 1.0) * spatial_scale
    y2 = torch.round(r[:, 4] + 1.0) * spatial_scale
    bin_h = true_div((y2 - y1).clamp_min(0.1)[:, None], ps)
    bin_w = true_div((x2 - x1).clamp_min(0.1)[:, None], ps)
    p = torch.arange(ps, device=dev)[None]
    hstart = torch.clip(torch.floor(p * bin_h + y1[:, None]), 0, h)
    hend = torch.clip(torch.ceil((p + 1) * bin_h + y1[:, None]), 0, h)
    wstart = torch.clip(torch.floor(p * bin_w + x1[:, None]), 0, w)
    wend = torch.clip(torch.ceil((p + 1) * bin_w + x1[:, None]), 0, w)
    yy = torch.arange(h, device=dev)[None, None]
    xx = torch.arange(w, device=dev)[None, None]
    row_m = ((yy >= hstart[..., None]) & (yy < hend[..., None])).float()
    col_m = ((xx >= wstart[..., None]) & (xx < wend[..., None])).float()
    counts = row_m.sum(-1)[:, :, None] * col_m.sum(-1)[:, None, :]
    gsel = torch.clip(torch.arange(ps, device=dev) * gs // ps, 0, gs - 1)
    d = data.float().reshape(b, o, gs, gs, h, w)
    d = d.index_select(2, gsel).index_select(3, gsel)   # (B, O, ps, ps, H, W)
    # contract W with each RoI's column masks, bin column ix by bin column
    # ix: (ps, B * O * ps * H, W) @ (ps, W, R)
    lhs = d.permute(3, 0, 1, 2, 4, 5).reshape(ps, b * o * ps * h, w)
    t = torch.matmul(lhs, col_m.permute(1, 2, 0))       # (ps_x, B O ps_y H, R)
    t = t.reshape(ps, b, o, ps, h, -1).permute(5, 1, 2, 3, 0, 4)
    t = t[torch.arange(r.shape[0], device=dev), bi]     # (R, O, ps_y, ps_x, H)
    summed = torch.einsum("royxh,ryh->royx", t, row_m)
    out = summed / counts.clamp_min(1.0)[:, None]
    return out.to(data.dtype)
