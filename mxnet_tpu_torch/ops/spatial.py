"""The training-loop ops of ``mxnet_tpu/ops/spatial.py``: ``hard_sigmoid``
(``:17``), ``multi_all_finite`` (``:28``), ``all_finite`` (``:205``),
``moments`` (``:210``), ``SoftmaxActivation`` (``:242``) and
``SVMOutput`` (``:252``, whose hand-written VJP ignores the head
gradient, as a ``torch.autograd.Function`` on both devices), the resize
ops ``UpSampling``, ``BilinearResize2D`` (reference ``ops/nn.py:1261``,
``:1298``) and ``AdaptiveAvgPooling2D`` (``ops/contrib.py:536``), the
box ops ``box_iou`` and ``box_nms`` (``:74``, ``:80``) with
``bipartite_matching`` (``ops/contrib.py:566``), and the sampling ops:
the zero-padded bilinear gather ``_bilinear_gather`` (``:135``) with
``BilinearSampler`` (``:160``) and ``SpatialTransformer`` (``:175``) over
it, plain PyTorch on both devices (four clipped gathers, as the
reference's). ``box_nms`` sorts and gathers here on both devices and
suppresses through ``kernels.box_nms_sorted`` (the hand-written kernel
on the card)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..kernels.box_nms import box_nms_sorted, corner_iou, to_corner
from .elemwise import clip
from .nn import _label_grad, _one_hot, deconvolution
from .registry import register

__all__ = ["hard_sigmoid", "multi_all_finite", "all_finite", "moments",
           "softmax_activation", "svm_output", "upsampling",
           "bilinear_resize_2d", "adaptive_avg_pooling_2d", "box_iou",
           "box_nms", "bipartite_matching", "bilinear_sampler",
           "spatial_transformer"]


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    """``clip(alpha * x + beta, 0, 1)``."""
    return clip(alpha * data + beta, a_min=0.0, a_max=1.0)


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    """``[1.0]`` if every element of every input is finite, else
    ``[0.0]`` (f32, shape (1,)), on the inputs' device with no host sync.
    ``init_output`` is the reference's in-place buffer reuse: the result
    is always the predicate of these inputs."""
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a.float()).all()
    return ok.to(torch.float32).reshape((1,))


@register("all_finite")
def all_finite(data, *, init_output=True):
    return multi_all_finite(data)


@register("moments")
def moments(data, *, axes=None, keepdims=False):
    """``(mean, variance)`` over ``axes`` (all when None), the biased
    variance ``mean((x - mean)^2)``."""
    ax = tuple(axes) if axes is not None else tuple(range(data.dim()))
    mean = data.mean(dim=ax, keepdim=True)
    var = ((data - mean) ** 2).mean(dim=ax, keepdim=keepdims)
    if not keepdims:
        mean = mean.squeeze(ax)
    return mean, var


@register("SoftmaxActivation")
def softmax_activation(data, *, mode="instance"):
    """Softmax over the channel axis (``channel``) or over every axis
    but the first, flattened (``instance``)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    if mode != "instance":
        raise MXNetError(f"SoftmaxActivation: mode {mode!r} is not "
                         "instance or channel")
    flat = data.reshape(data.shape[0], -1)
    return torch.softmax(flat, dim=-1).reshape(data.shape)


class _SVMOutput(torch.autograd.Function):
    """The identity; the backward is the hinge loss's (squared, or L1
    with ``use_linear``) gradient whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.cfg = (margin, reg, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        x, lab = ctx.saved_tensors
        m, reg, use_linear = ctx.cfg
        li = lab.to(torch.int32).to(torch.int64)
        onehot = _one_hot(lab, x.shape[-1], x.dtype)
        score_l = torch.gather(x, -1, li.unsqueeze(-1))
        dist = x - score_l + m
        viol = (dist > 0) & (onehot == 0)
        if use_linear:
            gj = torch.where(viol, reg, 0.0).to(x.dtype)
        else:
            gj = torch.where(viol, 2.0 * reg * dist, 0.0)
        grad = gj - onehot * gj.sum(dim=-1, keepdim=True)
        return grad.to(x.dtype), _label_grad(ctx, lab), None, None, None


@register("SVMOutput")
def svm_output(data, label, *, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient), use_linear)


# ---------------------------------------------------------------------------
# the resize ops: UpSampling and BilinearResize2D (reference
# ops/nn.py:1261-1306) and AdaptiveAvgPooling2D (ops/contrib.py:536)
# ---------------------------------------------------------------------------


@register("UpSampling")
def upsampling(*data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """``UpSampling`` of NCHW inputs. ``nearest``: every input repeated up
    to ``data[0]``'s size times ``scale`` (each its own integer factor),
    then concatenated on the channels or, with ``multi_input_mode="sum"``,
    summed. ``bilinear``: the grouped :func:`~.nn.deconvolution` of
    ``data[0]`` with the caller's ``(C, 1, k, k)`` weight ``data[1]``,
    ``k = 2 scale - scale % 2``, stride ``scale``, pad ``scale // 2``."""
    x = data[0]
    if sample_type == "nearest":
        out_h, out_w = x.shape[2] * scale, x.shape[3] * scale
        ups = [d.repeat_interleave(out_h // d.shape[2], dim=2)
               .repeat_interleave(out_w // d.shape[3], dim=3) for d in data]
        if len(ups) == 1:
            return ups[0]
        if multi_input_mode == "sum":
            out = ups[0]
            for u in ups[1:]:
                out = out + u
            return out
        return torch.cat(ups, dim=1)
    if sample_type == "bilinear":
        if len(data) < 2:
            raise MXNetError("UpSampling(sample_type='bilinear') needs a "
                             "weight input: it is a Deconvolution")
        k = 2 * scale - scale % 2
        p = scale // 2
        return deconvolution(x, data[1], None, kernel=(k, k),
                             stride=(scale, scale), pad=(p, p),
                             num_filter=x.shape[1], num_group=x.shape[1],
                             no_bias=True)
    raise MXNetError(f"UpSampling: unknown sample_type {sample_type!r}")


@register("_contrib_BilinearResize2D", aliases=["BilinearResize2D"])
def bilinear_resize_2d(data, *, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size", align_corners=True):
    """An NCHW input resized to ``height`` x ``width`` (or its size times
    ``scale_height``/``scale_width``) as the reference resizes it:
    ``jax.image.resize(method="bilinear")``, half-pixel centres and,
    downscaling, an antialiasing triangle filter as wide as the scale;
    that is ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=True)``. The reference ignores ``align_corners`` and
    ``mode``; the port ignores ``align_corners`` as well (so its answer
    is the reference's) and raises for a ``mode`` other than ``"size"``.
    A bf16 (or f16) input is resized in f32 and rounded once, forward and
    backward: torch's CUDA backward of this resize adds into the input's
    dtype with atomics, so in bf16 each of the ~30 adds an upscaled
    pixel takes rounded, in an order that changed from run to run."""
    if mode != "size":
        raise MXNetError(f"BilinearResize2D: mode {mode!r} is not supported "
                         "(the reference ignores it); give height and "
                         "width or the scales")
    h, w = data.shape[2:]
    out_h = int(height or round(h * (scale_height or 1)))
    out_w = int(width or round(w * (scale_width or 1)))
    x = data.float() if data.dtype in (torch.bfloat16, torch.float16) \
        else data
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True).to(data.dtype)


@register("_contrib_AdaptiveAvgPooling2D", aliases=["AdaptiveAvgPooling2D"])
def adaptive_avg_pooling_2d(data, *, output_size=()):
    """Average pooling of an NCHW input onto an ``output_size`` grid (one
    int, or (h, w); empty gives 1 x 1), bin ``i`` of ``n_out`` over
    ``[floor(i n_in / n_out), ceil((i + 1) n_in / n_out))``, in f32 and
    rounded once to data's dtype (the reference's bins are torch's)."""
    if not output_size:
        size = (1, 1)
    elif isinstance(output_size, int):
        size = (output_size, output_size)
    else:
        out = tuple(output_size)
        size = (out[0], out[0]) if len(out) == 1 else (out[0], out[1])
    return F.adaptive_avg_pool2d(data.float(), size).to(data.dtype)


# ---------------------------------------------------------------------------
# the box ops (reference ops/spatial.py:41-129, ops/contrib.py:566)
# ---------------------------------------------------------------------------


@register("_contrib_box_iou", aliases=["box_iou"])
def box_iou(lhs, rhs, *, format="corner"):
    """Pairwise IoU of the boxes of ``lhs`` (..., M, 4) and ``rhs`` (...,
    N, 4) in ``format`` (``corner`` or ``center``), f32."""
    return corner_iou(to_corner(lhs.float(), format),
                      to_corner(rhs.float(), format))


@register("_contrib_box_nms", aliases=["box_nms"])
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1,
            force_suppress=False, in_format="corner",
            out_format="corner"):
    """Greedy NMS of the rows of ``data`` (..., N, K) per leading index
    (reference ``bounding_box.cc::BoxNMS``): the rows sorted by score
    (stable, as ``jnp.argsort(-scores)``: ties in index order, NaN last,
    -0 equal to +0), suppressed and invalid rows -1, f32, ``data``'s
    shape. Only the first ``topk`` sorted rows can be kept (``topk > 0``),
    so only they take part; ``id_index < 0`` or ``force_suppress``
    suppresses across classes."""
    x = data.detach().float()
    n, k = x.shape[-2:]
    flat = x.reshape(-1, n, k)
    m = n if topk <= 0 else min(n, int(topk))
    order = torch.argsort(-flat[..., score_index], dim=-1, stable=True)
    rows = flat.gather(1, order[:, :m, None].expand(-1, -1, k))
    out = box_nms_sorted(
        rows.contiguous(), n, overlap_thresh=overlap_thresh,
        valid_thresh=valid_thresh, coord_start=coord_start,
        score_index=score_index,
        id_index=-1 if force_suppress else id_index,
        in_format=in_format, out_format=out_format)
    return out.reshape(x.shape)


@register("_contrib_bipartite_matching", aliases=["bipartite_matching"])
def bipartite_matching(data, *, is_ascend=False, threshold=0.0, topk=-1):
    """Greedy bipartite matching on a (..., N, M) score matrix
    (reference ``bounding_box.cc::BipartiteMatching``): ``min(N, M)``
    rounds (``min(topk, N, M)`` with ``topk``), each taking the best
    remaining pair (the largest, or with ``is_ascend`` the smallest;
    ``argmax``'s first at a tie) and retiring its row and column if its
    score passes ``threshold`` (``>=``, on the sign-flipped scores with
    ``is_ascend``). Returns f32 ``(row_match (..., N), col_match (...,
    M))``, -1 where unmatched."""
    lead = data.shape[:-2]
    n, m = data.shape[-2:]
    sgn = -1.0 if is_ascend else 1.0
    s = data.detach().float().reshape(-1, n, m) * sgn
    thr = threshold * sgn
    rounds = min(n, m) if topk < 0 else min(topk, n, m)
    b = s.shape[0]
    rmatch = s.new_full((b, n), -1.0)
    cmatch = s.new_full((b, m), -1.0)
    rows = torch.arange(n, device=s.device)
    cols = torch.arange(m, device=s.device)
    for _ in range(rounds):
        idx = s.reshape(b, -1).argmax(dim=1)
        val = s.reshape(b, -1).gather(1, idx[:, None])[:, 0]
        r, c = idx // m, idx % m
        ok = val >= thr
        rmatch = torch.where(ok[:, None] & (rows == r[:, None]),
                             c[:, None].float(), rmatch)
        cmatch = torch.where(ok[:, None] & (cols == c[:, None]),
                             r[:, None].float(), cmatch)
        gone = ok[:, None, None] & ((rows == r[:, None])[:, :, None]
                                    | (cols == c[:, None])[:, None, :])
        s = s.masked_fill(gone, float("-inf"))
    return rmatch.reshape(lead + (n,)), cmatch.reshape(lead + (m,))


# ---------------------------------------------------------------------------
# the sampling ops (reference ops/spatial.py:135-198)
# ---------------------------------------------------------------------------


def _bilinear_gather(img, xs, ys):
    """``img`` (B, C, H, W), f32, sampled at pixel coordinates ``xs``,
    ``ys`` (B, ...) with zero padding outside, corner by corner (the
    reference's ``at``): (B, C, ...). Differentiable in ``img``, ``xs``
    and ``ys`` (``floor`` carries none). The image is gathered
    channels-last, a row of C values a corner."""
    b, c, h, w = img.shape
    lead = xs.shape[1:]
    rows = img.permute(0, 2, 3, 1).reshape(b, h * w, c)
    bi = torch.arange(b, device=img.device).reshape((b,) + (1,) * len(lead))
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = xs - x0
    dy = ys - y0

    def at(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        flat = torch.where(inb, iy, 0.0).long() * w \
            + torch.where(inb, ix, 0.0).long()
        vals = rows[bi, flat].movedim(-1, 1)          # (B, C, ...)
        return torch.where(inb.unsqueeze(1), vals, 0.0)

    v00 = at(x0, y0)
    v01 = at(x0 + 1, y0)
    v10 = at(x0, y0 + 1)
    v11 = at(x0 + 1, y0 + 1)
    dx, dy = dx.unsqueeze(1), dy.unsqueeze(1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


@register("BilinearSampler")
def bilinear_sampler(data, grid):
    """``data`` (B, C, H, W) sampled at ``grid`` (B, 2, Ho, Wo), (x, y)
    normalised to [-1, 1] (corners at the edge pixels' centres), zero
    outside: (B, C, Ho, Wo) in f32 whatever data's dtype (the reference
    casts). Differentiable in data and grid."""
    data = data.float()
    grid = grid.float()
    h, w = data.shape[2:]
    xs = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    ys = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return _bilinear_gather(data, xs, ys)


@register("SpatialTransformer")
def spatial_transformer(data, loc, *, target_shape, transform_type="affine",
                        sampler_type="bilinear", cudnn_off=None):
    """The affine spatial transformer: ``loc`` (B, 6) thetas map the
    target's normalised grid (``target_shape`` (Ho, Wo)) to sampling
    positions, which ``BilinearSampler`` reads: (B, C, Ho, Wo) f32. The
    grid is formed in f64 and rounded to f32, as the reference's x64
    ``linspace`` promotes it. Differentiable in data and loc."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise NotImplementedError(
            "SpatialTransformer supports affine + bilinear")
    ho, wo = int(target_shape[0]), int(target_shape[1])
    b = data.shape[0]
    theta = loc.float().reshape(b, 2, 3).double()
    ys, xs = torch.meshgrid(
        torch.linspace(-1.0, 1.0, ho, dtype=torch.float64,
                       device=data.device),
        torch.linspace(-1.0, 1.0, wo, dtype=torch.float64,
                       device=data.device), indexing="ij")
    coords = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, -1)
    grid = torch.matmul(theta, coords).reshape(b, 2, ho, wo)
    return bilinear_sampler(data, grid)
