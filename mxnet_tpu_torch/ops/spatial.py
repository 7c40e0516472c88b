"""The training-loop ops of ``mxnet_tpu/ops/spatial.py``: ``hard_sigmoid``
(``:17``), ``multi_all_finite`` (``:28``), ``all_finite`` (``:205``),
``moments`` (``:210``), ``SoftmaxActivation`` (``:242``) and
``SVMOutput`` (``:252``, whose hand-written VJP ignores the head
gradient, as a ``torch.autograd.Function`` on both devices), and the
resize ops ``UpSampling``, ``BilinearResize2D`` (reference
``ops/nn.py:1261``, ``:1298``) and ``AdaptiveAvgPooling2D``
(``ops/contrib.py:536``). The box and sampling ops of that module wait
(ROADMAP.md, port queue 1, item 4)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import _label_grad, _one_hot, deconvolution
from .registry import register

__all__ = ["hard_sigmoid", "multi_all_finite", "all_finite", "moments",
           "softmax_activation", "svm_output", "upsampling",
           "bilinear_resize_2d", "adaptive_avg_pooling_2d"]


def _balanced(x, z, other):
    """The weight of ``x``'s gradient through ``z = max(x, other)`` (or
    min) in JAX: 1 where x won, 0.5 at a tie, 0 where it lost or where
    either is NaN."""
    return torch.where(x == z, torch.where(other == z, 0.5, 1.0), 0.0)


class _Clip01(torch.autograd.Function):
    """``minimum(maximum(y, 0), 1)`` with the reference's ``jnp.clip``
    gradient: halved where y sits on a bound, 0 at NaN (torch's
    ``maximum`` passes the gradient through a NaN)."""

    @staticmethod
    def forward(ctx, y):
        lo = torch.maximum(y, y.new_zeros(()))
        out = torch.minimum(lo, y.new_ones(()))
        ctx.save_for_backward(y, lo, out)
        return out

    @staticmethod
    def backward(ctx, g):
        y, lo, out = ctx.saved_tensors
        w = _balanced(y, lo, 0.0) * _balanced(lo, out, 1.0)
        return g * w.to(g.dtype)


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    """``clip(alpha * x + beta, 0, 1)``."""
    return _Clip01.apply(alpha * data + beta)


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
    is the reference's) and raises for a ``mode`` other than ``"size"``."""
    if mode != "size":
        raise MXNetError(f"BilinearResize2D: mode {mode!r} is not supported "
                         "(the reference ignores it); give height and "
                         "width or the scales")
    h, w = data.shape[2:]
    out_h = int(height or round(h * (scale_height or 1)))
    out_w = int(width or round(w * (scale_width or 1)))
    return F.interpolate(data, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=True)


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
