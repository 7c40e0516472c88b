"""The training-loop ops of ``mxnet_tpu/ops/spatial.py``: ``hard_sigmoid``
(``:17``), ``multi_all_finite`` (``:28``), ``all_finite`` (``:205``),
``moments`` (``:210``), ``SoftmaxActivation`` (``:242``) and
``SVMOutput`` (``:252``, whose hand-written VJP ignores the head
gradient, as a ``torch.autograd.Function`` on both devices). The box and
sampling ops of that module wait (ROADMAP.md, port queue 1, item 4)."""
from __future__ import annotations

import torch

from ..base import MXNetError
from .nn import _label_grad, _one_hot
from .registry import register

__all__ = ["hard_sigmoid", "multi_all_finite", "all_finite", "moments",
           "softmax_activation", "svm_output"]


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
