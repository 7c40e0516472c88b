"""Optimizer update operators (``mx.nd.sgd_update``, ``adam_update``...).

Counterpart of ``mxnet_tpu/ops/optimizer_op.py``: the 31 names of
``src/operator/optimizer_op.cc`` and ``contrib/adamw.cc`` the reference
registers, each a pure function returning the updated tensors, which the
``mx.nd`` wrappers write back through ``out=`` (MXNet's in-place
update). State math runs in f32 whatever the weight's dtype; the ``mp_``
variants update an f32 master and return the weight rounded from it.

These are XLA ops in the reference, not Pallas sites: plain PyTorch on
both devices is their port. The ops of the four fused families (SGD,
NAG's neighbour ``sgd_*``, Adam, AdamW and LAMB) compute each step with
the expression, the order and the roundings of the sweep's plain
version (``kernels/fused_optimizer.py``, ``*_sweep_reference``) over one
member, which equals the hand-written sweep bit for bit on the card, so
an optimizer's per-parameter ``update`` and the fused sweep agree bit
for bit on both devices. The ``multi_*`` ops run those plain sweeps over
their whole list (one call per op, as the reference's run on its packed
layout). The other ops take their square roots correctly rounded on
both devices, as XLA does (torch's vectorised CPU ``sqrt`` is not; see
``elemwise._sqrt``).

``lamb_update_phase1`` takes the step count ``t``: the reference's eager
op divides by the Python constant ``1 - beta**t``, which XLA folds into
a multiply by its f32 reciprocal, and so does this op
(:func:`lamb_phase1` with ``bc_recip=True``); ``parallel.TrainStep``
traces ``t`` in the reference and divides, which the port's optimizer
does through :func:`lamb_phase1` with ``bc_recip=False``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.fused_optimizer import (adam_sweep_reference,
                                       sgd_sweep_reference)
from .elemwise import _sqrt
from .registry import register

__all__ = ["lamb_phase1", "lamb_phase2", "lamb_bias_corrections",
           "l2_norm"]


def _clip(clip_gradient):
    """The sweeps' clip argument: None when off (a negative value)."""
    if clip_gradient is None or clip_gradient < 0:
        return None
    return float(clip_gradient)


def _grad(grad, rescale_grad, clip_gradient):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    return _grad(grad, rescale_grad, clip_gradient) + wd * weight.float()


def _sign(x):
    """``sign`` with NaN kept NaN, as XLA's (torch's gives 0)."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def _fresh(*ts):
    return [t.detach().clone() for t in ts]


# ---------------------------------------------------------------------------
# SGD and NAG
# ---------------------------------------------------------------------------

@register("sgd_update")
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    (w,) = _fresh(weight)
    sgd_sweep_reference([w], [grad], None, None, [lr], [wd], momentum=0.0,
                        rescale_grad=rescale_grad,
                        clip_gradient=_clip(clip_gradient))
    return w


@register("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    w, m = _fresh(weight, mom)
    sgd_sweep_reference([w], [grad], [m], None, [lr], [wd],
                        momentum=momentum, rescale_grad=rescale_grad,
                        clip_gradient=_clip(clip_gradient))
    return w, m


@register("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    w32, low = _fresh(weight32, weight)
    sgd_sweep_reference([w32], [grad], None, [low], [lr], [wd],
                        momentum=0.0, rescale_grad=rescale_grad,
                        clip_gradient=_clip(clip_gradient))
    return low, w32


@register("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    w32, m, low = _fresh(weight32, mom, weight)
    sgd_sweep_reference([w32], [grad], [m], [low], [lr], [wd],
                        momentum=momentum, rescale_grad=rescale_grad,
                        clip_gradient=_clip(clip_gradient))
    return low, m, w32


@register("nag_mom_update")
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom.float() + g
    new_w = weight.float() - lr * (g + momentum * new_mom)
    return new_w.to(weight.dtype), new_mom.to(mom.dtype)


@register("mp_nag_mom_update")
def mp_nag_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight32, wd, rescale_grad, clip_gradient)
    new_mom = momentum * mom + g
    new_w32 = weight32 - lr * (g + momentum * new_mom)
    return new_w32.to(weight.dtype), new_mom, new_w32


# ---------------------------------------------------------------------------
# Adam and AdamW
# ---------------------------------------------------------------------------

@register("adam_update")
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    w, m, v = _fresh(weight, mean, var)
    adam_sweep_reference([w], [grad], [m], [v], None, [lr], [wd],
                         beta1=beta1, beta2=beta2, epsilon=epsilon,
                         rescale_grad=rescale_grad,
                         clip_gradient=_clip(clip_gradient))
    return w, m, v


@register("_contrib_adamw_update", aliases=["adamw_update"])
def adamw_update(weight, grad, mean, var, rescale_grad_t=None, *, lr,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0, rescale_grad=1.0):
    """Decoupled weight decay (``contrib/adamw.cc``): the expressions of
    ``adamw_sweep_reference`` with ``eta`` scaling the step; the decay
    is ``f32(wd) * f32(lr)``, as the sweep's kernel forms it. A weight
    whose rescaled, clipped grad holds a value that is not finite keeps
    its weight and moments (the AMP overflow step); ``rescale_grad_t``,
    a tensor, takes ``rescale_grad``'s place."""
    rs = rescale_grad_t if rescale_grad_t is not None else rescale_grad
    g32 = _grad(grad, rs, clip_gradient)
    ok = torch.isfinite(g32).all()
    m32 = beta1 * mean + (1 - beta1) * g32
    v32 = beta2 * var + (1 - beta2) * (g32 * g32)
    w32 = weight.float()
    wd_lr = float(np.float32(wd) * np.float32(lr))
    step = lr * m32 / (torch.sqrt(v32) + epsilon) + wd_lr * w32
    w_new = w32 - (step if eta == 1.0 else eta * step)
    w_new = torch.where(ok, w_new, w32)
    return (w_new.to(weight.dtype), torch.where(ok, m32, mean),
            torch.where(ok, v32, var))


# ---------------------------------------------------------------------------
# RMSProp, Ftrl, Signum, AdaGrad, AdaDelta, FTML
# ---------------------------------------------------------------------------

@register("rmsprop_update")
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight.float() - lr * g / _sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return new_w.to(weight.dtype), new_n.to(n.dtype)


@register("rmspropalex_update")
def rmspropalex_update(weight, grad, n, g_acc, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_g = gamma1 * g_acc + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / _sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight.float() + new_delta
    if clip_weights is not None and clip_weights > 0:
        new_w = torch.clamp(new_w, -clip_weights, clip_weights)
    return (new_w.to(weight.dtype), new_n.to(n.dtype),
            new_g.to(g_acc.dtype), new_delta.to(delta.dtype))


@register("ftrl_update")
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (_sqrt(new_n) - _sqrt(n)) / lr
    new_z = z + g - sigma * weight.float()
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(new_z),
        -(new_z - _sign(new_z) * lamda1)
        / ((beta + _sqrt(new_n)) / lr + wd))
    return new_w.to(weight.dtype), new_z.to(z.dtype), new_n.to(n.dtype)


@register("signsgd_update")
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _grad(grad, rescale_grad, clip_gradient)
    new_w = (1 - lr * wd) * weight.float() - lr * _sign(g)
    return new_w.to(weight.dtype)


@register("signum_update")
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _grad(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * (g + wd * weight.float())
    new_w = (1 - lr * wd_lh) * weight.float() + lr * _sign(new_mom)
    return new_w.to(weight.dtype), new_mom.to(mom.dtype)


@register("adagrad_update", aliases=["_sparse_adagrad_update"])
def adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_h = history + torch.square(g)
    new_w = weight.float() - lr * g / (_sqrt(new_h) + epsilon)
    return new_w.to(weight.dtype), new_h.to(history.dtype)


@register("adadelta_update")
def adadelta_update(weight, grad, acc_g, acc_delta, *, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    new_acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = _sqrt(acc_delta + epsilon) / _sqrt(
        new_acc_g + epsilon) * g
    new_acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    new_w = weight.float() - delta
    return (new_w.to(weight.dtype), new_acc_g.to(acc_g.dtype),
            new_acc_delta.to(acc_delta.dtype))


@register("ftml_update")
def ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """FTML (Follow The Moving Leader; states d, v, z)."""
    g = _grad(grad, rescale_grad, clip_grad) + wd * weight.float()
    new_v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (
        _sqrt(new_v / (1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight.float()
    new_w = -new_z / d_t
    return (new_w.to(weight.dtype), d_t.to(d.dtype), new_v.to(v.dtype),
            new_z.to(z.dtype))


# ---------------------------------------------------------------------------
# LAMB
# ---------------------------------------------------------------------------

def lamb_bias_corrections(beta1, beta2, t, recip):
    """``(bc1, bc2)`` for step ``t``: ``1 - beta**t`` (``recip`` False,
    a divisor) or the f32 reciprocal of its f32 rounding (``recip``
    True, a multiplier), as ``multi_tensor.collect_scalars`` forms
    them."""
    bc1, bc2 = 1.0 - beta1 ** t, 1.0 - beta2 ** t
    if recip:
        return (float(np.float32(1.0) / np.float32(bc1)),
                float(np.float32(1.0) / np.float32(bc2)))
    return float(bc1), float(bc2)


def lamb_phase1(weight, grad, mean, var, *, beta1, beta2, epsilon,
                bias_correction, bc1, bc2, bc_recip, wd, rescale_grad,
                clip_gradient):
    """LAMB's first stage with the expressions of
    ``lamb_sweep_reference``: ``(upd, new_mean, new_var)``, all f32."""
    g32 = _grad(grad, rescale_grad, clip_gradient)
    w32 = weight.float()
    m32 = beta1 * mean + (1 - beta1) * g32
    v32 = beta2 * var + (1 - beta2) * (g32 * g32)
    mh, vh = m32, v32
    if bias_correction and bc_recip:
        mh, vh = m32 * float(bc1), v32 * float(bc2)
    elif bias_correction:
        dev = w32.device
        mh = m32 / torch.full((), float(bc1), device=dev)
        vh = v32 / torch.full((), float(bc2), device=dev)
    upd = mh / (torch.sqrt(vh) + epsilon) + wd * w32
    return upd, m32, v32


def lamb_phase2(weight32, upd, r1, r2, *, lr, lower_bound, upper_bound):
    """LAMB's second stage with ``lamb_sweep_reference``'s expressions:
    the new f32 weight ``w - (lr * ratio) * upd``."""
    dev = weight32.device
    r1, r2 = r1.reshape(()).float(), r2.reshape(()).float()
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.maximum(r1, torch.full((), float(lower_bound), device=dev))
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.minimum(r1, torch.full((), float(upper_bound), device=dev))
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2,
                        torch.ones((), device=dev))
    return weight32.float() - (float(lr) * ratio) * upd


def l2_norm(x):
    """``||x||`` in f32 as the plain LAMB sweep takes it:
    ``sqrt(sum(x * x))``."""
    x = x.float()
    return torch.sqrt(torch.sum(x * x))


@register("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, var, *, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    bc1, bc2 = lamb_bias_corrections(beta1, beta2, t, True)
    return lamb_phase1(weight, grad, mean, var, beta1=beta1, beta2=beta2,
                       epsilon=epsilon, bias_correction=bias_correction,
                       bc1=bc1, bc2=bc2, bc_recip=True, wd=wd,
                       rescale_grad=rescale_grad,
                       clip_gradient=clip_gradient)


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_update, r1, r2, *, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    return lamb_phase2(weight, g_update, r1, r2, lr=lr,
                       lower_bound=lower_bound,
                       upper_bound=upper_bound).to(weight.dtype)


@register("mp_lamb_update_phase1")
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, *, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    return lamb_update_phase1(weight32, grad, mean, var, beta1=beta1,
                              beta2=beta2, epsilon=epsilon, t=t,
                              bias_correction=bias_correction, wd=wd,
                              rescale_grad=rescale_grad,
                              clip_gradient=clip_gradient)


@register("mp_lamb_update_phase2")
def mp_lamb_update_phase2(weight, g_update, r1, r2, weight32, *, lr,
                          lower_bound=-1.0, upper_bound=-1.0):
    w32 = lamb_phase2(weight32, g_update, r1, r2, lr=lr,
                      lower_bound=lower_bound, upper_bound=upper_bound)
    return w32.to(weight.dtype), w32


# ---------------------------------------------------------------------------
# multi-tensor updates: one plain sweep over the whole list
# ---------------------------------------------------------------------------

def _per_weight(v, i):
    """lrs/wds arrive as a tuple (an attribute) or a 1-D tensor
    (preloaded)."""
    if isinstance(v, torch.Tensor):
        return float(v.reshape(-1)[i]) if v.dim() else float(v)
    if isinstance(v, (tuple, list)):
        return v[i]
    return v


def _unpack(inputs, per, n):
    """The ``per`` interleaved input lists of ``n`` members (default: as
    many as the inputs hold)."""
    n = n if n is not None else len(inputs) // per
    return [[inputs[per * i + j] for i in range(n)] for j in range(per)]


def _multi_sgd(ws, gs, moms, w32s, lrs, wds, momentum, rescale_grad,
               clip_gradient):
    n = len(ws)
    lr = [_per_weight(lrs, i) for i in range(n)]
    wd = [_per_weight(wds, i) for i in range(n)]
    new_m = _fresh(*moms) if moms is not None else None
    if w32s is not None:
        target, low = _fresh(*w32s), _fresh(*ws)
    else:
        target, low = _fresh(*ws), None
    sgd_sweep_reference(target, gs, new_m, low, lr, wd, momentum=momentum,
                        rescale_grad=rescale_grad,
                        clip_gradient=_clip(clip_gradient))
    if low is None:
        return target, new_m, None
    return low, new_m, target


def _interleave(*cols):
    return tuple(x for row in zip(*cols) for x in row)


@register("multi_sgd_update")
def multi_sgd_update(*inputs, lrs, wds, rescale_grad=1.0, clip_gradient=-1.0,
                     num_weights=None):
    """SGD over a list. Inputs: w0, g0, w1, g1, ...; outputs: the updated
    weights in order."""
    (ws, gs) = _unpack(inputs, 2, num_weights)
    out_w, _, _ = _multi_sgd(ws, gs, None, None, lrs, wds, 0.0,
                             rescale_grad, clip_gradient)
    return tuple(out_w)


@register("multi_sgd_mom_update")
def multi_sgd_mom_update(*inputs, lrs, wds, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=None):
    """Inputs: w0, g0, m0, w1, g1, m1, ...; outputs: w0', m0', w1', ..."""
    (ws, gs, ms) = _unpack(inputs, 3, num_weights)
    out_w, out_m, _ = _multi_sgd(ws, gs, ms, None, lrs, wds, momentum,
                                 rescale_grad, clip_gradient)
    return _interleave(out_w, out_m)


@register("multi_mp_sgd_update")
def multi_mp_sgd_update(*inputs, lrs, wds, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=None):
    """Inputs: w0, g0, w32_0, ...; outputs: w0', w32_0', ..."""
    (ws, gs, w32s) = _unpack(inputs, 3, num_weights)
    out_w, _, out_w32 = _multi_sgd(ws, gs, None, w32s, lrs, wds, 0.0,
                                   rescale_grad, clip_gradient)
    return _interleave(out_w, out_w32)


@register("multi_mp_sgd_mom_update")
def multi_mp_sgd_mom_update(*inputs, lrs, wds, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=None):
    """Inputs: w0, g0, m0, w32_0, ...; outputs: w0', m0', w32_0', ..."""
    (ws, gs, ms, w32s) = _unpack(inputs, 4, num_weights)
    out_w, out_m, out_w32 = _multi_sgd(ws, gs, ms, w32s, lrs, wds, momentum,
                                       rescale_grad, clip_gradient)
    return _interleave(out_w, out_m, out_w32)


def _multi_lamb(ws, gs, ms, vs, w32s, lrs, wds, beta1, beta2, epsilon, t,
                bias_correction, lower_bound, upper_bound, rescale_grad,
                clip_gradient):
    """Both LAMB stages over the list with divided bias corrections (the
    reference's op takes ``t`` as a divisor, ``bc_recip`` False)."""
    bc1, bc2 = lamb_bias_corrections(beta1, beta2, t, False)
    out_w, out_m, out_v, out_w32 = [], [], [], []
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        target = w32s[i] if w32s is not None else w
        upd, m32, v32 = lamb_phase1(
            target, g, m, v, beta1=beta1, beta2=beta2, epsilon=epsilon,
            bias_correction=bias_correction, bc1=bc1, bc2=bc2,
            bc_recip=False, wd=_per_weight(wds, i),
            rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        new = lamb_phase2(target, upd, l2_norm(target), l2_norm(upd),
                          lr=_per_weight(lrs, i), lower_bound=lower_bound,
                          upper_bound=upper_bound)
        out_w.append(new.to(w.dtype))
        out_m.append(m32)
        out_v.append(v32)
        out_w32.append(new)
    return out_w, out_m, out_v, out_w32


@register("multi_lamb_update")
def multi_lamb_update(*inputs, lrs, wds, beta1=0.9, beta2=0.999,
                      epsilon=1e-6, t=1, bias_correction=True,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lower_bound=-1.0, upper_bound=-1.0, num_weights=None):
    """LAMB over a list. Inputs: w0, g0, m0, v0, ...; outputs: w0', m0',
    v0', ..."""
    (ws, gs, ms, vs) = _unpack(inputs, 4, num_weights)
    w, m, v, _ = _multi_lamb(ws, gs, ms, vs, None, lrs, wds, beta1, beta2,
                             epsilon, t, bias_correction, lower_bound,
                             upper_bound, rescale_grad, clip_gradient)
    return _interleave(w, m, v)


@register("multi_mp_lamb_update")
def multi_mp_lamb_update(*inputs, lrs, wds, beta1=0.9, beta2=0.999,
                         epsilon=1e-6, t=1, bias_correction=True,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         lower_bound=-1.0, upper_bound=-1.0,
                         num_weights=None):
    """Multi-precision LAMB over a list. Inputs: w0, g0, m0, v0, w32_0,
    ...; outputs: w0', m0', v0', w32_0', ..."""
    (ws, gs, ms, vs, w32s) = _unpack(inputs, 5, num_weights)
    w, m, v, w32 = _multi_lamb(ws, gs, ms, vs, w32s, lrs, wds, beta1, beta2,
                               epsilon, t, bias_correction, lower_bound,
                               upper_bound, rescale_grad, clip_gradient)
    return _interleave(w, m, v, w32)


@register("preloaded_multi_sgd_update")
def preloaded_multi_sgd_update(*inputs, rescale_grad=1.0, clip_gradient=-1.0,
                               num_weights=None):
    """``multi_sgd_update`` with lrs and wds as two trailing 1-D
    tensors."""
    return multi_sgd_update(*inputs[:-2], lrs=inputs[-2], wds=inputs[-1],
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient,
                            num_weights=num_weights)


@register("preloaded_multi_sgd_mom_update")
def preloaded_multi_sgd_mom_update(*inputs, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=None):
    return multi_sgd_mom_update(*inputs[:-2], lrs=inputs[-2],
                                wds=inputs[-1], momentum=momentum,
                                rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient,
                                num_weights=num_weights)


@register("preloaded_multi_mp_sgd_update")
def preloaded_multi_mp_sgd_update(*inputs, rescale_grad=1.0,
                                  clip_gradient=-1.0, num_weights=None):
    return multi_mp_sgd_update(*inputs[:-2], lrs=inputs[-2], wds=inputs[-1],
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient,
                               num_weights=num_weights)


@register("preloaded_multi_mp_sgd_mom_update")
def preloaded_multi_mp_sgd_mom_update(*inputs, momentum=0.0,
                                      rescale_grad=1.0, clip_gradient=-1.0,
                                      num_weights=None):
    return multi_mp_sgd_mom_update(*inputs[:-2], lrs=inputs[-2],
                                   wds=inputs[-1], momentum=momentum,
                                   rescale_grad=rescale_grad,
                                   clip_gradient=clip_gradient,
                                   num_weights=num_weights)


@register("multi_sum_sq")
def multi_sum_sq(*inputs, num_arrays=None):
    """Each tensor's f32 sum of squares, stacked into one 1-D result."""
    n = num_arrays if num_arrays is not None else len(inputs)
    return torch.stack([torch.sum(torch.square(x.float()))
                        for x in inputs[:n]])
