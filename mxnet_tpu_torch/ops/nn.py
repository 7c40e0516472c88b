"""Neural-network ops of the BERT, Llama and ResNet paths.

Counterpart of the parts of ``mxnet_tpu/ops/nn.py`` the paths run:
``fully_connected`` (``:36``), ``convolution`` (``:86``), ``pooling``
(``:434``), ``batch_norm`` (``:580``), ``embedding`` (``:1030``),
``layer_norm`` (``:707``), ``fused_layer_norm_op`` (``:742``),
``fused_bias_gelu_op`` (``:775``), ``activation`` (``:835``), ``dropout``
(``dropout_op``, ``:1079``, its position-hash branch) and ``flatten``. A
CUDA tensor takes the port's kernels, a CPU tensor their plain versions;
under autograd the fused ops go through the kernels' differentiable
wrappers (their backward kernels on the card). The matrix products and
convolutions go to the library (``torch.nn.functional.linear``, cuDNN
through ``conv2d``), as the JAX package leaves them to XLA outside any
kernel; pooling and BatchNorm are plain PyTorch here as they are plain
XLA there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd, random_state
from ..base import MXNetError
from ..kernels import fused_bias_gelu, fused_layer_norm, hash_dropout

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "flatten", "embedding", "layer_norm", "fused_layer_norm_op",
           "fused_bias_gelu_op", "activation", "dropout"]


def fully_connected(data, weight, bias=None, *, flatten=True):
    """``data @ weight.T + bias`` with MXNet's (out, in) weight;
    ``flatten`` folds every axis after the first into the input axis."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight.to(data.dtype),
                    None if bias is None else bias.to(data.dtype))


_LAYOUTS = {None: False, "NCHW": False, "NHWC": True}


def _channels_last(op, layout) -> bool:
    if layout not in _LAYOUTS:
        raise MXNetError(f"{op}: layout {layout!r} is not ported yet, only "
                         "NCHW and NHWC (ROADMAP.md, port queue 1, item 4)")
    return _LAYOUTS[layout]


def _spatial_2d(op, data):
    if data.dim() != 4:
        raise MXNetError(f"{op}: {data.dim() - 2} spatial axes are not "
                         "ported yet, only 2 (ROADMAP.md, port queue 1, "
                         "item 4)")


def _pair(v):
    if isinstance(v, int):
        return (v, v)
    v = tuple(v)
    return v * 2 if len(v) == 1 else v


def convolution(data, weight, bias=None, *, kernel=(), stride=(), pad=(),
                num_filter=1, no_bias=False, layout=None):
    """2-D ``Convolution``, ungrouped and undilated. ``layout``: ``NCHW``
    (or None) or ``NHWC``; the weight is ``(num_filter, C, kh, kw)`` in
    both, so a checkpoint does not depend on the layout (the reference's
    ``_conv_dnums``, ``:55-67``). The weight is cast to data's dtype, the
    bias added after the product in the output's dtype. 1-D and 3-D
    convolutions, groups, dilation and the other layouts are not ported
    yet (ROADMAP.md, port queue 1, item 4).

    A channels-last input goes to ``conv2d`` (cuDNN on the card) as the
    NCHW view of its memory, torch's ``channels_last`` format, and the
    output comes back as the NHWC view of cuDNN's channels-last result:
    no copy either way. The reference's own reformulations of some convs
    (``_conv_s2d``, ``_conv1x1_dot`` at ``:185``, the dW path behind
    ``MXNET_TPU_CONV_DW``) rework the TPU's matrix unit and XLA's
    conv-backward choice; cuDNN picks its own algorithms, so they are not
    ported."""
    last = _channels_last("convolution", layout)
    _spatial_2d("convolution", data)
    x = data.movedim(-1, 1) if last else data
    if x.device.type == "cpu":
        # torch's CPU (oneDNN) backward of a strided 1x1 convolution on a
        # channels-last input crashes now and then (torch 2.13); the
        # plain CPU path runs on a row-major copy
        x = x.contiguous()
    out = F.conv2d(x, weight.to(data.dtype), None, _pair(stride or 1),
                   _pair(pad or 0))
    if last:
        out = out.movedim(1, -1)
    if not no_bias and bias is not None:
        shape = [1] * out.dim()
        shape[-1 if last else 1] = bias.shape[0]
        out = out + bias.to(out.dtype).reshape(shape)
    return out


def pooling(data, *, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid", layout=None):
    """2-D ``Pooling``, max or avg (layouts as :func:`convolution`).
    ``global_pool`` reduces both spatial axes, keeping them as size 1.
    Otherwise MXNet's ``"valid"`` convention (output ``floor((in + 2 pad
    - kernel) / stride) + 1``); max pads with -inf, avg divides by the
    whole window, padding included (MXNet's default
    ``count_include_pad``). The other conventions and pool types
    (``full``, ``same``, ``sum``, ``lp``), ``count_include_pad=False``
    and 1-D or 3-D pooling come with the op registry (ROADMAP.md, port
    queue 1, item 4)."""
    if pool_type not in ("max", "avg"):
        raise MXNetError(f"pooling: pool_type {pool_type!r} is not ported "
                         "yet (ROADMAP.md, port queue 1, item 4)")
    last = _channels_last("pooling", layout)
    _spatial_2d("pooling", data)
    if global_pool:
        axes = (1, 2) if last else (2, 3)
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    if pooling_convention != "valid":
        raise MXNetError(f"pooling: pooling_convention "
                         f"{pooling_convention!r} is not ported yet "
                         "(ROADMAP.md, port queue 1, item 4)")
    args = (_pair(kernel), _pair(stride or 1), _pair(pad or 0))
    x = data.movedim(-1, 1) if last else data
    pool = F.max_pool2d if pool_type == "max" else F.avg_pool2d
    out = pool(x, *args)
    return out.movedim(1, -1) if last else out


def flatten(data):
    """``Flatten``: every axis after the first folded into one."""
    return data.reshape(data.shape[0], -1)


def _bn_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def _bn_stats(x, axis, eps):
    """Per-channel f32 (mean, var, rsqrt(var + eps)), as the reference's
    ``_bn_stats`` (``:612-631``): the centred two-pass variance for f32
    input, the one-pass ``max(E[x^2] - E[x]^2, 0)`` for half-precision
    input."""
    red = tuple(i for i in range(x.dim()) if i != axis)
    x32 = x.float()
    mean = x32.mean(dim=red)
    if x.dtype in (torch.float32, torch.float64):
        var = (x32 - mean.reshape(_bn_shape(x, axis))).square().mean(dim=red)
    else:
        var = torch.clamp_min((x32 * x32).mean(dim=red) - mean * mean, 0.0)
    return x32, mean, var, torch.rsqrt(var + eps)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm with the reference's hand-derived
    backward (``_bn_train``, ``:634-688``): the forward folds the batch
    statistics into a per-channel f32 scale and bias and rounds the
    output once; the backward needs only ``sum(dy)`` and
    ``sum(dy * xhat)`` (dbeta and dgamma), with xhat recomputed from the
    saved mean and rsqrt. ``mean`` and ``var`` are outputs for the
    running statistics and carry no gradient."""

    @staticmethod
    def forward(ctx, x, g, b, axis, eps):
        x32, mean, var, inv = _bn_stats(x, axis, eps)
        shape = _bn_shape(x, axis)
        scale = g.float() * inv
        bias = b.float() - mean * scale
        out = (x32 * scale.reshape(shape) + bias.reshape(shape)).to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.axis = axis
        ctx.b_dtype = b.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g, mean, inv = ctx.saved_tensors
        axis = ctx.axis
        red = tuple(i for i in range(x.dim()) if i != axis)
        shape = _bn_shape(x, axis)
        n = x.numel() // x.shape[axis]
        dy32 = dy.float()
        xhat = (x.float() - mean.reshape(shape)) * inv.reshape(shape)
        dbeta = dy32.sum(dim=red)
        dgamma = (dy32 * xhat).sum(dim=red)
        dx = ((g.float() * inv / n).reshape(shape)
              * (n * dy32 - dbeta.reshape(shape)
                 - xhat * dgamma.reshape(shape))).to(x.dtype)
        return dx, dgamma.to(g.dtype), dbeta.to(ctx.b_dtype), None, None


def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, training=None):
    """``BatchNorm`` over the channel ``axis`` (1, or -1 for channels
    last). In training (``training``, default ``autograd.is_training()``)
    without ``use_global_stats`` it normalises by the batch statistics
    and returns ``(out, batch_mean, batch_var)`` (f32, the biased
    variance) for the caller to fold into the moving statistics, as the
    reference does (``:580-610``); otherwise it normalises by
    ``moving_mean`` / ``moving_var`` and returns ``out`` (with
    ``output_mean_var``, also the moving statistics). Either way the
    statistics are f32 and the output ``x * scale + bias`` is computed in
    f32 and rounded once to data's dtype. ``fix_gamma`` uses a gamma of
    ones (gamma gets no gradient). The moving-average update, and its
    momentum, belong to the caller. This is plain PyTorch on both devices;
    ``F.batch_norm`` would fold torch's unbiased variance, with its
    opposite momentum convention, into the running statistics."""
    axis = axis % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training is None:
        training = autograd.is_training()
    if training and not use_global_stats:
        return _BatchNormTrain.apply(data, g, beta, axis, float(eps))
    shape = _bn_shape(data, axis)
    mean, var = moving_mean.float(), moving_var.float()
    scale = g.float() * torch.rsqrt(var + eps)
    bias = beta.float() - mean * scale
    out = (data.float() * scale.reshape(shape)
           + bias.reshape(shape)).to(data.dtype)
    if output_mean_var:
        return out, mean, var
    return out


def embedding(data, weight):
    """Rows of ``weight`` at the indices ``data``, which may arrive as
    floats (the serving batcher casts every sample to its dtype) and are
    truncated to int64, as the JAX op truncates them to int32."""
    return F.embedding(data.to(torch.int64), weight)


def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5):
    """LayerNorm over the last axis through the fused kernel (no
    residual); output in data's dtype."""
    if axis not in (-1, data.dim() - 1):
        raise MXNetError(f"layer_norm: axis {axis} is not the last axis; "
                         "the port normalises the last axis only")
    return fused_layer_norm(data, gamma, beta, eps=eps)


def fused_layer_norm_op(data, gamma, beta, residual=None, *, eps=1e-5,
                        dropout=0.0):
    """``LayerNorm(dropout(data) + residual)`` over the last axis: the
    post-LN transformer cell's add+norm in one kernel. ``dropout`` drops
    ``data`` (not the residual) in training mode only
    (``autograd.is_training()``), under a seed drawn from
    ``random_state`` only then (the reference's ``rng_gate``)."""
    p = float(dropout) if autograd.is_training() else 0.0
    seed = random_state.next_seed(data.device) if p > 0.0 else None
    return fused_layer_norm(data, gamma, beta, residual, eps=eps,
                            dropout=p, seed=seed)


def dropout(data, p=0.5, mode="training", axes=()):
    """``Dropout``: in training mode (``autograd.is_training()``), or
    always with ``mode="always"``, each element of the mask shape
    (data's shape with ``axes`` set to 1) is kept with probability
    ``1 - p`` by the position hash under a seed drawn from
    ``random_state`` (only when it applies), and kept elements are scaled
    by ``dtype(1 / (1 - p))``; otherwise, or at ``p = 0``, the identity.
    The reference's ``dropout_op`` draws ``jax.random.bits`` unless
    ``MXNET_TPU_HASH_DROPOUT=1`` or ``MXNET_PALLAS_FUSED=1``; the port
    always takes that hash branch (``ops/nn.py:1093-1121``)."""
    if mode not in ("training", "always"):
        raise MXNetError(f"dropout: mode {mode!r} is not 'training' or "
                         "'always'")
    if not (autograd.is_training() or mode == "always") or p == 0.0:
        return data
    return hash_dropout(data.contiguous(), p,
                        random_state.next_seed(data.device), axes)


def fused_bias_gelu_op(data, bias):
    """``gelu(data + bias)``, exact erf, the Dense epilogue."""
    return fused_bias_gelu(data, bias)


# the activations the ported blocks use: PositionwiseFFN's default
# (relu), BERT's FFN and MLM transform (gelu), BERT's pooler (tanh)
_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="none"),
}


def activation(data, *, act_type="relu"):
    """``Activation(act_type=...)`` (``mxnet_tpu/ops/nn.py:835``) for the
    act_types the ported blocks use; the rest come with the op registry
    (ROADMAP.md, port queue 1)."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"activation: act_type {act_type!r} is not ported "
                         f"yet (ported: {sorted(_ACTIVATIONS)})")
    return fn(data)
