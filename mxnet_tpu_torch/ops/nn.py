"""Neural-network ops of the BERT, Llama, ResNet and vision-zoo paths.

Counterpart of the parts of ``mxnet_tpu/ops/nn.py`` the paths run:
``fully_connected`` (``:36``), ``convolution`` (``:86``),
``deconvolution`` (``:359``), ``pooling`` (``:434``), ``batch_norm``
(``:580``), ``embedding`` (``:1030``), ``layer_norm`` (``:707``),
``fused_layer_norm_op`` (``:742``), ``fused_bias_gelu_op`` (``:775``),
``activation`` (``:835``), ``dropout``
(``dropout_op``, ``:1079``, its position-hash branch), ``softmax``
(``:876``), ``log_softmax`` (``:893``) and ``flatten``; the ones NDArray
reaches are registered under the reference's op names and attribute
specs at the end of this module (``mx.nd.FullyConnected``...). A
CUDA tensor takes the port's kernels, a CPU tensor their plain versions;
under autograd the fused ops go through the kernels' differentiable
wrappers (their backward kernels on the card). The matrix products and
convolutions go to the library (``torch.nn.functional.linear``, cuDNN
through ``conv{1,2,3}d`` and ``conv_transpose{1,2,3}d``), as the JAX
package leaves them to XLA outside any kernel; pooling and BatchNorm are
plain PyTorch here as they are plain XLA there.
"""
from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from .. import autograd, random_state
from ..base import MXNetError, torch_dtype
from ..kernels import fused_bias_gelu, fused_layer_norm, hash_dropout
from .elemwise import _abs, max_zero_sign, relu, signed_zeros, true_div
from .registry import attr, register
from .tensor import amax

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "batch_norm", "flatten", "embedding", "layer_norm",
           "fused_layer_norm_op", "fused_bias_gelu_op", "activation",
           "dropout", "softmax", "log_softmax", "instance_norm",
           "group_norm", "leaky_relu", "grid_generator", "crop", "im2col",
           "col2im", "roi_pooling"]


def fully_connected(data, weight, bias=None, *, flatten=True):
    """``data @ weight.T + bias`` with MXNet's (out, in) weight;
    ``flatten`` folds every axis after the first into the input axis."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight.to(data.dtype),
                    None if bias is None else bias.to(data.dtype))


_LAYOUTS = {None: None, "NCW": False, "NCHW": False, "NCDHW": False,
            "NWC": True, "NHWC": True, "NDHWC": True}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _channels_last(op, layout, nd) -> bool:
    """Whether ``layout`` puts the channels last, for an input of ``nd``
    spatial axes: one of the reference's six layouts (``NCW``, ``NCHW``,
    ``NCDHW``, ``NWC``, ``NHWC``, ``NDHWC``) with ``nd`` spatial letters,
    or None (channels first)."""
    if layout not in _LAYOUTS:
        raise MXNetError(f"{op}: layout {layout!r} is not one of "
                         f"{[k for k in _LAYOUTS if k]}")
    if nd not in _CONV:
        raise MXNetError(f"{op}: {nd} spatial axes; 1, 2 or 3 are "
                         "supported")
    if layout is not None and len(layout) - 2 != nd:
        raise MXNetError(f"{op}: layout {layout} does not have {nd} "
                         "spatial axes")
    return bool(_LAYOUTS[layout])


def _tuplize(v, n):
    """The reference's ``_tuplize``: an int or a 1-tuple repeated ``n``
    times, a longer tuple as it is."""
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


def _to_first(data, last):
    """The channels-first view of ``data``'s memory: for a channels-last
    input, torch's ``channels_last`` (``channels_last_3d``) format, so
    cuDNN reads it in place. The plain CPU path runs on a row-major copy:
    torch's CPU (oneDNN) backward of a strided 1x1 convolution on a
    channels-last input crashes now and then (torch 2.13)."""
    x = data.movedim(-1, 1) if last else data
    return x.contiguous() if x.device.type == "cpu" else x


def _add_bias(out, bias, last):
    shape = [1] * out.dim()
    shape[-1 if last else 1] = bias.shape[0]
    return out + bias.to(out.dtype).reshape(shape)


def convolution(data, weight, bias=None, *, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=1, num_group=1, no_bias=False,
                layout=None):
    """``Convolution`` over ``len(kernel)`` (1, 2 or 3) spatial axes, with
    ``num_group`` groups and ``dilate``, in any of the reference's six
    layouts; the weight is ``(num_filter, C / num_group, *kernel)`` in
    every layout, so a checkpoint does not depend on the layout (the
    reference's ``_conv_dnums``, ``:55-67``). The weight is cast to
    data's dtype, the bias added after the product in the output's
    dtype.

    A channels-last input goes to ``conv{1,2,3}d`` (cuDNN on the card) as
    the channels-first view of its memory, torch's ``channels_last`` /
    ``channels_last_3d`` format, and the output comes back as the
    channels-last view of cuDNN's result: no copy either way. The
    reference's own reformulations of some convs (``_conv_s2d``,
    ``_conv1x1_dot`` at ``:185``, the dW path behind
    ``MXNET_TPU_CONV_DW``) rework the TPU's matrix unit and XLA's
    conv-backward choice; cuDNN picks its own algorithms, so they are not
    ported."""
    nd = len(kernel) if kernel else data.dim() - 2
    last = _channels_last("convolution", layout, nd)
    if data.dim() != nd + 2:
        raise MXNetError(f"convolution: a {len(kernel)}-D kernel over a "
                         f"{data.dim()}-D input")
    out = _CONV[nd](_to_first(data, last), weight.to(data.dtype), None,
                    _tuplize(stride or 1, nd), _tuplize(pad or 0, nd),
                    _tuplize(dilate or 1, nd), num_group)
    if last:
        out = out.movedim(1, -1)
    if not no_bias and bias is not None:
        out = _add_bias(out, bias, last)
    return out


def deconvolution(data, weight, bias=None, *, kernel=(), stride=(),
                  dilate=(), pad=(), adj=(), num_filter=1, num_group=1,
                  no_bias=True, target_shape=(), layout=None):
    """``Deconvolution``, the transposed convolution, with the weight
    ``(C, num_filter / num_group, *kernel)``; the output's spatial size
    is ``(in - 1) stride - 2 pad + dilate (k - 1) + 1 + adj``.

    It computes the reference's orientation (``mxnet_tpu/ops/nn.py:359-
    418``: ``lax.conv_transpose(transpose_kernel=False)``, and for groups
    the lhs-dilated convolution with the weight unflipped), which is
    torch's ``conv_transpose`` with the weight flipped on every spatial
    axis. Upstream MXNet's Deconvolution is torch's unflipped one, so a
    kernel that is not symmetric gives other numbers there; the port keeps
    the reference's, as ``.params`` files cross between the packages.
    ``target_shape``, which the reference accepts and ignores, raises."""
    if target_shape:
        raise MXNetError("Deconvolution: target_shape is not supported "
                         "(the reference ignores it); give pad and adj")
    nd = len(kernel) if kernel else data.dim() - 2
    last = _channels_last("deconvolution", layout, nd)
    w = weight.to(data.dtype).flip(tuple(range(2, 2 + nd)))
    out = _CONV_T[nd](_to_first(data, last), w, None,
                      _tuplize(stride or 1, nd), _tuplize(pad or 0, nd),
                      _tuplize(adj or 0, nd), num_group,
                      _tuplize(dilate or 1, nd))
    if last:
        out = out.movedim(1, -1)
    if not no_bias and bias is not None:
        out = _add_bias(out, bias, last)
    return out


def _pool_pads(shape, kernel, stride, pad, convention):
    """Each spatial axis's (low, high) padding under the reference's
    ``pads_for`` (``:471-495``): ``valid`` pads ``pad`` on both sides,
    ``full`` adds ``stride - rem`` on the high side (a ceil in place of
    the floor), ``same`` pads TF's way (``ceil(in / stride)`` outputs,
    the odd cell at the end)."""
    pads = []
    for size, k, s, p in zip(shape, kernel, stride, pad):
        if convention == "same":
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads.append((total // 2, total - total // 2))
            continue
        hi = p
        if convention == "full":
            rem = (size + 2 * p - k) % s
            if rem:
                hi += s - rem
        pads.append((p, hi))
    return pads


def _window_sum(x, kernel, stride, divisor=1):
    """The sum of every window of the (already padded) channels-first
    ``x`` over ``divisor``: torch's average pool with that divisor (1-D
    through the 2-D pool). An integer ``x`` (which torch's pools refuse)
    is summed exactly in its own dtype, wrapping as it does, over
    ``unfold``'s windows (``divisor`` 1)."""
    if not x.dtype.is_floating_point:
        for i, (k, s) in enumerate(zip(kernel, stride)):
            x = x.unfold(2 + i, k, s)
        return x.sum(dim=tuple(range(-len(kernel), 0)), dtype=x.dtype)
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=divisor).squeeze(-2)
    return _AVG_POOL[len(kernel)](x, kernel, stride,
                                  divisor_override=divisor)


def _flat_pads(pads):
    """(low, high) per axis, first axis first, as ``F.pad`` takes them
    (last axis first)."""
    return [v for lo_hi in reversed(pads) for v in lo_hi]


def _lp(x, p):
    """``|x| ** p`` through the registered ``abs``, whose gradient at +-0
    is 1 as ``jnp.abs``'s (torch's is 0)."""
    return _abs(x) if p == 1 else torch.pow(_abs(x), p)


def _avg_dtype(x):
    """An integer average's dtype, the reference's: float64 for int64,
    float32 else."""
    if x.dtype.is_floating_point:
        return x.dtype
    return torch.float64 if x.dtype == torch.int64 else torch.float32


class _MaxPoolSelect(torch.autograd.Function):
    """The identity on a max pool's channels-first output ``out`` of
    ``x``, whose backward sends each window's gradient where the
    reference's (XLA's select-and-scatter) sends it. The selection starts
    at the window's first element (a padded one is -inf and has no input
    to take the gradient) and moves to each next element c, in window
    order, when ``not (sel >= c)``. That is torch's first max wherever
    the max is neither NaN nor -inf, so only those windows are
    re-selected here, and torch's own backward gets their gradient
    zeroed; finite inputs keep torch's route. Whether any such window
    exists is found in the forward and, on the card, copied to the host
    behind the pool, so the backward waits for its forward's pool, not
    for the backward queued before it."""

    @staticmethod
    def forward(ctx, out, x, kernel, stride, lows):
        ctx.save_for_backward(out, x)
        ctx.cfg = (kernel, stride, lows)
        any_bad = (torch.isnan(out) | (out == float("-inf"))).any()
        ctx.ready = None
        if out.is_cuda:
            ctx.any_bad = torch.empty((), dtype=torch.bool, pin_memory=True)
            ctx.any_bad.copy_(any_bad, non_blocking=True)
            ctx.ready = torch.cuda.Event()
            ctx.ready.record()
        else:
            ctx.any_bad = any_bad
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        if ctx.ready is not None:
            ctx.ready.synchronize()
        if not bool(ctx.any_bad):
            return g, None, None, None, None
        out, x = ctx.saved_tensors
        bad = torch.isnan(out) | (out == float("-inf"))
        kernel, stride, lows = ctx.cfg
        n, c, *outs = bad.nonzero(as_tuple=True)
        sizes = x.shape[2:]
        sel = None
        for offs in itertools.product(*(range(k) for k in kernel)):
            at = [o * s - lo + d
                  for o, s, lo, d in zip(outs, stride, lows, offs)]
            real = torch.ones_like(n, dtype=torch.bool)
            for a, size in zip(at, sizes):
                real &= (a >= 0) & (a < size)
            at = [a.clamp(0, size - 1) for a, size in zip(at, sizes)]
            v = torch.where(real, x[(n, c, *at)], float("-inf"))
            if sel is None:
                sel, sel_at, sel_real = v, at, real
                continue
            move = ~(sel >= v)
            sel = torch.where(move, v, sel)
            sel_at = [torch.where(move, a, b) for a, b in zip(at, sel_at)]
            sel_real = torch.where(move, real, sel_real)
        gx = torch.zeros_like(x)
        gx.index_put_((n, c, *sel_at),
                      torch.where(sel_real, g[bad], 0.0).to(x.dtype),
                      accumulate=True)
        return g.masked_fill(bad, 0.0), gx, None, None, None


def pooling(data, *, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, p_value=2, layout=None):
    """``Pooling`` over 1, 2 or 3 spatial axes in any of the six layouts,
    as the reference computes it (``mxnet_tpu/ops/nn.py:434-519``):

    * ``pool_type`` ``max`` (padding at -inf), ``avg``, ``sum`` or ``lp``
      (``sum(|x|^p) ^ (1/p)`` over the window, zeros in the padding: not
      ``F.lp_pool``, which takes no absolute value);
    * ``pooling_convention`` ``valid`` (floor), ``full`` (ceil: extra
      padding on the high side) or ``same`` (TF's; ``pad`` must be 0);
    * ``avg`` divides by the kernel's size, padding included, whatever
      the convention (with ``full``, the extra high padding too, where
      torch's ``ceil_mode`` leaves it out of the divisor), or with
      ``count_include_pad=False`` by the count of input elements in the
      window;
    * ``global_pool`` reduces every spatial axis, keeping it as size 1;
    * integers: ``avg`` gives float32 (float64 from int64), ``sum`` the
      input's dtype; a max's zero sign and its gradient where a window's
      max is NaN or -inf are the reference's (:func:`_max_pool`).

    Symmetric padding of at most half the kernel (the ResNets' and the
    zoo's pools) goes to torch's pools directly; any other is applied
    explicitly first (-inf for max, zeros else) and the windows reduced
    unpadded. So is an average's padding on a channels-last CUDA input:
    torch's CUDA average-pool backward (torch 2.11) gives wrong
    gradients there, 0.33-1.25 against the CPU's on unit inputs, while
    its forward and its unpadded pool are right
    (tests/test_torch_cuda_vision.py ``avg_s1p1``)."""
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"pooling: pool_type {pool_type!r} is not max, "
                         "avg, sum or lp")
    if pooling_convention not in ("valid", "full", "same"):
        raise MXNetError(f"pooling: pooling_convention "
                         f"{pooling_convention!r} is not valid, full or "
                         "same")
    nd = data.dim() - 2
    last = _channels_last("pooling", layout, nd)
    if global_pool:
        axes = tuple(range(1, 1 + nd)) if last else tuple(range(2, 2 + nd))
        if pool_type == "max":
            return amax(data, axes, True)
        if pool_type == "avg":
            return data.to(_avg_dtype(data)).mean(dim=axes, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=axes, keepdim=True)
        return torch.pow(_lp(data, p_value).sum(dim=axes, keepdim=True),
                         1.0 / p_value)
    kernel = _tuplize(kernel, nd)
    stride = _tuplize(stride or 1, nd)
    pad = _tuplize(pad or 0, nd)
    if pooling_convention == "same" and any(p != 0 for p in pad):
        raise MXNetError("pooling: pooling_convention='same' requires "
                         "pad=0 (the reference's pooling.cc check)")
    x = data.movedim(-1, 1) if last else data
    pads = _pool_pads(x.shape[2:], kernel, stride, pad, pooling_convention)
    direct = all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads,
                                                                 kernel))
    padded_nhwc_cuda = last and x.is_cuda and any(lo for lo, _ in pads)
    floats = x.dtype.is_floating_point
    if pool_type == "max":
        out = _max_pool(x, kernel, stride, pads, direct)
    elif pool_type == "avg" and count_include_pad and direct and floats \
            and not padded_nhwc_cuda:
        out = _AVG_POOL[nd](x, kernel, stride, [lo for lo, _ in pads],
                            count_include_pad=True)
    elif pool_type == "avg" and count_include_pad and floats:
        out = _window_sum(F.pad(x, _flat_pads(pads)), kernel, stride,
                          math.prod(kernel))
    else:
        src = _lp(x, p_value) if pool_type == "lp" else x
        if any(lo or hi for lo, hi in pads):
            src = F.pad(src, _flat_pads(pads))
        out = _window_sum(src, kernel, stride)
        if pool_type == "lp":
            out = torch.pow(out, 1.0 / p_value)
        elif pool_type == "avg":
            out = out.to(_avg_dtype(x))
            if count_include_pad:
                out = out / math.prod(kernel)
            else:
                ones = F.pad(x.new_ones((1, 1) + tuple(x.shape[2:]),
                                        dtype=out.dtype), _flat_pads(pads))
                out = out / _window_sum(ones, kernel, stride)
    return out.movedim(1, -1) if last else out


def _max_pool(x, kernel, stride, pads, direct):
    """Max pooling of channels-first ``x`` at the reference's: padding
    at -inf, a zero max +0 where a +0 is in the window (torch keeps the
    window's first zero), and the gradient of a window whose max is NaN
    or -inf where the reference sends it (:class:`_MaxPoolSelect`)."""
    pool = _MAX_POOL[len(kernel)]
    lows = [lo for lo, _ in pads]

    def run(t):
        if direct:
            return pool(t, kernel, stride, lows)
        return pool(F.pad(t, _flat_pads(pads), value=float("-inf")),
                    kernel, stride)

    out = run(x)
    if not x.dtype.is_floating_point:
        return out
    if x.requires_grad and torch.is_grad_enabled():
        out = _MaxPoolSelect.apply(out, x, kernel, stride, lows)
    # which windows hold a +0: the max pool of a float16 +0 indicator,
    # made in one pass
    return max_zero_sign(out, run(signed_zeros(x, False, torch.float16)) > 0)


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


def _take_fill(weight):
    """``jnp.take``'s fill value for an index out of range: NaN for a
    float table, the lowest value of a signed and the highest of an
    unsigned integer one."""
    if weight.dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(weight.dtype)
    return info.min if info.min < 0 else info.max


def embedding(data, weight):
    """Rows of ``weight`` at the indices ``data``, which may arrive as
    floats (the serving batcher casts every sample to its dtype) and are
    truncated to int64, as the JAX op truncates them to int32. As
    ``jnp.take`` (``mxnet_tpu/ops/nn.py:1042``): an index in [-n, 0)
    counts from the end and one outside [-n, n) gives a row of
    ``_take_fill`` with no gradient. The gather runs on clamped indices
    and the bad rows are masked after it, with no host sync and no
    data-dependent branch (the decode step runs inside CUDA graphs), so
    a bad id never reaches ``F.embedding``'s device-side assert."""
    idx = data.to(torch.int64)
    n = weight.shape[0]
    valid = (idx >= -n) & (idx < n)
    safe = torch.where(idx < 0, idx + n, idx).clamp_(0, max(n - 1, 0))
    rows = F.embedding(safe, weight)
    return rows.masked_fill(~valid.unsqueeze(-1), _take_fill(weight))


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


def _erf_gelu(x):
    """``jax.nn.gelu(approximate=False)``'s ``x * (erf(x / sqrt2) + 1) /
    2``, in f32 for a half input and rounded once: +inf at +inf (torch's
    vectorised CPU ``F.gelu`` gives NaN there) and NaN at -inf, with the
    gradient the formula's (NaN at +-inf, as the reference's)."""
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    y = xf * (torch.erf(xf / 1.4142135623730951) + 1.0) / 2.0
    return y.to(x.dtype)


class _SigmoidGated(torch.autograd.Function):
    """silu or mish (``fn``, with ATen's backward ``fn_backward``), whose
    gradient is +0.0 at finite x <= -88: there the reference's f32
    sigmoid flushes to zero, so its silu's and mish's gradients are +0.0
    (torch gives -0.0 or a subnormal). The incoming gradient is zeroed
    where x <= -88 (``threshold_backward``), ATen's backward then gives
    -0.0 there (NaN at x = -inf, as the reference's) and adding +0.0
    makes it +0.0: two passes beside the backward's own, each over
    tensors of one dtype."""

    @staticmethod
    def forward(ctx, x, fn, fn_backward):
        ctx.save_for_backward(x)
        ctx.fn, ctx.fn_backward = fn, fn_backward
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g = torch.ops.aten.threshold_backward(g, x, -88.0)
        if torch.is_grad_enabled():     # create_graph: a gradient on the tape
            (gx,) = torch.autograd.grad(ctx.fn(x), x, g, create_graph=True)
            return gx + 0.0, None, None
        return ctx.fn_backward(g, x).add_(0.0), None, None


def _silu(x):
    return _SigmoidGated.apply(x, F.silu, torch.ops.aten.silu_backward)


def _mish(x):
    return _SigmoidGated.apply(x, F.mish, torch.ops.aten.mish_backward)


_ACTIVATIONS = {
    "relu": relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "silu": _silu,
    "swish": _silu,
    "gelu": _erf_gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "mish": _mish,
}


def activation(data, *, act_type="relu"):
    """``Activation(act_type=...)`` (``mxnet_tpu/ops/nn.py:835``)."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"activation: act_type {act_type!r} is not one of "
                         f"{sorted(_ACTIVATIONS)}")
    return fn(data)


def softmax(data, length=None, *, axis=-1, temperature=None, dtype=None,
            use_length=False):
    """``softmax`` (``mxnet_tpu/ops/nn.py:876``): over ``axis``, of
    ``data / temperature``; with ``use_length``, the positions of each
    row at or past ``length`` (one per index of the first axis) get 0."""
    x = data if temperature in (None, 1.0) else data / temperature
    if use_length and length is not None:
        pos = torch.arange(x.shape[axis], device=x.device)
        shape = [1] * x.dim()
        shape[axis] = x.shape[axis]
        lens = length.reshape([x.shape[0]] + [1] * (x.dim() - 1))
        x = x.masked_fill(~(pos.reshape(shape) < lens), float("-inf"))
    out = torch.softmax(x, dim=axis)
    if use_length and length is not None:
        out = torch.nan_to_num(out, nan=0.0)
    return out.to(torch_dtype(dtype)) if dtype else out


def log_softmax(data, *, axis=-1, temperature=None, dtype=None,
                use_length=False):
    """``log_softmax`` (``mxnet_tpu/ops/nn.py:893``)."""
    x = data if temperature in (None, 1.0) else data / temperature
    out = torch.log_softmax(x, dim=axis)
    return out.to(torch_dtype(dtype)) if dtype else out


# ---------------------------------------------------------------------------
# the ops above under the reference's registered names and attribute specs
# (mx.nd.FullyConnected, mx.nd.Activation, ...)
# ---------------------------------------------------------------------------

_LAYOUT_CHOICES = ("NCW", "NCHW", "NCDHW", "NWC", "NHWC", "NDHWC")


@register("FullyConnected", aliases=["fully_connected"], attrs=[
    attr("num_hidden", int, "Number of output hidden units.", low=0),
    attr("no_bias", bool, "Whether to disable the bias term."),
    attr("flatten", bool,
         "Flatten trailing input dims into one (MXNet default) or apply "
         "the projection to the last axis only."),
])
def _fully_connected_op(data, weight, bias=None, *, num_hidden=0,
                        no_bias=False, flatten=True):
    return fully_connected(data, weight, None if no_bias else bias,
                           flatten=flatten)


@register("Convolution", aliases=["convolution"], attrs=[
    attr("kernel", tuple, "Spatial kernel size, e.g. (3, 3)."),
    attr("stride", tuple, "Strides per spatial dim (default 1).", low=1),
    attr("dilate", tuple, "Dilation per spatial dim (default 1).", low=1),
    attr("pad", tuple, "Zero padding per spatial dim.", low=0),
    attr("num_filter", int, "Number of output channels.", low=1),
    attr("num_group", int, "Grouped-convolution group count.", low=1),
    attr("no_bias", bool, "Whether to disable the bias term."),
    attr("layout", str, "Input/output layout.", choices=_LAYOUT_CHOICES),
])
def _convolution_op(data, weight, bias=None, *, kernel=(), stride=(),
                    dilate=(), pad=(), num_filter=1, num_group=1,
                    no_bias=False, layout=None, workspace=1024,
                    cudnn_tune=None, cudnn_off=False):
    return convolution(data, weight, bias, kernel=kernel, stride=stride,
                       dilate=dilate, pad=pad, num_filter=num_filter,
                       num_group=num_group, no_bias=no_bias, layout=layout)


@register("Deconvolution", aliases=["deconvolution"], attrs=[
    attr("kernel", tuple, "Spatial kernel size, e.g. (3, 3)."),
    attr("stride", tuple, "Strides per spatial dim (default 1).", low=1),
    attr("dilate", tuple, "Dilation per spatial dim (default 1).", low=1),
    attr("pad", tuple, "Padding removed from each side of the output.",
         low=0),
    attr("adj", tuple, "Extra output cells on the high side.", low=0),
    attr("num_filter", int, "Number of output channels.", low=1),
    attr("num_group", int, "Grouped-convolution group count.", low=1),
    attr("no_bias", bool, "Whether to disable the bias term."),
    attr("layout", str, "Input/output layout.", choices=_LAYOUT_CHOICES),
])
def _deconvolution_op(data, weight, bias=None, *, kernel=(), stride=(),
                      dilate=(), pad=(), adj=(), num_filter=1, num_group=1,
                      no_bias=True, target_shape=(), layout=None,
                      workspace=1024, cudnn_tune=None, cudnn_off=False):
    return deconvolution(data, weight, bias, kernel=kernel, stride=stride,
                         dilate=dilate, pad=pad, adj=adj,
                         num_filter=num_filter, num_group=num_group,
                         no_bias=no_bias, target_shape=target_shape,
                         layout=layout)


@register("Pooling", aliases=["pooling"], attrs=[
    attr("kernel", tuple, "Pooling window size."),
    attr("pool_type", str, "Pooling reduction.",
         choices=("max", "avg", "sum", "lp")),
    attr("stride", tuple, "Window strides (default 1).", low=1),
    attr("pad", tuple, "Zero padding per spatial dim.", low=0),
    attr("global_pool", bool, "Pool over the whole spatial extent."),
    attr("pooling_convention", str, "Output-size rounding rule.",
         choices=("valid", "full", "same")),
    attr("p_value", int, "p of the Lp pooling norm.", low=1),
    attr("layout", str, "Input layout.", choices=_LAYOUT_CHOICES),
])
def _pooling_op(data, *, kernel=(), pool_type="max", stride=(), pad=(),
                global_pool=False, pooling_convention="valid",
                count_include_pad=True, cudnn_off=False, p_value=2,
                layout=None):
    return pooling(data, kernel=kernel, pool_type=pool_type, stride=stride,
                   pad=pad, global_pool=global_pool,
                   pooling_convention=pooling_convention,
                   count_include_pad=count_include_pad, p_value=p_value,
                   layout=layout)


@register("Dropout", aliases=["dropout"], attrs=[
    attr("p", float, "Fraction of units dropped.", low=0.0, high=1.0),
    attr("mode", str, "When to apply dropout.",
         choices=("training", "always")),
])
def _dropout_op(data, *, p=0.5, mode="training", axes=()):
    return dropout(data, p, mode, axes)


@register("Activation", aliases=["activation"], attrs=[
    attr("act_type", str, "The activation.", choices=tuple(_ACTIVATIONS)),
])
def _activation_op(data, *, act_type="relu"):
    return activation(data, act_type=act_type)


register("softmax")(softmax)
register("log_softmax")(log_softmax)


# the Gluon layers' ops (mx.nd.LayerNorm, mx.nd.BatchNorm, ...): each goes
# to the function above that the layer ran before, so a CUDA NDArray
# reaches the same kernel


@register("LayerNorm", aliases=["layer_norm"], attrs=[
    attr("axis", int, "The axis to normalize (the last only)."),
    attr("eps", float, "Normalization epsilon.", low=0.0),
])
def _layer_norm_op(data, gamma, beta, *, axis=-1, eps=1e-5,
                   output_mean_var=False):
    if output_mean_var:
        raise MXNetError("LayerNorm: output_mean_var is not ported yet "
                         "(ROADMAP.md, port queue 1, item 4)")
    return layer_norm(data, gamma, beta, axis=axis, eps=eps)


register("_contrib_fused_layer_norm", aliases=["fused_layer_norm"], attrs=[
    attr("eps", float, "Normalization epsilon.", low=0.0),
    attr("dropout", float, "Drop rate applied to ``data`` (not the "
         "residual) before the add+norm.", low=0.0, high=1.0),
])(fused_layer_norm_op)
register("_contrib_fused_bias_gelu",
         aliases=["fused_bias_gelu"])(fused_bias_gelu_op)


@register("BatchNorm", aliases=["batch_norm"], attrs=[
    attr("eps", float, "Numerical-stability epsilon added to variance.",
         low=0.0),
    attr("momentum", float, "Moving-average momentum.", low=0.0, high=1.0),
    attr("fix_gamma", bool, "Treat gamma as fixed at 1."),
    attr("use_global_stats", bool,
         "Normalize with moving stats even in training."),
    attr("axis", int, "Channel axis (1 = channels-first, -1 = last)."),
])
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False):
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats,
                      output_mean_var=output_mean_var, axis=axis)


@register("Embedding", attrs=[
    attr("input_dim", int, "Vocabulary size.", low=0),
    attr("output_dim", int, "Embedding width.", low=0),
])
def _embedding_op(data, weight, *, input_dim=0, output_dim=0,
                  dtype="float32", sparse_grad=False):
    return embedding(data, weight)


@register("InstanceNorm", attrs=[
    attr("eps", float, "Normalization epsilon.", low=0.0)])
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """Each sample's channels normalised over their spatial axes (the
    biased variance), then ``gamma``/``beta`` per channel, in data's
    dtype (reference ``ops/nn.py:793``)."""
    ax = tuple(range(2, data.dim()))
    mean = data.mean(dim=ax, keepdim=True)
    var = (data - mean).square().mean(dim=ax, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


@register("GroupNorm", attrs=[
    attr("num_groups", int, "Number of channel groups.", low=1),
    attr("eps", float, "Normalization epsilon.", low=0.0)])
def group_norm(data, gamma, beta, *, num_groups=1, eps=1e-5):
    """The channels split into ``num_groups`` groups, each normalised over
    its channels and the spatial axes (reference ``ops/nn.py:803``)."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + tuple(data.shape[2:]))
    ax = tuple(range(2, x.dim()))
    mean = x.mean(dim=ax, keepdim=True)
    var = (x - mean).square().mean(dim=ax, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(bshape) + beta.reshape(bshape)


_SELU = (1.0507009873554805, 1.6732632423543772)


@register("LeakyReLU", attrs=[
    attr("act_type", str, "The activation.",
         choices=("leaky", "prelu", "elu", "selu", "gelu", "rrelu")),
    attr("slope", float, "Negative slope (leaky) or alpha (elu)."),
])
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """``LeakyReLU`` in each ``act_type`` of the reference
    (``ops/nn.py:852``); ``rrelu`` takes the mean slope, as there."""
    # the reference's branch test: +-0 and NaN take the negative side,
    # in the value and the gradient
    pos = data > 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() < data.dim() and g.numel() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        scale, alpha = _SELU
        return scale * torch.where(pos, data, alpha * torch.expm1(data))
    if act_type == "gelu":
        return _erf_gelu(data)
    if act_type == "rrelu":
        return torch.where(pos, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise MXNetError(f"LeakyReLU: act_type {act_type!r} is not known")


# ---------------------------------------------------------------------------
# the ops a training loop meets (reference ops/nn.py:817-1191): the
# output heads and make_loss keep the reference's hand-written VJPs,
# which ignore the head gradient, as torch.autograd.Functions whose
# backward is the reference's bwd on both devices
# ---------------------------------------------------------------------------


@register("LRN")
def lrn(data, *, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Cross-channel local response normalisation of an NCHW input:
    ``data / (knorm + alpha * sum(window of data^2) / nsize) ** beta``
    (reference ``:817``)."""
    sq = data.square()
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    acc = torch.zeros_like(data)
    for i in range(nsize):
        acc = acc + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + alpha * acc / nsize, beta)


@register("softmin")
def softmin(data, *, axis=-1, temperature=None, dtype=None):
    """``softmax(-data)`` (reference ``:900``)."""
    return softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


_F32_MIN = float(torch.finfo(torch.float32).min)


@register("masked_softmax")
def masked_softmax(data, mask, *, axis=-1, temperature=1.0, normalize=True):
    """Softmax over the positions where ``mask`` is true, in f32; masked
    positions and fully masked rows give 0 (reference ``:905``). With
    ``normalize=False``, ``exp`` on the kept positions."""
    m = mask.to(torch.bool)
    x = data if temperature in (None, 1.0) else data / temperature
    if not normalize:
        return torch.where(m, torch.exp(x), 0.0).to(data.dtype)
    out = torch.softmax(torch.where(m, x.float(), _F32_MIN), dim=axis)
    return torch.where(m, out, 0.0).to(data.dtype)


@register("masked_log_softmax")
def masked_log_softmax(data, mask, *, axis=-1, temperature=1.0):
    """The log of :func:`masked_softmax`, -inf at masked positions
    (reference ``:925``)."""
    m = mask.to(torch.bool)
    x = data if temperature in (None, 1.0) else data / temperature
    out = torch.log_softmax(torch.where(m, x.float(), _F32_MIN), dim=axis)
    return torch.where(m, out, float("-inf")).to(data.dtype)


def _label_grad(ctx, label):
    """The label's gradient of the reference's heads: zeros."""
    return torch.zeros_like(label) if ctx.needs_input_grad[1] else None


def _one_hot(label, n, dtype):
    """``jax.nn.one_hot(label.astype(int32), n)``: a label out of [0, n)
    gives a zero row."""
    idx = label.to(torch.int32).to(torch.int64).unsqueeze(-1)
    return (idx == torch.arange(n, device=label.device)).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax over the last axis; the backward is ``(prob -
    one_hot(label)) * grad_scale`` normalised as ``normalization`` says,
    whatever the head gradient (reference ``_make_softmax_output``,
    ``:938``)."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        prob = torch.softmax(data, dim=-1)
        ctx.save_for_backward(prob, label)
        ctx.cfg = cfg
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, smooth_alpha, norm = ctx.cfg
        n_class = prob.shape[-1]
        onehot = _one_hot(label, n_class, prob.dtype)
        if smooth_alpha:
            onehot = onehot * (1 - smooth_alpha) \
                + smooth_alpha / (n_class - 1) * (1 - onehot)
        grad = prob - onehot
        valid = None
        if use_ignore:
            mask = (label != ignore_label).to(prob.dtype)
            grad = grad * mask[..., None]
            valid = torch.clamp(mask.sum(), min=1.0)
        if norm == "valid":
            denom = valid if valid is not None else float(
                prob[..., 0].numel())
            grad = grad / denom
        elif norm == "batch":
            grad = grad / float(prob.shape[0])
        return grad * grad_scale, _label_grad(ctx, label), None


@register("SoftmaxOutput", aliases=["Softmax"], attrs=[
    attr("normalization", str, "How the gradient is normalised.",
         choices=("null", "batch", "valid")),
])
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """The softmax head with the cross-entropy gradient (reference
    ``:981``): over axis 1 with ``multi_output``, over every axis but the
    first for a >2-d input unless ``preserve_shape``, else the last."""
    cfg = (grad_scale, ignore_label, use_ignore, smooth_alpha, normalization)
    if multi_output:
        x = torch.movedim(data, 1, -1)
        return torch.movedim(_SoftmaxOutput.apply(x, label, cfg), -1, 1)
    if data.dim() > 2 and not preserve_shape:
        flat = data.reshape(data.shape[0], -1)
        return _SoftmaxOutput.apply(flat, label, cfg).reshape(data.shape)
    return _SoftmaxOutput.apply(data, label, cfg)


class _MakeLoss(torch.autograd.Function):
    """The identity whose gradient is ``grad_scale`` everywhere, in f32
    (cast to the input's dtype), whatever the head gradient (reference
    ``:1002``)."""

    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full(g.shape, ctx.grad_scale, dtype=torch.float32,
                          device=g.device), None


@register("make_loss", aliases=["MakeLoss"])
def make_loss(data, *, grad_scale=1.0, valid_thresh=0.0,
              normalization="null"):
    return _MakeLoss.apply(data, grad_scale)


@register("BlockGrad", aliases=["stop_gradient"])
def block_grad(data):
    """The identity with no gradient (reference ``:1019``)."""
    return data.detach()


class _RegressionOutput(torch.autograd.Function):
    """``out = fwd(data)``; the backward is ``bwd(out or data, label) *
    grad_scale`` whatever the head gradient (reference ``:1138-1188``)."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out if kind == "logistic" else data, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if ctx.kind == "linear":
            grad = (x - y) * ctx.grad_scale / 1.0
        elif ctx.kind == "mae":
            d = x - y                   # jnp.sign keeps NaN, torch's is 0
            grad = torch.where(torch.isnan(d), d, torch.sign(d)) \
                * ctx.grad_scale
        else:
            grad = (x - y) * ctx.grad_scale
        return grad, _label_grad(ctx, y), None, None


@register("LinearRegressionOutput")
def linear_regression_output(data, label, *, grad_scale=1.0):
    return _RegressionOutput.apply(data, label.reshape(data.shape), "linear",
                                   grad_scale)


@register("MAERegressionOutput")
def mae_regression_output(data, label, *, grad_scale=1.0):
    return _RegressionOutput.apply(data, label.reshape(data.shape), "mae",
                                   grad_scale)


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, *, grad_scale=1.0):
    return _RegressionOutput.apply(data, label.reshape(data.shape),
                                   "logistic", grad_scale)


@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    """``0.5 s^2 x^2`` where ``|x| < 1 / s^2``, else ``|x| - 0.5 / s^2``
    (reference ``:1191``)."""
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * data.square(),
                       torch.abs(data) - 0.5 / s2)


# ---------------------------------------------------------------------------
# the spatial group: GridGenerator, Crop, im2col / col2im, ROIPooling
# (reference :1309, :1387, :1329, :1353, :521)
# ---------------------------------------------------------------------------


@register("GridGenerator")
def grid_generator(data, *, transform_type="affine", target_shape=(0, 0)):
    """The affine sampling grid: ``data`` (N, 6) thetas times the target's
    normalised (x, y, 1) grid, (N, 2, h, w). In float64, as the
    reference's x64 ``linspace`` promotes it whatever data's dtype. The
    reference computes the affine grid for any ``transform_type``; the
    port raises for another than ``affine``."""
    if transform_type != "affine":
        raise MXNetError(f"GridGenerator: transform_type {transform_type!r}"
                         " is not supported (the reference computes the "
                         "affine grid only)")
    h, w = (int(v) for v in target_shape)
    gy, gx = torch.meshgrid(
        torch.linspace(-1.0, 1.0, h, dtype=torch.float64, device=data.device),
        torch.linspace(-1.0, 1.0, w, dtype=torch.float64, device=data.device),
        indexing="ij")
    base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones(h * w, dtype=torch.float64,
                                   device=data.device)])
    theta = data.reshape(-1, 2, 3).double()
    return torch.matmul(theta, base).reshape(-1, 2, h, w)


@register("Crop")
def crop(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False,
         num_args=1):
    """``inputs[0]`` (NCHW) cropped to ``h_w``, or to the spatial size of
    a second (``crop_like``) input, at ``offset`` (y, x) or centred; a
    copy."""
    data = inputs[0]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = h_w
        if th <= 0 or tw <= 0:
            raise ValueError(
                "Crop: h_w must be given (positive) when no crop_like "
                "input is passed (reference crop.cc parameter check)")
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (h - th) // 2, (w - tw) // 2
    else:
        oy, ox = offset
    return data[:, :, oy:oy + th, ox:ox + tw].clone()


def _patch_grid(spatial, kernel, stride, dilate, pad):
    """Each spatial axis's output size and, per kernel tap, the slice of
    the padded axis that tap reads."""
    outs, taps = [], []
    for n, k, s, d, p in zip(spatial, kernel, stride, dilate, pad):
        o = (n + 2 * p - (d * (k - 1) + 1)) // s + 1
        outs.append(o)
        taps.append([slice(t * d, t * d + s * (o - 1) + 1, s)
                     for t in range(k)])
    return outs, taps


def _patch_args(kernel, stride, dilate, pad):
    nd = len(kernel)
    return (tuple(kernel), _tuplize(stride or 1, nd),
            _tuplize(dilate or 1, nd), _tuplize(pad or 0, nd))


@register("im2col", attrs=[
    attr("kernel", tuple, "Sliding window size."),
])
def im2col(data, *, kernel=(), stride=(), dilate=(), pad=()):
    """(N, C, *spatial) over ``len(kernel)`` (1, 2 or 3) spatial axes to
    (N, C * prod(kernel), prod(out)): feature ``c * prod(kernel) + tap``,
    channel-major as ``conv_general_dilated_patches`` orders it, zero
    padding; one strided view of the padded input per tap."""
    kernel, stride, dilate, pad = _patch_args(kernel, stride, dilate, pad)
    n, c = data.shape[:2]
    outs, taps = _patch_grid(data.shape[2:], kernel, stride, dilate, pad)
    x = F.pad(data, [v for p in reversed(pad) for v in (p, p)])
    cols = [x[(slice(None), slice(None)) + sl]
            for sl in itertools.product(*taps)]
    return torch.stack(cols, dim=2).reshape(n, c * len(cols),
                                            math.prod(outs))


@register("col2im", attrs=[
    attr("kernel", tuple, "Sliding window size."),
])
def col2im(data, *, output_size=(), kernel=(), stride=(), dilate=(),
           pad=()):
    """The exact adjoint of :func:`im2col`: (N, C * prod(kernel), L)
    columns scatter-added into (N, C, *output_size), overlaps summed, the
    padding cropped."""
    kernel, stride, dilate, pad = _patch_args(kernel, stride, dilate, pad)
    size = tuple(int(v) for v in output_size)
    n, ckk = data.shape[:2]
    kk = math.prod(kernel)
    c = ckk // kk
    outs, taps = _patch_grid(size, kernel, stride, dilate, pad)
    cols = data.reshape((n, c, kk) + tuple(outs))
    x = data.new_zeros((n, c) + tuple(s + 2 * p for s, p in zip(size, pad)))
    for t, sl in enumerate(itertools.product(*taps)):
        x[(slice(None), slice(None)) + sl] += cols[:, :, t]
    crop_sl = tuple(slice(p, p + s) for s, p in zip(size, pad))
    return x[(slice(None), slice(None)) + crop_sl]


_ROI_POOL_CHUNK = 1 << 26      # elements of a chunk's (rois, C, H, W, pw)


@register("ROIPooling")
def roi_pooling(data, rois, *, pooled_size=(), spatial_scale=1.0):
    """Max pooling of ``data`` (N, C, H, W) over quantised bins of ``rois``
    (R, 5) ``[batch, x1, y1, x2, y2]``: (R, C, ph, pw) in data's dtype.
    Corners round half away from zero (``floor(x * scale + 0.5)``); bin i
    spans ``[floor(i rh / ph), ceil((i + 1) rh / ph))`` (bins overlap by
    one), clipped into the map; an empty bin is 0. The batch column is
    truncated to an int, a negative one wraps once, and one still out of
    range gives a zero output (``jnp.take``'s fill). The max is taken over
    W, then over H, each splitting its gradient evenly among tied maxima
    as JAX's does (``amax``). RoIs go in chunks, so no (R, C, H, W, pw)
    mask outgrows ``_ROI_POOL_CHUNK`` elements."""
    ph, pw = pooled_size
    n, c, h, w = data.shape
    r = rois.detach().float()
    dev = data.device
    bi = r[:, 0].to(torch.int32).long()
    bi = torch.where(bi < 0, bi + n, bi)
    inb = (bi >= 0) & (bi < n)
    bi = bi.clamp(0, n - 1)

    def q(col):
        return torch.floor(r[:, col] * spatial_scale + 0.5).to(torch.int32)

    x1, y1, x2, y2 = q(1), q(2), q(3), q(4)
    rh = (y2 - y1 + 1).clamp_min(1).float()[:, None]
    rw = (x2 - x1 + 1).clamp_min(1).float()[:, None]
    iy = torch.arange(ph, device=dev)[None]
    ix = torch.arange(pw, device=dev)[None]
    hstart = y1[:, None] + torch.floor(true_div(iy * rh, ph)).to(torch.int32)
    hend = y1[:, None] + torch.ceil(true_div((iy + 1) * rh, ph)).to(
        torch.int32)
    wstart = x1[:, None] + torch.floor(true_div(ix * rw, pw)).to(torch.int32)
    wend = x1[:, None] + torch.ceil(true_div((ix + 1) * rw, pw)).to(
        torch.int32)
    hs = torch.arange(h, device=dev)[None, :, None]
    ws = torch.arange(w, device=dev)[None, :, None]
    ymask = (hs >= hstart[:, None]) & (hs < hend[:, None])     # (R, H, ph)
    xmask = (ws >= wstart[:, None]) & (ws < wend[:, None])     # (R, W, pw)
    neg = float("-inf")
    per = max(1, _ROI_POOL_CHUNK // max(1, c * h * w * pw))
    outs = []
    for s in range(0, r.shape[0], per):
        sl = slice(s, s + per)
        img = data[bi[sl]].float()                           # (m, C, H, W)
        tmp = torch.amax(torch.where(xmask[sl][:, None, None],
                                     img[..., None], neg), dim=3)
        out = torch.amax(torch.where(ymask[sl][:, None, :, :, None],
                                     tmp[:, :, :, None, :], neg), dim=2)
        keep = torch.isfinite(out) & inb[sl][:, None, None, None]
        outs.append(torch.where(keep, out, 0.0).to(data.dtype))
    if not outs:
        return data.new_zeros((0, c, ph, pw))
    return torch.cat(outs)
