"""Fused row kernels: RMSNorm, LayerNorm(+ residual) and the bias+GELU
epilogue, each a hand-written CUDA kernel beside its plain PyTorch
version.

Counterpart of ``mxnet_tpu/pallas_kernels/fused_layers.py``:
``_norm_fwd_kernel`` in RMS mode (``csrc/rms_norm.cu``) and
``_norm_bwd_kernel`` in RMS mode (the ``Rms`` instances of
``csrc/layer_norm.cu``'s backward), ``_norm_fwd_kernel`` and
``_norm_bwd_kernel`` in LayerNorm mode with and without the residual
(``csrc/layer_norm.cu``), and ``_bias_gelu_fwd_kernel`` /
``_bias_gelu_bwd_kernel`` (``csrc/bias_gelu.cu``). ``fused_rms_norm``,
``fused_layer_norm`` and ``fused_bias_gelu`` are differentiable: with
autograd recording and an input that requires grad they go through a
``torch.autograd.Function`` whose backward is the backward kernel (the
JAX ``custom_vjp``s ``_rms``, ``_ln_res``/``_ln_plain`` and
``_bias_gelu``); otherwise (serving under ``torch.inference_mode()``)
they launch the forward alone. The LayerNorm's dropout (``dropout > 0``
with a u32 ``seed``) drops x before the residual add with the
position hash of ``kernels/dropout.py`` (``_row_keep_mask``); the
backward regenerates the mask from the seed, which is all the autograd
node keeps of it. Each source's header comment says what bounds it on
an H100 and how its design answers that.

Routing is by device only: a CPU tensor takes the plain version (the CPU
tests' path), a CUDA tensor launches the kernel or raises. There is no
knob and no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from .dropout import check_dropout, dropout_thresh, f32, kernel_args, \
    row_keep_mask

__all__ = ["fused_rms_norm", "fused_rms_norm_reference",
           "fused_rms_norm_bwd", "fused_rms_norm_bwd_reference",
           "fused_layer_norm", "fused_layer_norm_reference",
           "fused_layer_norm_bwd", "fused_layer_norm_bwd_reference",
           "fused_bias_gelu", "fused_bias_gelu_reference",
           "fused_bias_gelu_bwd", "fused_bias_gelu_bwd_reference", "MAX_D"]

MAX_D = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327
# CTAs per SM of the backward kernels' grids: each CTA writes one f32
# partial row of the parameter gradients, summed by the wrapper
_BWD_CTAS_PER_SM = 8


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _bwd_ctas(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count \
        * _BWD_CTAS_PER_SM


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def fused_rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, *,
                             eps: float = 1e-6, return_rstd: bool = False):
    """Plain PyTorch RMSNorm with the JAX kernel's numerics
    (``fused_layers.py:172-176``): f32 statistics, the normalised value
    rounded to x's dtype, then the weight multiply, whose promotion sets
    the output dtype. ``return_rstd`` also returns the f32 per-row
    ``rstd``, shaped ``x.shape[:-1]``."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    out = (x32 * inv).to(x.dtype) * weight
    if return_rstd:
        return out, inv.squeeze(-1)
    return out


_RMS_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. ``x``: (..., D) float32 or bfloat16,
    contiguous, D <= 8192; ``weight``: (D,) float32 or bfloat16. Output
    dtype is ``promote_types(x.dtype, weight.dtype)``. With autograd
    recording and an input that requires grad, the backward is
    :func:`fused_rms_norm_bwd`."""
    if _needs_grad(x, weight):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_norm_fwd(x, weight, eps, False)


def _rms_norm_fwd(x, weight, eps, return_rstd):
    if x.device.type == "cpu":
        return fused_rms_norm_reference(x, weight, eps=eps,
                                        return_rstd=return_rstd)
    if x.device.type != "cuda" or weight.device != x.device:
        raise MXNetError(f"fused_rms_norm: x on {x.device}, weight on "
                         f"{weight.device}; both must be on one CUDA device")
    if x.dtype not in _DTYPE_CODE or weight.dtype not in _DTYPE_CODE:
        raise MXNetError(f"fused_rms_norm: dtypes {x.dtype}/{weight.dtype} "
                         "not supported (float32 or bfloat16)")
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or weight.shape != (d,) or not 0 < d <= MAX_D:
        raise MXNetError(f"fused_rms_norm: x {tuple(x.shape)} with weight "
                         f"{tuple(weight.shape)}: need weight (D,), "
                         f"0 < D <= {MAX_D}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise MXNetError("fused_rms_norm: x and weight must be contiguous")
    out = torch.empty(x.shape, dtype=torch.promote_types(x.dtype,
                                                         weight.dtype),
                      device=x.device)
    rstd = (torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
            if return_rstd else None)
    rows = x.numel() // d
    if rows > 0:
        vec = d % 8 == 0 and _aligned(x, weight, out)
        with torch.cuda.device(x.device):
            _build.call(
                "rms_norm.cu", "mx_rms_norm_fwd", _RMS_ARGS,
                "fused_rms_norm", x.data_ptr(), weight.data_ptr(),
                out.data_ptr(), rstd.data_ptr() if rstd is not None else None,
                rows, d, float(eps), _DTYPE_CODE[x.dtype],
                _DTYPE_CODE[weight.dtype], int(vec), _stream(x.device))
        fused_rms_norm.launches += 1
    if return_rstd:
        return out, rstd
    return out


fused_rms_norm.launches = 0


def fused_rms_norm_bwd_reference(x, weight, rstd, dy):
    """Plain PyTorch RMSNorm backward with the JAX kernel's numerics
    (``_norm_bwd_kernel`` with ``rms=True``, ``fused_layers.py:261-283``):
    ``xhat = x * rstd`` in f32 from the forward's saved f32 ``rstd`` (not
    rounded to x's dtype, unlike the forward's), ``wdy = dy * weight``,
    ``dx = rstd * (wdy - xhat * mean(wdy * xhat))`` in x's dtype, ``dw =
    sum(dy * xhat)`` over the rows in f32, then in weight's dtype.
    Returns ``(dx, dw)``."""
    d = x.shape[-1]
    rs = rstd.unsqueeze(-1)
    xhat = x.float() * rs
    dyf = dy.float()
    wdy = dyf * weight.float()
    m2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    dx = rs * (wdy - xhat * m2)
    dw = (dyf * xhat).reshape(-1, d).sum(dim=0).to(weight.dtype)
    return dx.to(x.dtype), dw


_RMS_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]


def fused_rms_norm_bwd(x, weight, rstd, dy):
    """Gradients ``(dx, dw)`` of :func:`fused_rms_norm` for the output
    gradient ``dy`` (in the output's dtype), from the forward's input,
    weight and f32 per-row ``rstd``; see
    :func:`fused_rms_norm_bwd_reference`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (f32 partial rows of dw
    per CTA, summed here, as ``_norm_bwd_pallas`` sums its partials) or
    raises."""
    if x.device.type == "cpu":
        return fused_rms_norm_bwd_reference(x, weight, rstd, dy)
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in (weight, rstd, dy)):
        raise MXNetError("fused_rms_norm_bwd: every input must be on one "
                         f"CUDA device (x on {x.device})")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPE_CODE or weight.dtype not in _DTYPE_CODE \
            or dy.dtype != torch.promote_types(x.dtype, weight.dtype) \
            or rstd.dtype != torch.float32:
        raise MXNetError(
            f"fused_rms_norm_bwd: dtypes x {x.dtype}, weight "
            f"{weight.dtype}, rstd {rstd.dtype}, dy {dy.dtype}: need x and "
            "weight in float32/bfloat16, rstd float32 and dy in their "
            "promoted dtype")
    if x.dim() < 1 or not 0 < d <= MAX_D or weight.shape != (d,) \
            or dy.shape != x.shape or rstd.shape != x.shape[:-1]:
        raise MXNetError(
            f"fused_rms_norm_bwd: x {tuple(x.shape)}, weight "
            f"{tuple(weight.shape)}, rstd {tuple(rstd.shape)}, dy "
            f"{tuple(dy.shape)}: need dy shaped as x, (D,) weight, "
            f"0 < D <= {MAX_D}, rstd shaped x.shape[:-1]")
    dy = dy.contiguous()
    if not all(t.is_contiguous() for t in (x, weight, rstd)):
        raise MXNetError("fused_rms_norm_bwd: inputs must be contiguous")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros(d, dtype=weight.dtype, device=x.device)
    n_blocks = min(rows, _bwd_ctas(x.device))
    dw_part = torch.empty((n_blocks, d), dtype=torch.float32,
                          device=x.device)
    vec = d % 8 == 0 and _aligned(x, weight, dy, dx)
    with torch.cuda.device(x.device):
        _build.call(
            "layer_norm.cu", "mx_rms_norm_bwd", _RMS_BWD_ARGS,
            "fused_rms_norm_bwd", x.data_ptr(), weight.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dw_part.data_ptr(), rows, d, n_blocks, _DTYPE_CODE[x.dtype],
            _DTYPE_CODE[weight.dtype], int(vec), _stream(x.device))
    fused_rms_norm_bwd.launches += 1
    return dx, dw_part.sum(dim=0).to(weight.dtype)


fused_rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with its backward kernel; the forward saves x, the weight
    and the f32 row ``rstd`` (``_rms_fwd``, ``fused_layers.py:473-476``).
    On the CPU both passes are the plain versions, so the two devices
    differentiate the same formula."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        out, rstd = _rms_norm_fwd(x, weight, eps, True)
        ctx.save_for_backward(x, weight, rstd)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        dx, dw = fused_rms_norm_bwd(x, weight, rstd, dy)
        return dx, dw, None


# ---------------------------------------------------------------------------
# LayerNorm (+ residual)
# ---------------------------------------------------------------------------

def _drop_rows(h, dropout, seed):
    """``h`` (f32, (..., D)) with the row kernels' dropout: kept elements
    times f32(1 / (1 - p)), dropped ones 0; the mask over the flat
    (row, col) ids. Returns ``(h, keep)`` (``keep`` None at p = 0)."""
    if dropout == 0.0:
        return h, None
    d = h.shape[-1]
    keep = row_keep_mask(h.numel() // d, d, seed, dropout_thresh(dropout),
                         h.device).reshape(h.shape)
    inv = torch.tensor(f32(1.0 / (1.0 - dropout)))
    return torch.where(keep, h * inv, torch.zeros((), device=h.device)), keep


def fused_layer_norm_reference(x, gamma, beta, residual=None, *,
                               eps: float = 1e-5, dropout: float = 0.0,
                               seed=None, return_stats: bool = False):
    """Plain PyTorch ``LayerNorm(dropout(x) + residual)`` with the JAX
    kernel's numerics (``_norm_fwd_kernel``, ``fused_layers.py:190-233``):
    x in f32, dropped under ``seed`` when ``dropout > 0`` (kept elements
    times f32(1 / (1 - p)), the mask over the flat (row, col) ids), the
    residual added in f32, two-pass f32 statistics (the mean, then the
    mean of ``(h - mean)**2``), ``(h - mean) * rstd * gamma + beta`` in
    f32, rounded once to x's dtype. ``return_stats`` also returns the f32
    per-row ``(mean, rstd)``, shaped ``x.shape[:-1]``."""
    dropout, seed = check_dropout(dropout, seed, "fused_layer_norm")
    h, _ = _drop_rows(x.float(), dropout, seed)
    if residual is not None:
        h = h + residual.float()
    mean = h.mean(dim=-1, keepdim=True)
    hc = h - mean
    rstd = torch.rsqrt((hc * hc).mean(dim=-1, keepdim=True) + eps)
    out = (hc * rstd * gamma.float() + beta.float()).to(x.dtype)
    if return_stats:
        return out, mean.squeeze(-1), rstd.squeeze(-1)
    return out


_LN_ARGS = [ctypes.c_void_p] * 7 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
    ctypes.c_void_p]


def fused_layer_norm(x, gamma, beta, residual=None, *, eps: float = 1e-5,
                     dropout: float = 0.0, seed=None,
                     return_stats: bool = False):
    """``LayerNorm(dropout(x) + residual)`` over the last axis (the post-LN
    transformer cell's add+norm; ``residual=None`` is a plain LayerNorm).

    ``x``: (..., D) float32 or bfloat16, contiguous, 0 < D <= 8192;
    ``residual``: None or x's shape and dtype; ``gamma``/``beta``: (D,),
    both float32 or both bfloat16. The output has x's dtype.
    ``dropout`` in [0, 1) drops x only, under the u32 ``seed`` (required
    when ``dropout > 0``). ``return_stats`` also returns the f32 per-row
    ``(mean, rstd)`` the backward recomputes xhat from (and is not
    differentiable). With autograd recording and an input that requires
    grad, the backward is :func:`fused_layer_norm_bwd`."""
    dropout, seed = check_dropout(dropout, seed, "fused_layer_norm")
    if not return_stats and _needs_grad(x, gamma, beta, residual):
        return _LayerNorm.apply(x, gamma, beta, residual, eps, dropout, seed)
    return _layer_norm_fwd(x, gamma, beta, residual, eps, return_stats,
                           dropout, seed)


def _layer_norm_fwd(x, gamma, beta, residual, eps, return_stats, dropout,
                    seed):
    if x.device.type == "cpu":
        return fused_layer_norm_reference(x, gamma, beta, residual, eps=eps,
                                          dropout=dropout, seed=seed,
                                          return_stats=return_stats)
    tensors = [x, gamma, beta] + ([residual] if residual is not None else [])
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in tensors):
        raise MXNetError("fused_layer_norm: every input must be on one "
                         f"CUDA device (x on {x.device})")
    if x.dtype not in _DTYPE_CODE or gamma.dtype not in _DTYPE_CODE \
            or beta.dtype != gamma.dtype \
            or (residual is not None and residual.dtype != x.dtype):
        raise MXNetError(
            f"fused_layer_norm: dtypes x {x.dtype}, gamma {gamma.dtype}, "
            f"beta {beta.dtype}, residual "
            f"{None if residual is None else residual.dtype}: need x (and "
            "the residual) in one of float32/bfloat16, gamma and beta in "
            "one of them")
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or not 0 < d <= MAX_D or gamma.shape != (d,) \
            or beta.shape != (d,) \
            or (residual is not None and residual.shape != x.shape):
        raise MXNetError(
            f"fused_layer_norm: x {tuple(x.shape)}, gamma "
            f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}, residual "
            f"{None if residual is None else tuple(residual.shape)}: need "
            f"(D,) gamma/beta, 0 < D <= {MAX_D}, residual shaped as x")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("fused_layer_norm: inputs must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d
    mean = rstd = None
    if return_stats:
        mean = torch.empty(x.shape[:-1], dtype=torch.float32,
                           device=x.device)
        rstd = torch.empty_like(mean)
    if rows > 0:
        vec = d % 8 == 0 and _aligned(x, residual, gamma, beta, out)
        with torch.cuda.device(x.device):
            _build.call(
                "layer_norm.cu", "mx_layer_norm_fwd", _LN_ARGS,
                "fused_layer_norm", x.data_ptr(),
                residual.data_ptr() if residual is not None else None,
                gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                mean.data_ptr() if mean is not None else None,
                rstd.data_ptr() if rstd is not None else None,
                rows, d, float(eps), _DTYPE_CODE[x.dtype],
                _DTYPE_CODE[gamma.dtype], int(vec),
                *kernel_args(dropout, seed, f32(1.0 / (1.0 - dropout))),
                _stream(x.device))
        fused_layer_norm.launches += 1
        fused_layer_norm.dropout_launches += int(dropout > 0.0)
    if return_stats:
        return out, mean, rstd
    return out


fused_layer_norm.launches = 0
fused_layer_norm.dropout_launches = 0    # the launches with dropout > 0


def fused_layer_norm_bwd_reference(x, gamma, mean, rstd, dy,
                                   residual=None, dropout: float = 0.0,
                                   seed=None):
    """Plain PyTorch LayerNorm backward with the JAX kernel's numerics
    (``_norm_bwd_kernel``, ``fused_layers.py:237-291``): h recomputed as
    the forward formed it (x dropped under ``seed``, plus the residual),
    xhat from the saved f32 ``(mean, rstd)``, ``wdy = dy * gamma``, ``dh
    = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat))`` in f32,
    ``dgamma = sum(dy * xhat)`` and ``dbeta = sum(dy)`` over the rows in
    f32, then in gamma's dtype. Without dropout, ``dx = dh`` in x's dtype
    and returns ``(dx, dgamma, dbeta)``, the residual's gradient being
    ``dx`` too. With dropout, ``dx = keep ? dh * f32(1 / (1 - p)) : 0``
    and, with a residual, its gradient ``dres = dh`` in x's dtype comes
    fourth: ``(dx, dgamma, dbeta, dres)``."""
    dropout, seed = check_dropout(dropout, seed, "fused_layer_norm_bwd")
    d = x.shape[-1]
    h, keep = _drop_rows(x.float(), dropout, seed)
    if residual is not None:
        h = h + residual.float()
    rs = rstd.unsqueeze(-1)
    xhat = (h - mean.unsqueeze(-1)) * rs
    dyf = dy.float()
    wdy = dyf * gamma.float()
    m2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    m1 = wdy.mean(dim=-1, keepdim=True)
    dh = rs * (wdy - m1 - xhat * m2)
    dgamma = (dyf * xhat).reshape(-1, d).sum(dim=0).to(gamma.dtype)
    dbeta = dyf.reshape(-1, d).sum(dim=0).to(gamma.dtype)
    if keep is None:
        return dh.to(x.dtype), dgamma, dbeta
    dx, _ = _drop_rows(dh, dropout, seed)
    if residual is None:
        return dx.to(x.dtype), dgamma, dbeta
    return dx.to(x.dtype), dgamma, dbeta, dh.to(x.dtype)


_LN_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
    ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p]


def fused_layer_norm_bwd(x, gamma, mean, rstd, dy, residual=None,
                         dropout: float = 0.0, seed=None):
    """Gradients ``(dx, dgamma, dbeta)`` of ``LayerNorm(dropout(x) +
    residual)`` for the output gradient ``dy``, from the forward's inputs,
    its f32 per-row ``(mean, rstd)`` (``return_stats``) and its dropout
    rate and seed; without dropout the residual's gradient is ``dx`` too,
    with dropout and a residual it comes fourth, ``(dx, dgamma, dbeta,
    dres)`` (see :func:`fused_layer_norm_bwd_reference`). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (f32
    partial rows of dgamma/dbeta per CTA, summed here, as
    ``_norm_bwd_pallas`` sums its partials) or raises."""
    dropout, seed = check_dropout(dropout, seed, "fused_layer_norm_bwd")
    if x.device.type == "cpu":
        return fused_layer_norm_bwd_reference(x, gamma, mean, rstd, dy,
                                              residual, dropout, seed)
    tensors = [x, gamma, mean, rstd, dy] + (
        [residual] if residual is not None else [])
    if x.device.type != "cuda" or any(t.device != x.device
                                      for t in tensors):
        raise MXNetError("fused_layer_norm_bwd: every input must be on one "
                         f"CUDA device (x on {x.device})")
    d = x.shape[-1] if x.dim() else 0
    if x.dtype not in _DTYPE_CODE or gamma.dtype not in _DTYPE_CODE \
            or dy.dtype != x.dtype \
            or (residual is not None and residual.dtype != x.dtype) \
            or mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise MXNetError("fused_layer_norm_bwd: need x, dy (and the "
                         "residual) in one of float32/bfloat16, gamma in "
                         "one of them, mean and rstd float32")
    if x.dim() < 1 or not 0 < d <= MAX_D or gamma.shape != (d,) \
            or dy.shape != x.shape or mean.shape != x.shape[:-1] \
            or rstd.shape != x.shape[:-1] \
            or (residual is not None and residual.shape != x.shape):
        raise MXNetError(
            f"fused_layer_norm_bwd: x {tuple(x.shape)}, gamma "
            f"{tuple(gamma.shape)}, dy {tuple(dy.shape)}, mean/rstd "
            f"{tuple(mean.shape)}: need dy shaped as x, (D,) gamma, "
            f"0 < D <= {MAX_D}, row statistics shaped x.shape[:-1]")
    dy = dy.contiguous()
    if not all(t.is_contiguous() for t in tensors[:4] + tensors[5:]):
        raise MXNetError("fused_layer_norm_bwd: inputs must be contiguous")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dres = (torch.empty_like(x) if dropout > 0.0 and residual is not None
            else None)
    extra = () if dres is None else (dres,)
    if rows == 0:
        zeros = torch.zeros(d, dtype=gamma.dtype, device=x.device)
        return (dx, zeros, zeros.clone()) + extra
    n_blocks = min(rows, _bwd_ctas(x.device))
    # the dgamma and dbeta partial rows, summed by one reduction
    parts = torch.empty((2, n_blocks, d), dtype=torch.float32,
                        device=x.device)
    vec = d % 8 == 0 and _aligned(x, residual, gamma, dy, dx, dres)
    with torch.cuda.device(x.device):
        _build.call(
            "layer_norm.cu", "mx_layer_norm_bwd", _LN_BWD_ARGS,
            "fused_layer_norm_bwd", x.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(),
            dres.data_ptr() if dres is not None else None,
            parts[0].data_ptr(), parts[1].data_ptr(), rows, d, n_blocks,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[gamma.dtype], int(vec),
            *kernel_args(dropout, seed, f32(1.0 / (1.0 - dropout))),
            _stream(x.device))
    fused_layer_norm_bwd.launches += 1
    fused_layer_norm_bwd.dropout_launches += int(dropout > 0.0)
    dgamma, dbeta = parts.sum(dim=1).to(gamma.dtype)
    return (dx, dgamma, dbeta) + extra


fused_layer_norm_bwd.launches = 0
fused_layer_norm_bwd.dropout_launches = 0


class _LayerNorm(torch.autograd.Function):
    """``LayerNorm(dropout(x) + residual)`` with its backward kernel; the
    forward saves x, the residual, gamma, the f32 row statistics and the
    dropout seed, not a mask (``_ln_res_fwd``/``_ln_plain_fwd``,
    ``fused_layers.py:384``, ``:411``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, residual, eps, dropout, seed):
        out, mean, rstd = _layer_norm_fwd(x, gamma, beta, residual, eps,
                                          True, dropout, seed)
        ctx.save_for_backward(x, gamma, mean, rstd, residual)
        ctx.dropout = (dropout, seed)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd, residual = ctx.saved_tensors
        dx, dgamma, dbeta, *dres = fused_layer_norm_bwd(
            x, gamma, mean, rstd, dy, residual, *ctx.dropout)
        if residual is None:
            dres = None
        else:
            dres = dres[0] if dres else dx
        return dx, dgamma, dbeta, dres, None, None, None


# ---------------------------------------------------------------------------
# bias + GELU
# ---------------------------------------------------------------------------

def fused_bias_gelu_reference(x: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``gelu(x + bias)``, exact erf, with the JAX kernel's
    numerics (``fused_layers.py:505-508``): ``u = x + bias`` in f32,
    ``u * 0.5 * (1 + erf(u / sqrt(2)))`` in f32, rounded once to x's
    dtype."""
    u = x.float() + bias.float()
    return (u * (0.5 * (1.0 + torch.erf(u * _INV_SQRT2)))).to(x.dtype)


_GELU_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p]


def fused_bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``gelu(x + bias)`` (exact erf form), the Dense matmul epilogue.
    ``x``: (..., D) float32 or bfloat16, contiguous; ``bias``: (D,)
    float32 or bfloat16. The output has x's dtype. With autograd
    recording and an input that requires grad, the backward is
    :func:`fused_bias_gelu_bwd`."""
    if _needs_grad(x, bias):
        return _BiasGelu.apply(x, bias)
    return _bias_gelu_fwd(x, bias)


def _bias_gelu_fwd(x, bias):
    if x.device.type == "cpu":
        return fused_bias_gelu_reference(x, bias)
    if x.device.type != "cuda" or bias.device != x.device:
        raise MXNetError(f"fused_bias_gelu: x on {x.device}, bias on "
                         f"{bias.device}; both must be on one CUDA device")
    if x.dtype not in _DTYPE_CODE or bias.dtype not in _DTYPE_CODE:
        raise MXNetError(f"fused_bias_gelu: dtypes {x.dtype}/{bias.dtype} "
                         "not supported (float32 or bfloat16)")
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or d < 1 or bias.shape != (d,):
        raise MXNetError(f"fused_bias_gelu: x {tuple(x.shape)} with bias "
                         f"{tuple(bias.shape)}: need bias (D,), D > 0")
    if not (x.is_contiguous() and bias.is_contiguous()):
        raise MXNetError("fused_bias_gelu: x and bias must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    vec = d % 8 == 0 and _aligned(x, bias, out)
    with torch.cuda.device(x.device):
        _build.call(
            "bias_gelu.cu", "mx_bias_gelu_fwd", _GELU_ARGS, "fused_bias_gelu",
            x.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, d,
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[bias.dtype], int(vec),
            _stream(x.device))
    fused_bias_gelu.launches += 1
    return out


fused_bias_gelu.launches = 0


def fused_bias_gelu_bwd_reference(x, bias, dy):
    """Plain PyTorch bias+GELU backward with the JAX kernel's numerics
    (``_bias_gelu_bwd_kernel``, ``fused_layers.py:511-519``): ``u = x +
    bias``, ``gelu'(u) = cdf + u * pdf`` and ``dx = dy * gelu'(u)`` in
    f32, dx in x's dtype, ``dbias = sum(dx)`` over the rows in f32, then
    in bias's dtype. Returns ``(dx, dbias)``."""
    u = x.float() + bias.float()
    cdf = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))
    pdf = torch.exp(-0.5 * u * u) * _INV_SQRT2PI
    dx = dy.float() * (cdf + u * pdf)
    db = dx.reshape(-1, x.shape[-1]).sum(dim=0).to(bias.dtype)
    return dx.to(x.dtype), db


_GELU_BWD_ARGS = [ctypes.c_void_p] * 5 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_GELU_BWD_COLS = 32      # column chunks per CTA (csrc kBwdCols)
_GELU_BWD_ROWS = 8       # row lanes per CTA (csrc kBwdRows)


def fused_bias_gelu_bwd(x, bias, dy):
    """Gradients ``(dx, dbias)`` of ``gelu(x + bias)`` for the output
    gradient ``dy``, recomputed from ``(x, bias)``. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (f32 partial rows
    of dbias per row block of CTAs, summed here, as ``_bias_gelu_pallas``
    sums its partials) or raises."""
    if x.device.type == "cpu":
        return fused_bias_gelu_bwd_reference(x, bias, dy)
    if x.device.type != "cuda" or bias.device != x.device \
            or dy.device != x.device:
        raise MXNetError("fused_bias_gelu_bwd: x, bias and dy must be on "
                         f"one CUDA device (x on {x.device})")
    if x.dtype not in _DTYPE_CODE or bias.dtype not in _DTYPE_CODE \
            or dy.dtype != x.dtype:
        raise MXNetError(f"fused_bias_gelu_bwd: dtypes {x.dtype}/"
                         f"{bias.dtype}/{dy.dtype}: need x and dy in one "
                         "of float32/bfloat16, bias in one of them")
    d = x.shape[-1] if x.dim() else 0
    if x.dim() < 1 or d < 1 or bias.shape != (d,) or dy.shape != x.shape:
        raise MXNetError(f"fused_bias_gelu_bwd: x {tuple(x.shape)}, bias "
                         f"{tuple(bias.shape)}, dy {tuple(dy.shape)}: need "
                         "bias (D,) and dy shaped as x")
    dy = dy.contiguous()
    if not (x.is_contiguous() and bias.is_contiguous()):
        raise MXNetError("fused_bias_gelu_bwd: x and bias must be "
                         "contiguous")
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros(d, dtype=bias.dtype, device=x.device)
    vec = d % 8 == 0 and _aligned(x, bias, dy, dx)
    col_blocks = -(-(d // 8 if vec else d) // _GELU_BWD_COLS)
    row_blocks = max(1, min(-(-rows // _GELU_BWD_ROWS),
                            _bwd_ctas(x.device) // col_blocks, 65535))
    db_part = torch.empty((row_blocks, d), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        _build.call(
            "bias_gelu.cu", "mx_bias_gelu_bwd", _GELU_BWD_ARGS,
            "fused_bias_gelu_bwd", x.data_ptr(), bias.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), db_part.data_ptr(), rows, d,
            row_blocks, _DTYPE_CODE[x.dtype], _DTYPE_CODE[bias.dtype],
            int(vec), _stream(x.device))
    fused_bias_gelu_bwd.launches += 1
    return dx, db_part.sum(dim=0).to(bias.dtype)


fused_bias_gelu_bwd.launches = 0


class _BiasGelu(torch.autograd.Function):
    """``gelu(x + bias)`` with its backward kernel; the forward saves
    ``(x, bias)`` and nothing else (``_bias_gelu_fwd``,
    ``fused_layers.py:554``)."""

    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return _bias_gelu_fwd(x, bias)

    @staticmethod
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors
        return fused_bias_gelu_bwd(x, bias, dy)
