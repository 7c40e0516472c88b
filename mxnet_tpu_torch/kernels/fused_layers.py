"""Fused row kernels: RMSNorm, LayerNorm(+ residual) and the bias+GELU
epilogue, each a hand-written CUDA kernel beside its plain PyTorch
version.

Counterpart of ``mxnet_tpu/pallas_kernels/fused_layers.py`` on its
forward paths: ``_norm_fwd_kernel`` in RMS mode (``csrc/rms_norm.cu``)
and in LayerNorm mode with and without the residual
(``csrc/layer_norm.cu``), and ``_bias_gelu_fwd_kernel``
(``csrc/bias_gelu.cu``). The backward kernels and the position-hash
dropout come with the training slice; ``dropout > 0`` raises until then.
Each source's header comment says what bounds it on an H100 and how its
design answers that.

Routing is by device only: a CPU tensor takes the plain version (the CPU
tests' path), a CUDA tensor launches the kernel or raises. There is no
knob and no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["fused_rms_norm", "fused_rms_norm_reference",
           "fused_layer_norm", "fused_layer_norm_reference",
           "fused_bias_gelu", "fused_bias_gelu_reference", "MAX_D"]

MAX_D = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INV_SQRT2 = 0.7071067811865476
_NO_DROPOUT = ("dropout > 0 needs the position-hash dropout of the "
               "training slice (ROADMAP.md, port queue 2, item 0)")


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def fused_rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, *,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch RMSNorm with the JAX kernel's numerics
    (``fused_layers.py:172-176``): f32 statistics, the normalised value
    rounded to x's dtype, then the weight multiply, whose promotion sets
    the output dtype."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * weight


_RMS_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis. ``x``: (..., D) float32 or bfloat16,
    contiguous, D <= 8192; ``weight``: (D,) float32 or bfloat16. Output
    dtype is ``promote_types(x.dtype, weight.dtype)``."""
    if x.device.type == "cpu":
        return fused_rms_norm_reference(x, weight, eps=eps)
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
    rows = x.numel() // d
    if rows == 0:
        return out
    vec = d % 8 == 0 and _aligned(x, weight, out)
    with torch.cuda.device(x.device):
        _build.call(
            "rms_norm.cu", "mx_rms_norm_fwd", _RMS_ARGS, "fused_rms_norm",
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
            float(eps), _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype],
            int(vec), _stream(x.device))
    fused_rms_norm.launches += 1
    return out


fused_rms_norm.launches = 0


# ---------------------------------------------------------------------------
# LayerNorm (+ residual)
# ---------------------------------------------------------------------------

def fused_layer_norm_reference(x, gamma, beta, residual=None, *,
                               eps: float = 1e-5, dropout: float = 0.0,
                               return_stats: bool = False):
    """Plain PyTorch ``LayerNorm(x + residual)`` with the JAX kernel's
    numerics (``_norm_fwd_kernel``, ``fused_layers.py:208-233``): the sum
    in f32, two-pass f32 statistics (the mean, then the mean of
    ``(h - mean)**2``), ``(h - mean) * rstd * gamma + beta`` in f32,
    rounded once to x's dtype. ``return_stats`` also returns the f32
    per-row ``(mean, rstd)``, shaped ``x.shape[:-1]``."""
    if dropout > 0.0:
        raise MXNetError(f"fused_layer_norm: {_NO_DROPOUT}")
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    mean = h.mean(dim=-1, keepdim=True)
    hc = h - mean
    rstd = torch.rsqrt((hc * hc).mean(dim=-1, keepdim=True) + eps)
    out = (hc * rstd * gamma.float() + beta.float()).to(x.dtype)
    if return_stats:
        return out, mean.squeeze(-1), rstd.squeeze(-1)
    return out


_LN_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]


def fused_layer_norm(x, gamma, beta, residual=None, *, eps: float = 1e-5,
                     dropout: float = 0.0, return_stats: bool = False):
    """``LayerNorm(x + residual)`` over the last axis (the post-LN
    transformer cell's add+norm; ``residual=None`` is a plain LayerNorm).

    ``x``: (..., D) float32 or bfloat16, contiguous, 0 < D <= 8192;
    ``residual``: None or x's shape and dtype; ``gamma``/``beta``: (D,),
    both float32 or both bfloat16. The output has x's dtype.
    ``return_stats`` also returns the f32 per-row ``(mean, rstd)`` the
    backward of the training slice recomputes xhat from."""
    if dropout > 0.0:
        raise MXNetError(f"fused_layer_norm: {_NO_DROPOUT}")
    if x.device.type == "cpu":
        return fused_layer_norm_reference(x, gamma, beta, residual, eps=eps,
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
                _DTYPE_CODE[gamma.dtype], int(vec), _stream(x.device))
        fused_layer_norm.launches += 1
    if return_stats:
        return out, mean, rstd
    return out


fused_layer_norm.launches = 0


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
    float32 or bfloat16. The output has x's dtype."""
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
