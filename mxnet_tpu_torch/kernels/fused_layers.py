"""Fused RMSNorm forward: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``mxnet_tpu/pallas_kernels/fused_layers.py`` in RMS mode
(forward only; the backward, the LayerNorm+residual+dropout mode and the
bias+GELU epilogue come with the training slice). The kernel is
``csrc/rms_norm.cu``; its header comment says what bounds it on an H100
and how its design answers that.

Routing is by device only: a CPU tensor takes the plain version (the CPU
tests' path), a CUDA tensor launches the kernel or raises. There is no
knob and no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["fused_rms_norm", "fused_rms_norm_reference", "MAX_D"]

MAX_D = 8192
_SRC = "rms_norm.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, *,
                             eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch RMSNorm with the JAX kernel's numerics
    (``fused_layers.py:172-176``): f32 statistics, the normalised value
    rounded to x's dtype, then the weight multiply, whose promotion sets
    the output dtype."""
    x32 = x.float()
    inv = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv).to(x.dtype) * weight


def _lib() -> ctypes.CDLL:
    lib = _build.load(_SRC)
    fn = lib.mx_rms_norm_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


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
    vec = (d % 8 == 0 and x.data_ptr() % 16 == 0
           and weight.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mx_rms_norm_fwd(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d,
            float(eps), _DTYPE_CODE[x.dtype], _DTYPE_CODE[weight.dtype],
            int(vec), stream)
    _build.check(lib, rc, "fused_rms_norm")
    fused_rms_norm.launches += 1
    return out


fused_rms_norm.launches = 0
