"""The 2-bit gradient quantizer with error feedback: the hand-written
CUDA kernel and its plain PyTorch version.

Counterpart of the jitted ``_q`` of
``mxnet_tpu/kvstore/gradient_compression.py`` (``:68-73``), which XLA
fuses on the TPU (not a Pallas site, as ``dropout_op``'s hash branch is
not). The kernel is ``csrc/gradient_compression.cu``; its header comment
says what bounds it on an H100. Per element, for the threshold t::

    g2 = f32(g) + r;  o = t if g2 >= t else (-t if g2 <= -t else 0)
    r  = g2 - o       (in place, f32);  q = o cast to g's dtype

The residual keeps the unrounded f32 t while ``q`` carries t rounded to
bf16/f16, exactly as the reference's ``astype`` does. NaN gives q 0 and
r NaN; +-inf gives q +-t and r +-inf. The two versions agree bit for bit.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from . import _build

__all__ = ["twobit_quantize", "twobit_quantize_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_THREADS = 256
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
_SMS = {}


def _t32(threshold) -> float:
    t = float(np.float32(threshold))
    if not t > 0:
        raise MXNetError("gradient compression threshold must be > 0")
    return t


def twobit_quantize_reference(g: torch.Tensor, r: torch.Tensor,
                              threshold: float) -> torch.Tensor:
    """Plain PyTorch quantizer: returns ``q`` (g's dtype and shape) and
    updates the f32 residual ``r`` in place; one op per step of the
    reference's ``_q``, in f32."""
    t = _t32(threshold)
    g2 = g.float() + r
    pos = torch.full_like(g2, t)
    zero = torch.zeros_like(g2)
    out = torch.where(g2 >= t, pos, torch.where(g2 <= -t, -pos, zero))
    r.copy_(g2 - out)
    return out.to(g.dtype)


def _sms(dev) -> int:
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def twobit_quantize(g: torch.Tensor, r: torch.Tensor, threshold: float,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize ``g + r`` to {-t, 0, +t} in g's dtype and keep the error
    in the f32 residual ``r`` (updated in place); returns ``q`` (``out``
    when given: g's dtype and shape, overlapping neither ``g`` nor
    ``r``). ``g``: float32, bfloat16 or float16; ``r``: float32 of g's
    shape. On the card: one launch per call over contiguous tensors."""
    if g.device.type == "cpu":
        q = twobit_quantize_reference(g, r, threshold)
        if out is None:
            return q
        out.copy_(q)
        return out
    if g.device.type != "cuda":
        raise MXNetError(f"twobit_quantize: unsupported device {g.device}")
    t = _t32(threshold)
    if g.dtype not in _DTYPE_CODE:
        raise MXNetError(f"twobit_quantize: gradient dtype {g.dtype} is not "
                         "float32, bfloat16 or float16")
    if r.dtype != torch.float32 or r.shape != g.shape \
            or r.device != g.device:
        raise MXNetError("twobit_quantize: the residual must be float32 of "
                         "the gradient's shape, on its device")
    if not (g.is_contiguous() and r.is_contiguous()):
        raise MXNetError("twobit_quantize: gradient and residual must be "
                         "contiguous")
    if out is None:
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
    elif out.dtype != g.dtype or out.shape != g.shape \
            or not out.is_contiguous():
        raise MXNetError("twobit_quantize: out must be a contiguous tensor "
                         "of the gradient's dtype and shape")
    n = g.numel()
    if n == 0:
        return out
    gw = 4 * g.element_size()
    vec = (n % 4 == 0 and g.data_ptr() % gw == 0
           and out.data_ptr() % gw == 0 and r.data_ptr() % 16 == 0)
    chunks = n // 4 if vec else n
    dev = g.device
    ctas = max(1, min(-(-chunks // _THREADS), _sms(dev) * 8))
    with torch.cuda.device(dev):
        _build.call("gradient_compression.cu", "mx_twobit_quantize", _ARGS,
                    "twobit_quantize", g.data_ptr(), r.data_ptr(),
                    out.data_ptr(), n, t, _DTYPE_CODE[g.dtype], int(vec),
                    ctas, torch.cuda.current_stream(dev).cuda_stream)
    twobit_quantize.launches += 1
    return out


twobit_quantize.launches = 0
