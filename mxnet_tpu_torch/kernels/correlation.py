"""Correlation, FlowNet's cost volume: the hand-written CUDA kernels
(``csrc/correlation.cu``), forward and backward, and their plain PyTorch
version.

No Pallas site: the reference's ``correlation`` (``mxnet_tpu/ops/
deformable.py:95-141``) loops over the displacements, each a roll, a
product and a channel mean over the padded maps, which XLA fuses. The
plain version here computes the same sums from strided views of the
padded maps at the output grid alone (the roll never wraps there), one
displacement at a time, so that autograd keeps views and no shifted copy;
its gradient is autograd's. The kernel's header says what it computes and
what bounds it on an H100.

:func:`correlation` is the op's entry: a CPU tensor takes the plain
version; a CUDA tensor goes through :class:`_Correlation`, whose forward
is one ``corr_fwd_kernel`` launch (``correlation.launches``) and whose
backward one ``corr_bwd_kernel`` launch for both inputs' gradients
(``correlation_bwd.launches``). Anything else raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..base import MXNetError
from . import _build

__all__ = ["correlation", "correlation_bwd", "correlation_reference",
           "correlation_geometry", "CorrGeometry"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


class CorrGeometry(NamedTuple):
    """The reference's grids (``deformable.py:113-124``): the
    displacements ``stride2 * (i - radius)``, i < d, and the output's
    padded rows and columns ``border + stride1 * i``, i < ho (wo)."""
    radius: int
    d: int
    border: int
    klo: int                    # the window's rows above its centre
    ho: int
    wo: int


def correlation_geometry(h, w, kernel_size, max_displacement, stride1,
                         stride2, pad_size) -> CorrGeometry:
    k, dmax = int(kernel_size), int(max_displacement)
    radius = dmax // int(stride2)
    border = dmax + k // 2
    s1 = int(stride1)
    hp, wp = h + 2 * int(pad_size), w + 2 * int(pad_size)
    ho = len(range(border, hp - border, s1))
    wo = len(range(border, wp - border, s1))
    return CorrGeometry(radius, 2 * radius + 1, border, (k - 1) // 2, ho, wo)


def correlation_reference(data1, data2, kernel_size=1, max_displacement=1,
                          stride1=1, stride2=1, pad_size=0,
                          is_multiply=True):
    """Plain PyTorch correlation of ``data1`` and ``data2`` (b, c, h, w):
    (b, d * d, ho, wo) in data1's dtype, f32 arithmetic, differentiable
    in both inputs (``|a - b|``'s gradient JAX's: +1 where a = b)."""
    from ..ops.elemwise import _abs

    b, c, h, w = data1.shape
    p, k, s1, s2 = int(pad_size), int(kernel_size), int(stride1), \
        int(stride2)
    g = correlation_geometry(h, w, k, max_displacement, s1, s2, p)
    a = F.pad(data1.float(), (p, p, p, p))
    bb = F.pad(data2.float(), (p, p, p, p))
    if g.ho == 0 or g.wo == 0:
        return data1.new_zeros((b, g.d * g.d, g.ho, g.wo))

    def at(t, y, x):
        """t's (padded) rows y + s1 i and columns x + s1 j, i < ho, j <
        wo: a strided view."""
        return t[:, :, y:y + s1 * (g.ho - 1) + 1:s1,
                 x:x + s1 * (g.wo - 1) + 1:s1]

    shifts = [s2 * (i - g.radius) for i in range(g.d)]
    outs = []
    for dy in shifts:
        for dx in shifts:
            acc = None
            for u in range(k):
                for v in range(k):
                    y, x = g.border - g.klo + u, g.border - g.klo + v
                    pa, pb = at(a, y, x), at(bb, y + dy, x + dx)
                    term = pa * pb if is_multiply else _abs(pa - pb)
                    acc = term if acc is None else acc + term
            outs.append(acc.mean(dim=1))
    out = torch.stack(outs, dim=1) / (k * k if k > 1 else 1)
    return out.to(data1.dtype)


def _kernel_dtype(data1, data2):
    """Both bf16: bf16; otherwise f32 (a bf16 input is widened, exactly)."""
    if data1.dtype == data2.dtype == torch.bfloat16:
        return torch.bfloat16
    for t in (data1, data2):
        if t.dtype not in _DTYPE_CODE:
            raise MXNetError("correlation: the kernel takes float32 or "
                             f"bfloat16 maps, not {t.dtype}")
    return torch.float32


def _args(a, cfg):
    k, dmax, s1, s2, p, mult = cfg
    b, c, h, w = a.shape
    return (_DTYPE_CODE[a.dtype], b, c, h, w, p, k, dmax, s1, s2, int(mult))


def _kernel_fwd(a, bb, cfg):
    k, dmax, s1, s2, p, _ = cfg
    g = correlation_geometry(a.shape[2], a.shape[3], k, dmax, s1, s2, p)
    out = torch.empty((a.shape[0], g.d * g.d, g.ho, g.wo), dtype=a.dtype,
                      device=a.device)
    with torch.cuda.device(a.device):
        _build.call("correlation.cu", "mx_correlation_fwd", _FWD_ARGS,
                    "correlation", a.data_ptr(), bb.data_ptr(),
                    out.data_ptr(), *_args(a, cfg),
                    torch.cuda.current_stream(a.device).cuda_stream)
    correlation.launches += 1
    return out


def correlation_bwd(grad, data1, data2, kernel_size=1, max_displacement=1,
                    stride1=1, stride2=1, pad_size=0, is_multiply=True):
    """The backward kernel on CUDA tensors of one dtype (f32 or bf16):
    (d data1, d data2) from the head gradient (b, d * d, ho, wo), one
    launch (``correlation_bwd.launches``)."""
    if data1.device.type != "cuda" or data1.dtype != data2.dtype \
            or data1.shape != data2.shape or data1.dtype not in _DTYPE_CODE:
        raise MXNetError("correlation_bwd: the kernel takes two CUDA maps of "
                         "one shape and dtype (float32 or bfloat16)")
    cfg = (int(kernel_size), int(max_displacement), int(stride1),
           int(stride2), int(pad_size), bool(is_multiply))
    a, bb = data1.contiguous(), data2.contiguous()
    g = correlation_geometry(a.shape[2], a.shape[3], *cfg[:5])
    grad = grad.float().contiguous()
    if grad.shape != (a.shape[0], g.d * g.d, g.ho, g.wo):
        raise MXNetError(f"correlation_bwd: head gradient "
                         f"{tuple(grad.shape)} is not "
                         f"{(a.shape[0], g.d * g.d, g.ho, g.wo)}")
    da, db = torch.empty_like(a), torch.empty_like(bb)
    with torch.cuda.device(a.device):
        _build.call("correlation.cu", "mx_correlation_bwd", _BWD_ARGS,
                    "correlation_bwd", grad.data_ptr(), a.data_ptr(),
                    bb.data_ptr(), da.data_ptr(), db.data_ptr(),
                    *_args(a, cfg),
                    torch.cuda.current_stream(a.device).cuda_stream)
    correlation_bwd.launches += 1
    return da, db


class _Correlation(torch.autograd.Function):
    """The kernels as one differentiable function of (data1, data2), both
    already in the kernel's dtype."""

    @staticmethod
    def forward(ctx, a, bb, cfg):
        ctx.save_for_backward(a, bb)
        ctx.cfg = cfg
        return _kernel_fwd(a, bb, cfg)

    @staticmethod
    def backward(ctx, g):
        a, bb = ctx.saved_tensors
        k, dmax, s1, s2, p, mult = ctx.cfg
        da, db = correlation_bwd(g, a, bb, k, dmax, s1, s2, p, mult)
        return da, db, None


def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """The cost volume (b, d * d, ho, wo) of ``data1`` and ``data2`` (b, c,
    h, w) in data1's dtype (see the module docstring); on the card one
    forward kernel, and one backward kernel under autograd."""
    if data1.device.type == "cpu":
        return correlation_reference(data1, data2, kernel_size,
                                     max_displacement, stride1, stride2,
                                     pad_size, is_multiply)
    if data1.device.type != "cuda" or data2.device != data1.device:
        raise MXNetError(f"correlation: unsupported devices {data1.device}, "
                         f"{data2.device}")
    if data1.dim() != 4 or data1.shape != data2.shape:
        raise MXNetError("correlation: data1 and data2 must be (b, c, h, w) "
                         "of one shape")
    kd = _kernel_dtype(data1, data2)
    cfg = (int(kernel_size), int(max_displacement), int(stride1),
           int(stride2), int(pad_size), bool(is_multiply))
    out = _Correlation.apply(data1.to(kd).contiguous(),
                             data2.to(kd).contiguous(), cfg)
    return out.to(data1.dtype)


correlation.launches = 0
correlation_bwd.launches = 0
