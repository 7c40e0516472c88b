"""Flash attention, forward and backward: the hand-written CUDA kernels
and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/pallas_kernels/flash_attention.py``: the
forward ``_flash_fwd_pallas`` (the whole-head ``pallas_call`` at ``:552``
and the streaming one at ``:590``, one algorithm; ``csrc/
flash_attention.cu``) and the backward ``_flash_bwd_pallas`` (the fused
whole-head sites ``:914``/``:937`` and the streaming dK/dV and dQ pair
``:959``/``:977``, one algorithm; ``csrc/flash_attention_bwd.cu``). Each
source's header comment says what bounds it on an H100 and how its design
answers that. :func:`flash_attention` is differentiable: with autograd
recording, its backward recomputes P from the saved base-2 lse, as
``_flash_bwd`` (``:1018``) does.

Contract, as in the JAX kernel: softmax in base 2 (``scale * log2(e)``
folded into the f32 scores), f32 statistics, the output in the input
dtype, and the per-row logsumexp in base 2, ``m + log2(l)``, as f32 —
the residual the backward and ring attention read as it is. Two
differences of form from the TPU kernel:

* the lse comes back as ``(B * H, Lq)``, not the TPU's sublane tile
  ``(B * H, nq, 8, bq)``;
* any ``Lq, Lk >= 1`` (a masked ragged edge, no ``L % 128`` gate) and
  any head dim ``D <= 256`` with ``D % 8 == 0``.

Causal masking is bottom-right aligned (key ``j`` is visible to query
``i`` iff ``j <= i + Lk - Lq``); causal with ``Lq > Lk`` is rejected, as
``flash_shape_supported`` rejects it. A row that sees no key gives zeros
and lse ``-1e30``. ``layout`` is ``"bhld"`` (B, H, L, D) or ``"blhd"``
(B, L, H, D); the kernel reads either through strides, so the per-head
views of a fused QKV projection need no copy. The backward takes head
dims up to 128.

Dropout on the attention probabilities (``dropout > 0`` with a u32
``seed``), as the TPU kernels drop: the online max, the row sum ``l``
and the lse stay pre-dropout, only the P that enters P.V is masked, and
the output divides by ``l * f32(1 - p)``; the backward regenerates the
mask from the seed (``dV`` from ``keep ? P / (1 - p) : 0``, ``dP``
masked and scaled by f32(1 / (1 - p)) before ``dS = P * (dP -
delta)``), so the autograd node keeps the seed and no mask. The mask is
the two-level position hash of ``kernels/dropout.py``'s
:func:`~mxnet_tpu_torch.kernels.dropout.drop_mask` over the absolute
``(b * H + h, q, k)`` ids with the true ``Lk`` and no causal offset, in
every layout.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError
from . import _build
from .dropout import attn_keep_mask, check_dropout, dropout_thresh, f32, \
    kernel_args

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference", "LOG2E", "NO_KEY_LSE"]

LOG2E = 1.4426950408889634
NO_KEY_LSE = -1e30
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128
_BLOCK_Q = 64                     # query rows per CTA (csrc kBM)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DROP_ARGS = [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int] + _DROP_ARGS \
    + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_int] + _DROP_ARGS + [ctypes.c_void_p]


def _dims(q, k, v, layout):
    if layout not in ("bhld", "blhd"):
        raise MXNetError(f"flash_attention: layout {layout!r} is not "
                         "'bhld' or 'blhd'")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise MXNetError("flash_attention: q, k and v must be 4-D")
    if layout == "blhd":
        (b, lq, h, d), (bk, lk, hk, dk) = q.shape, k.shape
    else:
        (b, h, lq, d), (bk, hk, lk, dk) = q.shape, k.shape
    if (bk, hk, dk) != (b, h, d) or v.shape != k.shape:
        raise MXNetError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} do not agree in batch, heads and head dim "
            f"({layout})")
    return b, h, lq, lk, d


def _check(q, k, v, causal, layout):
    b, h, lq, lk, d = _dims(q, k, v, layout)
    if lq < 1 or lk < 1:
        raise MXNetError(f"flash_attention: need Lq, Lk >= 1, got {lq}, "
                         f"{lk}")
    if causal and lq > lk:
        raise MXNetError(
            f"flash_attention: causal with Lq {lq} > Lk {lk} leaves the "
            "first query rows no visible key (bottom-right alignment); "
            "use sdp_attention, which takes the dense path for it")
    return b, h, lq, lk, d


def _bhld(x, layout):
    return x.transpose(1, 2) if layout == "blhd" else x


def _reference(q, k, v, scale, causal, causal_offset, layout, dropout=0.0,
               seed=None):
    """The plain version with an explicit causal offset (the public
    functions use ``Lk - Lq``; a negative offset makes rows with no
    visible key) and the kernels' dropout."""
    qh, kh, vh = (_bhld(t, layout) for t in (q, k, v))
    b, h, lq, d = qh.shape
    lk = kh.shape[2]
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        * (float(scale) * LOG2E)
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None]
        kpos = torch.arange(lk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos + causal_offset, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_use = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp2(s - m_use)
    l = p.sum(dim=-1, keepdim=True)
    div = l
    if dropout > 0.0:
        keep = attn_keep_mask(b, h, lq, lk, seed, dropout_thresh(dropout),
                              q.device)
        p = torch.where(keep, p, torch.zeros((), device=q.device))
        div = l * torch.tensor(f32(1.0 - dropout))
    # P rounds to v's dtype before the product, as in the kernels
    o = torch.matmul(p.to(v.dtype).float(), vh.float())
    o = o / torch.where(l > 0, div, torch.ones_like(l))
    lse = torch.where(l > 0, m + torch.log2(torch.where(l > 0, l,
                                                        torch.ones_like(l))),
                      torch.full_like(l, NO_KEY_LSE))
    out = o.to(q.dtype)
    if layout == "blhd":
        out = out.transpose(1, 2).contiguous()
    return out, lse.reshape(b * h, lq)


def flash_attention_reference(q, k, v, scale=None, causal=False,
                              layout="bhld", dropout=0.0, seed=None):
    """Plain PyTorch version of :func:`flash_attention_fwd`: dense f32
    scores in base 2, the masked softmax, P dropped (``dropout > 0``) and
    rounded to v's dtype, f32 P.V divided by ``l`` (times f32(1 - p)
    with dropout). Returns ``(out, lse)``."""
    dropout, seed = check_dropout(dropout, seed, "flash_attention")
    _, _, lq, lk, d = _check(q, k, v, causal, layout)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _reference(q, k, v, scale, causal, lk - lq, layout, dropout,
                      seed)


def _strides(x, layout):
    """(batch, head, seq) element strides of a tensor in ``layout``."""
    if layout == "blhd":
        return x.stride(0), x.stride(2), x.stride(1)
    return x.stride(0), x.stride(1), x.stride(2)


def _strides_ok(t) -> bool:
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
        and all(s % 8 == 0 for s in t.stride()[:3])


def _c_strides(tensors, layout):
    """The (batch, head, seq) strides of ``tensors`` as one ctypes
    array, after checking the layout the kernels read."""
    strides = []
    for t in tensors:
        if not _strides_ok(t):
            raise MXNetError(
                f"flash_attention: a tensor with strides {t.stride()} and "
                f"address {t.data_ptr():#x}: the head dim must be "
                "contiguous, the other strides multiples of 8 and the "
                "base 16-byte aligned (call .contiguous())")
        strides.extend(_strides(t, layout))
    return (ctypes.c_longlong * len(strides))(*strides)


def _launch(q, k, v, scale, causal, causal_offset, layout, dropout=0.0,
            seed=None):
    """Launch the kernel on CUDA tensors already shape-checked; returns
    ``(out, lse)``."""
    b, h, lq, lk, d = _dims(q, k, v, layout)
    if any(t.device != q.device for t in (k, v)):
        raise MXNetError("flash_attention: q, k and v must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise MXNetError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}: need one of float32, bfloat16 for "
                         "all three")
    if d % 8 or d > MAX_HEAD_DIM:
        raise MXNetError(f"flash_attention: head dim {d} must be a "
                         f"multiple of 8 and <= {MAX_HEAD_DIM}")
    if -(-lq // _BLOCK_Q) > 65535:
        raise MXNetError(f"flash_attention: Lq {lq} exceeds the grid "
                         f"({65535 * _BLOCK_Q} rows)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    c_strides = _c_strides((q, k, v, out), layout)
    with torch.cuda.device(q.device):
        _build.call(
            "flash_attention.cu", "mx_flash_attention_fwd", _ARGS,
            "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), ctypes.addressof(c_strides), b,
            h, lq, lk, d, float(scale) * LOG2E, int(bool(causal)),
            int(causal_offset), _DTYPE_CODE[q.dtype],
            *kernel_args(dropout, seed, f32(1.0 - dropout)),
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    flash_attention.dropout_launches += int(dropout > 0.0)
    return out, lse


def flash_attention_fwd(q, k, v, scale=None, causal=False, layout="bhld",
                        dropout=0.0, seed=None):
    """Attention and its base-2 logsumexp: returns ``(out, lse)`` with
    ``out`` shaped and laid out as ``q`` (contiguous) in q's dtype and
    ``lse`` (B * H, Lq) float32; ``dropout`` in [0, 1) with a u32
    ``seed`` when above 0. See the module docstring."""
    dropout, seed = check_dropout(dropout, seed, "flash_attention")
    _, _, lq, lk, d = _check(q, k, v, causal, layout)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _reference(q, k, v, scale, causal, lk - lq, layout, dropout,
                          seed)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, scale, causal, lk - lq, layout, dropout, seed)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _bwd_reference(q, k, v, o, lse, do, scale, causal, causal_offset,
                   layout, dropout=0.0, seed=None):
    """The plain backward with an explicit causal offset: P recomputed
    densely in base 2 from the saved lse, f32 products, the dropped P
    (``keep ? P * f32(1 / (1 - p)) : 0``) rounded to v's dtype before
    P^T.dO, dP dropped the same way, and dS to q's dtype before dS.K and
    dS^T.Q, as in the kernels and ``_bwd_fused_kernel``
    (``flash_attention.py:743``)."""
    qh, kh, vh, oh, doh = (_bhld(t, layout).float()
                           for t in (q, k, v, o, do))
    b, h, lq, d = qh.shape
    lk = kh.shape[2]
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (float(scale) * LOG2E)
    if causal:
        qpos = torch.arange(lq, device=q.device)[:, None]
        kpos = torch.arange(lk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos + causal_offset, float("-inf"))
    p = torch.exp2(s - lse.reshape(b, h, lq, 1))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    pd = p
    if dropout > 0.0:
        keep = attn_keep_mask(b, h, lq, lk, seed, dropout_thresh(dropout),
                              q.device)
        inv = torch.tensor(f32(1.0 / (1.0 - dropout)))
        zero = torch.zeros((), device=q.device)
        pd = torch.where(keep, p * inv, zero)
        dp = torch.where(keep, dp * inv, zero)
    dv = torch.matmul(pd.to(v.dtype).float().transpose(-1, -2), doh)
    ds = p * (dp - delta) * float(scale)
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    outs = []
    for g, like in ((dq, q), (dk, k), (dv, v)):
        g = g.to(like.dtype)
        if layout == "blhd":
            g = g.transpose(1, 2)
        outs.append(g.contiguous())
    return tuple(outs)


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale=None,
                                  causal=False, layout="bhld", dropout=0.0,
                                  seed=None):
    """Plain PyTorch version of :func:`flash_attention_bwd`."""
    dropout, seed = check_dropout(dropout, seed, "flash_attention_bwd")
    _, _, lq, lk, d = _check(q, k, v, causal, layout)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return _bwd_reference(q, k, v, o, lse, do, scale, causal, lk - lq,
                          layout, dropout, seed)


def _launch_bwd(q, k, v, o, lse, do, scale, causal, causal_offset, layout,
                dropout=0.0, seed=None):
    """Launch the backward kernels on CUDA tensors already shape-checked;
    returns ``(dq, dk, dv)``, each contiguous in ``layout``."""
    b, h, lq, lk, d = _dims(q, k, v, layout)
    if any(t.device != q.device for t in (k, v, o, lse, do)):
        raise MXNetError("flash_attention_bwd: every input must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype
                                         for t in (k, v, o, do)):
        raise MXNetError(f"flash_attention_bwd: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}/{o.dtype}/{do.dtype}: need one of "
                         "float32, bfloat16 for all five")
    if d % 8 or d > MAX_BWD_HEAD_DIM:
        raise MXNetError(f"flash_attention_bwd: head dim {d} must be a "
                         f"multiple of 8 and <= {MAX_BWD_HEAD_DIM}")
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (b * h, lq) or lse.dtype != torch.float32:
        raise MXNetError(
            f"flash_attention_bwd: o {tuple(o.shape)}, do "
            f"{tuple(do.shape)} must be shaped as q {tuple(q.shape)}, and "
            f"lse {tuple(lse.shape)} float32 ({b * h}, {lq})")
    if -(-max(lq, lk) // _BLOCK_Q) > 65535:
        raise MXNetError(f"flash_attention_bwd: L {max(lq, lk)} exceeds "
                         f"the grid ({65535 * _BLOCK_Q} rows)")
    if not _strides_ok(do):
        do = do.contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    delta = torch.empty((b * h, lq), dtype=torch.float32, device=q.device)
    c_strides = _c_strides((q, k, v, o, do, dq, dk, dv), layout)
    with torch.cuda.device(q.device):
        _build.call(
            "flash_attention_bwd.cu", "mx_flash_attention_bwd", _BWD_ARGS,
            "flash_attention_bwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            ctypes.addressof(c_strides), b, h, lq, lk, d, float(scale),
            float(scale) * LOG2E, int(bool(causal)), int(causal_offset),
            _DTYPE_CODE[q.dtype],
            *kernel_args(dropout, seed, f32(1.0 / (1.0 - dropout))),
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.dropout_launches += int(dropout > 0.0)
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale=None, causal=False,
                        layout="bhld", dropout=0.0, seed=None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` for the
    output gradient ``do``, from the forward's inputs, output ``o``,
    base-2 ``lse`` (B * H, Lq) and dropout rate and seed. Each gradient
    has its input's shape and dtype, contiguous in ``layout``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernels
    (delta pre-pass, dK/dV, dQ; one count) or raises."""
    dropout, seed = check_dropout(dropout, seed, "flash_attention_bwd")
    _, _, lq, lk, d = _check(q, k, v, causal, layout)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _bwd_reference(q, k, v, o, lse, do, scale, causal, lk - lq,
                              layout, dropout, seed)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    return _launch_bwd(q, k, v, o, lse, do, scale, causal, lk - lq, layout,
                       dropout, seed)


flash_attention_bwd.launches = 0
flash_attention_bwd.dropout_launches = 0    # the launches with dropout


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward saves q, k, v,
    the output, the base-2 lse and the dropout seed, not a mask
    (``_flash_fwd``, ``:1012``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, layout, dropout, seed):
        out, lse = flash_attention_fwd(q, k, v, scale, causal, layout,
                                       dropout, seed)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (scale, causal, layout, dropout, seed)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, scale=None, causal=False, layout="bhld",
                    dropout=0.0, seed=None):
    """Scaled dot-product attention without a mask (see the module
    docstring), with attention-probability ``dropout`` under the u32
    ``seed`` (required when ``dropout > 0``); the output only.
    Differentiable: with autograd recording and an input that requires
    grad it goes through :func:`flash_attention_bwd` in the backward;
    otherwise (serving under ``torch.inference_mode()``) it launches the
    forward alone."""
    dropout, seed = check_dropout(dropout, seed, "flash_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        return _FlashAttention.apply(q, k, v, scale, causal, layout,
                                     dropout, seed)
    return flash_attention_fwd(q, k, v, scale, causal, layout, dropout,
                               seed)[0]


flash_attention.launches = 0
flash_attention.dropout_launches = 0    # the launches with dropout > 0
