"""Paged single-query (decode) attention: the hand-written CUDA kernel and
its plain PyTorch version.

Counterpart of ``mxnet_tpu/pallas_kernels/paged_attention.py``, with the
same contract: ``q`` (B, H, 1, D); ``k_arena``/``v_arena`` (slots, KV, D)
for ONE layer; ``page_table`` (B, P) int32 page ids, page 0 the scratch
page that pads the tail; ``lengths`` (B,) int32 valid tokens per row.
The output is (B, H, 1, D) in q's dtype. Grouped-query attention groups
the H / KV q heads of each kv head and never repeats K or V; positions at
or past ``lengths`` are masked; a row with ``lengths == 0`` emits zeros
(``_decode_kernel``'s all-masked pin, ``paged_attention.py:105-109``).

The kernel is ``csrc/paged_attention.cu``; its header comment says what
bounds it on an H100 and how its design answers that. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["paged_attention_kernel", "paged_attention_reference"]

_SRC = "paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


def paged_attention_reference(q, k_arena, v_arena, page_table, lengths, *,
                              page_size: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather each row's pages,
    grouped f32 scores, masked f32 softmax, f32 P.V, zeros for an empty
    row."""
    b, h, _, d = q.shape
    kv = k_arena.shape[-2]
    ps = int(page_size)
    slots = (page_table.long()[:, :, None] * ps
             + torch.arange(ps, device=q.device)).reshape(b, -1)  # (B, T)
    k = k_arena[slots].float()                                    # (B,T,KV,D)
    v = v_arena[slots].float()
    qg = q.reshape(b, kv, h // kv, d).float() * scale
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    valid = (torch.arange(slots.shape[1], device=q.device)[None, :]
             < lengths.long()[:, None])                           # (B, T)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    o = torch.einsum("bkgt,btkd->bkgd", p, v) / denom
    return o.reshape(b, h, 1, d).to(q.dtype)


_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check(q, k_arena, v_arena, page_table, lengths, page_size) -> None:
    tensors = (q, k_arena, v_arena, page_table, lengths)
    if any(t.device != q.device for t in tensors):
        raise MXNetError("paged_attention_kernel: all inputs must be on "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE or k_arena.dtype != q.dtype \
            or v_arena.dtype != q.dtype:
        raise MXNetError(
            f"paged_attention_kernel: q/k/v dtypes {q.dtype}/"
            f"{k_arena.dtype}/{v_arena.dtype}: need one of float32, "
            "bfloat16 for all three")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise MXNetError("paged_attention_kernel: page_table and lengths "
                         "must be int32")
    if q.dim() != 4 or q.shape[2] != 1:
        raise MXNetError(f"paged_attention_kernel: q {tuple(q.shape)} must "
                         "be (B, H, 1, D)")
    b, h, _, d = q.shape
    if k_arena.dim() != 3 or k_arena.shape != v_arena.shape \
            or k_arena.shape[-1] != d:
        raise MXNetError(
            f"paged_attention_kernel: arenas {tuple(k_arena.shape)}/"
            f"{tuple(v_arena.shape)} must both be (slots, KV, {d})")
    kv = k_arena.shape[1]
    if d not in _HEAD_DIMS or h % kv or h // kv not in _GROUPS:
        raise MXNetError(
            f"paged_attention_kernel: head dim {d} (need {_HEAD_DIMS}) and "
            f"H/KV = {h}/{kv} (need a group size in {_GROUPS})")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or lengths.shape != (b,):
        raise MXNetError(
            f"paged_attention_kernel: page_table {tuple(page_table.shape)} "
            f"and lengths {tuple(lengths.shape)} must be (B, P) and (B,) "
            f"with B = {b}")
    if int(page_size) < 1 or k_arena.shape[0] % int(page_size):
        raise MXNetError(
            f"paged_attention_kernel: page_size {page_size} must divide "
            f"the arena's {k_arena.shape[0]} slots")
    if not all(t.is_contiguous() for t in tensors):
        raise MXNetError("paged_attention_kernel: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_arena, v_arena)):
        raise MXNetError("paged_attention_kernel: q and the arenas must be "
                         "16-byte aligned")


def paged_attention_kernel(q, k_arena, v_arena, page_table, lengths, *,
                           page_size: int, scale: float) -> torch.Tensor:
    """Decode attention over paged K/V (see the module docstring)."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_arena, v_arena, page_table,
                                         lengths, page_size=page_size,
                                         scale=scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_attention_kernel: unsupported device "
                         f"{q.device}")
    _check(q, k_arena, v_arena, page_table, lengths, page_size)
    b, h, _, d = q.shape
    kv = k_arena.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        _build.call(
            _SRC, "mx_paged_attention_decode", _ARGS,
            "paged_attention_kernel", q.data_ptr(), k_arena.data_ptr(),
            v_arena.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, kv, d, page_table.shape[1],
            int(page_size), float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
