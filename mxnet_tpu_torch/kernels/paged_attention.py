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

The kernel is ``csrc/paged_attention.cu`` (flash-decoding: a split
kernel over runs of each row's pages, then a combine kernel); its header
comment says what bounds it on an H100 and how its design answers that.
:func:`paged_splits` picks the number of runs from static shapes alone,
so the wrapper never reads ``lengths`` on the host, and
:func:`paged_attention_split_reference` is the plain version of the
split and the merge. A CPU tensor takes the plain version; a CUDA tensor
launches the kernels or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["paged_attention_kernel", "paged_attention_reference",
           "paged_attention_split_reference", "paged_splits"]

_SRC = "paged_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
_CTAS_PER_SM = 4          # the split kernel's target occupancy
_RUN_TOKENS = 64          # csrc kWarps x kTile: a tile per warp and run
_MAX_RUN_PAGES = 4096     # page ids a run holds in shared memory


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
    # slots past a row's length are zeros, as the kernel's zero-filled
    # copies: a stale NaN there must not reach P.V as 0 * NaN
    v = v.masked_fill(~valid[:, :, None, None], 0.0)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    o = torch.einsum("bkgt,btkd->bkgd", p, v) / denom
    return o.reshape(b, h, 1, d).to(q.dtype)


def paged_splits(b: int, kv: int, width: int, page_size: int,
                 sms: int) -> int:
    """How many runs the kernel splits each row's ``width`` table columns
    into: about ``_CTAS_PER_SM`` CTAs per SM (``sms`` of them) over the
    ``b * kv`` (row, kv head) pairs, at least ``_RUN_TOKENS`` tokens of capacity per run, at
    most ``_MAX_RUN_PAGES`` pages per run, and no run without a column.
    Static shapes only: ``lengths`` is never read."""
    if width < 1:
        return 1
    want = -(-_CTAS_PER_SM * sms // max(1, b * kv))
    most = -(-width * page_size // _RUN_TOKENS)
    n = max(1, min(want, most), -(-width // _MAX_RUN_PAGES))
    pps = -(-width // n)
    return -(-width // pps)


def paged_attention_split_reference(q, k_arena, v_arena, page_table,
                                    lengths, *, page_size: int,
                                    scale: float,
                                    n_split: int) -> torch.Tensor:
    """Plain PyTorch version of the split and the merge: each row's table
    columns cut into runs of ``ceil(P / n_split)`` as the kernel cuts
    them, each run's f32 partial (m, l, acc) of the masked scores (m =
    -inf, l = 0 for a run past the row's length), merged in run order
    and rounded once to q's dtype; zeros for an empty row."""
    b, h, _, d = q.shape
    kv = k_arena.shape[-2]
    ps = int(page_size)
    width = page_table.shape[1]
    pps = max(1, -(-width // int(n_split)))
    slots = (page_table.long()[:, :, None] * ps
             + torch.arange(ps, device=q.device)).reshape(b, -1)  # (B, T)
    k = k_arena[slots].float()                                    # (B,T,KV,D)
    v = v_arena[slots].float()
    qg = q.reshape(b, kv, h // kv, d).float() * scale
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    tok = torch.arange(slots.shape[1], device=q.device)[None, :]
    n = lengths.long().clamp(0, width * ps)[:, None]
    v = v.masked_fill(~(tok < n)[:, :, None, None], 0.0)  # as above
    m_all = torch.full(s.shape[:-1], float("-inf"), device=q.device)
    parts = []
    for sp in range(int(n_split)):
        lo = sp * pps * ps
        hi = min(width, (sp + 1) * pps) * ps
        valid = (tok >= lo) & (tok < hi) & (tok < n)              # (B, T)
        ss = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        m = ss.amax(dim=-1)
        p = torch.exp(ss - torch.where(torch.isfinite(m), m,
                                       torch.zeros_like(m))[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("bkgt,btkd->bkgd", p, v)))
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros_like(m_all)
    o = torch.zeros(b, kv, h // kv, d, device=q.device)
    for m, l, acc in parts:
        c = torch.where(torch.isfinite(m),
                        torch.exp(m - torch.where(torch.isfinite(m_all),
                                                  m_all,
                                                  torch.zeros_like(m_all))),
                        torch.zeros_like(m))
        l_all = l_all + l * c
        o = o + acc * c[..., None]
    o = torch.where(l_all[..., None] > 0,
                    o / torch.where(l_all > 0, l_all,
                                    torch.ones_like(l_all))[..., None],
                    torch.zeros_like(o))
    return o.reshape(b, h, 1, d).to(q.dtype)


_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
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
    if q.device.type in ("cpu", "meta"):
        return paged_attention_reference(q, k_arena, v_arena, page_table,
                                         lengths, page_size=page_size,
                                         scale=scale)
    if q.device.type != "cuda":
        raise MXNetError(f"paged_attention_kernel: unsupported device "
                         f"{q.device}")
    _check(q, k_arena, v_arena, page_table, lengths, page_size)
    b, h, _, d = q.shape
    kv = k_arena.shape[1]
    width = page_table.shape[1]
    if b == 0 or width == 0:                   # no row holds a token
        return torch.zeros_like(q)
    out = torch.empty_like(q)
    n_split = paged_splits(b, kv, width, int(page_size),
                           _sm_count(q.device))
    ws = torch.empty(b * h * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        _build.call(
            _SRC, "mx_paged_attention_decode", _ARGS,
            "paged_attention_kernel", q.data_ptr(), k_arena.data_ptr(),
            v_arena.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ws.data_ptr(), b, h, kv, d, width,
            int(page_size), n_split, float(scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    paged_attention_kernel.launches += 1
    return out


def _sm_count(device) -> int:
    """The card's SM count (torch caches the device properties: no
    sync)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


paged_attention_kernel.launches = 0
