"""Attention-path ops.

Counterpart of ``mxnet_tpu/ops/attention.py`` (``sdp_attention`` with
its ``_sdpa_reference``, ``rms_norm``, ``rope``, ``rope_at``,
``_paged_reference``, ``paged_attention``). The JAX op registry and its
``MXNET_PALLAS_FUSED`` knob have no counterpart: a CUDA tensor always
takes the port's kernel, a CPU tensor its plain version.
"""
from __future__ import annotations

import math

import torch

from .. import autograd, random_state
from ..compiler import flops as _flops
from ..kernels import flash_attention, fused_rms_norm, paged_attention_kernel
from ..kernels.dropout import attn_keep_mask, dropout_thresh, f32
from .registry import register

__all__ = ["sdp_attention", "rms_norm", "rope", "rope_at",
           "paged_attention"]


def _sdpa_reference(q, k, v, mask, scale, causal, layout="bhld",
                    dropout=0.0, seed=None):
    """Dense f32-softmax attention (``mxnet_tpu/ops/attention.py:21-62``):
    the score product in the input dtype, then f32 scores times
    ``scale``, causal bottom-right (``tril(k=Lk-Lq)``) and ``mask`` (1 =
    attend, broadcastable to (B, H, Lq, Lk)) filled with -1e9, the
    softmax, with ``dropout`` the position-hash mask of the flash kernels
    (kept probabilities times f32(1 / (1 - p))), the probabilities in the
    input dtype, and the value product. ``layout``: "bhld" (B, H, L, D)
    or "blhd" (B, L, H, D)."""
    if layout == "blhd":
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    else:
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k)
    scores = scores.float() * scale
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((lq, lk), dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        scores = scores.masked_fill(~keep, -1e9)
    if mask is not None:
        keep = torch.broadcast_to(mask.to(torch.bool), scores.shape)
        scores = scores.masked_fill(~keep, -1e9)
    probs = torch.softmax(scores, dim=-1)
    if dropout > 0.0:
        keep = attn_keep_mask(*probs.shape, seed, dropout_thresh(dropout),
                              q.device)
        inv = torch.tensor(f32(1.0 / (1.0 - dropout)))
        probs = torch.where(keep, probs * inv, torch.zeros(
            (), device=q.device))
    probs = probs.to(q.dtype)
    if layout == "blhd":
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def sdp_attention(query, key, value, mask=None, *, scale=None,
                  causal=False, layout="bhld", dropout=0.0):
    """Scaled dot-product attention, ``layout`` "bhld" (B, H, L, D) or
    "blhd" (B, L, H, D), output in the same layout.

    Mask-free calls go to :func:`~mxnet_tpu_torch.kernels.flash_attention`
    (the kernels on a CUDA tensor, differentiable through the flash
    backward); a ``mask`` (1 = attend, broadcastable to (B, H, Lq, Lk))
    and causal attention with Lq > Lk go to :func:`_sdpa_reference`, the
    JAX package's own route for them, which torch autograd
    differentiates. ``dropout`` drops attention probabilities in
    training mode only (``autograd.is_training()``), under a seed drawn
    from ``random_state`` only then; both routes drop the same elements
    for a seed. ``ring_axis`` (sequence parallelism) waits for the
    parallelism queue."""
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    p = float(dropout) if autograd.is_training() else 0.0
    seed = random_state.next_seed(query.device) if p > 0.0 else None
    seq_ax = 1 if layout == "blhd" else 2
    if mask is None and not (causal
                             and query.shape[seq_ax] > key.shape[seq_ax]):
        return flash_attention(query, key, value, scale=scale,
                               causal=causal, layout=layout, dropout=p,
                               seed=seed)
    return _sdpa_reference(query, key, value, mask, scale, causal,
                           layout=layout, dropout=p, seed=seed)


def rms_norm(data: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics; output in
    ``promote_types(data.dtype, weight.dtype)``."""
    return fused_rms_norm(data, weight, eps=eps)


def rope_at(data: torch.Tensor, positions: torch.Tensor, *,
            theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over (B, L, H, D) at explicit per-row absolute
    ``positions`` (B, L), in the rotate-half (Llama) convention, computed
    in f32 and returned in ``data``'s dtype."""
    b, l, h, d = data.shape
    pos = positions.to(torch.float32)
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=data.device) / d))
    angles = pos[:, :, None] * inv_freq[None, None, :]   # (B, L, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = data[..., : d // 2].float()
    x2 = data[..., d // 2:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(data.dtype)


def rope(data: torch.Tensor, *, theta: float = 10000.0,
         position_offset: int = 0) -> torch.Tensor:
    """:func:`rope_at` with positions ``position_offset + arange(L)`` for
    every row."""
    b, l = data.shape[:2]
    pos = torch.arange(position_offset, position_offset + l,
                       device=data.device).expand(b, l)
    return rope_at(data, pos, theta=theta)


def _paged_reference(q, k_arena, v_arena, page_table, lengths,
                     q_positions, page_size, scale):
    """Gather K/V through the page table, then masked f32-softmax
    attention, causal over each request's own timeline. The prefill path
    (Lq > 1) everywhere, as in the JAX package, and the decode path on
    the CPU. A padding row (length 0) sees only scratch key 0: garbage
    that the batcher slices away."""
    b, h, lq, d = q.shape
    kv = k_arena.shape[-2]
    ps = int(page_size)
    slots = (page_table.long()[:, :, None] * ps
             + torch.arange(ps, device=q.device)).reshape(b, -1)  # (B, T)
    k = k_arena[slots]                                  # (B, T, KV, D)
    v = v_arena[slots]
    key_pos = torch.arange(slots.shape[1], device=q.device)
    live = key_pos[None, :] < lengths.long()[:, None]   # (B, T)
    # a slot past the row's length (a freed page's stale values, NaN
    # after a request with a bad token id) is read as zeros: its
    # probability is 0, and 0 * NaN would poison the row
    v = v.masked_fill(~live[:, :, None, None], 0.0)
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    k = k.transpose(1, 2)                               # (B, H, T, D)
    v = v.transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    mask = key_pos[None, None, None, :] <= q_positions[:, None, :, None]
    mask = mask & live[:, None, None, :]
    scores = scores.masked_fill(~mask, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def paged_attention(query, k_arena, v_arena, page_table, lengths,
                    q_positions=None, *, page_size: int, scale=None):
    """Attention over a paged KV cache: ``query`` (B, H, Lq, D),
    ``k_arena``/``v_arena`` (slots, KV, D) for one layer, ``page_table``
    (B, P) int32, ``lengths`` (B,) int32 valid tokens per row including
    the query tokens, ``q_positions`` (B, Lq) absolute query positions
    (default: the trailing ``lengths - Lq + arange(Lq)``).

    The single-query decode shape on a CUDA tensor runs the paged
    kernel; everything else (prefill, or any CPU tensor) runs
    :func:`_paged_reference`, as the JAX op does off the TPU kernel."""
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    lq = query.shape[2]
    if _flops.active():
        # 4·H·D per attended (query, key) pair of a real query row
        b, h, _, d = query.shape
        pos = q_positions if q_positions is not None else (
            lengths.long()[:, None] - lq
            + torch.arange(lq, device=query.device)[None, :])
        real = pos < lengths.long()[:, None]
        _flops.add("paged_attention",
                   4 * h * d * int(((pos + 1) * real).sum()))
        with _flops.uncounted():
            return _paged(query, k_arena, v_arena, page_table, lengths,
                          q_positions, page_size, scale)
    return _paged(query, k_arena, v_arena, page_table, lengths, q_positions,
                  page_size, scale)


def _paged(query, k_arena, v_arena, page_table, lengths, q_positions,
           page_size, scale):
    lq = query.shape[2]
    if lq == 1 and query.is_cuda:
        return paged_attention_kernel(query.contiguous(), k_arena, v_arena,
                                      page_table, lengths,
                                      page_size=page_size, scale=scale)
    if q_positions is None:
        q_positions = (lengths.long()[:, None] - lq
                       + torch.arange(lq, device=query.device)[None, :])
    return _paged_reference(query, k_arena, v_arena, page_table, lengths,
                            q_positions, page_size, scale)


# under the reference's op names (mx.nd._contrib_sdp_attention, ...)
register("_contrib_sdp_attention", aliases=["sdp_attention"])(sdp_attention)
register("_contrib_rms_norm", aliases=["rms_norm"])(rms_norm)
register("_contrib_rope", aliases=["rope"])(rope)
