"""Llama-style decoder-only LM and its paged-KV decode engine.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/llama.py``. The blocks are
``nn.Module``s with the JAX blocks' attribute layout (``q_proj``,
``kv_proj``, ``out_proj``, ``gate_up``, ``down``, ``attn_norm``,
``mlp_norm``, ``embed``, ``norm``, ``lm_head``); MXNet's Dense weight is
(out, in), the same as ``nn.Linear``'s, so :mod:`mxnet_tpu_torch.convert`
carries weights across unchanged.

Two paths: the serving path, :class:`LlamaDecodeEngine` over
:func:`_paged_forward`, and the full-sequence causal ``forward`` that
pretraining runs under autograd (``parallel.TrainStep``): causal flash
attention in the "blhd" layout with the KV heads repeated up to the
query heads, RMSNorm through its forward and backward kernels, and with
``fused_ce`` the fused projection + cross-entropy head.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import MXNetError, torch_dtype
from ....context import resolve_device
from ....ops.attention import (paged_attention, rms_norm, rope, rope_at,
                               sdp_attention)
from ....ops.fused_loss import softmax_ce_head

__all__ = ["RMSNorm", "LlamaAttention", "LlamaMLP", "LlamaBlock",
           "LlamaModel", "LlamaDecodeEngine", "llama_tiny", "llama_3_8b",
           "llama_proxy1b"]


class RMSNorm(nn.Module):
    """f32-statistics RMSNorm; on a CUDA tensor it runs the port's fused
    kernel (:func:`mxnet_tpu_torch.ops.rms_norm`)."""

    def __init__(self, units, eps=1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(units, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, eps=self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, units, num_heads, num_kv_heads=None,
                 rope_theta=10000.0, device=None, dtype=None):
        super().__init__()
        num_kv_heads = num_kv_heads or num_heads
        if num_heads % num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = units // num_heads
        self.rope_theta = rope_theta
        kw = {"bias": False, "device": device, "dtype": dtype}
        self.q_proj = nn.Linear(units, units, **kw)
        self.kv_proj = nn.Linear(units, 2 * num_kv_heads * self.head_dim,
                                 **kw)
        self.out_proj = nn.Linear(units, units, **kw)

    def forward(self, x):
        """(B, L, units) -> (B, L, units), causal, with rope on q and k
        (the JAX ``LlamaAttention.hybrid_forward``, ``llama.py:65-83``);
        the (B, L, H, D) heads go to attention as they are ("blhd")."""
        b, l = x.shape[0], x.shape[1]
        d = self.head_dim
        q = self.q_proj(x).reshape(b, l, self.num_heads, d)
        kv = self.kv_proj(x).reshape(b, l, 2 * self.num_kv_heads, d)
        k, v = kv[:, :, :self.num_kv_heads], kv[:, :, self.num_kv_heads:]
        q = rope(q, theta=self.rope_theta)
        k = rope(k, theta=self.rope_theta)
        if self.num_kv_heads != self.num_heads:
            # F.repeat(k, repeats=rep, axis=1) in the JAX (B, H, L, D)
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = sdp_attention(q, k, v, causal=True, layout="blhd")
        return self.out_proj(out.reshape(b, l, self.num_heads * d))


class LlamaMLP(nn.Module):
    """SwiGLU: gate and up projected in ONE matmul, then silu(gate)*up."""

    def __init__(self, units, hidden_size, device=None, dtype=None):
        super().__init__()
        kw = {"bias": False, "device": device, "dtype": dtype}
        self.gate_up = nn.Linear(units, 2 * hidden_size, **kw)
        self.down = nn.Linear(hidden_size, units, **kw)

    def forward(self, x):
        gate, up = self.gate_up(x).chunk(2, dim=-1)
        return self.down(F.silu(gate) * up)


class LlamaBlock(nn.Module):
    def __init__(self, units, hidden_size, num_heads, num_kv_heads=None,
                 rope_theta=10000.0, eps=1e-6, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attn_norm = RMSNorm(units, eps, **kw)
        self.attention = LlamaAttention(units, num_heads, num_kv_heads,
                                        rope_theta, **kw)
        self.mlp_norm = RMSNorm(units, eps, **kw)
        self.mlp = LlamaMLP(units, hidden_size, **kw)

    def forward(self, x):
        x = x + self.attention(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


def _best_ce_chunk(vocab, target=8192):
    """Largest divisor of ``vocab`` <= target (the fused-CE tile that
    keeps the head free of vocabulary padding, e.g. 8192 for 32768 and
    8016 for Llama-3's 128256); a vocab <= target is its own chunk. Only
    when every divisor is degenerate (< target/4, a large near-prime
    vocab) fall back to ``target`` and the padded head (the JAX
    ``_best_ce_chunk``, ``llama.py:122-132``)."""
    if vocab <= target:
        return vocab
    for c in range(target, 0, -1):
        if vocab % c == 0:  # c=1 always divides, so this always returns
            return c if c >= target // 4 else target


class LlamaModel(nn.Module):
    """Decoder-only causal LM.

    ``ctx``: the device the weights live on (default: the card;
    ``mx.cpu()`` for the CPU). ``dtype``: the weights' dtype.
    ``generator``: the ``torch.Generator`` (on ``ctx``'s device) that
    draws the initial weights, N(0, 0.02) for the projections and the
    embedding and ones for the norms; ``None`` uses torch's default
    generator. The modules are built on the meta device first, so a
    Llama-3-8B in bf16 is materialised once, on its device.

    ``fused_ce``: ``forward(tokens, labels)`` returns the per-token loss
    through the fused projection + CE head over vocabulary chunks of
    ``ce_chunk`` (default: the largest divisor of the vocabulary up to
    8192), and the (B, L, vocab) logits never exist; otherwise
    ``forward(tokens)`` returns the logits. ``remat`` (per-block
    rematerialisation) is not ported: only False or None."""

    def __init__(self, vocab_size=128256, num_layers=32, units=4096,
                 hidden_size=14336, num_heads=32, num_kv_heads=8,
                 rope_theta=500000.0, eps=1e-5, remat=False,
                 fused_ce=False, ce_chunk=None, ctx=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if remat not in (False, None):
            raise MXNetError(f"LlamaModel: remat={remat!r} is not ported "
                             "yet (ROADMAP.md, port queue 1, item 8)")
        self._fused_ce = bool(fused_ce)
        if ce_chunk and vocab_size % int(ce_chunk):
            best = _best_ce_chunk(vocab_size)
            warnings.warn(
                f"ce_chunk={ce_chunk} does not divide vocab_size="
                f"{vocab_size}: the fused CE head takes the padded "
                "fallback with a vocab-sized synthetic-bias gradient"
                + (f"; a dividing chunk exists ({best})"
                   if vocab_size % best == 0 else ""),
                stacklevel=2)
        self._ce_chunk = int(ce_chunk) if ce_chunk else \
            _best_ce_chunk(vocab_size)
        device = resolve_device(ctx)
        num_kv = num_kv_heads or num_heads
        # architecture record for the paged decode engine
        self._decode_cfg = {
            "vocab_size": int(vocab_size), "num_layers": int(num_layers),
            "units": int(units), "num_heads": int(num_heads),
            "num_kv_heads": int(num_kv),
            "head_dim": int(units // num_heads),
            "rope_theta": float(rope_theta), "eps": float(eps),
        }
        kw = {"device": "meta", "dtype": torch_dtype(dtype)}
        self.embed = nn.Embedding(vocab_size, units, **kw)
        self.blocks = nn.ModuleList(
            LlamaBlock(units, hidden_size, num_heads, num_kv_heads,
                       rope_theta, eps, **kw)
            for _ in range(num_layers))
        self.norm = RMSNorm(units, eps, **kw)
        self.lm_head = nn.Linear(units, vocab_size, bias=False, **kw)
        self.to_empty(device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens, labels=None):
        """``tokens`` (B, L) integer ids; the (B, L, vocab) logits, or
        with ``fused_ce`` the (B, L) f32 per-token loss against
        ``labels`` (B, L)."""
        x = self.embed(tokens)
        for blk in self.blocks:
            x = blk(x)
        h = self.norm(x)
        if self._fused_ce:
            if labels is None:
                raise ValueError(
                    "LlamaModel(fused_ce=True) takes (tokens, labels) and "
                    "returns the per-token loss")
            return softmax_ce_head(h, self.lm_head.weight, None, labels,
                                   chunk=self._ce_chunk)
        return self.lm_head(h)

    def decode_engine(self, pool, dtype="float32") -> "LlamaDecodeEngine":
        """The paged-KV decode engine for serving (the seam
        ``serving.Server`` calls to enable ``submit_generate``).
        ``pool``: a :class:`mxnet_tpu_torch.serving.kvcache.PagePool`."""
        return LlamaDecodeEngine(self, pool, dtype=dtype)


# ---------------------------------------------------------------------------
# paged-KV decode engine (serving)
# ---------------------------------------------------------------------------


def _paged_forward(params, tokens, positions, page_table, lengths,
                   k_arena, v_arena, *, cfg, page_size):
    """Cache-aware forward: embeds ``tokens`` (B, L) at absolute
    ``positions`` (B, L), writes each layer's K/V into the paged arenas,
    attends through the page table, and returns the logits (B, vocab) of
    the LAST valid input position per row.

    One function serves both phases: prefill is (B, len-bucket), decode
    is (B, 1). Positions at or beyond a row's ``lengths`` (bucket
    padding, whole-row batch padding) write into the reserved scratch
    page 0 and are masked out of every attention read.

    The arenas are updated IN PLACE (``index_copy_``); the JAX package
    rebuilt them functionally and returned them, because its arrays are
    immutable.
    """
    embed_w, layer_params, norm_w, head_w = params
    n_heads = cfg["num_heads"]
    n_kv = cfg["num_kv_heads"]
    d = cfg["head_dim"]
    theta = cfg["rope_theta"]
    eps = cfg["eps"]
    ps = int(page_size)
    b, l = tokens.shape
    w_pages = page_table.shape[1]

    x = F.embedding(tokens, embed_w)                      # (B, L, U)
    real = positions < lengths[:, None]
    page_of = (positions // ps).clamp(0, w_pages - 1)
    page_ids = torch.gather(page_table.long(), 1, page_of)
    slot = torch.where(real, page_ids * ps + positions % ps,
                       positions % ps)                    # padding -> scratch
    slot_flat = slot.reshape(-1)

    for li, (anw, qw, kvw, ow, mnw, guw, dw) in enumerate(layer_params):
        h = rms_norm(x, anw, eps=eps)
        q = (h @ qw.T).reshape(b, l, n_heads, d)
        kv = (h @ kvw.T).reshape(b, l, 2 * n_kv, d)
        k, v = kv[:, :, :n_kv], kv[:, :, n_kv:]
        q = rope_at(q, positions, theta=theta)
        k = rope_at(k, positions, theta=theta)
        k_arena[li].index_copy_(0, slot_flat, k.reshape(b * l, n_kv, d))
        v_arena[li].index_copy_(0, slot_flat, v.reshape(b * l, n_kv, d))
        att = paged_attention(q.transpose(1, 2), k_arena[li], v_arena[li],
                              page_table, lengths, q_positions=positions,
                              page_size=ps)
        att = att.transpose(1, 2).reshape(b, l, n_heads * d)
        x = x + att @ ow.T
        hm = rms_norm(x, mnw, eps=eps)
        gate, up = (hm @ guw.T).chunk(2, dim=-1)
        x = x + (F.silu(gate) * up) @ dw.T

    hfin = rms_norm(x, norm_w, eps=eps)
    # the last REAL input row: index lengths-1-positions[:, 0]
    # (prefill: lengths-1; decode L=1: always 0)
    last = (lengths.long() - 1 - positions[:, 0]).clamp(0, l - 1)
    h_last = hfin[torch.arange(b, device=hfin.device), last]
    return h_last @ head_w.T


class LlamaDecodeEngine:
    """Cache-aware generation engine over one :class:`LlamaModel`.

    Owns the per-replica K/V arenas (pages allocated from ``pool``) on
    the model's device and runs :func:`_paged_forward` eagerly: PyTorch
    has no trace cache to key, so the JAX engine's compile-cache site has
    no counterpart. Numpy in, numpy logits out, as in the JAX engine.

    Not thread-safe by design: exactly one scheduler thread drives it
    (the :class:`~mxnet_tpu_torch.serving.server.Server` contract).
    """

    def __init__(self, model, pool, dtype="float32"):
        from ....serving.kvcache import make_kv_arena

        self.cfg = dict(model._decode_cfg)
        self.pool = pool
        self.page_size = pool.page_size
        self.dtype = torch_dtype(dtype)
        self.device = model.embed.weight.device
        self.k_arena, self.v_arena = make_kv_arena(
            self.cfg["num_layers"], pool, self.cfg["num_kv_heads"],
            self.cfg["head_dim"], dtype=self.dtype, device=self.device)
        self.refresh_params(model)

    @torch.no_grad()
    def refresh_params(self, model) -> None:
        """(Re)extract the weights, cast to the engine dtype (no copy when
        the model already holds that dtype)."""
        def w(p):
            return p.detach().to(self.device, self.dtype)

        self._params = (
            w(model.embed.weight),
            tuple((w(blk.attn_norm.weight), w(blk.attention.q_proj.weight),
                   w(blk.attention.kv_proj.weight),
                   w(blk.attention.out_proj.weight),
                   w(blk.mlp_norm.weight), w(blk.mlp.gate_up.weight),
                   w(blk.mlp.down.weight))
                  for blk in model.blocks),
            w(model.norm.weight), w(model.lm_head.weight))

    def _tensor(self, a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def forward(self, tokens, positions, page_table, lengths) -> np.ndarray:
        """One cache-aware forward; numpy in, float32 numpy logits
        (B, vocab) out; the arenas advance in place."""
        logits = _paged_forward(
            self._params, self._tensor(tokens, torch.long),
            self._tensor(positions, torch.long),
            self._tensor(page_table, torch.int32),
            self._tensor(lengths, torch.int32),
            self.k_arena, self.v_arena, cfg=self.cfg,
            page_size=self.page_size)
        return logits.float().cpu().numpy()

    def prefill(self, tokens, lengths, page_table) -> np.ndarray:
        """Prefill (B, len-bucket) prompts; ``lengths`` are the real
        prompt lengths. Returns the next-token logits per row."""
        b, l = np.shape(tokens)
        positions = np.broadcast_to(np.arange(l, dtype=np.int64), (b, l))
        return self.forward(tokens, positions, page_table, lengths)

    def decode_step(self, tokens, lengths, page_table) -> np.ndarray:
        """One continuous-batching decode step: ``tokens`` (B,) are the
        rows' newest tokens, already counted in ``lengths``."""
        tokens = np.asarray(tokens).reshape(-1, 1)
        positions = (np.asarray(lengths, dtype=np.int64) - 1).reshape(-1, 1)
        return self.forward(tokens, positions, page_table, lengths)

    def apply_defrag(self, moves) -> None:
        """Replay :meth:`PagePool.defrag` page moves onto this engine's
        arenas (in place), before any dispatch reads the renumbered
        page tables."""
        from ....serving.kvcache import apply_defrag

        apply_defrag(self.k_arena, moves, self.page_size)
        apply_defrag(self.v_arena, moves, self.page_size)

    def forward_full(self, tokens) -> np.ndarray:
        """No-cache full-recompute oracle: run the whole (B, L) prefix
        through scratch pages and return the next-token logits. Frees its
        pages before returning."""
        tokens = np.asarray(tokens, dtype=np.int64)
        b, l = tokens.shape
        owners = [object() for _ in range(b)]
        table = np.zeros((b, self.pool.pages_for(l)), dtype=np.int32)
        try:
            for i, o in enumerate(owners):
                table[i] = self.pool.alloc(o, l)
            return self.prefill(tokens, np.full((b,), l, dtype=np.int32),
                                table)
        finally:
            for o in owners:
                self.pool.free(o)


def llama_tiny(**kwargs) -> LlamaModel:
    """Test-sized config (the JAX package's ``llama_tiny``)."""
    cfg = dict(vocab_size=256, num_layers=2, units=64, hidden_size=128,
               num_heads=4, num_kv_heads=2, rope_theta=10000.0)
    cfg.update(kwargs)
    return LlamaModel(**cfg)


def llama_proxy1b(**kwargs) -> LlamaModel:
    """The ~0.7B single-card proxy of the Llama-3-8B recipe (the JAX
    ``tools/pretrain_llama.py`` config ``proxy1b``): GQA 2:1 over heads
    of 128, SwiGLU, an untied head, rope theta 5e5."""
    cfg = dict(vocab_size=32768, num_layers=10, units=2048,
               hidden_size=7168, num_heads=16, num_kv_heads=8,
               rope_theta=500000.0)
    cfg.update(kwargs)
    return LlamaModel(**cfg)


def llama_3_8b(**kwargs) -> LlamaModel:
    """Llama-3-8B shapes."""
    cfg = dict(vocab_size=128256, num_layers=32, units=4096,
               hidden_size=14336, num_heads=32, num_kv_heads=8,
               rope_theta=500000.0)
    cfg.update(kwargs)
    return LlamaModel(**cfg)
