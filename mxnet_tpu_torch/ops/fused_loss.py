"""Fused projection + softmax cross-entropy head.

Counterpart of ``mxnet_tpu/ops/fused_loss.py`` (``softmax_ce_head``,
``:233``): the per-position loss

    loss_i = logsumexp_v(h_i . W_v + b_v) - (h_i . W_label_i + b_label_i)

computed over vocabulary chunks with an online base-2 logsumexp
(``_fused_ce_fwd``, ``:67``), so the (N, vocab) logits never exist at
once; the backward recomputes each chunk's softmax from the saved
per-position lse (``_fused_ce_bwd``, ``:108``) and accumulates dX, dW and
db chunk by chunk. The vocabulary is padded to a whole number of chunks
with zero rows and a -1e30 bias (``_pad_vocab``, ``:36``), outside the
autograd function, so the padding's gradients are trimmed by autograd.
A bias-free head whose chunk divides the vocabulary takes the same node
with no bias at all (``_fused_ce_nobias``, ``:152-229``): no bias add in
the chunk logits and no bias gradient; only a padded bias-free head
carries a zero bias, for its -1e30 padding rows, as the reference's
fallback does (``:246-262``).

The JAX package has no Pallas kernel here: each chunk's products are
library GEMMs with f32 results (``torch.mm(..., out_dtype=float32)`` for
bf16 on the card, the f32 product of the widened operands on the CPU),
and the chunk softmax is plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..compiler import flops as _flops
from .registry import register

__all__ = ["softmax_ce_head"]

_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_NEG = -1e30


def _pad_vocab(weight, bias, chunk):
    v = weight.shape[0]
    v_pad = -(-v // chunk) * chunk
    if v_pad != v:
        weight = F.pad(weight, (0, 0, 0, v_pad - v))
        # -1e30 bias on the padding rows: exp2 gives 0, never the max of a
        # real row, and no label < v picks them
        bias = torch.cat([bias, torch.full((v_pad - v,), _NEG,
                                           dtype=bias.dtype,
                                           device=bias.device)])
    return weight, bias


def _mm32(a, b):
    """``a @ b`` with an f32 result: the products of bf16 operands summed
    in f32, as the JAX op's ``preferred_element_type=float32``."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _chunk_logits(hidden, weight, bias, lo, hi):
    """Base-2 logits of vocabulary rows [lo, hi): (N, hi - lo) f32."""
    s = _mm32(hidden, weight[lo:hi].t())
    if bias is not None:
        s = s + bias[lo:hi].float()
    return s * _LOG2E


class _SoftmaxCEHead(torch.autograd.Function):
    """The chunked head; ``bias`` may be None (no bias add, no bias
    gradient)."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, chunk):
        _flops.add("softmax_ce_head",
                   2 * hidden.shape[0] * weight.shape[0] * hidden.shape[1])
        with _flops.uncounted():
            return _SoftmaxCEHead._forward(ctx, hidden, weight, bias,
                                           labels, chunk)

    @staticmethod
    def _forward(ctx, hidden, weight, bias, labels, chunk):
        n = hidden.shape[0]
        dev = hidden.device
        m = torch.full((n,), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros(n, dtype=torch.float32, device=dev)
        picked = torch.zeros(n, dtype=torch.float32, device=dev)
        for lo in range(0, weight.shape[0], chunk):
            s2 = _chunk_logits(hidden, weight, bias, lo, lo + chunk)
            m_new = torch.maximum(m, s2.amax(dim=-1))
            l = l * torch.exp2(m - m_new) \
                + torch.exp2(s2 - m_new[:, None]).sum(dim=-1)
            off = labels - lo
            hit = (off >= 0) & (off < chunk)
            got = s2.gather(1, off.clamp(0, chunk - 1)[:, None])[:, 0]
            picked = torch.where(hit, got, picked)
            m = m_new
        lse2 = m + torch.log2(l)
        ctx.save_for_backward(hidden, weight, bias, labels, lse2)
        ctx.chunk = chunk
        # back to natural log; picked is base-2 scaled
        return (lse2 - picked) * _LN2

    @staticmethod
    def backward(ctx, g):
        # dX and dW; the recompute of each chunk's logits is not counted
        saved = ctx.saved_tensors
        hidden, weight = saved[:2]
        _flops.add("softmax_ce_head_bwd",
                   4 * hidden.shape[0] * weight.shape[0] * hidden.shape[1])
        with _flops.uncounted():
            return _SoftmaxCEHead._backward(ctx, g, saved)

    @staticmethod
    def _backward(ctx, g, saved):
        hidden, weight, bias, labels, lse2 = saved
        chunk = ctx.chunk
        gf = g.float()
        dx = torch.zeros(hidden.shape, dtype=torch.float32,
                         device=hidden.device)
        dw = torch.empty_like(weight)
        db = None if bias is None else torch.empty_like(bias)
        cols = torch.arange(chunk, device=hidden.device)
        for lo in range(0, weight.shape[0], chunk):
            s2 = _chunk_logits(hidden, weight, bias, lo, lo + chunk)
            p = torch.exp2(s2 - lse2[:, None])
            off = labels - lo
            hit = (off >= 0) & (off < chunk)
            onehot = (cols[None, :] == off.clamp(0, chunk - 1)[:, None]) \
                & hit[:, None]
            gl = (p - onehot.float()) * gf[:, None]    # dlogits (N, C)
            gl_cast = gl.to(hidden.dtype)
            dx = dx + _mm32(gl_cast, weight[lo:lo + chunk])
            dw[lo:lo + chunk] = _mm32(gl_cast.t(), hidden).to(weight.dtype)
            if db is not None:
                db[lo:lo + chunk] = gl.sum(dim=0).to(bias.dtype)
        return dx.to(hidden.dtype), dw, db, None, None


def softmax_ce_head(hidden, weight, bias=None, labels=None, *, chunk=5120):
    """Per-position cross-entropy of the vocabulary projection
    ``hidden @ weight.T + bias`` against ``labels``, without the (N,
    vocab) logits (see the module docstring).

    ``hidden`` (..., D); ``weight`` (V, D), often a tied embedding table,
    whose two uses then add their gradients; ``bias`` (V,) or None (no
    bias: a bias-free node when ``chunk`` divides V, else a zero bias that
    masks the padding rows); ``labels`` (...) integer class ids. Returns
    the f32 loss shaped like ``labels``."""
    lead = hidden.shape[:-1]
    d = hidden.shape[-1]
    chunk = int(chunk)
    if bias is None and weight.shape[0] % chunk:
        bias = torch.zeros(weight.shape[0], dtype=torch.float32,
                           device=weight.device)
    if bias is not None:
        weight, bias = _pad_vocab(weight, bias, chunk)
    loss = _SoftmaxCEHead.apply(hidden.reshape(-1, d), weight, bias,
                                labels.reshape(-1).long(), chunk)
    return loss.reshape(lead)


register("_contrib_softmax_ce_head",
         aliases=["softmax_ce_head"])(softmax_ce_head)
