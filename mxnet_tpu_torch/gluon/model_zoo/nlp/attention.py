"""Multi-head self-attention with a fused QKV projection.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/attention.py`` on its
self-attention path (``cross=False``): one fused QKV Dense, the
attention core through :func:`~mxnet_tpu_torch.ops.sdp_attention`, and
the output Dense. The heads are read in place: q, k and v are (B, L, H,
D) views into the QKV projection's output, handed to the attention core
in its "blhd" layout, whose output reshapes to (B, L, U) without a copy.
The JAX block splits the heads into (B, H, L, D) by transposes instead;
the function is the same. Cross-attention comes with the NMT
Transformer.
"""
from __future__ import annotations

from torch import nn

from ....base import MXNetError
from ....ops.attention import sdp_attention
from ...nn import Dense, Dropout

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    """Self-attention with ``num_heads`` heads over ``query`` (B, L, U);
    ``mask`` optional, broadcastable to (B, heads, L, L), 1 = attend."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, attn_dropout=0.0, device=None, dtype=None):
        super().__init__()
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        self._attn_dropout = float(attn_dropout)
        kw = {"device": device, "dtype": dtype}
        self.qkv_proj = Dense(3 * units, units, flatten=False,
                              use_bias=use_bias, **kw)
        self.out_proj = Dense(units, units, flatten=False,
                              use_bias=use_bias, **kw)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, query, mask=None):
        b, l, _ = query.shape
        h = self._num_heads
        d = self._units // h
        qkv = self.qkv_proj(query)                          # (B, L, 3U)
        q, k, v = (t.view(b, l, h, d)
                   for t in qkv.split(self._units, dim=-1))
        out = sdp_attention(q, k, v, mask, causal=self._causal,
                            layout="blhd", dropout=self._attn_dropout)
        out = self.out_proj(out.reshape(b, l, self._units))
        if self.dropout is not None:
            out = self.dropout(out)
        return out
