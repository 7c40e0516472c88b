"""Multi-head self-attention with a fused QKV projection.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/attention.py`` on its
self-attention path (``cross=False``), with the reference's parameter
names (``qkv_``, ``out_``): one fused QKV Dense, the attention core
through ``_contrib_sdp_attention`` and the output Dense. The heads are
read in place: q, k and v are (B, L, H, D) views into the QKV
projection's output, handed to the attention core in its "blhd" layout,
whose output reshapes to (B, L, U) without a copy. The JAX block splits
the heads into (B, H, L, D) by transposes instead; the function is the
same. Cross-attention comes with the NMT Transformer.
"""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(HybridBlock):
    """Self-attention with ``num_heads`` heads over ``query`` (B, L, U);
    ``mask`` optional, broadcastable to (B, heads, L, L), 1 = attend."""

    def __init__(self, units, num_heads, dropout=0.0, use_bias=True,
                 causal=False, attn_dropout=0.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by heads "
                             f"{num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._causal = causal
        self._attn_dropout = float(attn_dropout)
        with self.name_scope():
            self.qkv_proj = nn.Dense(3 * units, flatten=False,
                                     use_bias=use_bias, in_units=units,
                                     prefix="qkv_")
            self.out_proj = nn.Dense(units, flatten=False,
                                     use_bias=use_bias, in_units=units,
                                     prefix="out_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, query, mask=None):
        b, l = query.shape[0], query.shape[1]
        h = self._num_heads
        d = self._units // h
        qkv = self.qkv_proj(query)                          # (B, L, 3U)
        # views of the projection, split once (its backward is one
        # concatenation; three slices would each zero-fill the whole
        # projection's gradient)
        q, k, v = (t.reshape((b, l, h, d))
                   for t in F._split_views(qkv, num_outputs=3, axis=-1))
        out = F._contrib_sdp_attention(q, k, v, mask, causal=self._causal,
                                       layout="blhd",
                                       dropout=self._attn_dropout)
        out = self.out_proj(out.reshape((b, l, self._units)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out
