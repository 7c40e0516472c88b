"""Transformer encoder cell and its position-wise FFN.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/transformer.py``'s
``PositionwiseFFN`` and ``TransformerEncoderCell``, with the reference's
parameter names (``ffn_ffn1_``, ``ln1_``...). The post-LN cell always
takes the fused add+norm (``_fused_add_norm``, one LayerNorm kernel over
``dropout(h) + residual``), the JAX cell's ``MXNET_PALLAS_FUSED=1``
route, with the dropout sites of that route in its order: the attention
block's own output dropout, then the add+norm's dropout of the same
output (so, as in the reference, the attention output is dropped twice;
GluonNLP drops it once), then the FFN's output dropout; the second
add+norm does not drop. The decoder cell and the NMT ``Transformer`` come
later.
"""
from __future__ import annotations

from ...block import HybridBlock, param_like
from ... import nn
from .attention import MultiHeadAttention

__all__ = ["PositionwiseFFN", "TransformerEncoderCell"]


class PositionwiseFFN(HybridBlock):
    """ffn1 (with the activation) then ffn2."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="relu",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.ffn1 = nn.Dense(hidden_size, flatten=False,
                                 activation=activation, in_units=units,
                                 prefix="ffn1_")
            self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden_size,
                                 prefix="ffn2_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        out = self.ffn2(self.ffn1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(HybridBlock):
    """Self-attention and FFN sublayers, post-LN (default) or pre-LN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=False, activation="relu", attn_dropout=0.0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._pre_norm = pre_norm
        self._drop_rate = float(dropout)
        with self.name_scope():
            self.attention = MultiHeadAttention(units, num_heads,
                                                dropout=dropout,
                                                attn_dropout=attn_dropout,
                                                prefix="attn_")
            self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                       activation=activation, prefix="ffn_")
            self.ln1 = nn.LayerNorm(in_channels=units, prefix="ln1_")
            self.ln2 = nn.LayerNorm(in_channels=units, prefix="ln2_")
            self.dropout = nn.Dropout(dropout) if dropout else None

    @staticmethod
    def _fused_add_norm(F, h, residual, ln, dropout=0.0):
        """``LN(dropout(h) + residual)`` in one kernel; the LayerNorm
        child keeps its gamma/beta (and their names)."""
        return F._contrib_fused_layer_norm(
            h, param_like(ln.gamma, h), param_like(ln.beta, h), residual,
            eps=ln._epsilon, dropout=dropout)

    def hybrid_forward(self, F, x, mask=None):
        if self._pre_norm:
            h = self.attention(self.ln1(x), mask)
            x = x + (self.dropout(h) if self.dropout is not None else h)
            return x + self.ffn(self.ln2(x))
        h = self.attention(x, mask)
        x = self._fused_add_norm(F, h, x, self.ln1, dropout=self._drop_rate)
        return self._fused_add_norm(F, self.ffn(x), x, self.ln2)
