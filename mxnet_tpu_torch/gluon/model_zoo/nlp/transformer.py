"""Transformer encoder cell and its position-wise FFN.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/transformer.py``'s
``PositionwiseFFN`` and ``TransformerEncoderCell``. The post-LN cell
always takes the fused add+norm (``_fused_add_norm``, one LayerNorm
kernel over ``dropout(h) + residual``), the JAX cell's
``MXNET_PALLAS_FUSED=1`` route, with the dropout sites of that route in
its order: the attention block's own output dropout, then the add+norm's
dropout of the same output (so, as in the reference, the attention
output is dropped twice; GluonNLP drops it once), then the FFN's output
dropout; the second add+norm does not drop. The decoder cell and the
NMT ``Transformer`` come later.
"""
from __future__ import annotations

from torch import nn

from ....ops.nn import fused_layer_norm_op
from ...nn import Dense, Dropout, LayerNorm
from .attention import MultiHeadAttention

__all__ = ["PositionwiseFFN", "TransformerEncoderCell"]


class PositionwiseFFN(nn.Module):
    """ffn1 (with the activation) then ffn2."""

    def __init__(self, units, hidden_size, dropout=0.0, activation="relu",
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ffn1 = Dense(hidden_size, units, flatten=False,
                          activation=activation, **kw)
        self.ffn2 = Dense(units, hidden_size, flatten=False, **kw)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.ffn2(self.ffn1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerEncoderCell(nn.Module):
    """Self-attention and FFN sublayers, post-LN (default) or pre-LN."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 pre_norm=False, activation="relu", attn_dropout=0.0,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self._pre_norm = pre_norm
        self._drop_rate = float(dropout)
        self.attention = MultiHeadAttention(units, num_heads,
                                            dropout=dropout,
                                            attn_dropout=attn_dropout, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                   activation=activation, **kw)
        self.ln1 = LayerNorm(units, **kw)
        self.ln2 = LayerNorm(units, **kw)
        self.dropout = Dropout(dropout) if dropout else None

    @staticmethod
    def _fused_add_norm(h, residual, ln, dropout=0.0):
        """``LN(dropout(h) + residual)`` in one kernel; the LayerNorm
        child keeps its gamma/beta (and their names)."""
        return fused_layer_norm_op(h, ln.gamma, ln.beta, residual,
                                   eps=ln._epsilon, dropout=dropout)

    def forward(self, x, mask=None):
        if self._pre_norm:
            h = self.attention(self.ln1(x), mask)
            x = x + (self.dropout(h) if self.dropout is not None else h)
            return x + self.ffn(self.ln2(x))
        h = self.attention(x, mask)
        x = self._fused_add_norm(h, x, self.ln1, dropout=self._drop_rate)
        return self._fused_add_norm(self.ffn(x), x, self.ln2)
