"""BERT: the encoder for fine-tuning and serving, and masked-LM
pretraining.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/bert.py``, with the
reference's parameter names (``bertmodel0_word_embed_weight``,
``bertmodel0_enc_layer0_attn_qkv_weight``...) and structural names
(``word_embed.weight``, ``encoder.cells.0.attention.qkv_proj.weight``):
word + token-type + position embeddings, ``embed_ln``, a stack of
post-LN encoder cells with a GELU FFN, then the pooler, the
next-sentence classifier and the masked-LM head whose output projection
shares the word embedding's weight; and ``BERTForPretrainFused``, the
same backbone under the fused projection + cross-entropy head, for
``parallel.TrainStep``. A ``.params`` file of either package loads into
the other's model (``load_parameters``).

Built as in the reference, the model is not initialized:
``bert_12_768_12()`` then ``initialize(mx.init.Normal(0.02), ctx=...)``.
The port also takes ``ctx=``, ``dtype=`` and ``generator=`` at
construction: ``dtype`` sets every parameter's dtype, and ``ctx`` or
``generator`` initializes at once on ``ctx`` (default: the card), N(0,
0.02) for the projections and the embeddings, zeros for the biases and
beta, ones for gamma, drawn from ``generator`` (a ``torch.Generator`` on
that device) when given.
"""
from __future__ import annotations

from .... import initializer
from ...block import HybridBlock, param_like
from ... import nn
from .._build import materialize
from .transformer import TransformerEncoderCell

__all__ = ["BERTEncoder", "BERTModel", "BERTForPretrainFused",
           "bert_12_768_12", "bert_24_1024_16"]


class BERTEncoder(HybridBlock):
    """Stack of post-LN transformer cells with a GELU FFN."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, attn_dropout=0.0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.cells = nn.HybridSequential(prefix="")
            for i in range(num_layers):
                self.cells.add(TransformerEncoderCell(
                    units, hidden_size, num_heads, dropout=dropout,
                    activation="gelu", attn_dropout=attn_dropout,
                    prefix=f"layer{i}_"))

    def hybrid_forward(self, F, x, mask=None):
        for cell in self.cells:
            x = cell(x, mask)
        return x


def _valid_mask(F, valid, tokens):
    """``valid`` as a (B, L) 1/0 mask over ``tokens`` (B, L): a (B,)
    ``valid_length`` (GluonNLP) becomes ``arange(L) < valid_length``; a
    (B, L) mask stays."""
    if len(valid.shape) != 1:
        return valid
    pos = F._contrib_arange_like(tokens, axis=1)
    return F.broadcast_lesser(pos.reshape((1, -1)),
                              F.cast(valid, "float32").reshape((-1, 1)))


class BERTModel(HybridBlock):
    """Embeddings -> encoder -> heads.

    ``forward(token_ids, token_types=None, valid_mask=None)`` returns, in
    order: the sequence output (B, L, U); the pooled output (B, U) when
    ``use_pooler``; the classifier logits (B, 2) when also
    ``use_classifier``; the masked-LM logits (B, L, vocab) when
    ``use_decoder``. A single output comes back bare, several as a tuple.
    ``token_ids`` may be floats (the serving batcher's dtype); they are
    truncated. ``valid_mask``: (B, L) 1 = a real token, or a (B,)
    ``valid_length``; the keys it marks out are masked in every
    attention. ``ctx``, ``dtype`` and ``generator``: see the module
    docstring."""

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, attn_dropout=0.0,
                 use_pooler=True, use_classifier=True, use_decoder=True,
                 prefix=None, params=None, ctx=None, dtype=None,
                 generator=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._use_pooler = use_pooler
        self._use_classifier = use_classifier
        self._use_decoder = use_decoder
        self.config = {"vocab_size": vocab_size, "max_length": max_length,
                       "num_layers": num_layers, "units": units,
                       "hidden_size": hidden_size, "num_heads": num_heads}
        with self.name_scope():
            self.word_embed = nn.Embedding(vocab_size, units,
                                           prefix="word_embed_")
            self.token_type_embed = nn.Embedding(token_type_vocab_size,
                                                 units,
                                                 prefix="token_type_embed_")
            self.position_embed = nn.Embedding(max_length, units,
                                               prefix="position_embed_")
            self.embed_ln = nn.LayerNorm(in_channels=units,
                                         prefix="embed_ln_")
            self.embed_dropout = nn.Dropout(dropout) if dropout else None
            self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                       num_heads, dropout,
                                       attn_dropout=attn_dropout,
                                       prefix="enc_")
            if use_pooler:
                self.pooler = nn.Dense(units, flatten=False,
                                       activation="tanh", in_units=units,
                                       prefix="pooler_")
            if use_classifier:
                self.classifier = nn.Dense(2, flatten=False, in_units=units,
                                           prefix="classifier_")
            if use_decoder:
                # masked-LM head: transform + the output projection that
                # shares the word embedding's weight (its bias is its own)
                self.decoder_transform = nn.Dense(
                    units, flatten=False, activation="gelu", in_units=units,
                    prefix="decoder_transform_")
                self.decoder_ln = nn.LayerNorm(in_channels=units,
                                               prefix="decoder_ln_")
                self.decoder = nn.Dense(
                    vocab_size, flatten=False, in_units=units,
                    params=self.word_embed.params, prefix="word_embed_")
        materialize(self, ctx, dtype, generator, initializer.Normal(0.02))

    def hybrid_forward(self, F, token_ids, token_types=None,
                       valid_mask=None):
        l = token_ids.shape[1]
        x = self.word_embed(token_ids)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        # the position embedding's first l rows (its lookup at arange(l))
        pos = param_like(self.position_embed.weight, x)[:l]
        x = x + pos.reshape((1, l, self._units))
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        attn_mask = None
        if valid_mask is not None:
            valid_mask = _valid_mask(F, valid_mask, token_ids)
            # (B, L) 1/0 -> (B, 1, 1, L): every query may attend valid keys
            attn_mask = valid_mask.reshape((valid_mask.shape[0], 1, 1, l))
        seq = self.encoder(x, attn_mask)
        outs = [seq]
        pooled = None
        if self._use_pooler:
            pooled = self.pooler(seq[:, 0, :])
            outs.append(pooled)
        if self._use_classifier and pooled is not None:
            outs.append(self.classifier(pooled))
        if self._use_decoder:
            h = self.decoder_ln(self.decoder_transform(seq))
            outs.append(self.decoder(h))
        return tuple(outs) if len(outs) > 1 else outs[0]


def bert_12_768_12(**kwargs) -> BERTModel:
    """BERT-base: GluonNLP's published ``bert_12_768_12`` shape."""
    cfg = dict(num_layers=12, units=768, hidden_size=3072, num_heads=12)
    cfg.update(kwargs)
    return BERTModel(**cfg)


def bert_24_1024_16(**kwargs) -> BERTModel:
    """BERT-large: GluonNLP's published ``bert_24_1024_16`` shape."""
    cfg = dict(num_layers=24, units=1024, hidden_size=4096, num_heads=16)
    cfg.update(kwargs)
    return BERTModel(**cfg)


class BERTForPretrainFused(HybridBlock):
    """BERT masked-LM pretraining with the fused projection + CE head
    (``bert.py:145-200`` of the JAX package).

    A ``BERTModel(use_pooler=False, use_classifier=False,
    use_decoder=False)`` backbone named ``bert``, then ``decoder_ln(
    decoder_transform(seq))`` (Dense with GELU, LayerNorm) and
    ``_contrib_softmax_ce_head`` over the word embedding table (the tied
    projection: the lookup's and the head's gradients add up on
    ``bert.word_embed.weight``) with this block's own ``vocab_bias``
    (named ``decoder_bias``). The (B, L, vocab) logits never exist at
    once.

    ``forward(token_ids, mlm_labels)`` returns the (B, L) f32
    per-position loss; train it with ``parallel.TrainStep(net, lambda
    outs, *a: outs, "adam", loss_only=True)``, the labels riding as the
    second data input. ``ctx``, ``dtype`` and ``generator`` are as for
    :class:`BERTModel`.
    """

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, attn_dropout=0.0, chunk=5120,
                 prefix=None, params=None, ctx=None, dtype=None,
                 generator=None):
        super().__init__(prefix=prefix, params=params)
        self._chunk = int(chunk)
        with self.name_scope():
            self.vocab_bias = self.params.get(
                "decoder_bias", shape=(vocab_size,), init="zeros")
            self.bert = BERTModel(
                vocab_size=vocab_size,
                token_type_vocab_size=token_type_vocab_size,
                max_length=max_length, num_layers=num_layers, units=units,
                hidden_size=hidden_size, num_heads=num_heads,
                dropout=dropout, attn_dropout=attn_dropout,
                use_pooler=False, use_classifier=False, use_decoder=False,
                prefix="bert_")
            self.decoder_transform = nn.Dense(
                units, flatten=False, activation="gelu", in_units=units,
                prefix="decoder_transform_")
            self.decoder_ln = nn.LayerNorm(in_channels=units,
                                           prefix="decoder_ln_")
        self.config = dict(self.bert.config, chunk=self._chunk)
        materialize(self, ctx, dtype, generator, initializer.Normal(0.02))

    def hybrid_forward(self, F, token_ids, mlm_labels, vocab_bias):
        seq = self.bert(token_ids)
        h = self.decoder_ln(self.decoder_transform(seq))
        return F._contrib_softmax_ce_head(
            h, param_like(self.bert.word_embed.weight, h), vocab_bias,
            mlm_labels, chunk=self._chunk)
