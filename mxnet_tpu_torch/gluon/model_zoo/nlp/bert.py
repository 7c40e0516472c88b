"""BERT: the encoder for serving and masked-LM pretraining.

Counterpart of ``mxnet_tpu/gluon/model_zoo/nlp/bert.py``: word +
token-type + position embeddings, ``embed_ln``, a stack of post-LN
encoder cells with a GELU FFN, then the pooler, the next-sentence
classifier and the masked-LM head whose output projection is tied to the
word embedding; and ``BERTForPretrainFused``, the same backbone under the
fused projection + cross-entropy head, for ``parallel.TrainStep``.
Attribute names mirror the JAX blocks, so
:func:`mxnet_tpu_torch.convert.bert_params_from_reference` and
:func:`~mxnet_tpu_torch.convert.bert_pretrain_params_from_reference`
carry a JAX model's weights across name by name.
"""
from __future__ import annotations

import torch
from torch import nn

from ....base import torch_dtype
from ....context import resolve_device
from ....ops.fused_loss import softmax_ce_head
from ...nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm
from .transformer import TransformerEncoderCell

__all__ = ["BERTEncoder", "BERTModel", "BERTForPretrainFused",
           "bert_12_768_12", "bert_24_1024_16"]


class BERTEncoder(nn.Module):
    """Stack of post-LN transformer cells with a GELU FFN."""

    def __init__(self, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, attn_dropout=0.0, device=None,
                 dtype=None):
        super().__init__()
        self.cells = HybridSequential()
        for _ in range(num_layers):
            self.cells.add(TransformerEncoderCell(
                units, hidden_size, num_heads, dropout=dropout,
                activation="gelu", attn_dropout=attn_dropout,
                device=device, dtype=dtype))

    def forward(self, x, mask=None):
        for cell in self.cells:
            x = cell(x, mask)
        return x


class BERTModel(nn.Module):
    """Embeddings -> encoder -> heads.

    ``forward(token_ids, token_types=None, valid_mask=None)`` returns, in
    order: the sequence output (B, L, U); the pooled output (B, U) when
    ``use_pooler``; the classifier logits (B, 2) when also
    ``use_classifier``; the masked-LM logits (B, L, vocab) when
    ``use_decoder``. A single output comes back bare, several as a tuple.
    ``token_ids`` may be floats (the serving batcher's dtype); they are
    truncated to int64.

    ``ctx``: the device of the weights (default: the card; ``mx.cpu()``
    for the CPU). ``dtype``: the weights' dtype. ``generator``: the
    ``torch.Generator`` (on ``ctx``'s device) that draws the initial
    weights: N(0, 0.02) for the projections and the embeddings, zeros
    for the biases and beta, ones for gamma; ``None`` uses torch's
    default generator. The modules are built on the meta device and
    materialised once, on their device.
    """

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, attn_dropout=0.0,
                 use_pooler=True, use_classifier=True, use_decoder=True,
                 ctx=None, dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(ctx)
        self._units = units
        self._use_pooler = use_pooler
        self._use_classifier = use_classifier
        self._use_decoder = use_decoder
        self.config = {"vocab_size": vocab_size, "max_length": max_length,
                       "num_layers": num_layers, "units": units,
                       "hidden_size": hidden_size, "num_heads": num_heads}
        kw = {"device": "meta", "dtype": torch_dtype(dtype)}
        self.word_embed = Embedding(vocab_size, units, **kw)
        self.token_type_embed = Embedding(token_type_vocab_size, units, **kw)
        self.position_embed = Embedding(max_length, units, **kw)
        self.embed_ln = LayerNorm(units, **kw)
        self.embed_dropout = Dropout(dropout) if dropout else None
        self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                   num_heads, dropout,
                                   attn_dropout=attn_dropout, **kw)
        if use_pooler:
            self.pooler = Dense(units, units, flatten=False,
                                activation="tanh", **kw)
        if use_classifier:
            self.classifier = Dense(2, units, flatten=False, **kw)
        if use_decoder:
            # masked-LM head: transform + the output projection tied to
            # the word embedding (its bias is the decoder's own)
            self.decoder_transform = Dense(units, units, flatten=False,
                                           activation="gelu", **kw)
            self.decoder_ln = LayerNorm(units, **kw)
            self.decoder = Dense(vocab_size, units, flatten=False, **kw)
        self.to_empty(device=device)
        if use_decoder:
            self.decoder.weight = self.word_embed.weight
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        for name, p in self.named_parameters():
            if name.endswith("gamma"):
                p.fill_(1.0)
            elif name.endswith("bias") or name.endswith("beta"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, token_ids, token_types=None, valid_mask=None):
        l = token_ids.shape[1]
        x = self.word_embed(token_ids)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        positions = torch.arange(l, device=token_ids.device)
        x = x + self.position_embed(positions).reshape(1, l, self._units)
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        attn_mask = None
        if valid_mask is not None:
            # (B, L) 1/0 -> (B, 1, 1, L): every query may attend valid keys
            attn_mask = valid_mask.reshape(valid_mask.shape[0], 1, 1,
                                           valid_mask.shape[1])
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


class BERTForPretrainFused(nn.Module):
    """BERT masked-LM pretraining with the fused projection + CE head
    (``bert.py:145-200`` of the JAX package).

    A ``BERTModel(use_pooler=False, use_classifier=False,
    use_decoder=False)`` backbone named ``bert``, then ``decoder_ln(
    decoder_transform(seq))`` (Dense with GELU, LayerNorm) and
    :func:`~mxnet_tpu_torch.ops.fused_loss.softmax_ce_head` over the word
    embedding table (the tied projection: the lookup's and the head's
    gradients add up on ``bert.word_embed.weight``) with this block's own
    ``decoder_bias``. The (B, L, vocab) logits never exist at once.

    ``forward(token_ids, mlm_labels)`` returns the (B, L) f32
    per-position loss; train it with ``parallel.TrainStep(net, lambda
    outs, *a: outs, "adam", loss_only=True)``, the labels riding as the
    second data input. ``ctx``, ``dtype`` and ``generator`` are as for
    :class:`BERTModel`; the head is drawn after the backbone (N(0, 0.02)
    weight, zero biases and beta, unit gamma).
    """

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 max_length=512, num_layers=12, units=768, hidden_size=3072,
                 num_heads=12, dropout=0.1, attn_dropout=0.0, chunk=5120,
                 ctx=None, dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(ctx)
        self._chunk = int(chunk)
        self.bert = BERTModel(
            vocab_size=vocab_size,
            token_type_vocab_size=token_type_vocab_size,
            max_length=max_length, num_layers=num_layers, units=units,
            hidden_size=hidden_size, num_heads=num_heads, dropout=dropout,
            attn_dropout=attn_dropout, use_pooler=False,
            use_classifier=False, use_decoder=False, ctx=device,
            dtype=dtype, generator=generator)
        self.config = dict(self.bert.config, chunk=self._chunk)
        kw = {"device": device, "dtype": torch_dtype(dtype)}
        self.decoder_transform = Dense(units, units, flatten=False,
                                       activation="gelu", **kw)
        self.decoder_ln = LayerNorm(units, **kw)
        self.decoder_bias = nn.Parameter(torch.zeros(vocab_size, **kw))
        with torch.no_grad():
            self.decoder_transform.weight.normal_(0.0, 0.02,
                                                  generator=generator)

    def forward(self, token_ids, mlm_labels):
        seq = self.bert(token_ids)
        h = self.decoder_ln(self.decoder_transform(seq))
        return softmax_ce_head(h, self.bert.word_embed.weight,
                               self.decoder_bias, mlm_labels,
                               chunk=self._chunk)
