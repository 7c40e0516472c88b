"""Weight carrier from the JAX package's models to the port's.

The JAX side hands over plain numpy arrays (``{name: p.data().asnumpy()
for name, p in net.collect_params().items()}``), so this module imports
nothing of ``mxnet_tpu``.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .base import MXNetError

__all__ = ["llama_params_from_reference", "bert_params_from_reference",
           "bert_pretrain_params_from_reference"]

_GLOBAL = {"embed_weight": "embed.weight", "norm_weight": "norm.weight",
           "lm_head_weight": "lm_head.weight"}
_LAYER = {"attnnorm_weight": "attn_norm.weight",
          "attn_q_weight": "attention.q_proj.weight",
          "attn_kv_weight": "attention.kv_proj.weight",
          "attn_out_weight": "attention.out_proj.weight",
          "mlpnorm_weight": "mlp_norm.weight",
          "mlp_gateup_weight": "mlp.gate_up.weight",
          "mlp_down_weight": "mlp.down.weight"}
_LAYER_RE = re.compile(r"layer(\d+)_(" + "|".join(_LAYER) + r")")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16 has no torch twin
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _expected_shapes(named: Dict[str, np.ndarray], n_layers: int):
    """Every name's shape implied by the embedding, the norm and the
    first layer's projections: (V, U) embed, (U,) norms, (U, U) q/out,
    (2*KV*D, U) kv, (2F, U) gate-up, (U, F) down, (V, U) head."""
    vocab, units = named["embed.weight"].shape
    kv_rows = named["blocks.0.attention.kv_proj.weight"].shape[0]
    ff2 = named["blocks.0.mlp.gate_up.weight"].shape[0]
    shapes = {"embed.weight": (vocab, units), "norm.weight": (units,),
              "lm_head.weight": (vocab, units)}
    per = {"attn_norm.weight": (units,),
           "attention.q_proj.weight": (units, units),
           "attention.kv_proj.weight": (kv_rows, units),
           "attention.out_proj.weight": (units, units),
           "mlp_norm.weight": (units,),
           "mlp.gate_up.weight": (ff2, units),
           "mlp.down.weight": (units, ff2 // 2)}
    for i in range(n_layers):
        for k, s in per.items():
            shapes[f"blocks.{i}.{k}"] = s
    return shapes


def llama_params_from_reference(named: Dict[str, np.ndarray]
                                ) -> Dict[str, torch.Tensor]:
    """Map a JAX ``LlamaModel``'s named numpy parameters onto the port's
    ``LlamaModel.state_dict()`` names (CPU tensors of the same dtype;
    ``load_state_dict`` moves them to the model's device and dtype).

    Names match on their suffix after the model prefix (for example
    ``llamamodel0_``). Raises :class:`MXNetError` on a missing name, an
    unknown name, or a shape that disagrees with the rest."""
    heads = [n for n in named if n.endswith("embed_weight")]
    if len(heads) != 1:
        raise MXNetError(f"expected exactly one '*embed_weight' parameter, "
                         f"found {heads}")
    prefix = heads[0][:-len("embed_weight")]
    out: Dict[str, torch.Tensor] = {}
    layers = set()
    for name, arr in named.items():
        if not name.startswith(prefix):
            raise MXNetError(f"parameter {name!r} lacks the model prefix "
                             f"{prefix!r}")
        suffix = name[len(prefix):]
        m = _LAYER_RE.fullmatch(suffix)
        if suffix in _GLOBAL:
            key = _GLOBAL[suffix]
        elif m is not None:
            layers.add(int(m.group(1)))
            key = f"blocks.{int(m.group(1))}.{_LAYER[m.group(2)]}"
        else:
            raise MXNetError(f"unexpected parameter {name!r} (suffix "
                             f"{suffix!r}) for a Llama model")
        out[key] = _to_tensor(np.asarray(arr))
    n_layers = max(layers) + 1 if layers else 0
    if n_layers == 0 or "blocks.0.attention.kv_proj.weight" not in out \
            or "blocks.0.mlp.gate_up.weight" not in out:
        raise MXNetError("no complete layer 0 among the parameters")
    expected = _expected_shapes(out, n_layers)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise MXNetError(f"missing parameters: {missing}")
    for key, shape in expected.items():
        if tuple(out[key].shape) != shape:
            raise MXNetError(f"parameter {key!r} has shape "
                             f"{tuple(out[key].shape)}, expected {shape}")
    return out


# -- BERT ---------------------------------------------------------------------

_BERT_GLOBAL = {
    "word_embed_weight": "word_embed.weight",
    "token_type_embed_weight": "token_type_embed.weight",
    "position_embed_weight": "position_embed.weight",
    "embed_ln_gamma": "embed_ln.gamma", "embed_ln_beta": "embed_ln.beta",
    "pooler_weight": "pooler.weight", "pooler_bias": "pooler.bias",
    "classifier_weight": "classifier.weight",
    "classifier_bias": "classifier.bias",
    "decoder_transform_weight": "decoder_transform.weight",
    "decoder_transform_bias": "decoder_transform.bias",
    "decoder_ln_gamma": "decoder_ln.gamma",
    "decoder_ln_beta": "decoder_ln.beta",
    # the masked-LM output projection shares word_embed_weight; its bias
    # is registered under the shared "word_embed_" scope
    "word_embed_bias": "decoder.bias",
}
_BERT_LAYER = {"attn_qkv_weight": "attention.qkv_proj.weight",
               "attn_qkv_bias": "attention.qkv_proj.bias",
               "attn_out_weight": "attention.out_proj.weight",
               "attn_out_bias": "attention.out_proj.bias",
               "ffn_ffn1_weight": "ffn.ffn1.weight",
               "ffn_ffn1_bias": "ffn.ffn1.bias",
               "ffn_ffn2_weight": "ffn.ffn2.weight",
               "ffn_ffn2_bias": "ffn.ffn2.bias",
               "ln1_gamma": "ln1.gamma", "ln1_beta": "ln1.beta",
               "ln2_gamma": "ln2.gamma", "ln2_beta": "ln2.beta"}
_BERT_LAYER_RE = re.compile(r"enc_layer(\d+)_(" + "|".join(_BERT_LAYER)
                            + r")")
# the heads come whole or not at all
_BERT_HEADS = {"pooler": ("pooler.weight", "pooler.bias"),
               "classifier": ("classifier.weight", "classifier.bias"),
               "decoder": ("decoder_transform.weight",
                           "decoder_transform.bias", "decoder_ln.gamma",
                           "decoder_ln.beta", "decoder.bias")}


def _bert_shapes(out, n_layers):
    """Every name's shape implied by the word, token-type and position
    embeddings and layer 0's FFN: (V, U), (T, U), (P, U) tables, (3U, U)
    qkv, (U, U) out, (F, U) ffn1, (U, F) ffn2, (U,) norms and biases,
    (2, U) classifier, (V,) decoder bias."""
    vocab, units = out["word_embed.weight"].shape
    hidden = out["encoder.cells.0.ffn.ffn1.weight"].shape[0]
    shapes = {"word_embed.weight": (vocab, units),
              "token_type_embed.weight": (
                  out["token_type_embed.weight"].shape[0], units),
              "position_embed.weight": (
                  out["position_embed.weight"].shape[0], units),
              "embed_ln.gamma": (units,), "embed_ln.beta": (units,)}
    per = {"attention.qkv_proj.weight": (3 * units, units),
           "attention.qkv_proj.bias": (3 * units,),
           "attention.out_proj.weight": (units, units),
           "attention.out_proj.bias": (units,),
           "ffn.ffn1.weight": (hidden, units), "ffn.ffn1.bias": (hidden,),
           "ffn.ffn2.weight": (units, hidden), "ffn.ffn2.bias": (units,),
           "ln1.gamma": (units,), "ln1.beta": (units,),
           "ln2.gamma": (units,), "ln2.beta": (units,)}
    for i in range(n_layers):
        for k, s in per.items():
            shapes[f"encoder.cells.{i}.{k}"] = s
    heads = {"pooler.weight": (units, units), "pooler.bias": (units,),
             "classifier.weight": (2, units), "classifier.bias": (2,),
             "decoder_transform.weight": (units, units),
             "decoder_transform.bias": (units,),
             "decoder_ln.gamma": (units,), "decoder_ln.beta": (units,),
             "decoder.bias": (vocab,)}
    for names in _BERT_HEADS.values():
        if any(n in out for n in names):
            shapes.update({n: heads[n] for n in names})
    return shapes


def bert_params_from_reference(named: Dict[str, np.ndarray]
                               ) -> Dict[str, torch.Tensor]:
    """Map a JAX ``BERTModel``'s named numpy parameters onto the port's
    ``BERTModel.state_dict()`` names (CPU tensors of the same dtype;
    ``load_state_dict`` moves them to the model's device and dtype).

    Names match on their suffix after the model prefix (for example
    ``bertmodel0_``). The masked-LM output projection is tied to the word
    embedding: when the decoder head is present, ``word_embed_weight``
    fills both ``word_embed.weight`` and ``decoder.weight``. Raises
    :class:`MXNetError` on a missing name, an unknown name, a head that
    is only partly present, or a shape that disagrees with the rest."""
    heads = [n for n in named if n.endswith("word_embed_weight")]
    if len(heads) != 1:
        raise MXNetError(f"expected exactly one '*word_embed_weight' "
                         f"parameter, found {heads}")
    prefix = heads[0][:-len("word_embed_weight")]
    out: Dict[str, torch.Tensor] = {}
    layers = set()
    for name, arr in named.items():
        if not name.startswith(prefix):
            raise MXNetError(f"parameter {name!r} lacks the model prefix "
                             f"{prefix!r}")
        suffix = name[len(prefix):]
        m = _BERT_LAYER_RE.fullmatch(suffix)
        if suffix in _BERT_GLOBAL:
            key = _BERT_GLOBAL[suffix]
        elif m is not None:
            layers.add(int(m.group(1)))
            key = f"encoder.cells.{int(m.group(1))}.{_BERT_LAYER[m.group(2)]}"
        else:
            raise MXNetError(f"unexpected parameter {name!r} (suffix "
                             f"{suffix!r}) for a BERT model")
        out[key] = _to_tensor(np.asarray(arr))
    n_layers = max(layers) + 1 if layers else 0
    needed = ("token_type_embed.weight", "position_embed.weight",
              "encoder.cells.0.ffn.ffn1.weight")
    if n_layers == 0 or any(k not in out for k in needed):
        raise MXNetError(f"missing parameters among {list(needed)}: no "
                         "complete embedding set and layer 0")
    for head, names in _BERT_HEADS.items():
        present = [n for n in names if n in out]
        if present and len(present) != len(names):
            raise MXNetError(f"the {head} head is incomplete: missing "
                             f"{sorted(set(names) - set(present))}")
    expected = _bert_shapes(out, n_layers)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise MXNetError(f"missing parameters: {missing}")
    for key, shape in expected.items():
        if tuple(out[key].shape) != shape:
            raise MXNetError(f"parameter {key!r} has shape "
                             f"{tuple(out[key].shape)}, expected {shape}")
    if "decoder.bias" in out:
        out["decoder.weight"] = out["word_embed.weight"]
    return out


# the fused-pretraining head, at the model's own scope
_BERT_PRETRAIN_HEAD = {
    "decoder_transform_weight": "decoder_transform.weight",
    "decoder_transform_bias": "decoder_transform.bias",
    "decoder_ln_gamma": "decoder_ln.gamma",
    "decoder_ln_beta": "decoder_ln.beta",
    "decoder_bias": "decoder_bias",
}


def bert_pretrain_params_from_reference(named: Dict[str, np.ndarray]
                                        ) -> Dict[str, torch.Tensor]:
    """Map a JAX ``BERTForPretrainFused``'s named numpy parameters onto
    the port's ``BERTForPretrainFused.state_dict()`` names.

    The backbone's names (``<prefix>bert_*``) go through
    :func:`bert_params_from_reference`'s table (a backbone without heads)
    into ``bert.*``; the head's (``<prefix>decoder_transform_*``,
    ``<prefix>decoder_ln_*``, ``<prefix>decoder_bias``) map to the
    model's own. The output projection is the word embedding itself, so
    there is no projection weight to carry. Raises :class:`MXNetError`
    on a missing, unknown or mis-shaped name."""
    heads = [n for n in named if n.endswith("bert_word_embed_weight")]
    if len(heads) != 1:
        raise MXNetError(f"expected exactly one '*bert_word_embed_weight' "
                         f"parameter, found {heads}")
    prefix = heads[0][:-len("bert_word_embed_weight")]
    backbone, out = {}, {}
    for name, arr in named.items():
        if not name.startswith(prefix):
            raise MXNetError(f"parameter {name!r} lacks the model prefix "
                             f"{prefix!r}")
        suffix = name[len(prefix):]
        if suffix.startswith("bert_"):
            backbone[name] = arr
        elif suffix in _BERT_PRETRAIN_HEAD:
            out[_BERT_PRETRAIN_HEAD[suffix]] = _to_tensor(np.asarray(arr))
        else:
            raise MXNetError(f"unexpected parameter {name!r} (suffix "
                             f"{suffix!r}) for BERTForPretrainFused")
    bert = bert_params_from_reference(backbone)
    if any(k.startswith(("pooler.", "classifier.", "decoder"))
           for k in bert):
        raise MXNetError("the BERTForPretrainFused backbone has no pooler, "
                         "classifier or masked-LM decoder of its own")
    out.update({"bert." + k: v for k, v in bert.items()})
    vocab, units = bert["word_embed.weight"].shape
    shapes = {"decoder_transform.weight": (units, units),
              "decoder_transform.bias": (units,),
              "decoder_ln.gamma": (units,), "decoder_ln.beta": (units,),
              "decoder_bias": (vocab,)}
    missing = sorted(set(shapes) - set(out))
    if missing:
        raise MXNetError(f"missing parameters: {missing}")
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise MXNetError(f"parameter {key!r} has shape "
                             f"{tuple(out[key].shape)}, expected {shape}")
    return out
