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
           "bert_pretrain_params_from_reference",
           "resnet_params_from_reference"]

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


# -- ResNet v1 ----------------------------------------------------------------

_RESNET_RE = re.compile(
    r"(?P<prefix>.*?)(?:stage(?P<stage>\d+)_)?(?P<kind>conv2d|batchnorm|dense)"
    r"(?P<idx>\d+)_(?P<field>weight|bias|gamma|beta|running_mean|"
    r"running_var)")
_BN_FIELDS = {"gamma", "beta", "running_mean", "running_var"}


def resnet_params_from_reference(named: Dict[str, np.ndarray]
                                 ) -> Dict[str, torch.Tensor]:
    """Map a JAX ``ResNetV1``'s named numpy parameters, BatchNorm's
    running statistics included, onto the port's ``ResNetV1.state_dict()``
    names (CPU tensors of the same dtype; ``load_state_dict`` moves them
    to the model's device and dtype).

    The reference names its layers by process-wide counters
    (``resnetv10_stage2_conv2d7_weight``), so the layers of the stem and
    of each stage are taken in counter order, which is construction
    order: each block's body, then its downsample. The block type is read
    from a stage's first convolution (1x1: bottleneck, 3x3: basic), a
    first block's downsample from the stage's convolution count, the
    thumbnail stem from the absence of a stem BatchNorm. Raises
    :class:`MXNetError` on an unknown name, a missing or extra layer, or
    channel counts that do not chain from the 3 input channels to the
    classifier."""
    groups: Dict[tuple, Dict[str, np.ndarray]] = {}
    prefixes = set()
    for name, arr in named.items():
        m = _RESNET_RE.fullmatch(name)
        if m is None:
            raise MXNetError(f"unexpected parameter {name!r} for a ResNet v1 "
                             "model")
        prefixes.add(m["prefix"])
        key = (int(m["stage"] or 0), m["kind"], int(m["idx"]))
        groups.setdefault(key, {})[m["field"]] = np.asarray(arr)
    if len(prefixes) != 1:
        raise MXNetError(f"parameters of more than one model: {prefixes}")

    def layers(stage, kind):
        return [(f"{kind}{k[2]}", groups[k]) for k in sorted(
            k for k in groups if k[0] == stage and k[1] == kind)]

    out: Dict[str, torch.Tensor] = {}

    def conv(key, layer, c_in):
        what, fields = layer
        w = fields.get("weight")
        if set(fields) != {"weight"} or w.ndim != 4 or w.shape[1] != c_in:
            raise MXNetError(f"{what}: expected one (O, {c_in}, kh, kw) "
                             f"weight, got {_shapes(fields)}")
        out[key + ".weight"] = _to_tensor(w)
        return w.shape[0]

    def bn(key, layer, c):
        what, fields = layer
        if set(fields) != _BN_FIELDS or any(
                a.shape != (c,) for a in fields.values()):
            raise MXNetError(f"{what}: expected gamma, beta, running_mean "
                             f"and running_var of shape ({c},), got "
                             f"{_shapes(fields)}")
        for f, a in fields.items():
            out[f"{key}.{f}"] = _to_tensor(a)

    stem_convs, stem_bns = layers(0, "conv2d"), layers(0, "batchnorm")
    if len(stem_convs) != 1 or len(stem_bns) > 1:
        raise MXNetError(f"expected one stem convolution and at most one "
                         f"stem BatchNorm, got {len(stem_convs)} and "
                         f"{len(stem_bns)}")
    c = conv("features.0", stem_convs[0], 3)
    if stem_bns:
        bn("features.1", stem_bns[0], c)
    first = 4 if stem_bns else 1      # conv, bn, relu, max pool / conv
    stages = sorted({k[0] for k in groups} - {0})
    if not stages or stages != list(range(1, len(stages) + 1)):
        raise MXNetError(f"stages {stages} are not 1, 2, ...")
    for s in stages:
        convs, bns = layers(s, "conv2d"), layers(s, "batchnorm")
        if not convs or len(convs) != len(bns):
            raise MXNetError(f"stage {s}: {len(convs)} convolutions and "
                             f"{len(bns)} BatchNorms")
        per = 3 if convs[0][1]["weight"].shape[2:] == (1, 1) else 2
        n_blocks, ds = divmod(len(convs), per)
        if ds > 1:
            raise MXNetError(f"stage {s}: {len(convs)} convolutions do not "
                             f"make blocks of {per}")
        pairs = iter(zip(convs, bns))
        for b in range(n_blocks):
            base = f"features.{first + s - 1}.{b}"
            c_in = c
            for k in range(per):
                cv, norm = next(pairs)
                c = conv(f"{base}.body.{3 * k}", cv, c)
                bn(f"{base}.body.{3 * k + 1}", norm, c)
            if b == 0 and ds:
                cv, norm = next(pairs)
                c_ds = conv(f"{base}.downsample.0", cv, c_in)
                bn(f"{base}.downsample.1", norm, c_ds)
                if c_ds != c:
                    raise MXNetError(f"stage {s}: the downsample gives "
                                     f"{c_ds} channels, the body {c}")
            elif c != c_in:
                raise MXNetError(f"stage {s}, block {b}: {c_in} channels "
                                 f"in, {c} out, and no downsample")
    dense = layers(0, "dense")
    if len(dense) != 1 or set(dense[0][1]) != {"weight", "bias"}:
        raise MXNetError("expected one classifier with a weight and a bias")
    w, bias = dense[0][1]["weight"], dense[0][1]["bias"]
    if w.shape[1:] != (c,) or bias.shape != (w.shape[0],):
        raise MXNetError(f"classifier: weight {w.shape} and bias "
                         f"{bias.shape} after {c} channels")
    out["output.weight"], out["output.bias"] = _to_tensor(w), \
        _to_tensor(bias)
    return out


def _shapes(fields):
    return {f: tuple(a.shape) for f, a in fields.items()}
