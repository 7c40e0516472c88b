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

__all__ = ["llama_params_from_reference"]

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
