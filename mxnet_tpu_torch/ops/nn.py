"""Neural-network ops of the BERT serving and pretraining paths.

Counterpart of the parts of ``mxnet_tpu/ops/nn.py`` the paths run:
``fully_connected`` (``:36``), ``embedding`` (``:1030``), ``layer_norm``
(``:707``), ``fused_layer_norm_op`` (``:742``), ``fused_bias_gelu_op``
(``:775``), ``activation`` (``:835``) and ``dropout`` (``dropout_op``,
``:1079``, its position-hash branch). A CUDA tensor takes the port's
kernels, a CPU tensor their plain versions; under autograd the fused
ops go through the kernels' differentiable wrappers (their backward
kernels on the card). The matrix products go to the library GEMM
(``torch.nn.functional.linear``), as the JAX package leaves them to XLA
outside any kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd, random_state
from ..base import MXNetError
from ..kernels import fused_bias_gelu, fused_layer_norm, hash_dropout

__all__ = ["fully_connected", "embedding", "layer_norm",
           "fused_layer_norm_op", "fused_bias_gelu_op", "activation",
           "dropout"]


def fully_connected(data, weight, bias=None, *, flatten=True):
    """``data @ weight.T + bias`` with MXNet's (out, in) weight;
    ``flatten`` folds every axis after the first into the input axis."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight.to(data.dtype),
                    None if bias is None else bias.to(data.dtype))


def embedding(data, weight):
    """Rows of ``weight`` at the indices ``data``, which may arrive as
    floats (the serving batcher casts every sample to its dtype) and are
    truncated to int64, as the JAX op truncates them to int32."""
    return F.embedding(data.to(torch.int64), weight)


def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5):
    """LayerNorm over the last axis through the fused kernel (no
    residual); output in data's dtype."""
    if axis not in (-1, data.dim() - 1):
        raise MXNetError(f"layer_norm: axis {axis} is not the last axis; "
                         "the port normalises the last axis only")
    return fused_layer_norm(data, gamma, beta, eps=eps)


def fused_layer_norm_op(data, gamma, beta, residual=None, *, eps=1e-5,
                        dropout=0.0):
    """``LayerNorm(dropout(data) + residual)`` over the last axis: the
    post-LN transformer cell's add+norm in one kernel. ``dropout`` drops
    ``data`` (not the residual) in training mode only
    (``autograd.is_training()``), under a seed drawn from
    ``random_state`` only then (the reference's ``rng_gate``)."""
    p = float(dropout) if autograd.is_training() else 0.0
    seed = random_state.next_seed(data.device) if p > 0.0 else None
    return fused_layer_norm(data, gamma, beta, residual, eps=eps,
                            dropout=p, seed=seed)


def dropout(data, p=0.5, mode="training", axes=()):
    """``Dropout``: in training mode (``autograd.is_training()``), or
    always with ``mode="always"``, each element of the mask shape
    (data's shape with ``axes`` set to 1) is kept with probability
    ``1 - p`` by the position hash under a seed drawn from
    ``random_state`` (only when it applies), and kept elements are scaled
    by ``dtype(1 / (1 - p))``; otherwise, or at ``p = 0``, the identity.
    The reference's ``dropout_op`` draws ``jax.random.bits`` unless
    ``MXNET_TPU_HASH_DROPOUT=1`` or ``MXNET_PALLAS_FUSED=1``; the port
    always takes that hash branch (``ops/nn.py:1093-1121``)."""
    if mode not in ("training", "always"):
        raise MXNetError(f"dropout: mode {mode!r} is not 'training' or "
                         "'always'")
    if not (autograd.is_training() or mode == "always") or p == 0.0:
        return data
    return hash_dropout(data.contiguous(), p,
                        random_state.next_seed(data.device), axes)


def fused_bias_gelu_op(data, bias):
    """``gelu(data + bias)``, exact erf, the Dense epilogue."""
    return fused_bias_gelu(data, bias)


# the activations the ported blocks use: PositionwiseFFN's default
# (relu), BERT's FFN and MLM transform (gelu), BERT's pooler (tanh)
_ACTIVATIONS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="none"),
}


def activation(data, *, act_type="relu"):
    """``Activation(act_type=...)`` (``mxnet_tpu/ops/nn.py:835``) for the
    act_types the ported blocks use; the rest come with the op registry
    (ROADMAP.md, port queue 1)."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"activation: act_type {act_type!r} is not ported "
                         f"yet (ported: {sorted(_ACTIVATIONS)})")
    return fn(data)
