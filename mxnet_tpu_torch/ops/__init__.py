"""Tensor ops of the port (counterpart of ``mxnet_tpu/ops``)."""
from . import nn
from .attention import (paged_attention, rms_norm, rope, rope_at,
                        sdp_attention)
from .nn import (activation, embedding, fully_connected, fused_bias_gelu_op,
                 fused_layer_norm_op, layer_norm)

__all__ = ["nn", "paged_attention", "rms_norm", "rope", "rope_at",
           "sdp_attention", "activation", "embedding", "fully_connected",
           "fused_bias_gelu_op", "fused_layer_norm_op", "layer_norm"]
