"""Tensor ops of the port (counterpart of ``mxnet_tpu/ops``)."""
from . import fused_loss, nn
from .attention import (paged_attention, rms_norm, rope, rope_at,
                        sdp_attention)
from .fused_loss import softmax_ce_head
from .nn import (activation, batch_norm, convolution, dropout, embedding,
                 flatten, fully_connected, fused_bias_gelu_op,
                 fused_layer_norm_op, layer_norm, pooling)

__all__ = ["nn", "fused_loss", "softmax_ce_head", "paged_attention",
           "rms_norm", "rope", "rope_at", "sdp_attention", "activation",
           "batch_norm", "convolution", "dropout", "embedding", "flatten",
           "fully_connected", "fused_bias_gelu_op", "fused_layer_norm_op",
           "layer_norm", "pooling"]
