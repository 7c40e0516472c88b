"""Tensor ops of the port (counterpart of ``mxnet_tpu/ops``)."""
from . import contrib, deformable, fused_loss, multibox, nn, rnn, spatial
from .attention import (paged_attention, rms_norm, rope, rope_at,
                        sdp_attention)
from .fused_loss import softmax_ce_head
from .nn import (activation, batch_norm, convolution, dropout, embedding,
                 flatten, fully_connected, fused_bias_gelu_op,
                 fused_layer_norm_op, layer_norm, pooling)

__all__ = ["contrib", "deformable", "nn", "fused_loss", "multibox", "rnn", "spatial", "softmax_ce_head",
           "paged_attention", "rms_norm", "rope", "rope_at", "sdp_attention", "activation",
           "batch_norm", "convolution", "dropout", "embedding", "flatten",
           "fully_connected", "fused_bias_gelu_op", "fused_layer_norm_op",
           "layer_norm", "pooling"]
