"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (counterpart of ``mxnet_tpu/pallas_kernels``)."""
from .fused_layers import fused_rms_norm, fused_rms_norm_reference
from .paged_attention import (paged_attention_kernel,
                              paged_attention_reference)

__all__ = ["fused_rms_norm", "fused_rms_norm_reference",
           "paged_attention_kernel", "paged_attention_reference"]
