"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (counterpart of ``mxnet_tpu/pallas_kernels``)."""
from .dropout import (hash_dropout, hash_dropout_bwd,
                      hash_dropout_reference)
from .flash import (flash_attention, flash_attention_bwd,
                    flash_attention_bwd_reference, flash_attention_fwd,
                    flash_attention_reference)
from .fused_layers import (fused_bias_gelu, fused_bias_gelu_bwd,
                           fused_bias_gelu_bwd_reference,
                           fused_bias_gelu_reference, fused_layer_norm,
                           fused_layer_norm_bwd,
                           fused_layer_norm_bwd_reference,
                           fused_layer_norm_reference, fused_rms_norm,
                           fused_rms_norm_bwd, fused_rms_norm_bwd_reference,
                           fused_rms_norm_reference)
from .fused_optimizer import (adam_sweep_reference, adamw_sweep_reference,
                              fused_adam_sweep, fused_adamw_sweep,
                              fused_sgd_sweep, sgd_sweep_reference)
from .paged_attention import (paged_attention_kernel,
                              paged_attention_reference)

__all__ = ["hash_dropout", "hash_dropout_bwd", "hash_dropout_reference",
           "fused_rms_norm", "fused_rms_norm_reference",
           "fused_rms_norm_bwd", "fused_rms_norm_bwd_reference",
           "fused_layer_norm", "fused_layer_norm_reference",
           "fused_layer_norm_bwd", "fused_layer_norm_bwd_reference",
           "fused_bias_gelu", "fused_bias_gelu_reference",
           "fused_bias_gelu_bwd", "fused_bias_gelu_bwd_reference",
           "flash_attention", "flash_attention_fwd",
           "flash_attention_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference",
           "fused_sgd_sweep", "sgd_sweep_reference",
           "fused_adam_sweep", "adam_sweep_reference",
           "fused_adamw_sweep", "adamw_sweep_reference",
           "paged_attention_kernel", "paged_attention_reference"]
