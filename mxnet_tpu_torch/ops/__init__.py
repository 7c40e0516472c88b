"""Tensor ops of the port (counterpart of ``mxnet_tpu/ops``)."""
from .attention import paged_attention, rms_norm, rope, rope_at

__all__ = ["paged_attention", "rms_norm", "rope", "rope_at"]
