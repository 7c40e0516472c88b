"""The fused training step (counterpart of ``mxnet_tpu/parallel``), on
one device: ``TrainStep``."""
from .step import TrainStep

__all__ = ["TrainStep"]
