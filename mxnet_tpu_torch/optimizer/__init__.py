"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``):
``Adam`` and the fused multi-tensor sweep ``parallel.TrainStep`` runs."""
from . import multi_tensor
from .optimizer import Adam, Optimizer, create

__all__ = ["Optimizer", "Adam", "create", "multi_tensor"]
