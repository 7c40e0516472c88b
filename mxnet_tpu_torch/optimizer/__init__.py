"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``):
``SGD``, ``Adam``, ``AdamW`` and the fused multi-tensor sweeps
``parallel.TrainStep`` runs."""
from . import multi_tensor
from .optimizer import SGD, Adam, AdamW, Optimizer, create

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "multi_tensor"]
