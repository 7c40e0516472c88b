"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``):
``Adam``, ``AdamW`` and the fused multi-tensor sweeps ``parallel.TrainStep``
runs."""
from . import multi_tensor
from .optimizer import Adam, AdamW, Optimizer, create

__all__ = ["Optimizer", "Adam", "AdamW", "create", "multi_tensor"]
