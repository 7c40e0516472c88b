"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``): the
reference's sixteen optimizers with their per-parameter updates, the
``Updater`` that holds their states, and the fused multi-tensor sweeps
``parallel.TrainStep`` and ``gluon.Trainer`` run for SGD, Adam, AdamW and
LAMB."""
from . import multi_tensor
from .optimizer import (FTML, LAMB, LBSGD, NAG, SGD, SGLD, AdaDelta, AdaGrad,
                        Adam, Adamax, AdamW, DCASGD, Ftrl, Nadam, Optimizer,
                        RMSProp, Signum, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "RMSProp", "AdaGrad",
           "AdaDelta", "Ftrl", "Signum", "SGLD", "DCASGD", "LAMB", "FTML",
           "Adamax", "Nadam", "LBSGD", "Updater", "create", "register",
           "get_updater", "multi_tensor"]
