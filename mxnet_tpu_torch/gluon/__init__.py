"""Gluon layer of the port (counterpart of ``mxnet_tpu/gluon``):
``Block``/``HybridBlock``, ``Parameter``/``Constant``/``ParameterDict``,
the ``Trainer``, the layers (``nn``), the losses, ``utils`` and the model
zoo's BERT, Llama and ResNet v1 models, and ``data`` (datasets,
samplers, the ``DataLoader``)."""
from . import data, loss, nn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer
from . import model_zoo  # noqa: E402  (builds on the layers above)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Constant", "Parameter",
           "ParameterDict", "Trainer", "data", "loss", "model_zoo", "nn",
           "utils"]
