"""Gluon layer of the port (counterpart of ``mxnet_tpu/gluon``):
``Block``/``HybridBlock``, ``Parameter``/``Constant``/``ParameterDict``,
the ``Trainer``, the layers (``nn``), the losses, ``utils`` and the model
zoo's BERT, Llama and ResNet v1 models, ``data`` (datasets,
samplers, the ``DataLoader``), ``rnn`` (the recurrent layers and cells)
and ``contrib`` (``nn``, ``rnn``, ``estimator``)."""
from . import data, loss, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Constant, Parameter, ParameterDict
from .trainer import Trainer
from . import model_zoo  # noqa: E402  (builds on the layers above)
from . import contrib  # noqa: E402  (builds on nn, rnn and the Trainer)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "Constant", "Parameter",
           "ParameterDict", "Trainer", "contrib", "data", "loss",
           "model_zoo", "nn", "rnn", "utils"]
