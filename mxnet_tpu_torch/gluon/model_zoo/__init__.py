"""Model zoo of the port (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import nlp

__all__ = ["nlp"]
