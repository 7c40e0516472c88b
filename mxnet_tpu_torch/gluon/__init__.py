"""Gluon layer of the port (counterpart of ``mxnet_tpu/gluon``): the basic
layers and the model zoo's BERT and Llama serving models."""
from . import model_zoo, nn

__all__ = ["model_zoo", "nn"]
