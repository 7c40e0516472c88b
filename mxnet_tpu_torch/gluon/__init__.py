"""Gluon layer of the port (counterpart of ``mxnet_tpu/gluon``): the basic,
convolution and pooling layers, the softmax cross-entropy loss, and the
model zoo's BERT, Llama and ResNet v1 models."""
from . import loss, model_zoo, nn

__all__ = ["loss", "model_zoo", "nn"]
