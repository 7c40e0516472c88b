"""Gluon layer of the port (counterpart of ``mxnet_tpu/gluon``); this slice
carries only the Llama model of the model zoo."""
from . import model_zoo

__all__ = ["model_zoo"]
