"""Gluon layers of the port (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import Dense, Dropout, Embedding, HybridSequential, LayerNorm

__all__ = ["Dense", "Dropout", "Embedding", "HybridSequential", "LayerNorm"]
