"""Gluon layers of the port (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403

# the Block bases through gluon.nn as well, as upstream exposes them
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401,E402
