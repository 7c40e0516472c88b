"""Gluon contrib of the port (counterpart of ``mxnet_tpu/gluon/contrib``):
``nn`` (``Concurrent``, ``HybridConcurrent``, ``Identity``,
``SyncBatchNorm``, ``PixelShuffle2D``), ``rnn`` (the convolutional
cells, ``VariationalDropoutCell``) and ``estimator``."""
from . import nn  # noqa: F401
from . import estimator  # noqa: F401
from . import rnn  # noqa: F401
