"""Gluon recurrent layers and cells of the port (counterpart of
``mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,  # noqa: F401
                       HybridRecurrentCell, HybridSequentialRNNCell,
                       LSTMCell, ModifierCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401
