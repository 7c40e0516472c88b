"""Convolutional recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py:26-170``; ConvLSTM, Shi
et al. 2015): ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``.

State and input are channels-first feature maps; the i2h and h2h
projections are ``Convolution`` ops, so the recurrence keeps the spatial
structure. The state's spatial shape is the i2h convolution's output
(stride 1, ``i2h_pad``, ``i2h_dilate``) on ``input_shape``, given at
construction as in the reference; the h2h convolution pads
``h2h_dilate (k - 1) / 2`` so it keeps that shape, which needs an odd
``h2h_kernel`` (an even one raises ``ValueError``, as there). The gates
are the reference's: LSTM i, f, g, o; GRU r, z, n with
``n = tanh(i2h_n + r * h2h_n)``.
"""
from __future__ import annotations

from ...rnn.rnn_cell import RecurrentCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected length-{n} tuple, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


class _BaseConvRNNCell(RecurrentCell):
    """The i2h/h2h convolution weights and biases (``gates * hidden``
    output channels) and the spatial state shape."""

    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dims=2, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._dims = dims
        self._input_shape = tuple(input_shape)
        if len(self._input_shape) != dims + 1:
            raise ValueError(
                f"input_shape must be (channels, *{dims} spatial dims), "
                f"got {input_shape}")
        self._channels = int(hidden_channels)
        self._i2h_kernel = _tuple(i2h_kernel, dims)
        self._h2h_kernel = _tuple(h2h_kernel, dims)
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise ValueError(f"h2h_kernel must be odd (state shape must be "
                             f"preserved), got {self._h2h_kernel}")
        self._i2h_pad = _tuple(i2h_pad, dims)
        self._i2h_dilate = _tuple(i2h_dilate, dims)
        self._h2h_dilate = _tuple(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for k, d in
                              zip(self._h2h_kernel, self._h2h_dilate))
        self._state_spatial = tuple(
            s + 2 * p - d * (k - 1)
            for s, p, d, k in zip(self._input_shape[1:], self._i2h_pad,
                                  self._i2h_dilate, self._i2h_kernel))
        rows = self._num_gates * self._channels
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(rows, self._input_shape[0])
                + self._i2h_kernel, init=i2h_weight_initializer)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(rows, self._channels) + self._h2h_kernel,
                init=h2h_weight_initializer)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(rows,), init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(rows,), init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._channels) + self._state_spatial
        n_states = 2 if self._num_gates == 4 else 1
        return [{"shape": shape, "__layout__": "NC" + "DHW"[-self._dims:]}
                for _ in range(n_states)]

    def _conv_pair(self, F, inputs, state_h, i2h_weight, h2h_weight,
                   i2h_bias, h2h_bias):
        rows = self._num_gates * self._channels
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            dilate=self._i2h_dilate, num_filter=rows)
        h2h = F.Convolution(state_h, h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            dilate=self._h2h_dilate, num_filter=rows)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    """``tanh(conv(x) + conv(h))``."""

    _num_gates = 1

    def _alias(self):
        return "conv_rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        out = F.Activation(i2h + h2h, act_type="tanh")
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    """The LSTM step over feature maps, gates i, f, g, o."""

    _num_gates = 4

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        in_g, forget_g, in_t, out_g = F.split(i2h + h2h, num_outputs=4,
                                              axis=1)
        next_c = F.sigmoid(forget_g) * states[1] \
            + F.sigmoid(in_g) * F.Activation(in_t, act_type="tanh")
        next_h = F.sigmoid(out_g) * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    """The GRU step over feature maps, gates r, z, n."""

    _num_gates = 3

    def _alias(self):
        return "conv_gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_pair(F, inputs, states[0], i2h_weight,
                                   h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        new = F.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        next_h = (1.0 - update) * new + update * states[0]
        return next_h, [next_h]


def _make(cls, dims, name):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 **kwargs):
        cls.__init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, dims=dims, **kwargs)

    return type(name, (cls,), {"__init__": __init__,
                               "__doc__": f"{dims}-D: {cls.__doc__}"})


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
