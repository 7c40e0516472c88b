"""The fused recurrent layers ``RNN``, ``LSTM`` and ``GRU``.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``: the parameters are
``{l,r}{i}_{i2h,h2h}_{weight,bias}`` (so ``.params`` files cross between
the packages in both directions), packed into the ``RNN`` op's flat
vector at each call (``_pack_params``); layouts TNC and NTC; the input
size deferred to the first call; ``begin_state``; states passed or made
as zeros (then only the output is returned).

The states are passed as separate inputs of the block (``forward(x,
[h, c])`` calls the body with ``x, h, c``), so a hybridized layer keeps
one CUDA graph per signature in the port's ``_CachedGraph``, as every
``HybridBlock`` does: the graph's warm-up call makes cuDNN's descriptors
and workspace before the capture, and a failed capture raises.
"""
from __future__ import annotations

from ..block import HybridBlock
from .rnn_cell import zero_states

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout, bidirectional,
                 input_size, i2h_weight_initializer, h2h_weight_initializer,
                 i2h_bias_initializer, h2h_bias_initializer, mode, gates,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert layout in ("TNC", "NTC"), "layout must be TNC or NTC"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = gates
        ng, ni, nh = gates, input_size, hidden_size
        with self.name_scope():
            for i in range(num_layers):
                for j in ["l", "r"][: self._dir]:
                    self._register_param(
                        f"{j}{i}_i2h_weight",
                        (ng * nh, ni if i == 0 else nh * self._dir),
                        i2h_weight_initializer)
                    self._register_param(
                        f"{j}{i}_h2h_weight", (ng * nh, nh),
                        h2h_weight_initializer)
                    self._register_param(
                        f"{j}{i}_i2h_bias", (ng * nh,), i2h_bias_initializer)
                    self._register_param(
                        f"{j}{i}_h2h_bias", (ng * nh,), h2h_bias_initializer)

    def _register_param(self, name, shape, init):
        setattr(self, name, self.params.get(name, shape=shape, init=init,
                                            allow_deferred_init=True))

    def _infer_param_shapes(self, x, *rest):
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            in_size = x.shape[2] if i == 0 else nh * self._dir
            for j in ["l", "r"][: self._dir]:
                getattr(self, f"{j}{i}_i2h_weight")._finish_deferred_init(
                    (ng * nh, in_size))
                getattr(self, f"{j}{i}_h2h_weight")._finish_deferred_init(
                    (ng * nh, nh))
                getattr(self, f"{j}{i}_i2h_bias")._finish_deferred_init(
                    (ng * nh,))
                getattr(self, f"{j}{i}_h2h_bias")._finish_deferred_init(
                    (ng * nh,))

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states (zeros by default), one array per
        :meth:`state_info` entry."""
        from ... import ndarray as F

        func = func or F.zeros
        return [func(shape=info["shape"], ctx=ctx, **kwargs)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        if states is None:
            return super().forward(inputs)
        if not isinstance(states, (list, tuple)):
            states = [states]
        return super().forward(inputs, *states)

    def hybrid_forward(self, F, inputs, *states, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        explicit_states = bool(states)
        if not explicit_states:
            states = zero_states(self, inputs, inputs.shape[1])
        flat = self._pack_params(F, params)
        kw = dict(state_size=self._hidden_size, num_layers=self._num_layers,
                  mode=self._mode, bidirectional=self._dir == 2,
                  p=self._dropout)
        if self._mode == "lstm":
            out, h_n, c_n = F.RNN(inputs, flat, states[0], states[1], **kw)
            new_states = [h_n, c_n]
        else:
            out, h_n = F.RNN(inputs, flat, states[0], **kw)
            new_states = [h_n]
        if self._layout == "NTC":
            out = F.swapaxes(out, dim1=0, dim2=1)
        if explicit_states:
            return out, new_states
        return out

    def _pack_params(self, F, params):
        """The per-layer weights packed into the op's flat vector (the
        layout of ``ops/rnn.py``'s ``_slice_params``)."""
        ws = []
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                ws.append(params[f"{j}{i}_i2h_weight"].reshape(-1))
                ws.append(params[f"{j}{i}_h2h_weight"].reshape(-1))
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                ws.append(params[f"{j}{i}_i2h_bias"])
                ws.append(params[f"{j}{i}_h2h_bias"])
        return F.concat(*ws, dim=0)

    def __repr__(self):
        return (f"{type(self).__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, layout={self._layout}, "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    """Vanilla RNN, ``activation`` relu or tanh."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, 1,
                         **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", 4, **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", 3, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
