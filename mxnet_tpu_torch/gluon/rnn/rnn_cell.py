"""Recurrent cells of the port.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``: the ``RecurrentCell``
base (``begin_state``, ``unroll`` with ``merge_outputs`` and
``valid_length`` through ``SequenceMask``/``SequenceLast``), the cells
``RNNCell``, ``LSTMCell`` (gates i, f, g, o) and ``GRUCell`` (r, z, n),
and the containers and modifiers ``SequentialRNNCell``,
``HybridSequentialRNNCell``, ``DropoutCell``, ``ModifierCell``,
``ZoneoutCell``, ``ResidualCell`` and ``BidirectionalCell``.

A cell is called one step at a time, ``cell(x_t, states) -> (out,
states)``, with a list of states; it runs its body eagerly (on NDArrays
with ``F`` = ``mx.nd``, on tensors with the registered ops), whether or
not it is hybridized: a step is a handful of ops, and the fused layers
(``rnn_layer.py``) are what runs a sequence through CUDA graphs. Dropout
and zoneout draw their masks through the ``Dropout`` op, the port's
position hash.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell", "ModifierCell",
           "HybridSequentialRNNCell"]


def _format_sequence(length, inputs, layout):
    """The steps of ``inputs`` (a list of (batch, C) arrays, or one array
    in ``layout``) as a list, the time axis and the batch size."""
    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        in_list = list(inputs)
        batch = in_list[0].shape[0]
    else:
        if axis != 0:
            inputs = inputs.swapaxes(0, axis)
        batch = inputs.shape[1]
        in_list = [inputs[i] for i in range(inputs.shape[0])]
    return in_list, axis, batch


def zero_states(block, x, batch_size) -> list:
    """``block``'s initial states as zeros on ``x``'s device and dtype:
    NDArrays through ``block.begin_state`` for an NDArray ``x``, tensors
    for a tensor."""
    if isinstance(x, NDArray):
        return block.begin_state(batch_size, ctx=x.context,
                                 dtype=str(x.dtype))
    return [torch.zeros(info["shape"], dtype=x.dtype, device=x.device)
            for info in block.state_info(batch_size)]


class RecurrentCell(HybridBlock):
    """Base of the cells: ``state_info``, ``begin_state``, ``unroll``."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters before a new sequence."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states (zeros by default), one per
        :meth:`state_info` entry."""
        from ... import ndarray as F

        func = func or F.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            shape = info["shape"] if isinstance(info, dict) else info
            states.append(func(shape=shape, ctx=ctx, **kwargs))
        return states

    def __call__(self, inputs, states=None):
        self._counter += 1
        return super().__call__(inputs, states)

    def forward(self, inputs, states=None):
        if states is None:
            states = zero_states(self, inputs, inputs.shape[0])
        return self._eager_forward([inputs, states],
                                   nd=isinstance(inputs, NDArray))

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run the cell over ``length`` steps of ``inputs``; returns
        ``(outputs, states)``: a list of steps, or one array in
        ``layout`` with ``merge_outputs``. With ``valid_length`` the
        steps past each sequence's length are zeros and its states are
        those of its last valid step."""
        from ... import ndarray as F

        self.reset()
        in_list, axis, batch = _format_sequence(length, inputs, layout)
        if begin_state is None:
            begin_state = zero_states(self, in_list[0], batch)
        states = begin_state
        outputs = []
        all_states = [] if valid_length is not None else None
        for i in range(length):
            output, states = self(in_list[i], states)
            outputs.append(output)
            if all_states is not None:
                all_states.append(states)
        if valid_length is not None:
            stacked = F.stack(*outputs, axis=0)
            stacked = F.SequenceMask(stacked, valid_length,
                                     use_sequence_length=True, axis=0)
            outputs = [stacked[i] for i in range(length)]
            # each sequence's final state is its state at its last
            # valid step
            states = []
            for s_idx in range(len(all_states[0])):
                s_seq = F.stack(*[st[s_idx] for st in all_states], axis=0)
                states.append(F.SequenceLast(s_seq, valid_length,
                                             use_sequence_length=True,
                                             axis=0))
        if merge_outputs:
            outputs = F.stack(*outputs, axis=layout.find("T"))
        return outputs, states


HybridRecurrentCell = RecurrentCell


class _GatedCell(RecurrentCell):
    """A cell with i2h/h2h weights and biases of ``gates * hidden`` rows,
    the input size deferred to the first step."""

    _num_gates = 1

    def __init__(self, hidden_size, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        rows = self._num_gates * hidden_size
        with self.name_scope():
            self.i2h_weight = self.params.get(
                "i2h_weight", shape=(rows, input_size),
                init=i2h_weight_initializer, allow_deferred_init=True)
            self.h2h_weight = self.params.get(
                "h2h_weight", shape=(rows, hidden_size),
                init=h2h_weight_initializer, allow_deferred_init=True)
            self.i2h_bias = self.params.get(
                "i2h_bias", shape=(rows,), init=i2h_bias_initializer)
            self.h2h_bias = self.params.get(
                "h2h_bias", shape=(rows,), init=h2h_bias_initializer)

    def _infer_param_shapes(self, x, *rest):
        rows = self._num_gates * self._hidden_size
        self.i2h_weight._finish_deferred_init((rows, x.shape[-1]))
        self.h2h_weight._finish_deferred_init((rows, self._hidden_size))

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        rows = self._num_gates * self._hidden_size
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=rows)
        h2h = F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=rows)
        return i2h, h2h


class RNNCell(_GatedCell):
    """``act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, act tanh or relu."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        output = F.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """The LSTM step, gates i, f, g, o."""

    _num_gates = 4

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._projections(F, inputs, states[0], i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        in_gate, forget_gate, in_trans, out_gate = F.split(
            gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(in_gate)
        forget_gate = F.sigmoid(forget_gate)
        in_trans = F.Activation(in_trans, act_type="tanh")
        out_gate = F.sigmoid(out_gate)
        next_c = forget_gate * states[1] + in_gate * in_trans
        next_h = out_gate * F.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """The GRU step, gates r, z, n with ``n = tanh(i2h_n + r * h2h_n)``."""

    _num_gates = 3

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None):
        super().__init__(hidden_size, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, i2h_weight,
                                     h2h_weight, i2h_bias, h2h_bias)
        i2h_r, i2h_z, i2h_n = F.split(i2h, num_outputs=3, axis=1)
        h2h_r, h2h_z, h2h_n = F.split(h2h, num_outputs=3, axis=1)
        reset = F.sigmoid(i2h_r + h2h_r)
        update = F.sigmoid(i2h_z + h2h_z)
        next_n = F.Activation(i2h_n + reset * h2h_n, act_type="tanh")
        next_h = (1.0 - update) * next_n + update * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each taking its slice
    of the states."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def hybrid_forward(self, F, inputs, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states


class DropoutCell(RecurrentCell):
    """Dropout of each step's input at ``rate`` (in training), no
    state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(RecurrentCell):
    """A cell wrapped around ``base_cell``, which it holds as a child and
    whose states it carries."""

    def __init__(self, base_cell):
        super().__init__(prefix=base_cell.prefix + self._alias() + "_",
                         params=None)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=None, **kwargs):
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size, func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout: each output (state) element keeps its previous value with
    probability ``zoneout_outputs`` (``zoneout_states``); the masks come
    from the ``Dropout`` op in ``always`` mode."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p, mode="always")

        prev_output = self._prev_output if self._prev_output is not None \
            else F.zeros_like(next_output)
        if self.zoneout_outputs > 0.0:
            output = F.where(mask(self.zoneout_outputs, next_output) != 0,
                             next_output, prev_output)
        else:
            output = next_output
        if self.zoneout_states > 0.0:
            new_states = [F.where(mask(self.zoneout_states, ns) != 0, ns, os)
                          for ns, os in zip(next_states, states)]
        else:
            new_states = next_states
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """The base cell's output plus its input."""

    def _alias(self):
        return "residual"

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed (each
    sequence's valid steps reversed with ``valid_length``), outputs
    concatenated; only :meth:`unroll` runs it."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")
        self._output_prefix = output_prefix

    def state_info(self, batch_size=0):
        return (self._children["l_cell"].state_info(batch_size)
                + self._children["r_cell"].state_info(batch_size))

    def __call__(self, inputs, states=None):
        raise MXNetError("BidirectionalCell supports only unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F

        self.reset()
        in_list, axis, batch = _format_sequence(length, inputs, layout)
        l_cell = self._children["l_cell"]
        r_cell = self._children["r_cell"]
        if begin_state is None:
            begin_state = zero_states(self, in_list[0], batch)
        n_l = len(l_cell.state_info(batch))
        cell_layout = "TNC" if axis == 0 else "NTC"
        l_outputs, l_states = l_cell.unroll(
            length, in_list, begin_state[:n_l], layout=cell_layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            rev_in = list(reversed(in_list))
        else:
            # a length-aware reverse keeps the padding at the tail
            rev = F.SequenceReverse(F.stack(*in_list, axis=0), valid_length,
                                    use_sequence_length=True, axis=0)
            rev_in = [rev[i] for i in range(length)]
        r_outputs, r_states = r_cell.unroll(
            length, rev_in, begin_state[n_l:], layout=cell_layout,
            merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            r_outputs = list(reversed(r_outputs))
        else:
            rev = F.SequenceReverse(F.stack(*r_outputs, axis=0), valid_length,
                                    use_sequence_length=True, axis=0)
            r_outputs = [rev[i] for i in range(length)]
        outputs = [F.concat(lo, ro, dim=1)
                   for lo, ro in zip(l_outputs, r_outputs)]
        if merge_outputs:
            outputs = F.stack(*outputs, axis=layout.find("T"))
        return outputs, l_states + r_states


class HybridSequentialRNNCell(SequentialRNNCell):
    """:class:`SequentialRNNCell` under its hybridizable name (every
    cell container of the port runs the same body)."""
