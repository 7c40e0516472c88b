"""``VariationalDropoutCell`` (counterpart of
``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; Gal & Ghahramani 2016): one
dropout mask per sequence for the inputs, the first state and the
outputs each, drawn at the first step of a sequence in training and
reused at every later step until ``reset()`` (which ``unroll`` calls).
The masks come from the ``Dropout`` op, the port's position hash."""
from __future__ import annotations

from .... import autograd
from ...rnn.rnn_cell import ModifierCell

__all__ = ["VariationalDropoutCell"]


class VariationalDropoutCell(ModifierCell):
    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _mask(self, F, which, rate, like):
        """The sequence's mask: drawn at its first step, then reused."""
        mask = getattr(self, which)
        if mask is None:
            mask = F.Dropout(F.ones_like(like), p=rate)
            setattr(self, which, mask)
        return mask

    def hybrid_forward(self, F, inputs, states):
        training = autograd.is_training()
        if training and self.drop_inputs:
            inputs = inputs * self._mask(F, "_input_mask",
                                         self.drop_inputs, inputs)
        if training and self.drop_states:
            mask = self._mask(F, "_state_mask", self.drop_states, states[0])
            states = [states[0] * mask] + list(states[1:])
        output, next_states = self.base_cell(inputs, states)
        if training and self.drop_outputs:
            output = output * self._mask(F, "_output_mask",
                                         self.drop_outputs, output)
        return output, next_states

    def __repr__(self):
        return (f"VariationalDropoutCell(in={self.drop_inputs}, "
                f"state={self.drop_states}, out={self.drop_outputs}, "
                f"base={self.base_cell.__class__.__name__})")
