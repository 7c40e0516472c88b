"""The fused ``RNN`` op: vanilla RNN (relu/tanh), LSTM and GRU, multi-layer
and bidirectional, with every weight in one flat vector.

Counterpart of ``mxnet_tpu/ops/rnn.py``, whose docstring names upstream
MXNet's GPU implementation: cuDNN's ``cudnnRNNForward``. The reference is
no Pallas site (``lax.scan`` over a per-step cell), so the port has no
kernel of its own here, as for convolution:

* a CUDA tensor runs each layer through cuDNN's RNN, one call per layer
  (:func:`cudnn_rnn_layer`: ``torch._VF.{lstm,gru,rnn_tanh,rnn_relu}``
  with one layer and the layer's direction count), never with cuDNN's
  own inter-layer dropout or cell clip; the per-(layer, direction)
  weights are views of the flat vector, so gradients reach it. The
  wrapper counts its calls in ``cudnn_rnn_layer.launches``;
* a CPU tensor runs the plain version: the reference's per-step loop
  (:func:`_cell_step`, one step at a time per layer and direction; the
  reverse direction flips the input and flips its outputs back).

The flat layout is the reference's (``_slice_params``, ``:62``): per
layer and direction W_ih then W_hh; after all weights, b_ih and b_hh per
layer and direction. Gates: LSTM i, f, g, o; GRU r, z, n with ``n =
tanh(x W_in + b_in + r * (h W_hn + b_hn))``, which is cuDNN's and
torch's convention too.

Between layers, in training at ``p > 0``, every layer's output but the
last goes through the port's position-hash dropout (``hash_dropout``:
the kernel on the card, its plain version on the CPU) under a u32 seed
drawn from ``random_state``, so both devices drop the same elements and
a recompute under remat replays the masks. The reference draws
``jax.random.bernoulli`` there: a difference by design (ROADMAP.md).
``lstm_state_clip_min``/``_max`` clip only the returned ``c_n``, as the
reference does. ``projection_size`` and ``use_sequence_length=True``,
which the reference accepts and ignores, raise :class:`MXNetError`.
"""
from __future__ import annotations

import torch

from .. import autograd, random_state
from ..base import MXNetError
from ..kernels import hash_dropout
from .registry import attr, register

__all__ = ["rnn", "rnn_param_size", "cudnn_rnn_layer", "GATES"]

GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _cell_step(mode, W_ih, W_hh, b_ih, b_hh):
    """``step(carry, x_t) -> (carry, h_t)`` of one direction of one layer
    (reference ``_cell_step``, ``:25-58``)."""
    if mode == "lstm":
        def step(carry, x):
            h, c = carry
            gates = x @ W_ih.T + h @ W_hh.T + b_ih + b_hh
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            return (h_new, c_new), h_new
        return step
    if mode == "gru":
        def step(carry, x):
            (h,) = carry
            gi = x @ W_ih.T + b_ih
            gh = h @ W_hh.T + b_hh
            ir, iz, inn = torch.chunk(gi, 3, dim=-1)
            hr, hz, hn = torch.chunk(gh, 3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(inn + r * hn)
            h_new = (1 - z) * n + z * h
            return (h_new,), h_new
        return step
    act = torch.relu if mode == "rnn_relu" else torch.tanh

    def step(carry, x):
        (h,) = carry
        h_new = act(x @ W_ih.T + h @ W_hh.T + b_ih + b_hh)
        return (h_new,), h_new

    return step


def _slice_params(params, mode, num_layers, input_size, hidden, dirs):
    """The flat vector as ``[layer][direction] = [W_ih, W_hh, b_ih,
    b_hh]``, each a view of ``params``."""
    gates = GATES[mode]
    weights = []
    off = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden * dirs
        layer_ws = []
        for _ in range(dirs):
            n = gates * hidden * in_size
            W_ih = params[off:off + n].reshape(gates * hidden, in_size)
            off += n
            n = gates * hidden * hidden
            W_hh = params[off:off + n].reshape(gates * hidden, hidden)
            off += n
            layer_ws.append([W_ih, W_hh, None, None])
        weights.append(layer_ws)
    for layer in range(num_layers):
        for d in range(dirs):
            n = gates * hidden
            weights[layer][d][2] = params[off:off + n]
            off += n
            weights[layer][d][3] = params[off:off + n]
            off += n
    if off != params.numel():
        raise MXNetError(f"RNN: the parameter vector has {params.numel()} "
                         f"elements, mode {mode!r} with {num_layers} "
                         f"layer(s), input {input_size}, hidden {hidden} "
                         f"and {dirs} direction(s) needs {off}")
    return weights


def rnn_param_size(mode, num_layers, input_size, hidden, bidirectional):
    """The flat vector's length (reference ``:91``)."""
    gates = GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden * dirs
        size += dirs * gates * hidden * (in_size + hidden + 2)
    return size


def _plain_layer(mode, x, h0, c0, layer_ws):
    """One layer on the CPU: the step loop per direction; returns
    ``(out, [h_n per direction], [c_n per direction])``."""
    outs, hs, cs = [], [], []
    for d, (W_ih, W_hh, b_ih, b_hh) in enumerate(layer_ws):
        step = _cell_step(mode, W_ih, W_hh, b_ih, b_hh)
        carry = (h0[d], c0[d]) if mode == "lstm" else (h0[d],)
        seq_in = torch.flip(x, (0,)) if d == 1 else x
        ys = []
        for t in range(seq_in.shape[0]):
            carry, y = step(carry, seq_in[t])
            ys.append(y)
        ys = torch.stack(ys, 0)
        if d == 1:
            ys = torch.flip(ys, (0,))
        outs.append(ys)
        hs.append(carry[0])
        if mode == "lstm":
            cs.append(carry[1])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return out, hs, cs


def cudnn_rnn_layer(mode, x, h0, c0, layer_ws):
    """One layer of the card route: one cuDNN RNN call over both of its
    directions. ``x`` (seq, batch, in), ``h0``/``c0`` (dirs, batch,
    hidden), ``layer_ws`` the per-direction ``[W_ih, W_hh, b_ih, b_hh]``.
    Returns ``(out, h_n, c_n or None)``; adds one to ``launches``."""
    if x.device.type != "cuda":
        raise MXNetError(f"cudnn_rnn_layer: a {x.device.type} tensor (the "
                         "card route takes CUDA tensors)")
    flat = [w for ws in layer_ws for w in ws]
    bidirectional = len(layer_ws) == 2
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, h0] + flat
        + ([c0] if c0 is not None else []))
    fn = getattr(torch._VF, mode)       # lstm, gru, rnn_tanh, rnn_relu
    # one layer, no dropout (the port's own hash runs between layers),
    # time-major, the biases present
    if mode == "lstm":
        out, h_n, c_n = fn(x, (h0, c0), flat, True, 1, 0.0, train,
                           bidirectional, False)
    else:
        out, h_n = fn(x, h0, flat, True, 1, 0.0, train, bidirectional,
                      False)
        c_n = None
    cudnn_rnn_layer.launches += 1
    return out, h_n, c_n


cudnn_rnn_layer.launches = 0


@register("RNN", attrs=[
    attr("mode", str, "The recurrent cell.", choices=tuple(GATES)),
    attr("state_size", int, "The hidden size.", low=1),
    attr("num_layers", int, "The number of stacked layers.", low=1),
    attr("p", float, "Dropout between layers in training.", low=0.0,
         high=1.0),
])
def rnn(data, parameters, state, state_cell=None, *, state_size=0,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=True, projection_size=None, use_sequence_length=False,
        lstm_state_clip_min=None, lstm_state_clip_max=None,
        lstm_state_clip_nan=False):
    """``data`` (seq, batch, input), ``parameters`` the flat vector,
    ``state``/``state_cell`` (layers * dirs, batch, hidden). Returns
    ``(out, h_n)``, or ``(out, h_n, c_n)`` for an LSTM (reference
    ``rnn_op``, ``:100``); see the module docstring."""
    if projection_size is not None:
        raise MXNetError("RNN: projection_size is not supported (the "
                         "reference accepts it and ignores it; the port "
                         "refuses it rather than return an unprojected "
                         "result)")
    if use_sequence_length:
        raise MXNetError("RNN: use_sequence_length=True is not supported "
                         "(the reference accepts it and ignores it; the "
                         "port refuses it rather than run over the "
                         "padding)")
    if mode == "lstm" and state_cell is None:
        raise MXNetError("RNN: mode 'lstm' needs state_cell")
    seq, batch, input_size = data.shape
    hidden = state_size
    dirs = 2 if bidirectional else 1
    weights = _slice_params(parameters, mode, num_layers, input_size,
                            hidden, dirs)
    card = data.device.type == "cuda"
    drop = p > 0.0 and autograd.is_training()
    x = data
    h_states, c_states = [], []
    for layer in range(num_layers):
        span = slice(layer * dirs, (layer + 1) * dirs)
        h0 = state[span]
        c0 = state_cell[span] if mode == "lstm" else None
        if card:
            x, h_n, c_n = cudnn_rnn_layer(mode, x, h0, c0, weights[layer])
            h_states.extend(h_n.unbind(0))
            if mode == "lstm":
                c_states.extend(c_n.unbind(0))
        else:
            x, hs, cs = _plain_layer(mode, x, h0, c0, weights[layer])
            h_states.extend(hs)
            c_states.extend(cs)
        if drop and layer < num_layers - 1:
            x = hash_dropout(x.contiguous(), p,
                             random_state.next_seed(x.device))
    h_n = torch.stack(h_states, 0)
    if mode == "lstm":
        c_n = torch.stack(c_states, 0)
        if lstm_state_clip_min is not None \
                and lstm_state_clip_max is not None:
            c_n = torch.clamp(c_n, lstm_state_clip_min, lstm_state_clip_max)
        return x, h_n, c_n
    return x, h_n
