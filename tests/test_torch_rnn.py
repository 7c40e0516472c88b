"""The port's recurrent stack against the JAX package's, on the CPU.

The ``RNN`` op (every mode, one and two directions, one and two layers;
outputs, states and the gradients of data, flat parameters and states
against ``jax.vjp`` of the reference op for a head gradient that is not
all ones), its state clip, its inter-layer dropout (the port's position
hash: the mask is ``hash_dropout_reference``'s for the drawn seed, by
design not the reference's ``jax.random.bernoulli``), its refusals; the
``Sequence*`` ops; the fused layers (TNC and NTC, with and without
states, ``.params`` files both ways); every cell and modifier through
``unroll``; ``VariationalDropoutCell``'s mask reuse; the word language
model at a small size (three clipped SGD steps with detached states,
both packages from one ``.params`` file); and the import boundary.

Inputs and weights are made with numpy from a seed. Tolerance: 1e-5 of
the largest magnitude of the reference's value (the two frameworks sum
products in other orders), unless a test says otherwise.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ops import rnn as jrnn
from mxnet_tpu.ops import tensor as jtensor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, random_state
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import rnn
from mxnet_tpu_torch.gluon.contrib.rnn import VariationalDropoutCell
from mxnet_tpu_torch.kernels import hash_dropout_reference
from mxnet_tpu_torch.ops import rnn as prnn
from mxnet_tpu_torch.ops import tensor as ptensor

TOL = 1e-5
SEQ, BATCH, INPUT, HIDDEN = 7, 3, 5, 4
MODES = ("rnn_relu", "rnn_tanh", "lstm", "gru")


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(a, b, tol=TOL, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
    err = float(np.abs(a - b).max(initial=0.0))
    assert err <= tol * scale, (what, err, scale)


def _op_inputs(mode, layers, bidirectional, seed):
    rs = np.random.RandomState(seed)
    dirs = 2 if bidirectional else 1
    n = jrnn.rnn_param_size(mode, layers, INPUT, HIDDEN, bidirectional)
    arrays = {
        "data": rs.randn(SEQ, BATCH, INPUT).astype(np.float32),
        "params": (rs.randn(n) * 0.4).astype(np.float32),
        "h": rs.randn(layers * dirs, BATCH, HIDDEN).astype(np.float32),
        "c": rs.randn(layers * dirs, BATCH, HIDDEN).astype(np.float32),
    }
    heads = [rs.randn(SEQ, BATCH, HIDDEN * dirs).astype(np.float32),
             rs.randn(layers * dirs, BATCH, HIDDEN).astype(np.float32),
             rs.randn(layers * dirs, BATCH, HIDDEN).astype(np.float32)]
    return arrays, heads


def _reference_op(arrays, heads, **kw):
    """The reference op's outputs and the gradients of (data, params, h,
    c) for ``heads``, through ``jax.vjp``."""
    lstm = kw["mode"] == "lstm"
    names = ["data", "params", "h"] + (["c"] if lstm else [])

    def f(*xs):
        return jrnn.rnn_op(jax.random.PRNGKey(0), *xs, **kw)

    outs, vjp = jax.vjp(f, *[jnp.asarray(arrays[k]) for k in names])
    grads = vjp(tuple(jnp.asarray(h) for h in heads[:len(outs)]))
    return [np.asarray(o) for o in outs], dict(zip(names, map(np.asarray,
                                                             grads)))


def _port_op(arrays, heads, **kw):
    lstm = kw["mode"] == "lstm"
    names = ["data", "params", "h"] + (["c"] if lstm else [])
    ts = {k: torch.from_numpy(arrays[k]).requires_grad_() for k in names}
    outs = prnn.rnn(*[ts[k] for k in names], **kw)
    torch.autograd.backward(outs, [torch.from_numpy(h)
                                   for h in heads[:len(outs)]])
    return ([o.detach().numpy() for o in outs],
            {k: t.grad.numpy() for k, t in ts.items()})


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_the_reference(mode, bidirectional, layers):
    arrays, heads = _op_inputs(mode, layers, bidirectional, seed=layers)
    kw = dict(state_size=HIDDEN, num_layers=layers, mode=mode,
              bidirectional=bidirectional)
    want_outs, want_grads = _reference_op(arrays, heads, **kw)
    got_outs, got_grads = _port_op(arrays, heads, **kw)
    assert len(got_outs) == len(want_outs) == (3 if mode == "lstm" else 2)
    for name, g, w in zip(("out", "h_n", "c_n"), got_outs, want_outs):
        _close(g, w, what=name)
    for k, w in want_grads.items():
        _close(got_grads[k], w, what="d" + k)


def test_rnn_param_size_matches_the_reference():
    for mode in MODES:
        for layers in (1, 3):
            for bi in (False, True):
                assert prnn.rnn_param_size(mode, layers, 6, 5, bi) == \
                    jrnn.rnn_param_size(mode, layers, 6, 5, bi)


def test_lstm_state_clip_clips_only_the_returned_cell():
    arrays, heads = _op_inputs("lstm", 2, True, seed=5)
    arrays["c"] *= 4.0
    kw = dict(state_size=HIDDEN, num_layers=2, mode="lstm",
              bidirectional=True, lstm_state_clip_min=-0.3,
              lstm_state_clip_max=0.25)
    want_outs, want_grads = _reference_op(arrays, heads, **kw)
    got_outs, got_grads = _port_op(arrays, heads, **kw)
    for g, w in zip(got_outs, want_outs):
        _close(g, w)
    for k, w in want_grads.items():
        _close(got_grads[k], w, what="d" + k)
    assert got_outs[2].max() <= 0.25 and got_outs[2].min() >= -0.3
    # the carried state is not clipped: the output equals an unclipped
    # run's
    unclipped, _ = _port_op(arrays, heads, state_size=HIDDEN, num_layers=2,
                            mode="lstm", bidirectional=True)
    np.testing.assert_array_equal(got_outs[0], unclipped[0])


def _tensors(arrays, mode):
    ts = [torch.from_numpy(arrays[k]) for k in ("data", "params", "h")]
    if mode == "lstm":
        ts.append(torch.from_numpy(arrays["c"]))
    return ts


@pytest.mark.parametrize("mode", MODES)
def test_eval_mode_ignores_p(mode):
    arrays, _ = _op_inputs(mode, 3, True, seed=7)
    kw = dict(state_size=HIDDEN, num_layers=3, mode=mode, bidirectional=True)
    with autograd.predict_mode():
        a = prnn.rnn(*_tensors(arrays, mode), p=0.5, **kw)
    b = prnn.rnn(*_tensors(arrays, mode), p=0.0, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_inter_layer_dropout_is_the_position_hash(mode):
    """In training each layer's output but the last goes through
    ``hash_dropout`` under a seed drawn from ``random_state``; by design
    the port does not draw the reference's ``jax.random.bernoulli``."""
    layers, p = 3, 0.5
    arrays, _ = _op_inputs(mode, layers, True, seed=11)
    kw = dict(state_size=HIDDEN, num_layers=layers, mode=mode,
              bidirectional=True)
    data, params, h = _tensors(arrays, mode)[:3]
    c = torch.from_numpy(arrays["c"]) if mode == "lstm" else None
    with autograd.train_mode(), random_state.seed_tape() as seeds:
        got = prnn.rnn(data, params, h, c, p=p, **kw)
    assert len(seeds) == layers - 1
    weights = prnn._slice_params(params, mode, layers, INPUT, HIDDEN, 2)
    x, hs, cs = data, [], []
    for layer in range(layers):
        span = slice(2 * layer, 2 * layer + 2)
        x, lh, lc = prnn._plain_layer(mode, x, h[span],
                                      None if c is None else c[span],
                                      weights[layer])
        hs += lh
        cs += lc
        if layer < layers - 1:
            kept = hash_dropout_reference(torch.ones_like(x), p,
                                          seeds[layer]) != 0
            assert 0.3 < float(kept.float().mean()) < 0.7
            x = hash_dropout_reference(x, p, seeds[layer])
    np.testing.assert_array_equal(got[0].numpy(), x.numpy())
    np.testing.assert_array_equal(got[1].numpy(), torch.stack(hs).numpy())
    # a second call draws fresh seeds, so other masks
    with autograd.train_mode():
        again = prnn.rnn(data, params, h, c, p=p, **kw)
    assert not torch.equal(again[0], got[0])


def test_rnn_refuses_what_the_reference_ignores():
    arrays, _ = _op_inputs("lstm", 1, False, seed=2)
    ts = _tensors(arrays, "lstm")
    kw = dict(state_size=HIDDEN, num_layers=1, mode="lstm")
    with pytest.raises(MXNetError, match="projection_size"):
        prnn.rnn(*ts, projection_size=2, **kw)
    with pytest.raises(MXNetError, match="use_sequence_length"):
        prnn.rnn(*ts, use_sequence_length=True, **kw)
    # the reference runs both and ignores them
    jouts = jrnn.rnn_op(jax.random.PRNGKey(0),
                        *[jnp.asarray(t.numpy()) for t in ts],
                        projection_size=2, use_sequence_length=True, **kw)
    assert jouts[0].shape == (SEQ, BATCH, HIDDEN)
    with pytest.raises(MXNetError, match="needs state_cell"):
        prnn.rnn(*ts[:3], **kw)
    with pytest.raises(MXNetError, match="parameter vector"):
        prnn.rnn(ts[0], ts[1][:-1], *ts[2:], **kw)


def test_rnn_through_mx_nd():
    arrays, _ = _op_inputs("gru", 2, False, seed=3)
    nd = [mx.nd.array(arrays[k]) for k in ("data", "params", "h")]
    out, h_n = mx.nd.RNN(*nd, state_size=HIDDEN, num_layers=2, mode="gru")
    want = jrnn.rnn_op(jax.random.PRNGKey(0),
                       *[jnp.asarray(arrays[k]) for k in ("data", "params",
                                                          "h")],
                       state_size=HIDDEN, num_layers=2, mode="gru")
    _close(out.asnumpy(), np.asarray(want[0]))
    _close(h_n.asnumpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# the Sequence ops
# ---------------------------------------------------------------------------

SEQ_OPS = {"SequenceMask": (ptensor.sequence_mask, jtensor.sequence_mask),
           "SequenceLast": (ptensor.sequence_last, jtensor.sequence_last),
           "SequenceReverse": (ptensor.sequence_reverse,
                               jtensor.sequence_reverse)}


def _seq_case(op, axis, lengths, seed=0):
    pfn, jfn = SEQ_OPS[op]
    rs = np.random.RandomState(seed)
    t, b = 6, len(lengths)
    shape = (t, b, 3) if axis == 0 else (b, t, 3)
    x = rs.randn(*shape).astype(np.float32)
    lens = np.asarray(lengths, np.float32)
    kw = dict(use_sequence_length=True, axis=axis)
    if op == "SequenceMask":
        kw["value"] = -2.5
    want, vjp = jax.vjp(lambda d: jfn(d, jnp.asarray(lens), **kw),
                        jnp.asarray(x))
    head = rs.randn(*want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(head))
    xt = torch.from_numpy(x).requires_grad_()
    got = pfn(xt, torch.from_numpy(lens), **kw)
    got.backward(torch.from_numpy(head))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("op,axis", [
    ("SequenceMask", 0), ("SequenceMask", 1), ("SequenceLast", 0),
    ("SequenceLast", 1), ("SequenceReverse", 0)])
def test_sequence_ops_match_the_reference(op, axis):
    for lengths in ([0, 1, 6, 3], [6, 6, 6, 6], [1, 0, 0, 1]):
        _seq_case(op, axis, lengths)


@pytest.mark.parametrize("op", sorted(SEQ_OPS))
def test_sequence_ops_without_lengths(op):
    """Without lengths: the identity, the last step, and a flip of axis 0
    whatever ``axis`` says (the reference's quirk, kept)."""
    pfn, jfn = SEQ_OPS[op]
    x = np.random.RandomState(1).randn(4, 5, 2).astype(np.float32)
    for axis in (0, 1):
        want = np.asarray(jfn(jnp.asarray(x), axis=axis))
        got = pfn(torch.from_numpy(x), axis=axis).numpy()
        np.testing.assert_array_equal(got, want)
    if op == "SequenceReverse":
        np.testing.assert_array_equal(
            pfn(torch.from_numpy(x), axis=1).numpy(), x[::-1])


def test_sequence_reverse_along_axis_1():
    """With lengths ``axis`` 1 reverses each row's first ``length`` steps
    of a (batch, time, ...) input (the reference gathers along axis 0
    there, so it is held against the time-major case transposed)."""
    x = np.random.RandomState(2).randn(3, 6, 2).astype(np.float32)
    lens = np.asarray([0, 6, 4], np.float32)
    want = np.asarray(jtensor.sequence_reverse(
        jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(lens),
        use_sequence_length=True)).transpose(1, 0, 2)
    got = ptensor.sequence_reverse(torch.from_numpy(x),
                                   torch.from_numpy(lens),
                                   use_sequence_length=True, axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sequence_ops_through_mx_nd():
    x = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    lens = mx.nd.array([1, 4, 0])
    out = mx.nd.SequenceMask(mx.nd.array(x), lens, use_sequence_length=True)
    want = jmx.nd.SequenceMask(jmx.nd.array(x), jmx.nd.array([1, 4, 0]),
                               use_sequence_length=True)
    np.testing.assert_array_equal(out.asnumpy(), want.asnumpy())
    assert mx.nd.sequence_mask is not None
    with pytest.raises(MXNetError, match="axis 2"):
        mx.nd.SequenceLast(mx.nd.array(x), axis=2)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

LAYERS = {"RNN": dict(activation="tanh"), "LSTM": {}, "GRU": {}}


def _layer_pair(cls, layout, tmp_path, bidirectional=True, layers=2):
    kw = dict(num_layers=layers, bidirectional=bidirectional, layout=layout,
              **LAYERS[cls])
    jl = getattr(jmx.gluon.rnn, cls)(HIDDEN, input_size=INPUT, **kw)
    jl.initialize()
    f = str(tmp_path / f"{cls}.params")
    jl.save_parameters(f)
    pl = getattr(rnn, cls)(HIDDEN, **kw)
    pl.initialize(ctx=mx.cpu())
    pl.load_parameters(f, ctx=mx.cpu())
    return jl, pl


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("cls", sorted(LAYERS))
def test_layers_match_the_reference(cls, layout, explicit, tmp_path):
    jl, pl = _layer_pair(cls, layout, tmp_path)
    rs = np.random.RandomState(4)
    x = rs.randn(SEQ, BATCH, INPUT).astype(np.float32)
    if layout == "NTC":
        x = np.ascontiguousarray(x.transpose(1, 0, 2))
    if not explicit:
        _close(pl(mx.nd.array(x)).asnumpy(), jl(jmx.nd.array(x)).asnumpy())
        return
    n_states = 2 if cls == "LSTM" else 1
    states = [rs.randn(4, BATCH, HIDDEN).astype(np.float32)
              for _ in range(n_states)]
    xp = mx.nd.array(x)
    xp.attach_grad()
    sp = [mx.nd.array(s) for s in states]
    with autograd.record():
        out, new = pl(xp, sp)
        loss = (out * out).sum() + sum((s * s).sum() for s in new)
    loss.backward()
    xj = jmx.nd.array(x)
    xj.attach_grad()
    with jag.record():
        jout, jnew = jl(xj, [jmx.nd.array(s) for s in states])
        jloss = (jout * jout).sum() + sum((s * s).sum() for s in jnew)
    jloss.backward()
    _close(out.asnumpy(), jout.asnumpy(), what="out")
    assert len(new) == len(jnew) == n_states
    for a, b in zip(new, jnew):
        _close(a.asnumpy(), b.asnumpy(), what="state")
    _close(xp.grad.asnumpy(), xj.grad.asnumpy(), what="dx")
    jparams = {k: v for k, v in jl._collect_params_with_prefix().items()}
    for name, p in pl._collect_params_with_prefix().items():
        _close(p.grad().asnumpy(), jparams[name].grad().asnumpy(),
               what="d" + name)


@pytest.mark.parametrize("cls", sorted(LAYERS))
def test_layer_params_cross_both_ways(cls, tmp_path):
    """The port's ``.params`` file loads into the reference layer and
    gives the same forward, and the names are the reference's."""
    jl, pl = _layer_pair(cls, "TNC", tmp_path)
    names = sorted(pl._collect_params_with_prefix())
    assert names == sorted(jl._collect_params_with_prefix())
    assert "r1_h2h_bias" in names and "l0_i2h_weight" in names
    f = str(tmp_path / "port.params")
    rs = np.random.RandomState(6)
    for p in pl.collect_params().values():
        p.set_data(mx.nd.array(rs.randn(*p.shape).astype(np.float32) * 0.3))
    pl.save_parameters(f)
    jl2 = getattr(jmx.gluon.rnn, cls)(HIDDEN, num_layers=2,
                                      bidirectional=True, input_size=INPUT,
                                      **LAYERS[cls])
    jl2.load_parameters(f)
    x = rs.randn(SEQ, BATCH, INPUT).astype(np.float32)
    _close(pl(mx.nd.array(x)).asnumpy(), jl2(jmx.nd.array(x)).asnumpy())


def test_layer_defers_its_input_size_and_begins_states():
    layer = rnn.LSTM(HIDDEN, num_layers=2, bidirectional=True)
    layer.initialize(ctx=mx.cpu())
    assert layer.l0_i2h_weight.shape == (4 * HIDDEN, 0)
    out = layer(mx.nd.ones((SEQ, BATCH, 6)))
    assert out.shape == (SEQ, BATCH, 2 * HIDDEN)
    assert layer.l0_i2h_weight.shape == (4 * HIDDEN, 6)
    assert layer.l1_i2h_weight.shape == (4 * HIDDEN, 2 * HIDDEN)
    states = layer.begin_state(BATCH)
    assert [s.shape for s in states] == [(4, BATCH, HIDDEN)] * 2
    assert repr(layer) == "LSTM(4, num_layers=2, layout=TNC, " \
        "bidirectional=True)"


def test_layer_on_tensors():
    """Called with torch tensors (as TrainStep and Server call blocks), the
    layer runs the same registered op on them."""
    layer = rnn.GRU(HIDDEN, input_size=INPUT)
    layer.initialize(ctx=mx.cpu())
    x = np.random.RandomState(8).randn(SEQ, BATCH, INPUT).astype(np.float32)
    want = layer(mx.nd.array(x)).asnumpy()
    got = layer(torch.from_numpy(x))
    np.testing.assert_array_equal(got.detach().numpy(), want)


def test_layer_dropout_between_layers_only_in_training():
    layer = rnn.LSTM(HIDDEN, num_layers=2, dropout=0.5, input_size=INPUT)
    layer.initialize(ctx=mx.cpu())
    x = mx.nd.array(np.random.RandomState(9).randn(SEQ, BATCH, INPUT))
    plain = layer(x).asnumpy()
    np.testing.assert_array_equal(layer(x).asnumpy(), plain)
    with autograd.record():
        dropped = layer(x).asnumpy()
    assert not np.array_equal(dropped, plain)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _cells(m, kind):
    """The same cell structure in the package ``m``."""
    r = m.gluon.rnn
    if kind == "rnn":
        return r.RNNCell(HIDDEN, input_size=INPUT)
    if kind == "rnn_relu":
        return r.RNNCell(HIDDEN, activation="relu", input_size=INPUT)
    if kind == "lstm":
        return r.LSTMCell(HIDDEN, input_size=INPUT)
    if kind == "gru":
        return r.GRUCell(HIDDEN, input_size=INPUT)
    if kind in ("sequential", "hybrid_sequential"):
        seq = (r.SequentialRNNCell() if kind == "sequential"
               else r.HybridSequentialRNNCell())
        seq.add(r.LSTMCell(HIDDEN, input_size=INPUT))
        seq.add(r.DropoutCell(0.5))
        seq.add(r.GRUCell(HIDDEN, input_size=HIDDEN))
        return seq
    if kind == "residual":
        return r.ResidualCell(r.GRUCell(INPUT, input_size=INPUT))
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(HIDDEN, input_size=INPUT))
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(HIDDEN, input_size=INPUT),
                                   r.GRUCell(HIDDEN, input_size=INPUT))
    if kind == "vardrop":
        cell = r.LSTMCell(HIDDEN, input_size=INPUT)
        if m is mx:
            return VariationalDropoutCell(cell, 0.3, 0.3, 0.3)
        return m.gluon.contrib.rnn.VariationalDropoutCell(cell, 0.3, 0.3, 0.3)
    raise KeyError(kind)


CELLS = ["rnn", "rnn_relu", "lstm", "gru", "sequential", "hybrid_sequential",
         "residual", "zoneout", "bidirectional", "vardrop"]


def _cell_pair(kind, tmp_path):
    jc = _cells(jmx, kind)
    jc.initialize()
    f = str(tmp_path / f"{kind}.params")
    jc.save_parameters(f)
    pc = _cells(mx, kind)
    pc.initialize(ctx=mx.cpu())
    pc.load_parameters(f, ctx=mx.cpu())
    return jc, pc


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("kind", CELLS)
def test_cells_unroll_like_the_reference(kind, merge, tmp_path):
    """Predict mode: the dropout and variational cells are the identity
    there, and zoneout's rates are 0 (its masks are the ``Dropout`` op's,
    not the reference's stream; see the zoneout test)."""
    jc, pc = _cell_pair(kind, tmp_path)
    rs = np.random.RandomState(12)
    x = rs.randn(BATCH, SEQ, INPUT).astype(np.float32)
    for valid in (None, [0.0, float(SEQ), 3.0]):
        kw = dict(layout="NTC", merge_outputs=merge)
        jkw, pkw = dict(kw), dict(kw)
        if valid is not None:
            jkw["valid_length"] = jmx.nd.array(valid)
            pkw["valid_length"] = mx.nd.array(valid)
        jo, js = jc.unroll(SEQ, jmx.nd.array(x), **jkw)
        po, ps = pc.unroll(SEQ, mx.nd.array(x), **pkw)
        if merge:
            _close(po.asnumpy(), jo.asnumpy(), what="outputs")
        else:
            assert len(po) == len(jo) == SEQ
            for a, b in zip(po, jo):
                _close(a.asnumpy(), b.asnumpy(), what="step")
        assert len(ps) == len(js)
        for a, b in zip(ps, js):
            _close(a.asnumpy(), b.asnumpy(), what="state")


def test_cell_equals_the_layer():
    """One LSTM layer and an LSTMCell with its weights unroll alike (as
    ``tests/test_gluon.py:222``), TNC, through ``unroll``."""
    layer = rnn.LSTM(HIDDEN, input_size=INPUT)
    layer.initialize(ctx=mx.cpu())
    cell = rnn.LSTMCell(HIDDEN, input_size=INPUT)
    cell.initialize(ctx=mx.cpu())
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, name).set_data(getattr(layer, "l0_" + name).data())
    x = mx.nd.array(np.random.RandomState(3).randn(SEQ, 2, INPUT))
    fused = layer(x).asnumpy()
    outs, _ = cell.unroll(SEQ, x, layout="TNC", merge_outputs=True)
    _close(outs.asnumpy(), fused)


def test_zoneout_keeps_the_previous_output_where_it_zones_out():
    """At the first step the previous output is zeros: each element of
    the zoneout output is the base cell's new output or 0, and both
    occur at rate 0.5 (the masks are the ``Dropout`` op's hash)."""
    cell = rnn.ZoneoutCell(rnn.GRUCell(HIDDEN, input_size=INPUT),
                           zoneout_outputs=0.5, zoneout_states=0.5)
    cell.initialize(ctx=mx.cpu())
    base = cell.base_cell
    x = mx.nd.array(np.random.RandomState(5).randn(8, SEQ, INPUT))
    outs, _ = cell.unroll(SEQ, x, layout="NTC", merge_outputs=False)
    new, _ = base(x[:, 0], base.begin_state(8))
    o, n = outs[0].asnumpy(), new.asnumpy()
    is_new = o == n
    assert np.all(is_new | (o == 0))
    assert 0 < is_new.sum() < is_new.size


def test_variational_dropout_reuses_its_masks():
    """One mask per sequence and per site: every step of an unroll in
    training drops the same input positions; ``reset`` (a new unroll)
    draws new ones."""
    base = rnn.RNNCell(HIDDEN, input_size=INPUT)
    cell = VariationalDropoutCell(base, drop_inputs=0.5)
    cell.initialize(ctx=mx.cpu())
    seen = []
    handle = base.register_forward_pre_hook(
        lambda blk, args: seen.append(args[0].asnumpy()))
    x = mx.nd.ones((BATCH, SEQ, INPUT))
    with autograd.train_mode():
        cell.unroll(SEQ, x, layout="NTC")
        first = seen[0] != 0
        assert 0 < first.sum() < first.size
        for step in seen[1:]:
            np.testing.assert_array_equal(step != 0, first)
        seen.clear()
        cell.unroll(SEQ, x, layout="NTC")
    handle.detach()
    assert not np.array_equal(seen[0] != 0, first)
    for step in seen[1:]:
        np.testing.assert_array_equal(step != 0, seen[0] != 0)


def test_bidirectional_cell_refuses_a_step():
    cell = rnn.BidirectionalCell(rnn.GRUCell(2), rnn.GRUCell(2))
    with pytest.raises(MXNetError, match="only unroll"):
        cell(mx.nd.ones((1, 3)), [])


def test_contrib_conv_cells_name_the_roadmap_item():
    """The convolutional cells, which raised naming item 4 until its
    convolutions came, are recurrent cells that build and step
    (tests/test_torch_conv_rnn.py holds them against the reference)."""
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn

    cell = crnn.Conv2DLSTMCell((3, 8, 8), 4, 3, 3)
    assert isinstance(cell, rnn.RecurrentCell)
    assert issubclass(crnn.Conv1DGRUCell, rnn.RecurrentCell)
    with mx.cpu():
        cell.initialize()
        out, states = cell(mx.nd.ones((2, 3, 8, 8)),
                           cell.begin_state(2, ctx=mx.cpu()))
    assert out.shape == (2, 4, 6, 6) and len(states) == 2


# ---------------------------------------------------------------------------
# MXNet's word language model at a small size
# ---------------------------------------------------------------------------

VOCAB, EMB, LM_LAYERS, BPTT, LM_BATCH = 50, 16, 2, 5, 4


def _word_lm(m):
    gl = m.gluon

    class RNNModel(gl.Block):
        """``example/gluon/word_language_model``'s model, the decoder
        tied to the embedding."""

        def __init__(self, dropout=0.0):
            super().__init__()
            with self.name_scope():
                self.drop = gl.nn.Dropout(dropout)
                self.encoder = gl.nn.Embedding(VOCAB, EMB)
                self.rnn = gl.rnn.LSTM(EMB, LM_LAYERS, dropout=dropout,
                                       input_size=EMB)
                self.decoder = gl.nn.Dense(VOCAB, in_units=EMB,
                                           params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, EMB))), hidden

    return RNNModel()


def _values(model):
    """Each parameter's value by its structural name (the tied weight
    under both of its names)."""
    return {k: p.data().asnumpy().copy()
            for k, p in model._collect_params_with_prefix().items()}


def _lm_steps(m, ag, model, tokens, n_steps):
    """``n_steps`` segments of truncated BPTT: mean token cross-entropy,
    ``clip_global_norm(grads, 0.25)``, SGD at lr 1.0, the state detached
    between segments. Returns the losses and each parameter's value
    after every step."""
    gl = m.gluon
    params = model.collect_params()
    trainer = gl.Trainer(params, "sgd", {"learning_rate": 1.0})
    loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
    hidden = model.rnn.begin_state(LM_BATCH)
    losses, values = [], []
    for step in range(n_steps):
        seg = tokens[step * BPTT:(step + 1) * BPTT + 1]
        data, target = m.nd.array(seg[:-1]), m.nd.array(seg[1:])
        hidden = [h.detach() for h in hidden]
        with ag.record():
            out, hidden = model(data, hidden)
            loss = loss_fn(out, target.reshape((-1,))).mean()
        loss.backward()
        grads = [p.grad() for p in params.values()]
        gl.utils.clip_global_norm(grads, 0.25)
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        values.append(_values(model))
    return losses, values


def test_word_language_model_matches_the_reference(tmp_path):
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, VOCAB, (3 * BPTT + 1, LM_BATCH)).astype(
        np.float32)
    jm = _word_lm(jmx)
    jm.initialize(jmx.init.Uniform(0.1))
    jm(jmx.nd.array(tokens[:BPTT]), jm.rnn.begin_state(LM_BATCH))
    f = str(tmp_path / "lm.params")
    jm.save_parameters(f)
    pm = _word_lm(mx)
    pm.load_parameters(f, ctx=mx.cpu())
    assert pm.decoder.weight is pm.encoder.weight
    start = _values(pm)
    jl, jv = _lm_steps(jmx, jag, jm, tokens, 3)
    pl, pv = _lm_steps(mx, autograd, pm, tokens, 3)
    assert sorted(pv[0]) == sorted(jv[0])
    for step in range(3):
        _close(pl[step], jl[step], what=f"loss {step}")
        for name, got in pv[step].items():
            want_delta = jv[step][name] - start[name]
            got_delta = got - start[name]
            rel = np.linalg.norm(got_delta - want_delta) / max(
                np.linalg.norm(want_delta), 1e-30)
            assert rel <= 1e-3, (step, name, rel)


# ---------------------------------------------------------------------------
# the import boundary
# ---------------------------------------------------------------------------


def test_the_recurrent_modules_import_no_jax():
    code = ("import sys\n"
            "import mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.ops.rnn\n"
            "import mxnet_tpu_torch.gluon.contrib\n"
            "import mxnet_tpu_torch.gluon.contrib.estimator\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)
