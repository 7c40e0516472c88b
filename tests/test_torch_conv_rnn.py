"""The port's convolutional recurrent cells (``gluon.contrib.rnn``'s
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``) against the JAX package's on the
CPU: each of the nine unrolled over three steps from the same numpy
weights and inputs, the outputs, the last states and every parameter's
gradient of a weighted sum of the outputs (``autograd.record`` and
``backward`` in both packages), f32 within 1e-5 of the largest
magnitude; the state shape from the i2h convolution's padding and
dilation; the refusals the reference makes.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.gluon.contrib import rnn as jrnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.contrib import rnn as prnn

SPATIAL = {1: (7,), 2: (5, 6), 3: (3, 4, 5)}
LENGTH, BATCH, CHANNELS, HIDDEN = 3, 2, 2, 3


def _cell(pkg, kind, dims, **kw):
    cls = getattr(pkg, f"Conv{dims}D{kind}Cell")
    return cls((CHANNELS,) + SPATIAL[dims], HIDDEN, i2h_kernel=3,
               h2h_kernel=3, **kw)


def _run(m, cell, xs, head):
    """Unroll ``cell`` over the numpy steps ``xs`` under record, backward
    the ``head``-weighted sum of the outputs; returns outputs, states and
    each parameter's gradient by its suffix."""
    steps = [m.nd.array(x) for x in xs]
    with m.autograd.record():
        outs, states = cell.unroll(LENGTH, steps, layout="TNC",
                                   merge_outputs=False)
        total = None
        for o, h in zip(outs, head):
            term = (o * m.nd.array(h)).sum()
            total = term if total is None else total + term
    total.backward()
    grads = {n.rsplit("_", 2)[-2] + "_" + n.rsplit("_", 1)[-1]:
             p.grad().asnumpy() for n, p in cell.collect_params().items()}
    return ([o.asnumpy() for o in outs], [s.asnumpy() for s in states],
            grads)


def _close(got, want, what):
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= 1e-5 * top, (what, err, top)


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_conv_cell_matches_the_reference(kind, dims):
    kw = dict(i2h_pad=1, i2h_dilate=1, h2h_dilate=2) if dims != 1 else \
        dict(i2h_pad=2, i2h_dilate=2, h2h_dilate=1)
    jcell, pcell = _cell(jrnn, kind, dims, **kw), _cell(prnn, kind, dims, **kw)
    jcell.initialize()
    with mx.cpu():
        pcell.initialize()
    rs = np.random.RandomState(dims * 10 + len(kind))
    for name, p in jcell.collect_params().items():
        a = (0.3 * rs.randn(*p.shape)).astype(np.float32)
        p.set_data(jmx.nd.array(a))
        suffix = name.rsplit("_", 2)[-2:]
        (pp,) = [q for n, q in pcell.collect_params().items()
                 if n.rsplit("_", 2)[-2:] == suffix]
        pp.set_data(a)
    xs = [rs.randn(BATCH, CHANNELS, *SPATIAL[dims]).astype(np.float32)
          for _ in range(LENGTH)]
    state_shape = tuple(pcell.state_info(BATCH)[0]["shape"])
    assert state_shape == tuple(jcell.state_info(BATCH)[0]["shape"])
    head = [rs.randn(*state_shape).astype(np.float32) for _ in range(LENGTH)]
    jouts, jstates, jgrads = _run(jmx, jcell, xs, head)
    with mx.cpu():
        outs, states, grads = _run(mx, pcell, xs, head)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        _close(o, jo, f"output {i}")
    assert len(states) == len(jstates) == (2 if kind == "LSTM" else 1)
    for s, js in zip(states, jstates):
        _close(s, js, "state")
    assert sorted(grads) == sorted(jgrads)
    for k in grads:
        _close(grads[k], jgrads[k], k)


def test_state_shape_and_refusals():
    """The state's spatial shape is the i2h convolution's output (here
    padded by 1, dilated by 2: 8 - 4 + 2 = 6); an even h2h kernel and an
    input shape of the wrong rank raise ``ValueError``, as in the
    reference; the weights' names and shapes are the reference's."""
    cell = prnn.Conv2DLSTMCell((3, 8, 8), 4, i2h_kernel=3, h2h_kernel=5,
                               i2h_pad=1, i2h_dilate=2)
    jcell = jrnn.Conv2DLSTMCell((3, 8, 8), 4, i2h_kernel=3, h2h_kernel=5,
                                i2h_pad=1, i2h_dilate=2)
    assert cell.state_info(2) == jcell.state_info(2)
    assert cell.state_info(2)[0]["shape"] == (2, 4, 6, 6)
    assert [(n.rsplit("_", 2)[-2:], p.shape)
            for n, p in cell.collect_params().items()] == \
        [(n.rsplit("_", 2)[-2:], p.shape)
         for n, p in jcell.collect_params().items()]
    for pkg in (prnn, jrnn):
        with pytest.raises(ValueError, match="odd"):
            pkg.Conv1DGRUCell((2, 9), 3, 3, 4)
        with pytest.raises(ValueError, match="input_shape"):
            pkg.Conv3DRNNCell((2, 9, 9), 3, 3, 3)
