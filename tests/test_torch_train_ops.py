"""The ops a training loop meets, ``depth_to_space``/``space_to_depth``,
``gluon.contrib.nn`` and the ``Estimator``: the port against the JAX
package on the CPU.

Each op's forward and gradient against ``jax.vjp`` of the reference
function, for a head gradient that is not all ones (the output heads,
``make_loss`` and ``SVMOutput`` ignore it, and so must the port), over
inputs with the edge values ROADMAP.md's conventions ask for: +-0, NaN,
+-inf, ties for ``moments`` and ``softmin``, a fully masked row for the
masked softmaxes, every ``normalization`` and ``use_ignore`` of
``SoftmaxOutput``. NaN and inf must sit at the same places; finite
values agree to 1e-5 of the reference's largest finite magnitude.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import spatial as jspatial
from mxnet_tpu.ops import tensor as jtensor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import contrib, nn
from mxnet_tpu_torch.ops import nn as pnn
from mxnet_tpu_torch.ops import spatial as pspatial
from mxnet_tpu_torch.ops import tensor as ptensor

TOL = 1e-5
EDGES = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0],
                 np.float32)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _match(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    inf = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), inf, what)
    np.testing.assert_array_equal(got[inf], want[inf], what)
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max(initial=0.0)), 1e-30)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert err <= tol * scale, (what, err, scale)


def _with_edges(rs, shape):
    x = rs.randn(*shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:len(EDGES)] = EDGES
    return x


def _check(pfn, jfn, diff, rest=(), kw=None, head_seed=0, tol=TOL):
    """``pfn(*diff, *rest, **kw)`` against ``jfn``: outputs, and the
    gradients of the ``diff`` inputs for a random head gradient."""
    kw = kw or {}
    outs, vjp = jax.vjp(lambda *d: jfn(*d, *[jnp.asarray(r) for r in rest],
                                       **kw),
                        *[jnp.asarray(d) for d in diff])
    multi = isinstance(outs, (tuple, list))
    outs = list(outs) if multi else [outs]
    rs = np.random.RandomState(head_seed)
    heads = [np.asarray(rs.randn(*np.shape(o))).astype(np.asarray(o).dtype)
             for o in outs]
    want_g = vjp(tuple(jnp.asarray(h) for h in heads) if multi
                 else jnp.asarray(heads[0]))
    ts = [torch.from_numpy(np.array(d)).requires_grad_() for d in diff]
    got = pfn(*ts, *[torch.from_numpy(np.array(r)) for r in rest], **kw)
    got = list(got) if multi else [got]
    for i, (g, w) in enumerate(zip(got, outs)):
        _match(g.detach().numpy(), w, tol, f"output {i}")
    torch.autograd.backward(got, [torch.from_numpy(h) for h in heads])
    for i, (t, w) in enumerate(zip(ts, want_g)):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        _match(g.numpy(), w, tol, f"grad {i}")


# ---------------------------------------------------------------------------
# the output heads and make_loss: custom VJPs that ignore the head gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smooth_alpha", [0.0, 0.1])
@pytest.mark.parametrize("use_ignore", [False, True])
@pytest.mark.parametrize("normalization", ["null", "batch", "valid"])
def test_softmax_output(normalization, use_ignore, smooth_alpha):
    rs = np.random.RandomState(1)
    x = rs.randn(6, 5).astype(np.float32)
    label = np.array([0, 4, 2, -1, 3, -1], np.float32)
    _check(pnn.softmax_output, jnn.softmax_output, [x], [label],
           dict(normalization=normalization, use_ignore=use_ignore,
                ignore_label=-1.0, smooth_alpha=smooth_alpha,
                grad_scale=0.7), head_seed=3)


@pytest.mark.parametrize("case", ["multi_output", "flatten",
                                  "preserve_shape", "edges"])
def test_softmax_output_shapes(case):
    rs = np.random.RandomState(2)
    if case == "multi_output":
        x = rs.randn(2, 4, 3).astype(np.float32)
        label = rs.randint(0, 4, (2, 3)).astype(np.float32)
        kw = dict(multi_output=True)
    elif case == "flatten":
        x = rs.randn(3, 2, 4).astype(np.float32)
        label = np.array([1, 7, 0], np.float32)
        kw = {}
    elif case == "preserve_shape":
        x = rs.randn(3, 2, 4).astype(np.float32)
        label = rs.randint(0, 4, (3, 2)).astype(np.float32)
        kw = dict(preserve_shape=True, normalization="valid")
    else:
        x = _with_edges(rs, (4, 5))
        label = np.array([0, 1, 2, 3], np.float32)
        kw = {}
    _check(pnn.softmax_output, jnn.softmax_output, [x], [label], kw)


def test_softmax_alias_and_nd():
    assert mx.nd.Softmax is not None
    x = mx.nd.array(np.random.RandomState(4).randn(3, 4))
    x.attach_grad()
    with autograd.record():
        y = mx.nd.Softmax(x, mx.nd.array([0, 1, 3]))
    y.backward(mx.nd.ones((3, 4)) * 5.0)
    jx = jmx.nd.array(x.asnumpy())
    jx.attach_grad()
    with jag.record():
        jy = jmx.nd.SoftmaxOutput(jx, jmx.nd.array([0, 1, 3]))
    jy.backward()
    _match(y.asnumpy(), jy.asnumpy())
    _match(x.grad.asnumpy(), jx.grad.asnumpy())


@pytest.mark.parametrize("grad_scale", [1.0, 2.5])
def test_make_loss(grad_scale):
    x = _with_edges(np.random.RandomState(5), (3, 4))
    for fn in (pnn.make_loss, mx.nd.MakeLoss):
        assert fn is not None
    _check(pnn.make_loss, jnn.make_loss, [x], kw=dict(grad_scale=grad_scale))


@pytest.mark.parametrize("op", ["linear_regression_output",
                                "mae_regression_output",
                                "logistic_regression_output"])
def test_regression_outputs(op):
    rs = np.random.RandomState(6)
    x = _with_edges(rs, (4, 3))
    label = rs.randn(12).astype(np.float32)
    label[:3] = [0.0, -0.0, 1.0]
    _check(getattr(pnn, op), getattr(jnn, op), [x], [label],
           dict(grad_scale=1.5))


@pytest.mark.parametrize("use_linear", [False, True])
def test_svm_output(use_linear):
    rs = np.random.RandomState(7)
    x = rs.randn(5, 4).astype(np.float32)
    x[0, 1] = x[0, 0] - 1.0           # a margin tie: dist exactly 0
    label = np.array([0, 3, 1, 2, 0], np.float32)
    _check(pspatial.svm_output, jspatial.svm_output, [x], [label],
           dict(margin=1.0, regularization_coefficient=0.8,
                use_linear=use_linear))


def test_block_grad():
    x = _with_edges(np.random.RandomState(8), (2, 5))
    for m, ag in ((mx, autograd), (jmx, jag)):
        a = m.nd.array(x)
        a.attach_grad()
        with ag.record():
            y = m.nd.BlockGrad(a) * 2.0 + m.nd.stop_gradient(a) + a
        y.backward()
        if m is mx:
            got, got_g = y.asnumpy(), a.grad.asnumpy()
        else:
            want, want_g = y.asnumpy(), a.grad.asnumpy()
    _match(got, want)
    _match(got_g, want_g)
    np.testing.assert_array_equal(got_g, np.ones_like(x))
    out = pnn.block_grad(torch.ones(2, requires_grad=True))
    assert not out.requires_grad


# ---------------------------------------------------------------------------
# elementwise and normalising ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scalar", [1.0, 0.5, 3.0])
def test_smooth_l1(scalar):
    x = _with_edges(np.random.RandomState(9), (3, 6))
    x.reshape(-1)[7:9] = [1.0 / scalar ** 2, -1.0 / scalar ** 2]
    _check(pnn.smooth_l1, jnn.smooth_l1, [x], kw=dict(scalar=scalar))


@pytest.mark.parametrize("alpha,beta", [(0.2, 0.5), (0.5, 0.5)])
def test_hard_sigmoid(alpha, beta):
    x = _with_edges(np.random.RandomState(10), (3, 5))
    x.reshape(-1)[7:9] = [-1.0, 1.0]  # exactly at 0 and 1 for (0.5, 0.5)
    _check(pspatial.hard_sigmoid, jspatial.hard_sigmoid, [x],
           kw=dict(alpha=alpha, beta=beta))


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    rs = np.random.RandomState(11)
    x = rs.randn(2, 3, 4).astype(np.float32)
    x[1] = 0.0                         # a zero sample: eps keeps it finite
    _check(ptensor.l2_normalization, jtensor.l2_normalization, [x],
           kw=dict(mode=mode))
    xe = _with_edges(rs, (2, 3, 4))
    _check(ptensor.l2_normalization, jtensor.l2_normalization, [xe],
           kw=dict(mode=mode))


@pytest.mark.parametrize("nsize", [3, 5])
def test_lrn(nsize):
    rs = np.random.RandomState(12)
    x = rs.randn(2, 6, 3, 3).astype(np.float32)
    _check(pnn.lrn, jnn.lrn, [x], kw=dict(nsize=nsize, alpha=1e-2,
                                          beta=0.75, knorm=2.0))
    _check(pnn.lrn, jnn.lrn, [_with_edges(rs, (1, 4, 2, 2))],
           kw=dict(nsize=nsize))


@pytest.mark.parametrize("temperature", [None, 2.0])
def test_softmin(temperature):
    rs = np.random.RandomState(13)
    x = rs.randn(4, 5).astype(np.float32)
    x[0] = 1.5                         # a row of ties
    x[1, :2] = x[1, 2]
    _check(pnn.softmin, jnn.softmin, [x], kw=dict(temperature=temperature))
    _check(pnn.softmin, jnn.softmin, [_with_edges(rs, (2, 7))])


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("op", ["masked_softmax", "masked_log_softmax"])
def test_masked_softmaxes(op, temperature):
    rs = np.random.RandomState(14)
    x = rs.randn(4, 6).astype(np.float32)
    x[3, 1] = np.nan                   # a NaN where the mask drops it
    mask = rs.rand(4, 6) > 0.4
    mask[0] = False                    # a fully masked row
    mask[1] = True
    mask[3, 1] = False
    _check(getattr(pnn, op), getattr(jnn, op), [x], [mask],
           dict(temperature=temperature))


def test_masked_softmax_unnormalized_and_edges():
    rs = np.random.RandomState(15)
    x = _with_edges(rs, (2, 7))
    mask = np.ones((2, 7), bool)
    mask[0, 2] = False
    _check(pnn.masked_softmax, jnn.masked_softmax, [x], [mask],
           dict(normalize=False))
    _check(pnn.masked_softmax, jnn.masked_softmax, [x], [mask])
    _check(pnn.masked_log_softmax, jnn.masked_log_softmax, [x], [mask])


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation(mode):
    rs = np.random.RandomState(16)
    _check(pspatial.softmax_activation, jspatial.softmax_activation,
           [rs.randn(2, 3, 4).astype(np.float32)], kw=dict(mode=mode))
    _check(pspatial.softmax_activation, jspatial.softmax_activation,
           [_with_edges(rs, (2, 3, 2))], kw=dict(mode=mode))


@pytest.mark.parametrize("axes,keepdims", [(None, False), ((1,), False),
                                           ((0, 2), True), ((2,), True)])
def test_moments(axes, keepdims):
    rs = np.random.RandomState(17)
    x = rs.randn(3, 4, 5).astype(np.float32)
    x[0] = 2.0                         # ties: a constant slab
    _check(pspatial.moments, jspatial.moments, [x],
           kw=dict(axes=axes, keepdims=keepdims))
    _check(pspatial.moments, jspatial.moments, [_with_edges(rs, (2, 7))],
           kw=dict(axes=(1,), keepdims=keepdims))


def test_all_finite_ops():
    rs = np.random.RandomState(18)
    fine = rs.randn(3, 4).astype(np.float32)
    for bad in (np.nan, np.inf, -np.inf):
        worse = fine.copy()
        worse[1, 2] = bad
        for arrays in ([fine], [worse], [fine, worse], [fine, fine]):
            want = np.asarray(jspatial.multi_all_finite(
                *[jnp.asarray(a) for a in arrays],
                num_arrays=len(arrays)))
            got = pspatial.multi_all_finite(
                *[torch.from_numpy(a) for a in arrays],
                num_arrays=len(arrays))
            np.testing.assert_array_equal(got.numpy(), want)
            assert got.dtype == torch.float32 and got.shape == (1,)
        np.testing.assert_array_equal(
            pspatial.all_finite(torch.from_numpy(worse)).numpy(),
            np.asarray(jspatial.all_finite(jnp.asarray(worse))))
    half = torch.tensor([1.0, float("inf")], dtype=torch.bfloat16)
    assert float(pspatial.all_finite(half)) == 0.0
    # no gradient through the predicate: d(all_finite(x) * x)/dx is the
    # predicate
    _check(lambda x: pspatial.all_finite(x) * x,
           lambda x: jspatial.all_finite(x) * x, [fine])
    got = mx.nd.multi_all_finite(mx.nd.array(fine), mx.nd.array(worse),
                                 num_arrays=2)
    np.testing.assert_array_equal(got.asnumpy(), [0.0])


@pytest.mark.parametrize("block", [2, 3])
def test_depth_to_space_and_back(block):
    rs = np.random.RandomState(19)
    x = _with_edges(rs, (2, 2 * block * block, 3, 4))
    _check(ptensor.depth_to_space, jtensor.depth_to_space, [x],
           kw=dict(block_size=block))
    y = _with_edges(rs, (2, 3, 3 * block, 2 * block))
    _check(ptensor.space_to_depth, jtensor.space_to_depth, [y],
           kw=dict(block_size=block))
    t = torch.from_numpy(y)
    back = ptensor.depth_to_space(ptensor.space_to_depth(t, block_size=block),
                                  block_size=block)
    np.testing.assert_array_equal(back.numpy(), y)


# ---------------------------------------------------------------------------
# gluon.contrib.nn
# ---------------------------------------------------------------------------


def test_pixel_shuffle_2d():
    x = np.random.RandomState(20).randn(2, 12, 3, 5).astype(np.float32)
    got = contrib.nn.PixelShuffle2D(2)(mx.nd.array(x)).asnumpy()
    want = jmx.gluon.contrib.nn.PixelShuffle2D(2)(jmx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 3, 6, 10)
    assert contrib.nn.PixelShuffle2D((3, 3))._factor == 3


def _concurrent(m, hybrid):
    c = (m.gluon.contrib.nn.HybridConcurrent(axis=1) if hybrid
         else m.gluon.contrib.nn.Concurrent(axis=1))
    c.add(m.gluon.nn.Dense(3, in_units=4), m.gluon.contrib.nn.Identity(),
          m.gluon.nn.Dense(2, in_units=4, activation="tanh"))
    return c


@pytest.mark.parametrize("hybrid", [False, True])
def test_concurrent_and_identity(hybrid, tmp_path):
    jc = _concurrent(jmx, hybrid)
    jc.initialize()
    f = str(tmp_path / "c.params")
    jc.save_parameters(f)
    pc = _concurrent(mx, hybrid)
    pc.load_parameters(f, ctx=mx.cpu())
    x = np.random.RandomState(21).randn(5, 4).astype(np.float32)
    got = pc(mx.nd.array(x)).asnumpy()
    assert got.shape == (5, 9)
    np.testing.assert_array_equal(got[:, 3:7], x)
    _match(got, jc(jmx.nd.array(x)).asnumpy())


def test_sync_batch_norm_is_batch_norm_on_one_card():
    bn = contrib.nn.SyncBatchNorm(in_channels=3, num_devices=1)
    assert isinstance(bn, nn.BatchNorm) and bn._axis == 1
    bn.initialize(ctx=mx.cpu())
    ref = nn.BatchNorm(in_channels=3)
    ref.initialize(ctx=mx.cpu())
    x = mx.nd.array(np.random.RandomState(22).randn(4, 3, 2, 2))
    with autograd.record():
        a, b = bn(x), ref(x)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    np.testing.assert_array_equal(bn.running_mean.data().asnumpy(),
                                  ref.running_mean.data().asnumpy())


# ---------------------------------------------------------------------------
# the Estimator
# ---------------------------------------------------------------------------


def _recorder(m, events):
    eh = m.gluon.contrib.estimator.event_handler

    class Recorder(eh.TrainBegin, eh.TrainEnd, eh.EpochBegin, eh.EpochEnd,
                   eh.BatchBegin, eh.BatchEnd):
        def train_begin(self, est, *a, **k):
            events.append("train_begin")

        def train_end(self, est, *a, **k):
            events.append("train_end")

        def epoch_begin(self, est, *a, **k):
            events.append("epoch_begin")

        def epoch_end(self, est, *a, **k):
            events.append("epoch_end:" + ",".join(
                f"{n}={v:.6f}" for n, v in (
                    mm.get() for mm in est.train_metrics + est.val_metrics)))

        def batch_begin(self, est, *a, **k):
            events.append("batch_begin")

        def batch_end(self, est, *a, **k):
            events.append("batch_end")

    return Recorder()


def _fit(m, f, x, y, tmp_path, caplog):
    net = m.gluon.nn.HybridSequential()
    net.add(m.gluon.nn.Dense(8, in_units=4, activation="relu"),
            m.gluon.nn.Dense(3, in_units=8))
    net.load_parameters(f, **({"ctx": m.cpu()} if m is mx else {}))
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
    est = m.gluon.contrib.estimator.Estimator(
        net, m.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=["accuracy", m.metric.Loss()], trainer=trainer,
        context=m.cpu(), val_metrics=["accuracy"])
    train = m.io.NDArrayIter(x, y, batch_size=4)
    val = m.io.NDArrayIter(x[:8], y[:8], batch_size=4)

    class Batches:
        def __init__(self, it):
            self.it = it

        def __iter__(self):
            self.it.reset()
            for b in self.it:
                yield b.data[0], b.label[0]

    events = []
    eh = m.gluon.contrib.estimator
    stop = eh.EarlyStoppingHandler(monitor=est.train_metrics[0],
                                   patience=5)
    ckpt = eh.CheckpointHandler(str(tmp_path / m.__name__), epoch_period=1)
    with caplog.at_level(logging.INFO):
        est.fit(Batches(train), val_data=Batches(val), epochs=2,
                event_handlers=[_recorder(m, events), stop, ckpt])
    saved = sorted(p.name for p in (tmp_path / m.__name__).iterdir())
    weights = [p.data().asnumpy() for p in net.collect_params().values()]
    return events, saved, weights


def test_estimator_fit_matches_the_reference(tmp_path, caplog):
    rs = np.random.RandomState(23)
    x = rs.randn(12, 4).astype(np.float32)
    y = rs.randint(0, 3, 12).astype(np.float32)
    jnet = jmx.gluon.nn.HybridSequential()
    jnet.add(jmx.gluon.nn.Dense(8, in_units=4, activation="relu"),
             jmx.gluon.nn.Dense(3, in_units=8))
    jnet.initialize()
    f = str(tmp_path / "net.params")
    jnet.save_parameters(f)
    want = _fit(jmx, f, x, y, tmp_path, caplog)
    got = _fit(mx, f, x, y, tmp_path, caplog)
    assert got[0][0] == "train_begin" and got[0][-1] == "train_end"
    assert got[0].count("batch_end") == 6 and got[0].count("epoch_begin") == 2
    assert [e.split(":")[0] for e in got[0]] == \
        [e.split(":")[0] for e in want[0]]
    for g, w in zip(got[0], want[0]):
        if g.startswith("epoch_end"):
            gv = [float(t.split("=")[1]) for t in g[10:].split(",")]
            wv = [float(t.split("=")[1]) for t in w[10:].split(",")]
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)
    assert got[1] == want[1]
    for g, w in zip(got[2], want[2]):
        _match(g, w, tol=1e-4)
    assert "Train finished" in caplog.text


def test_estimator_needs_epochs_or_batches():
    net = nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    est = contrib.estimator.Estimator(net, mx.gluon.loss.L2Loss(),
                                      context=mx.cpu())
    with pytest.raises(MXNetError, match="epochs or batches"):
        est.fit([])
