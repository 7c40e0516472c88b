"""The port's Gluon core against the JAX package's, on the CPU.

Mirrors the cases of ``tests/test_gluon.py`` this slice covers (dense
shapes and flatten, deferred and explicit initialization, the conv/pool
stack, parameter sharing, ``collect_params`` select, hybridize parity
and cache, dropout's fresh masks, BatchNorm's running statistics, grads
hybridized against eager, trainer convergence, every loss, save/load,
sequential slicing, hooks, ``cast``, name scopes, the ``nn`` exports),
each through both packages from the same seeded numpy inputs and
weights. One test per row of the probe table the slice repairs
(prefixed ``collect_params`` names, ``Parameter.data()`` an NDArray,
``nn.Dense(5)`` deferred, ``mx.init``, ``HybridBlock`` its own class),
the seven ``mx.nd`` ops the layers call, the activations, ``gluon.utils``
and ``.params`` files cross-loaded both ways for a ``HybridSequential``
of Dense/LayerNorm/BatchNorm and a 2-layer BERT.

The port runs under ``with mx.cpu():`` (its default context is the
card). Tolerances: f32 results to 1e-5 of their largest magnitude (the
two frameworks sum products in other orders) unless a test says
otherwise.
"""
import hashlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _close(a, b, tol=TOL, what=""):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
    assert float(np.abs(a - b).max(initial=0.0)) <= tol * scale, what


def _suffix(name):
    """A prefixed name without its top block's counter prefix."""
    return name[name.index("_") + 1:]


def _copy_weights(jnet, pnet, seed=0):
    """Fill both nets' parameters (structural names, shapes settled)
    with the same seeded numpy values; returns them."""
    rs = np.random.RandomState(seed)
    jp = jnet._collect_params_with_prefix()
    pp = pnet._collect_params_with_prefix()
    assert sorted(jp) == sorted(pp)
    vals = {}
    for k in sorted(jp):
        shape = tuple(jp[k].shape)
        if k.endswith("running_var") or k.endswith("gamma"):
            v = 1.0 + 0.1 * rs.rand(*shape)
        else:
            v = 0.3 * rs.randn(*shape)
        vals[k] = v.astype(np.float32)
        jp[k].set_data(jmx.nd.array(vals[k]))
        pp[k].set_data(vals[k])
    return vals


# ---------------------------------------------------------------------------
# the probe table: one row each
# ---------------------------------------------------------------------------

BERT_CFG = dict(vocab_size=64, max_length=16, num_layers=2, units=32,
                hidden_size=48, num_heads=4, dropout=0.0)


def test_collect_params_names_are_the_references():
    """Row 1: ``BERTModel(...).collect_params()`` keys are the reference's
    prefixed names (``bertmodel0_word_embed_weight``...), in its order,
    and a select such as ``".*_bias"`` picks the same parameters."""
    from mxnet_tpu.gluon.model_zoo.nlp.bert import BERTModel as JBERT

    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTModel

    jnet, pnet = JBERT(**BERT_CFG), BERTModel(**BERT_CFG)
    jkeys = [_suffix(k) for k in jnet.collect_params().keys()]
    pkeys = [_suffix(k) for k in pnet.collect_params().keys()]
    assert pkeys == jkeys
    assert pnet.prefix.startswith("bertmodel")
    assert "word_embed_weight" in pkeys and "enc_layer1_ln2_beta" in pkeys
    for sel in (".*_bias", ".*ln.*", ".*enc_layer0_.*weight"):
        j = [_suffix(k) for k in jnet.collect_params(sel).keys()]
        p = [_suffix(k) for k in pnet.collect_params(sel).keys()]
        assert p == j and p, sel
    # the structural names of a .params file are the JAX package's too
    assert sorted(pnet._collect_params_with_prefix()) == \
        sorted(jnet._collect_params_with_prefix())


def test_parameter_data_is_an_ndarray_over_its_storage():
    """Row 2: ``Parameter.data()`` and ``grad()`` are NDArrays over the
    parameter's own storage (no copy), as the reference's are; a write
    through them is a write to the weight the forward reads."""
    d = nn.Dense(3, in_units=4)
    d.initialize()
    w = d.weight.data()
    assert isinstance(w, mx.nd.NDArray) and isinstance(d.weight.grad(),
                                                      mx.nd.NDArray)
    assert w._data.data_ptr() == d.weight.tensor.data_ptr()
    assert d.weight.grad()._data is d.weight.tensor.grad
    assert d.weight.data() is w and d.weight.list_data() == [w]
    jd = jnn.Dense(3, in_units=4)
    jd.initialize()
    assert isinstance(jd.weight.data(), jmx.nd.NDArray)
    w[:] = 0.0
    x = mx.nd.ones((2, 4))
    assert float(d(x).abs().sum().asscalar()) == 0.0


def test_dense_without_in_units_is_deferred():
    """Row 3: ``nn.Dense(5)`` then ``initialize()`` defers the weight,
    shape (5, 0), until the first forward fills it in; before that
    ``data()`` raises, in both packages."""
    for m, pkg_nn in ((jmx, jnn), (mx, nn)):
        d = pkg_nn.Dense(5)
        d.initialize()
        assert tuple(d.weight.shape) == (5, 0)
        with pytest.raises(Exception):
            d.weight.data()
        out = d(m.nd.ones((2, 9)))
        assert tuple(d.weight.shape) == (5, 9) and out.shape == (2, 5)
    with pytest.raises(DeferredInitializationError):
        d = nn.Dense(5)
        d.initialize()
        d.weight.data()


def test_mx_init_and_mx_initializer_exist():
    """Row 4: ``mx.init.Xavier()`` and ``mx.initializer`` exist and name
    the same classes, as in the reference."""
    assert mx.init.Xavier is mx.initializer.Xavier
    assert isinstance(mx.init.Xavier(), mx.initializer.Initializer)
    assert mx.init.create("zeros").__class__ is mx.init.Zero
    for name in ("Uniform", "Normal", "Zero", "One", "Constant", "Xavier",
                 "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias", "Mixed",
                 "Load", "InitDesc", "register", "create"):
        assert hasattr(mx.init, name) and hasattr(jmx.init, name), name


def test_hybrid_block_is_its_own_class():
    """Row 5: ``HybridBlock`` is a subclass of ``Block``, not the same
    class; ``hybridize()`` turns its graph cache on (on the CPU it runs
    eagerly and gives the eager values)."""
    assert gluon.HybridBlock is not gluon.Block
    assert issubclass(gluon.HybridBlock, gluon.Block)
    assert jgluon.HybridBlock is not jgluon.Block
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3))
    net.initialize()
    assert not net._active
    net.hybridize()
    assert net._active and net[0]._active


# ---------------------------------------------------------------------------
# tests/test_gluon.py's cases
# ---------------------------------------------------------------------------

def test_dense_shapes_and_flatten():
    rs = np.random.RandomState(1)
    x = rs.randn(4, 3, 5).astype(np.float32)
    for flatten, shape in ((True, (4, 7)), (False, (4, 3, 7))):
        jd, pd = jnn.Dense(7, flatten=flatten), nn.Dense(7, flatten=flatten)
        jd.initialize()
        pd.initialize()
        jd(jmx.nd.array(x))
        pd(mx.nd.array(x))
        _copy_weights(jd, pd)
        out = pd(mx.nd.array(x))
        assert out.shape == shape
        _close(out.asnumpy(), jd(jmx.nd.array(x)).asnumpy())


def test_deferred_init_and_explicit():
    d = nn.Dense(3)
    d.initialize()
    with pytest.raises(DeferredInitializationError):
        d.weight.data()
    d(mx.nd.ones((2, 9)))
    assert d.weight.shape == (3, 9)
    e = nn.Dense(3, in_units=9)
    e.initialize()
    assert e.weight.data().shape == (3, 9)
    # a known shape allocates at initialize; no shape and no deferral raises
    p = gluon.Parameter("w", shape=(2, 0))
    with pytest.raises(mx.MXNetError, match="unknown shape"):
        p.initialize()


def test_conv_pool_stack():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 8, 8).astype(np.float32)
    nets = []
    for pnn_ in (jnn, nn):
        net = pnn_.HybridSequential()
        with net.name_scope():
            net.add(pnn_.Conv2D(8, 3, padding=1), pnn_.MaxPool2D(),
                    pnn_.Conv2D(4, 1), pnn_.GlobalAvgPool2D())
        net.initialize()
        nets.append(net)
    jout = nets[0](jmx.nd.array(x))
    nets[1](mx.nd.array(x))
    _copy_weights(*nets)
    out = nets[1](mx.nd.array(x))
    assert out.shape == (2, 4, 1, 1)
    _close(out.asnumpy(), nets[0](jmx.nd.array(x)).asnumpy())
    assert jout.shape == out.shape


def test_conv_layers_nhwc_and_pools():
    """NHWC convolution (weights still OIHW) equals NCHW on the permuted
    input; AvgPool2D and GlobalMaxPool2D against the JAX layers; the
    transposed, grouped and 1-D/3-D forms, which raised naming item 4
    until its convolutions came, against the JAX layers too."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 4, 6, 6).astype(np.float32)
    a = nn.Conv2D(5, 3, padding=1, in_channels=4)
    b = nn.Conv2D(5, 3, padding=1, in_channels=4, layout="NHWC")
    for blk in (a, b):
        blk.initialize()
    b.weight.set_data(a.weight.data())
    b.bias.set_data(a.bias.data())
    assert b.weight.tensor.is_contiguous(memory_format=torch.channels_last)
    got = b(mx.nd.array(x.transpose(0, 2, 3, 1))).asnumpy()
    _close(got.transpose(0, 3, 1, 2), a(mx.nd.array(x)).asnumpy())
    for jl, pl in ((jnn.AvgPool2D(2), nn.AvgPool2D(2)),
                   (jnn.GlobalMaxPool2D(), nn.GlobalMaxPool2D()),
                   (jnn.ReflectionPad2D(1), nn.ReflectionPad2D(1))):
        _close(pl(mx.nd.array(x)).asnumpy(), jl(jmx.nd.array(x)).asnumpy())
    for cls, args, kw, xs in (
            ("Conv2DTranspose", (3, 4), {}, x),
            ("Conv1D", (3, 2), {}, x[:, :, 0]),
            ("Conv3D", (3, 2), {}, np.stack([x, 2 * x], 2)),
            ("Conv2D", (8, 3), {"groups": 2}, x)):
        pl, jl = getattr(nn, cls)(*args, **kw), getattr(jnn, cls)(*args, **kw)
        pl.initialize()
        jl.initialize()
        jout = jl(jmx.nd.array(xs))
        pl(mx.nd.array(xs))
        pl.weight.set_data(jl.weight.data().asnumpy())
        pl.bias.set_data(jl.bias.data().asnumpy())
        _close(pl(mx.nd.array(xs)).asnumpy(), jout.asnumpy())


def test_parameter_sharing():
    d1 = nn.Dense(5, in_units=4)
    d2 = nn.Dense(5, in_units=4, params=d1.collect_params())
    d1.initialize()
    assert d2.weight is d1.weight and d2.bias is d1.bias
    x = mx.nd.array(np.random.RandomState(4).rand(2, 4))
    np.testing.assert_array_equal(d1(x).asnumpy(), d2(x).asnumpy())
    # one tensor, held by both blocks
    assert d2.weight.tensor is d1.weight.tensor
    assert dict(d2.named_parameters())["weight"] is d1.weight.tensor


def test_collect_params_select():
    for pnn_ in (jnn, nn):
        net = pnn_.HybridSequential(prefix="model_")
        with net.name_scope():
            net.add(pnn_.Dense(3, in_units=2), pnn_.Dense(2, in_units=3))
        params = net.collect_params(".*weight")
        assert all(k.endswith("weight") for k in params.keys())
        assert len(params) == 2
        assert all(k.startswith("model_dense") for k in params.keys())


def test_hybridize_parity_and_cache():
    rs = np.random.RandomState(5)
    x = rs.randn(3, 8).astype(np.float32)
    nets = []
    for pnn_ in (jnn, nn):
        net = pnn_.HybridSequential()
        with net.name_scope():
            net.add(pnn_.Dense(16, activation="relu", in_units=8),
                    pnn_.Dense(4, in_units=16))
        net.initialize()
        nets.append(net)
    _copy_weights(*nets)
    jnet, pnet = nets
    eager = pnet(mx.nd.array(x)).asnumpy()
    for n in nets:
        n.hybridize()
    hybrid = pnet(mx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(eager, hybrid)     # the CPU runs eagerly
    _close(hybrid, jnet(jmx.nd.array(x)).asnumpy())
    y = rs.randn(5, 8).astype(np.float32)
    assert pnet(mx.nd.array(y)).shape == (5, 4)
    assert pnet.cached_graph is None        # no CUDA graph on the CPU
    assert pnet.warmup([(2, 8)], ctx=mx.cpu()) == 0
    pnet.hybridize(False)
    with pytest.raises(mx.MXNetError, match="hybridize"):
        pnet.warmup([(2, 8)])


def test_hybridize_dropout_fresh_masks():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dropout(0.5))
    net.initialize()
    net.hybridize()
    x = mx.nd.ones((100,))
    with autograd.record():
        a = net(x).asnumpy()
        b = net(x).asnumpy()
    assert not np.allclose(a, b), "dropout mask must differ across calls"
    assert set(np.unique(a)) <= {0.0, 2.0}
    np.testing.assert_array_equal(net(x).asnumpy(), np.ones(100))


def test_hybridize_batchnorm_aux_updates():
    """BatchNorm in training (``record()``) folds the batch statistics
    into the running ones by the reference's expression, equal to the
    JAX block's; outside it, the running statistics normalise."""
    x = np.random.RandomState(6).normal(5.0, 2.0, (16, 3)).astype(
        np.float32)
    outs = []
    for m, pnn_, ag in ((jmx, jnn, jag), (mx, nn, autograd)):
        bn = pnn_.BatchNorm()
        bn.initialize()
        bn.hybridize()
        with ag.record():
            bn(m.nd.array(x))
        outs.append((bn.running_mean.data().asnumpy(),
                     bn.running_var.data().asnumpy(),
                     bn(m.nd.array(x)).asnumpy()))
    assert not np.allclose(outs[1][0], 0)
    for a, b in zip(outs[1], outs[0]):
        _close(a, b)


def test_hybridize_grads_match_eager():
    rs = np.random.RandomState(7)
    x = rs.randn(4, 6).astype(np.float32)
    grads = {}
    for m, pnn_, ag, key in ((jmx, jnn, jag, "jax"), (mx, nn, autograd,
                                                      "port")):
        net = pnn_.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(pnn_.Dense(8, activation="tanh", in_units=6),
                    pnn_.Dense(1, in_units=8))
        net.initialize()
        wr = np.random.RandomState(8)
        for p in net.collect_params().values():
            p.set_data(m.nd.array(wr.randn(*p.shape).astype(np.float32)))
        for hyb in (False, True):
            net.hybridize(hyb)
            for p in net.collect_params().values():
                p.zero_grad()
            with ag.record():
                loss = (net(m.nd.array(x)) ** 2).sum()
            loss.backward()
            grads[key, hyb] = [p.grad().asnumpy()
                               for p in net.collect_params().values()]
    for a, b in zip(grads["port", True], grads["port", False]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(grads["port", True], grads["jax", True]):
        _close(a, b)


def test_trainer_step_converges():
    net = nn.Dense(1, in_units=2)
    net.initialize(mx.init.Normal(0.1))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    rs = np.random.RandomState(9)
    x = mx.nd.array(rs.randn(64, 2).astype("float32"))
    w_true = np.array([[2.0], [-3.0]], dtype="float32")
    y = mx.nd.array(x.asnumpy() @ w_true)
    l2 = gluon.loss.L2Loss()
    for _ in range(200):
        with autograd.record():
            loss = l2(net(x), y)
        loss.backward()
        trainer.step(64)
    np.testing.assert_allclose(net.weight.data().asnumpy(), w_true.T,
                               atol=1e-2)


def _loss_cases():
    rs = np.random.RandomState(10)
    p = rs.randn(4, 5).astype(np.float32)
    lab = rs.randint(0, 5, (4,)).astype(np.float32)
    dense = np.abs(rs.rand(4, 5)).astype(np.float32)
    dense /= dense.sum(-1, keepdims=True)
    t = rs.randn(4, 5).astype(np.float32)
    signs = np.sign(rs.randn(4, 5)).astype(np.float32)
    prob = (1 / (1 + np.exp(-p))).astype(np.float32)
    sw = rs.rand(4, 1).astype(np.float32)
    pos = np.abs(rs.randn(4, 5)).astype(np.float32)
    return [
        ("L2Loss", {}, (p, t)),
        ("L2Loss", {"weight": 0.5}, (p, t, sw)),
        ("L1Loss", {}, (p, t)),
        ("SigmoidBinaryCrossEntropyLoss", {}, (p, (t > 0).astype("f4"))),
        ("SigmoidBinaryCrossEntropyLoss", {"from_sigmoid": True},
         (prob, (t > 0).astype("f4"))),
        ("SoftmaxCrossEntropyLoss", {}, (p, lab)),
        ("SoftmaxCrossEntropyLoss", {}, (p, lab, sw)),
        ("SoftmaxCrossEntropyLoss", {"sparse_label": False}, (p, dense)),
        ("SoftmaxCrossEntropyLoss", {"from_logits": True},
         (np.log(dense), lab)),
        ("SoftmaxCrossEntropyLoss",
         {"from_logits": True, "sparse_label": False},
         (np.log(dense), dense)),
        ("KLDivLoss", {}, (np.log(dense[::-1]), dense)),
        ("KLDivLoss", {"from_logits": False}, (p, dense)),
        ("HuberLoss", {"rho": 0.5}, (p, t)),
        ("HingeLoss", {}, (p, signs)),
        ("SquaredHingeLoss", {}, (p, signs)),
        ("LogisticLoss", {}, (p, signs)),
        ("LogisticLoss", {"label_format": "binary"},
         (p, (signs > 0).astype("f4"))),
        ("TripletLoss", {}, (p, t, signs)),
        ("CosineEmbeddingLoss", {}, (p, t, np.array([1, -1, 1, -1],
                                                    np.float32))),
        ("PoissonNLLLoss", {}, (p, pos)),
        ("PoissonNLLLoss", {"from_logits": False, "compute_full": True},
         (pos + 0.5, pos * 3)),
    ]


@pytest.mark.parametrize("case", range(len(_loss_cases())))
def test_every_loss_against_the_reference(case):
    """Each loss of ``gluon.loss`` (each form) against the JAX loss on the
    same inputs; the sigmoid BCE with ``pos_weight`` too."""
    name, kw, args = _loss_cases()[case]
    got = getattr(gluon.loss, name)(**kw)(*[mx.nd.array(a) for a in args])
    want = getattr(jgluon.loss, name)(**kw)(*[jmx.nd.array(a)
                                              for a in args])
    assert isinstance(got, mx.nd.NDArray)
    _close(got.asnumpy(), want.asnumpy(), what=name)


def test_loss_values_vs_numpy():
    pred = mx.nd.array([[1.0, 2.0, 3.0], [1.0, 1.0, 1.0]])
    label = mx.nd.array([2, 0])
    lo = gluon.loss.SoftmaxCrossEntropyLoss()(pred, label).asnumpy()
    logp = pred.asnumpy() - np.log(np.exp(pred.asnumpy()).sum(
        -1, keepdims=True))
    np.testing.assert_allclose(lo, -np.array([logp[0, 2], logp[1, 0]]),
                               rtol=1e-5)
    p, t = mx.nd.array([1.0, 2.0]), mx.nd.array([0.0, 0.0])
    np.testing.assert_allclose(gluon.loss.L2Loss()(p, t).asnumpy(),
                               [0.5, 2.0])
    big, lbl = mx.nd.array([100.0, -100.0]), mx.nd.array([1.0, 0.0])
    bce = gluon.loss.SigmoidBCELoss()(big, lbl).asnumpy()
    assert np.all(np.isfinite(bce)) and np.allclose(bce, 0, atol=1e-4)
    rs = np.random.RandomState(11)
    x, y = rs.randn(3, 4).astype("f4"), rs.randn(3, 4).astype("f4")
    pw = np.abs(rs.randn(3, 4)).astype("f4") + 0.5
    got = gluon.loss.SigmoidBCELoss()(mx.nd.array(x), mx.nd.array(
        (y > 0).astype("f4")), None, mx.nd.array(pw)).asnumpy()
    want = jgluon.loss.SigmoidBCELoss()(jmx.nd.array(x), jmx.nd.array(
        (y > 0).astype("f4")), None, jmx.nd.array(pw)).asnumpy()
    _close(got, want)
    huber = gluon.loss.HuberLoss(rho=1.0)(mx.nd.array(x),
                                          mx.nd.array(y)).asnumpy()
    d = np.abs(x - y)
    np.testing.assert_allclose(
        huber, np.where(d > 1, d - 0.5, 0.5 * d * d).mean(1), rtol=1e-5)
    with pytest.raises(mx.MXNetError, match="item 4"):
        gluon.loss.CTCLoss()


def test_losses_take_tensors_for_trainstep():
    """A loss called with torch tensors (as ``parallel.TrainStep`` calls
    it) gives the NDArray call's values as a tensor."""
    rs = np.random.RandomState(12)
    p, lab = rs.randn(6, 5).astype("f4"), rs.randint(0, 5, 6).astype("f4")
    fn = gluon.loss.SoftmaxCrossEntropyLoss()
    t = fn(torch.from_numpy(p), torch.from_numpy(lab))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(
        t.numpy(), fn(mx.nd.array(p), mx.nd.array(lab)).asnumpy())


def _seq(pnn_, m=None):
    net = pnn_.HybridSequential(prefix="seq_")
    with net.name_scope():
        net.add(pnn_.Dense(6, in_units=4), pnn_.LayerNorm(in_channels=6),
                pnn_.BatchNorm(in_channels=6), pnn_.Dense(3, in_units=6))
    net.initialize()
    return net


def test_save_load_cross_load_both_ways(tmp_path):
    """A HybridSequential of Dense/LayerNorm/BatchNorm: the port's
    ``save_parameters`` file loads into the JAX package's net and the
    JAX package's into the port's, each then computing the other's
    outputs; a net of another shape refuses the file."""
    x = np.random.RandomState(13).randn(5, 4).astype(np.float32)
    jnet, pnet = _seq(jnn), _seq(nn)
    _copy_weights(jnet, pnet, seed=14)
    ref = jnet(jmx.nd.array(x)).asnumpy()
    _close(pnet(mx.nd.array(x)).asnumpy(), ref)
    f_port, f_jax = str(tmp_path / "port.params"), \
        str(tmp_path / "jax.params")
    pnet.save_parameters(f_port)
    jnet.save_parameters(f_jax)
    assert open(f_port, "rb").read() == open(f_jax, "rb").read()
    j2, p2 = _seq(jnn), _seq(nn)
    j2.load_parameters(f_port)
    p2.load_parameters(f_jax)
    _close(j2(jmx.nd.array(x)).asnumpy(), ref)
    _close(p2(mx.nd.array(x)).asnumpy(), ref)
    # an uninitialized net loads from the file, no initializer first
    p3 = nn.HybridSequential(prefix="seq_")
    with p3.name_scope():
        p3.add(nn.Dense(6), nn.LayerNorm(), nn.BatchNorm(), nn.Dense(3))
    p3.load_parameters(f_jax, ctx=mx.cpu())
    _close(p3(mx.nd.array(x)).asnumpy(), ref)
    bad = nn.Dense(9, in_units=3)
    bad.initialize()
    with pytest.raises(mx.MXNetError):
        bad.load_parameters(f_port)


def test_bert_cross_loads_both_ways(tmp_path):
    """A 2-layer narrow BERT: the JAX package's ``.params`` file loads
    into the port's ``BERTModel`` and the port's into the JAX package's,
    every output then equal to the other package's to 1e-5."""
    from mxnet_tpu.gluon.model_zoo.nlp.bert import BERTModel as JBERT

    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTModel

    rs = np.random.RandomState(15)
    tok = rs.randint(0, 64, (2, 16)).astype(np.float32)
    jnet = JBERT(**BERT_CFG)
    jnet.initialize(jmx.init.Normal(0.02))
    jnet(jmx.nd.array(tok))
    f_jax = str(tmp_path / "jax.params")
    jnet.save_parameters(f_jax)
    pnet = BERTModel(**BERT_CFG)
    pnet.load_parameters(f_jax, ctx=mx.cpu())
    for a, b in zip(pnet(mx.nd.array(tok)), jnet(jmx.nd.array(tok))):
        _close(a.asnumpy(), b.asnumpy())
    pnet2 = BERTModel(ctx=mx.cpu(), **BERT_CFG)
    f_port = str(tmp_path / "port.params")
    pnet2.save_parameters(f_port)
    jnet.load_parameters(f_port)
    for a, b in zip(pnet2(mx.nd.array(tok)), jnet(jmx.nd.array(tok))):
        _close(a.asnumpy(), b.asnumpy())


def test_sequential_slicing():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(4), nn.Dense(3), nn.Dense(2))
    assert len(net) == 3
    assert isinstance(net[1], nn.Dense)
    sub = net[:2]
    assert len(sub) == 2 and isinstance(sub, nn.HybridSequential)
    assert sub[0] is net[0]
    seq = nn.Sequential()
    seq.add(nn.Dense(2, in_units=3), nn.Lambda("relu"))
    seq.initialize()
    assert seq(mx.nd.ones((1, 3))).shape == (1, 2) and len(seq[1:]) == 1


def test_block_hooks():
    net = nn.Dense(2, in_units=2)
    net.initialize()
    calls = []
    h1 = net.register_forward_pre_hook(lambda blk, inp: calls.append("pre"))
    h2 = net.register_forward_hook(lambda blk, inp, out: calls.append(
        ("post", type(out).__name__)))
    net(mx.nd.ones((1, 2)))
    assert calls == ["pre", ("post", "NDArray")]
    h1.detach()
    h2.detach()
    net(mx.nd.ones((1, 2)))
    assert len(calls) == 2
    text = net.summary(mx.nd.ones((1, 2)))
    assert "Dense" in text and "(1, 2)" in text


def test_cast_dtype():
    net = nn.Dense(3, in_units=2)
    net.initialize()
    before = net.weight.tensor
    net.cast("bfloat16")
    assert net.weight.dtype == "bfloat16"
    assert net.weight.tensor is not before
    assert net.weight.tensor.dtype == torch.bfloat16
    assert dict(net.named_parameters())["weight"] is net.weight.tensor
    out = net(mx.nd.ones((2, 2), dtype="bfloat16"))
    assert str(out.dtype) == "bfloat16"
    bn = nn.BatchNorm(in_channels=3)
    bn.initialize()
    bn.cast("bfloat16")
    assert bn.gamma.dtype == "float32"


def test_name_scope_not_leaked_by_reentrant_blocks():
    from mxnet_tpu_torch.gluon.block import _scope

    before = _scope.current
    net = nn.HybridSequential()
    net.add(nn.Dense(4, activation="relu"), nn.Dense(2))
    assert _scope.current is before
    d = nn.Dense(3)
    assert not d.prefix.startswith(net.prefix)
    with net.name_scope():
        inner = nn.Dense(3)
        with net.name_scope():
            nn.Dense(1)
        assert _scope.current is net.name_scope()
    assert _scope.current is before
    assert inner.prefix.startswith(net.prefix)


def test_nn_exposes_block_bases():
    from mxnet_tpu_torch.gluon import nn as gnn

    assert gnn.Block is mx.gluon.Block
    assert gnn.HybridBlock is mx.gluon.HybridBlock
    assert gnn.SymbolBlock is mx.gluon.SymbolBlock
    jnames = {n for n in dir(jnn) if not n.startswith("_")}
    for name in ("Dense", "Dropout", "BatchNorm", "InstanceNorm",
                 "LayerNorm", "GroupNorm", "Embedding", "Flatten", "Lambda",
                 "HybridLambda", "Identity", "Sequential", "HybridSequential",
                 "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
                 "Swish", "SiLU", "Conv2D", "MaxPool2D", "AvgPool2D",
                 "GlobalMaxPool2D", "GlobalAvgPool2D", "ReflectionPad2D"):
        assert name in jnames and hasattr(gnn, name), name
    for name in ("Parameter", "Constant", "ParameterDict", "Trainer",
                 "loss", "nn", "utils", "model_zoo"):
        assert hasattr(mx.gluon, name) and hasattr(jgluon, name), name


def test_symbol_entry_points_raise_naming_item_12():
    net = nn.Dense(2, in_units=2)
    net.initialize()
    with pytest.raises(mx.MXNetError, match="item 12"):
        net.export("x")
    with pytest.raises(mx.MXNetError, match="item 12"):
        net.optimize_for(mx.nd.ones((1, 2)))
    with pytest.raises(mx.MXNetError, match="item 12"):
        gluon.SymbolBlock()
    with pytest.raises(mx.MXNetError, match="item 12"):
        net.weight.var()


# ---------------------------------------------------------------------------
# Parameter and ParameterDict
# ---------------------------------------------------------------------------

def test_parameter_dict_api(tmp_path):
    pd = gluon.ParameterDict("blk_")
    w = pd.get("w", shape=(2, 3), init=mx.init.One())
    assert w.name == "blk_w" and pd.get("w") is w
    c = pd.get_constant("c", np.arange(3, dtype=np.float32))
    assert c.grad_req == "null" and isinstance(c, gluon.Constant)
    shared = gluon.ParameterDict("blk_", shared=pd)
    assert shared.get("w") is w
    other = gluon.ParameterDict("o_")
    other.get("v", shape=(4,))
    pd.update(other)
    assert list(pd.keys()) == ["blk_w", "blk_c", "o_v"]
    with pytest.raises(mx.MXNetError, match="duplicate"):
        pd.update({"blk_w": gluon.Parameter("blk_w", shape=(1,))})
    pd.initialize(mx.init.Zero())
    np.testing.assert_array_equal(w.data().asnumpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(c.data().asnumpy(), np.arange(3))
    np.testing.assert_array_equal(pd["o_v"].data().asnumpy(), np.zeros(4))
    pd.setattr("lr_mult", 0.5)
    assert all(p.lr_mult == 0.5 for p in pd.values())
    w.grad()[:] = 1.0
    pd.zero_grad()
    assert float(w.grad().sum().asscalar()) == 0.0
    path = str(tmp_path / "pd.params")
    pd.save(path, strip_prefix="blk_")
    loaded = mx.nd.load(path)
    assert sorted(loaded) == ["c", "o_v", "w"]
    pd2 = gluon.ParameterDict("blk_")
    pd2.get("w", shape=(2, 3))
    pd2.get_constant("c", np.zeros(3, np.float32))
    pd2.load(path, ctx=mx.cpu(), ignore_extra=True, restore_prefix="blk_")
    np.testing.assert_array_equal(pd2["blk_w"].data().asnumpy(),
                                  np.ones((2, 3)))
    with pytest.raises(mx.MXNetError, match="extra"):
        pd2.load(path, restore_prefix="blk_")


def test_a_served_model_holds_no_gradient_buffers():
    """A parameter's gradient buffer is made at its first use, so an
    initialized model that is only served holds none (an 8B model would
    otherwise hold its size again in zeros)."""
    net = _seq(nn)
    net(mx.nd.ones((2, 4)))
    assert all(p.tensor.grad is None for p in net.collect_params().values())
    with autograd.record():
        loss = net(mx.nd.ones((2, 4))).sum()
    loss.backward()
    assert all((p.tensor.grad is not None) == (p.grad_req != "null")
               for p in net.collect_params().values())


def test_parameter_grad_req_reset_ctx_and_set_data():
    p = gluon.Parameter("p", shape=(3,))
    p.initialize(mx.init.One(), ctx=mx.cpu())
    assert p.list_ctx() == [mx.cpu()]
    assert p.grad().shape == (3,)
    p.grad_req = "null"
    assert not p.tensor.requires_grad and p.list_grad() == []
    with pytest.raises(mx.MXNetError, match="grad_req='null'"):
        p.grad()
    p.grad_req = "add"
    assert p.tensor.grad is None           # made at its first use
    assert p.grad()._data is p.tensor.grad and p.tensor.grad is not None
    with pytest.raises(mx.MXNetError, match="grad_req"):
        p.grad_req = "sometimes"
    p.set_data(np.array([1.0, 2.0, 3.0], np.float32))
    np.testing.assert_array_equal(p.data().asnumpy(), [1, 2, 3])
    with pytest.raises(mx.MXNetError, match="shape"):
        p.set_data(np.zeros(4, np.float32))
    p.reset_ctx(mx.cpu())
    p.initialize(ctx=[mx.cpu(0), mx.cpu(1)], force_reinit=True)
    assert p.list_ctx() == [mx.cpu(0), mx.cpu(1)]
    assert [d.context for d in p.list_data()] == [mx.cpu(0), mx.cpu(1)]
    assert p.list_data()[0]._data is not p.list_data()[1]._data
    deferred = gluon.Parameter("d", shape=(0, 2), allow_deferred_init=True)
    deferred.initialize(ctx=mx.cpu())
    deferred.set_data(np.ones((3, 2), np.float32))
    assert deferred.shape == (3, 2)


def test_a_deep_copy_keeps_gradient_buffers_and_grad_req():
    """``copy.deepcopy`` of an initialized block (as the card tests copy a
    CPU model to the card) gives parameters with their gradient buffers
    and ``grad_req``: a Trainer steps the copy, a parameter the loss does
    not reach included, and the original is left alone."""
    import copy

    seq = nn.Sequential()
    seq.add(nn.Dense(2, in_units=3), nn.Dense(2, in_units=3))
    seq.initialize()
    seq[0].bias.grad_req = "add"
    dup = copy.deepcopy(seq)
    assert dup[0].weight.tensor is not seq[0].weight.tensor
    assert dict(dup.named_parameters())["0.weight"] is dup[0].weight.tensor
    for p in dup.collect_params().values():
        assert p.grad()._data is p.tensor.grad
        assert float(p.grad().abs().sum().asscalar()) == 0.0
    assert dup[0].bias.tensor._mx_grad_req == "add"
    before = seq[0].weight.data().asnumpy().copy()
    tr = gluon.Trainer(dup.collect_params(), "sgd", {"learning_rate": 0.5})
    with autograd.record():
        loss = dup[0](mx.nd.ones((1, 3))).sum()
    loss.backward()
    tr.step(1)
    np.testing.assert_array_equal(seq[0].weight.data().asnumpy(), before)
    assert not np.array_equal(dup[0].weight.data().asnumpy(), before)


def test_a_dropped_model_is_freed_without_a_cycle_collection():
    """Blocks, their parameters and name scopes hold no reference cycle:
    a model is freed (and its device memory with it) when its last
    reference goes, not at the next cycle collection; a deep copy and a
    hybridized block included."""
    import copy
    import gc
    import weakref

    from mxnet_tpu_torch.gluon.model_zoo.nlp import BERTModel

    was = gc.isenabled()
    gc.disable()
    try:
        net = BERTModel(ctx=mx.cpu(), **BERT_CFG)
        net.hybridize()
        dup = copy.deepcopy(net)
        refs = [weakref.ref(net), weakref.ref(dup),
                weakref.ref(net.word_embed.weight.tensor)]
        assert dup.decoder.weight._holders()[0][0] is dup.word_embed
        del net, dup
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()


def test_the_same_body_serves_tensors_and_ndarrays():
    """A block called with torch tensors (as TrainStep and Server call
    it) returns tensors equal bit for bit to what the NDArray call
    returns; autograd records both."""
    net = _seq(nn)
    x = np.random.RandomState(16).randn(3, 4).astype(np.float32)
    t = net(torch.from_numpy(x))
    n = net(mx.nd.array(x))
    assert isinstance(t, torch.Tensor) and isinstance(n, mx.nd.NDArray)
    np.testing.assert_array_equal(t.detach().numpy(), n.asnumpy())
    with autograd.record():
        loss = (net(mx.nd.array(x)) ** 2).sum()
    loss.backward()
    g = [p.grad().asnumpy().copy() for p in net.collect_params().values()
         if p.grad_req != "null"]
    with autograd.record():
        tl = (net(torch.from_numpy(x)) ** 2).sum()
    autograd.backward(tl)
    g2 = [p.grad().asnumpy() for p in net.collect_params().values()
          if p.grad_req != "null"]
    for a, b in zip(g, g2):
        _close(a, b, 1e-6)


# ---------------------------------------------------------------------------
# the ops the layers call, and the activations
# ---------------------------------------------------------------------------

def _op_cases():
    rs = np.random.RandomState(17)
    x4 = rs.randn(2, 6, 3, 3).astype("f4")
    x2 = rs.randn(4, 6).astype("f4")
    g6, b6 = (1 + 0.1 * rs.randn(6)).astype("f4"), rs.randn(6).astype("f4")
    mm, mv = rs.randn(6).astype("f4"), (1 + rs.rand(6)).astype("f4")
    idx = rs.randint(0, 5, (3, 4)).astype("f4")
    table = rs.randn(5, 6).astype("f4")
    return [
        ("LayerNorm", (x2, g6, b6), {"eps": 1e-5}),
        ("BatchNorm", (x4, g6, b6, mm, mv),
         {"eps": 1e-5, "fix_gamma": False, "use_global_stats": True}),
        ("Embedding", (idx, table), {"input_dim": 5, "output_dim": 6}),
        ("InstanceNorm", (x4, g6, b6), {"eps": 1e-5}),
        ("GroupNorm", (x4, g6, b6), {"num_groups": 3}),
        ("LeakyReLU", (x2,), {"act_type": "leaky", "slope": 0.1}),
        ("LeakyReLU", (x4, (0.1 * rs.rand(6)).astype("f4")),
         {"act_type": "prelu"}),
        ("LeakyReLU", (x2,), {"act_type": "elu", "slope": 0.7}),
        ("LeakyReLU", (x2,), {"act_type": "selu"}),
        ("LeakyReLU", (x2,), {"act_type": "gelu"}),
        ("LeakyReLU", (x2,), {"act_type": "rrelu"}),
        ("_contrib_fused_bias_gelu", (x2, b6), {}),
    ]


@pytest.mark.parametrize("case", range(len(_op_cases())))
def test_the_layer_ops_are_in_mx_nd(case):
    """``mx.nd`` has the seven ops the layers call, under the reference's
    names and attributes, each equal to the JAX op on the same inputs."""
    name, args, kw = _op_cases()[case]
    got = getattr(mx.nd, name)(*[mx.nd.array(a) for a in args], **kw)
    want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in args], **kw)
    _close(got.asnumpy(), want.asnumpy(), what=name)


@pytest.mark.parametrize("axis", [None, 1])
def test_arange_like_matches_the_reference(axis):
    """``_contrib_arange_like`` (BERT's valid-length mask) equals the JAX
    op, through ``mx.nd`` and through the tensor ``F``, exactly."""
    from mxnet_tpu_torch.gluon.block import tensor_ops

    x = np.random.RandomState(19).randn(3, 5).astype("f4")
    kw = {"start": 2.0, "step": 0.5, "axis": axis}
    want = jmx.nd._contrib_arange_like(jmx.nd.array(x), **kw).asnumpy()
    np.testing.assert_array_equal(
        mx.nd._contrib_arange_like(mx.nd.array(x), **kw).asnumpy(), want)
    np.testing.assert_array_equal(
        tensor_ops._contrib_arange_like(torch.from_numpy(x), **kw).numpy(),
        want)


def test_split_views_hand_out_views_that_record():
    """``_split_views``: the parts of an NDArray are views of it (they
    share its storage and follow a write to it), equal to the
    reference's ``split``; recorded, their gradients come back as one
    concatenation, as the reference's split's do."""
    x = np.random.RandomState(20).randn(2, 3, 6).astype("f4")
    w = np.random.RandomState(21).randn(2, 3, 6).astype("f4")
    a = mx.nd.array(x)
    parts = mx.nd._split_views(a, num_outputs=3, axis=-1)
    want = jmx.nd.split(jmx.nd.array(x), num_outputs=3, axis=-1)
    for p, q in zip(parts, want):
        np.testing.assert_array_equal(p.asnumpy(), q.asnumpy())
        assert p._data.untyped_storage().data_ptr() == \
            a._data.untyped_storage().data_ptr()
    a[:] = 0
    assert float(np.abs(parts[2].asnumpy()).max()) == 0.0
    pa, ja = mx.nd.array(x), jmx.nd.array(x)
    pa.attach_grad()
    ja.attach_grad()
    with autograd.record():
        ps = mx.nd._split_views(pa, num_outputs=3, axis=-1)
        pl = sum((p * mx.nd.array(w[..., 2 * i:2 * i + 2])).sum()
                 for i, p in enumerate(ps))
    pl.backward()
    with jag.record():
        js = jmx.nd.split(ja, num_outputs=3, axis=-1)
        jl = sum((p * jmx.nd.array(w[..., 2 * i:2 * i + 2])).sum()
                 for i, p in enumerate(js))
    jl.backward()
    _close(pa.grad.asnumpy(), ja.grad.asnumpy(), 1e-6)


@pytest.mark.parametrize("name,args", [
    ("Activation", ("softrelu",)), ("LeakyReLU", (0.2,)), ("PReLU", ()),
    ("ELU", (0.5,)), ("SELU", ()), ("GELU", ()), ("Swish", (1.5,)),
    ("SiLU", ())])
def test_activation_blocks(name, args):
    x = np.random.RandomState(18).randn(3, 5).astype("f4")
    jb, pb = getattr(jnn, name)(*args), getattr(nn, name)(*args)
    jb.initialize()
    pb.initialize()
    _close(pb(mx.nd.array(x)).asnumpy(), jb(jmx.nd.array(x)).asnumpy())


def test_norm_and_embedding_layers():
    rs = np.random.RandomState(19)
    x = rs.randn(2, 4, 3, 3).astype("f4")
    for make in (lambda m: m.InstanceNorm(), lambda m: m.GroupNorm(2),
                 lambda m: m.LayerNorm(), lambda m: m.Flatten(),
                 lambda m: m.Identity(),
                 lambda m: m.HybridLambda(lambda F, v: F.relu(v) * 2)):
        jb, pb = make(jnn), make(nn)
        for b in (jb, pb):
            b.initialize()
        _close(pb(mx.nd.array(x)).asnumpy(), jb(jmx.nd.array(x)).asnumpy())
    idx = rs.randint(0, 7, (2, 5)).astype("f4")
    je, pe = jnn.Embedding(7, 3), nn.Embedding(7, 3)
    for b in (je, pe):
        b.initialize()
    _copy_weights(je, pe)
    _close(pe(mx.nd.array(idx)).asnumpy(), je(jmx.nd.array(idx)).asnumpy())


# ---------------------------------------------------------------------------
# gluon.utils
# ---------------------------------------------------------------------------

def test_gluon_utils(tmp_path):
    from mxnet_tpu_torch.gluon import utils

    x = mx.nd.array(np.arange(10, dtype=np.float32).reshape(5, 2))
    parts = utils.split_data(x, 2, even_split=False)
    jparts = jgluon.utils.split_data(jmx.nd.array(x.asnumpy()), 2,
                                     even_split=False)
    assert [p.shape for p in parts] == [p.shape for p in jparts]
    with pytest.raises(mx.MXNetError, match="evenly"):
        utils.split_data(x, 2)
    loaded = utils.split_and_load(x.asnumpy(), [mx.cpu()])
    np.testing.assert_array_equal(loaded[0].asnumpy(), x.asnumpy())
    a = mx.nd.array(np.full((3,), 3.0, np.float32))
    b = mx.nd.array(np.full((4,), 4.0, np.float32))
    norm = utils.clip_global_norm([a, b], 1.0)
    want = float(np.sqrt(9 * 3 + 16 * 4))
    assert abs(norm - want) < 1e-5
    total = np.sqrt((a.asnumpy() ** 2).sum() + (b.asnumpy() ** 2).sum())
    assert abs(total - 1.0) < 1e-5
    path = tmp_path / "f.bin"
    path.write_bytes(b"mxnet")
    assert utils.check_sha1(str(path), hashlib.sha1(b"mxnet").hexdigest())
    assert not utils.check_sha1(str(path), "0" * 40)
    with pytest.raises(mx.MXNetError, match="network"):
        utils.download("http://localhost/none")


def test_port_gluon_imports_neither_jax_nor_the_jax_package():
    import subprocess
    import sys

    code = ("import sys, mxnet_tpu_torch\n"
            "from mxnet_tpu_torch.gluon import nn, loss, utils\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# a served Llama request with a token id out of the vocabulary
# ---------------------------------------------------------------------------

def test_llama_server_survives_a_token_id_out_of_the_vocabulary():
    """The decode step gathers embeddings as ``jnp.take`` does (NaN rows
    for an id outside the table, no device-side assert on the card,
    where ``F.embedding`` would leave the CUDA context unusable): the bad
    request returns its tokens and the server answers the next request
    as a fresh server does (the plain paged attention reads a freed
    page's stale NaN slots as zeros, as the kernel's zero-filled
    copies)."""
    from mxnet_tpu_torch.gluon.model_zoo.nlp import llama_tiny
    from mxnet_tpu_torch.serving import Server

    mx.random.seed(3)
    net = llama_tiny(ctx=mx.cpu())
    vocab = net.embed.weight.shape[0]
    kw = dict(batch_buckets=(1, 2), slo_ms=50.0, dtype="float32",
              decode_pages=16, page_size=4, len_buckets=(8, 16))
    good = np.array([5, 9, 2, 7, 1], np.int32)
    bad = np.array([3, vocab + 5, 4], np.int32)
    with Server(net, ctx=mx.cpu(), **kw) as srv:
        want = srv.submit_generate(good, 6).result(timeout=60)
    with Server(net, ctx=mx.cpu(), **kw) as srv:
        out = srv.submit_generate(bad, 5).result(timeout=60)
        assert out.dtype == np.int32 and len(out) == 5
        got = srv.submit_generate(good, 6).result(timeout=60)
        assert srv.stats()["errors"] == 0
    np.testing.assert_array_equal(got, want)
