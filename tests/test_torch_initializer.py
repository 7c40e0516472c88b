"""The port's initializers (``mx.init``) against the JAX package's, on
the CPU.

The deterministic ones (``Zero``, ``One``, ``Constant``, ``Bilinear``,
``LSTMBias``, ``Load``, ``Mixed`` and the name-pattern dispatch) are held
bit for bit. The random ones draw from the port's own streams, not the
reference's (ROADMAP.md, port queue 3), so they are held to their
distributions: ``Xavier`` (every ``rnd_type`` x ``factor_type``) and
``MSRAPrelu`` against the reference's scale formula from the fans,
``Normal``/``Uniform`` by moments and bounds, ``Orthogonal`` by
``Q^T Q = scale^2 I``. The moment tolerances are 5 standard errors of the
estimate at the sample sizes used.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import initializer as pinit


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _port(init, name, shape):
    arr = mx.nd.zeros(shape)
    init(pinit.InitDesc(name), arr)
    return arr.asnumpy()


def _jax(init, name, shape):
    arr = jmx.nd.zeros(shape)
    init(jmx.initializer.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("make,name,shape", [
    (lambda m: m.init.Zero(), "w_weight", (3, 4)),
    (lambda m: m.init.One(), "w_weight", (3, 4)),
    (lambda m: m.init.Constant(0.25), "w_weight", (3, 4)),
    (lambda m: m.init.Constant(np.arange(4, dtype=np.float32)), "w_weight",
     (3, 4)),
    (lambda m: m.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
    (lambda m: m.init.Bilinear(), "up_weight", (1, 1, 3, 5)),
    (lambda m: m.init.LSTMBias(2.0), "lstm_i2h_bias", (16,)),
    (lambda m: m.init.Uniform(), "fc_bias", (5,)),
    (lambda m: m.init.Normal(), "bn_gamma", (5,)),
    (lambda m: m.init.Xavier(), "bn_beta", (5,)),
    (lambda m: m.init.Xavier(), "bn_running_mean", (5,)),
    (lambda m: m.init.Xavier(), "bn_running_var", (5,)),
    (lambda m: m.init.Xavier(), "bn_moving_var", (5,)),
])
def test_deterministic_initializers_bit_for_bit(make, name, shape):
    got = _port(make(mx), name, shape)
    want = _jax(make(jmx), name, shape)
    np.testing.assert_array_equal(got, want)


def test_load_and_mixed_bit_for_bit(tmp_path):
    rs = np.random.RandomState(0)
    saved = {"fc_weight": rs.randn(3, 4).astype(np.float32),
             "fc_bias": rs.randn(3).astype(np.float32)}
    path = str(tmp_path / "init.params")
    mx.nd.save(path, {k: mx.nd.array(v) for k, v in saved.items()})
    for m in (mx, jmx):
        ld = m.init.Load(path, default_init=m.init.One())
        got = {}
        for name, shape in (("fc_weight", (3, 4)), ("fc_bias", (3,)),
                            ("other_weight", (2,))):
            arr = m.nd.zeros(shape)
            ld(m.initializer.InitDesc(name), arr)
            got[name] = arr.asnumpy()
        np.testing.assert_array_equal(got["fc_weight"], saved["fc_weight"])
        np.testing.assert_array_equal(got["fc_bias"], saved["fc_bias"])
        np.testing.assert_array_equal(got["other_weight"], np.ones(2))
        with pytest.raises(ValueError, match="shape"):
            ld(m.initializer.InitDesc("fc_bias"), m.nd.zeros((4,)))
    mixes = [m.init.Mixed([".*bias", ".*"], [m.init.Constant(3.0),
                                              m.init.One()])
             for m in (mx, jmx)]
    np.testing.assert_array_equal(_port(mixes[0], "x_bias", (4,)),
                                  _jax(mixes[1], "x_bias", (4,)))
    np.testing.assert_array_equal(_port(mixes[0], "x_weight", (4,)),
                                  np.ones(4))
    strict = mx.init.Mixed(["a.*"], [mx.init.One()])
    with pytest.raises(mx.MXNetError, match="did not match"):
        strict(pinit.InitDesc("b_weight"), mx.nd.zeros((2,)))


def _fans(shape):
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    return shape[1] * hw, shape[0] * hw


@pytest.mark.parametrize("rnd_type", ["uniform", "gaussian"])
@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
@pytest.mark.parametrize("shape", [(256, 384), (64, 32, 3, 3)])
def test_xavier_scale_from_the_fans(rnd_type, factor_type, shape):
    """Every rnd_type x factor_type: the draws' spread is the reference's
    ``sqrt(magnitude / factor)``, the factor from the fans."""
    fan_in, fan_out = _fans(shape)
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = math.sqrt(3.0 / factor)
    w = _port(mx.init.Xavier(rnd_type, factor_type, 3), "conv_weight",
              shape).ravel()
    n = w.size
    if rnd_type == "uniform":
        assert np.abs(w).max() <= scale
        assert np.abs(w).max() > 0.99 * scale
        sd = scale / math.sqrt(3)
    else:
        sd = scale
    assert abs(w.mean()) < 5 * sd / math.sqrt(n)
    assert abs(w.std() / sd - 1) < 5 / math.sqrt(2 * n)
    jw = _jax(jmx.init.Xavier(rnd_type, factor_type, 3), "conv_weight",
              shape).ravel()
    assert abs(w.std() / jw.std() - 1) < 10 / math.sqrt(2 * n)
    with pytest.raises(mx.MXNetError, match="ndim"):
        _port(mx.init.Xavier(), "v_weight", (5,))


@pytest.mark.parametrize("factor_type", ["avg", "in", "out"])
def test_msra_prelu_scale(factor_type):
    shape = (128, 64, 3, 3)
    fan_in, fan_out = _fans(shape)
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    slope = 0.25
    sd = math.sqrt(2.0 / (1 + slope ** 2) / factor)
    w = _port(mx.init.MSRAPrelu(factor_type, slope), "c_weight",
              shape).ravel()
    assert abs(w.std() / sd - 1) < 5 / math.sqrt(2 * w.size)
    assert mx.init.MSRAPrelu(factor_type)._kwargs == \
        jmx.init.MSRAPrelu(factor_type)._kwargs


def test_normal_and_uniform_moments_and_bounds():
    w = _port(mx.init.Normal(0.02), "e_weight", (512, 256)).ravel()
    n = w.size
    assert abs(w.mean()) < 5 * 0.02 / math.sqrt(n)
    assert abs(w.std() / 0.02 - 1) < 5 / math.sqrt(2 * n)
    u = _port(mx.init.Uniform(0.07), "e_weight", (512, 256)).ravel()
    assert u.min() >= -0.07 and u.max() < 0.07
    assert abs(u.mean()) < 5 * 0.07 / math.sqrt(3 * n)
    assert abs(u.std() / (0.07 / math.sqrt(3)) - 1) < 5 / math.sqrt(2 * n)


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(8, 32), (32, 8), (6, 2, 2, 2)])
def test_orthogonal_rows_or_columns(rand_type, shape):
    w = _port(mx.init.Orthogonal(1.5, rand_type), "o_weight",
              shape).astype(np.float64).reshape(shape[0], -1)
    small = min(w.shape)
    gram = w @ w.T if w.shape[0] == small else w.T @ w
    np.testing.assert_allclose(gram, 1.5 ** 2 * np.eye(small), atol=1e-5)


def test_draws_follow_the_seed_and_a_generator_scope():
    """``mx.random.seed`` fixes the draws; a generator scope draws from
    its generator; neither moves a device's dropout seed stream."""
    from mxnet_tpu_torch import random_state

    mx.random.seed(7)
    a = _port(mx.init.Normal(1.0), "w_weight", (64,))
    with random_state.preserved_stream():
        drop = random_state.next_seed(mx.cpu())
    mx.random.seed(7)
    with random_state.preserved_stream():
        assert random_state.next_seed(mx.cpu()) == drop
    b = _port(mx.init.Normal(1.0), "w_weight", (64,))
    np.testing.assert_array_equal(a, b)
    c = _port(mx.init.Normal(1.0), "w_weight", (64,))
    assert not np.array_equal(b, c)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    with pinit.generator_scope(g1):
        d = _port(mx.init.Normal(1.0), "w_weight", (64,))
    with pinit.generator_scope(g2):
        e = _port(mx.init.Normal(1.0), "w_weight", (64,))
    np.testing.assert_array_equal(d, e)


def test_registry_dumps_and_init_attr():
    assert isinstance(mx.init.create("xavier", magnitude=2), mx.init.Xavier)
    assert isinstance(mx.init.create(None), mx.init.Uniform)
    with pytest.raises(mx.MXNetError, match="unknown initializer"):
        mx.init.create("nosuch")
    x = mx.init.Xavier("gaussian", "in", 2)
    assert x.dumps() == jmx.init.Xavier("gaussian", "in", 2).dumps()

    @mx.init.register
    class Fives(mx.init.Initializer):
        def _init_weight(self, name, arr):
            arr[:] = 5.0

    assert isinstance(mx.init.create("fives"), Fives)
    # a name's __init__ attribute chooses the initializer
    desc = pinit.InitDesc("odd_name", attrs={"__init__": mx.init.One().dumps()})
    arr = mx.nd.zeros((3,))
    mx.init.Zero()(desc, arr)
    np.testing.assert_array_equal(arr.asnumpy(), np.ones(3))


def test_initializers_reach_blocks_by_name_pattern():
    """``initialize(init)`` applies ``init`` to the weights and the
    pattern defaults to the rest; a parameter's own ``init`` wins."""
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(nn.Dense(4, in_units=3, prefix="d0_"),
                nn.BatchNorm(in_channels=4, prefix="bn_"),
                nn.Dense(2, in_units=4, weight_initializer=mx.init.One(),
                         prefix="d1_"))
    net.initialize(mx.init.Constant(0.5))
    p = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    np.testing.assert_array_equal(p["net_d0_weight"], np.full((4, 3), 0.5))
    np.testing.assert_array_equal(p["net_d0_bias"], np.zeros(4))
    np.testing.assert_array_equal(p["net_bn_gamma"], np.ones(4))
    np.testing.assert_array_equal(p["net_bn_running_var"], np.ones(4))
    np.testing.assert_array_equal(p["net_d1_weight"], np.ones((2, 4)))
