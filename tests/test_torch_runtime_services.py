"""The port's ``mx.monitor``, ``mx.storage``, ``mx.runtime`` and
``mx.test_utils`` on the CPU, against the JAX package's where both answer.

* ``Monitor`` over a Gluon block's forward hook: on one two-layer net
  (FullyConnected, ReLU, FullyConnected) with the same weights and input,
  forward and backward, its ``(step, name, stat)`` triples are the
  reference executor monitor's, in the same order, the statistics equal
  (weights and input bit for bit, outputs and gradients within float32
  rounding); ``pattern``, ``sort``, ``interval`` and ``toc_print``.
* ``storage`` on the CPU gives the reference's answers for a platform
  without stats; ``runtime.Features`` carries MXNet's feature names,
  probed (no card here: CUDA, CUDNN, NCCL, CUDA_RTC and NVJPEG off).
* ``test_utils``: the reference's own cases (located mismatches,
  dtype-scaled tolerances, the numeric gradient catching a wrong
  backward, consistency across contexts, the rand helpers), over NDArrays
  and tensors.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import monitor as jmon
from mxnet_tpu import runtime as jrt
from mxnet_tpu import storage as jstorage
from mxnet_tpu import symbol as sym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import monitor, runtime, storage
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.gluon import nn


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(8, 5).astype(np.float32),
            "fc1_bias": rs.randn(8).astype(np.float32),
            "fc2_weight": rs.randn(4, 8).astype(np.float32),
            "fc2_bias": rs.randn(4).astype(np.float32)}


def _reference_triples(x, w, **mon_kw):
    data = sym.var("data")
    net = sym.FullyConnected(data, name="fc1", num_hidden=8)
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, name="fc2", num_hidden=4)
    exe = net.simple_bind(ctx=jmx.cpu(), data=x.shape)
    for k, v in w.items():
        exe.arg_dict[k][:] = jmx.nd.array(v)
    mon = jmon.Monitor(**mon_kw)
    mon.install(exe)
    mon.tic()
    exe.forward(is_train=True, data=jmx.nd.array(x))
    exe.backward([jmx.nd.ones((x.shape[0], 4))])
    return mon.toc()


def _port_net(w):
    net = nn.HybridSequential(prefix="")
    with net.name_scope():
        net.add(nn.Dense(8, in_units=5, activation="relu", prefix="fc1_"),
                nn.Dense(4, in_units=8, prefix="fc2_"))
    net.initialize(ctx=mx.cpu())
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(w[k], ctx=mx.cpu()))
    return net


def _port_triples(x, w, **mon_kw):
    net = _port_net(w)
    mon = monitor.Monitor(**mon_kw)
    mon.install(net)
    mon.tic()
    xd = mx.nd.array(x, ctx=mx.cpu())
    xd.attach_grad()
    with mx.autograd.record():
        out = net(xd)
    out.backward(mx.nd.ones(out.shape, ctx=mx.cpu()))
    return mon.toc()


def test_monitor_matches_the_reference_on_a_two_layer_net():
    x = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    w = _weights()
    ref = _reference_triples(x, w, interval=1)
    got = _port_triples(x, w, interval=1)
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in ref]
    for (_, name, a), (_, _, b) in zip(got, ref):
        if name.endswith("_grad") or name.startswith("output"):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=name)
        else:
            assert a == b, name


def test_monitor_pattern_sort_interval_and_print(caplog):
    x = np.random.RandomState(2).randn(2, 5).astype(np.float32)
    w = _weights(3)
    ref = _reference_triples(x, w, interval=1, pattern=".*fc2.*|output.*",
                             sort=True)
    got = _port_triples(x, w, interval=1, pattern=".*fc2.*|output.*",
                        sort=True)
    assert [n for _, n, _ in got] == [n for _, n, _ in ref] == [
        "fc2_bias", "fc2_bias_grad", "fc2_weight", "fc2_weight_grad",
        "output0"]
    net = _port_net(w)
    mon = monitor.Monitor(interval=2, stat_func=lambda a: float(a.max()))
    mon.install(net)
    mon.install(net)                       # once only
    seen = []
    for _ in range(4):
        mon.tic()
        net(mx.nd.array(x, ctx=mx.cpu()))
        seen.append(len(mon.toc()))
    # data, four weights, their four gradient buffers, output0
    assert seen[1] == seen[3] == 0 and seen[0] == seen[2] == 10
    mon.tic()
    net(mx.nd.array(x, ctx=mx.cpu()))
    with caplog.at_level(logging.INFO):
        mon.toc_print()
    assert any("fc1_weight" in r.getMessage() for r in caplog.records)


def test_storage_on_the_cpu_gives_the_reference_answers():
    cpu = mx.cpu()
    assert storage.memory_info(cpu) == jstorage.memory_info(jmx.cpu())
    ours, theirs = storage.pool_stats(cpu), jstorage.pool_stats(jmx.cpu())
    assert set(ours) == set(theirs)
    assert ours == {k: 0 for k in theirs}
    storage.empty_cache(cpu)
    with cpu:
        assert storage.memory_info() == (0, 0)


def test_runtime_features_use_mxnets_names():
    f = runtime.Features()
    assert f.is_enabled("CPU") and f.is_enabled("bf16")
    for name in ("CUDA", "CUDNN", "NCCL", "CUDA_RTC", "NVJPEG"):
        assert f.is_enabled(name) == (torch.cuda.is_available()
                                      and f[name].enabled)
    assert not f.is_enabled("CUDA") or torch.cuda.is_available()
    assert not f.is_enabled("OPENCV") and not f.is_enabled("TENSORRT")
    assert f.is_enabled("IMAGE_CODECS")             # Pillow, the CPU codec
    with pytest.raises(RuntimeError, match="unknown feature"):
        f.is_enabled("WARP_DRIVE")
    names = {x.name for x in runtime.feature_list()}
    assert {"CUDA", "CUDNN", "NCCL", "CUDA_RTC", "NVJPEG", "PROFILER"} \
        <= names
    assert not {"TPU", "PALLAS", "X64"} & names
    shared = names & {x.name for x in jrt.feature_list()}
    assert {"CPU", "BF16", "IMAGE_CODECS", "NATIVE_RECORDIO"} <= shared
    assert "CUDA" in repr(f)


def test_assert_almost_equal_locates_and_scales():
    a = np.zeros((3, 4), "float32")
    b = a.copy()
    tu.assert_almost_equal(a, b)
    b[1, 2] = 1.0
    with pytest.raises(AssertionError, match=r"\(1, 2\)"):
        tu.assert_almost_equal(torch.from_numpy(a), mx.nd.array(
            b, ctx=mx.cpu()))
    x = mx.nd.array(np.ones(4), ctx=mx.cpu()).astype("bfloat16")
    y = mx.nd.array([1.004, 1.0, 1.0, 1.0], ctx=mx.cpu()).astype("bfloat16")
    tu.assert_almost_equal(x, y)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(np.ones(4, "float64"),
                               np.ones(4, "float64") + 1e-4)
    assert tu.almost_equal(torch.ones(3), np.ones(3))
    assert tu.same(torch.arange(3), np.arange(3))
    assert tu.effective_dtype(torch.ones(1, dtype=torch.bfloat16)) == \
        np.float16


def test_numeric_gradient_passes_and_catches_a_wrong_backward():
    tu.check_numeric_gradient(
        lambda x, y: (x * y + (x ** 2)).sum(),
        [np.random.RandomState(0).randn(3, 2),
         torch.from_numpy(np.random.RandomState(1).randn(3, 2))])
    seen = []

    def on(x):
        seen.append(x.context)
        return (x * x).sum()

    with mx.cpu(1):                    # the default is default_context()
        tu.check_numeric_gradient(on, [np.array([1.0, -2.0])])
    assert set(seen) == {mx.cpu(1)}

    class Bad(mx.autograd.Function):
        def forward(self, x):
            return x * x

        def backward(self, dy):
            return dy                  # wrong: should be 2x*dy

    with pytest.raises(AssertionError):
        tu.check_numeric_gradient(lambda x: Bad()(x).sum(),
                                  [np.array([1.0, 2.0])])


def test_consistency_and_rand_helpers():
    res = tu.check_consistency(
        lambda x: mx.nd.softmax(x),
        [np.random.RandomState(2).randn(4, 5).astype("float32")],
        ctx_list=[mx.cpu(0), mx.cpu(1)])
    assert len(res) == 2
    assert len(tu.check_consistency(lambda x: x * 2, [np.ones(3)])) == \
        1 + torch.cuda.is_available()
    np.random.seed(0)
    assert len(tu.rand_shape_nd(4, 6)) == 4
    with mx.cpu():
        arr = tu.rand_ndarray((2, 3))
        assert tu.default_context() == mx.cpu()
    assert arr.shape == (2, 3) and arr.context == mx.cpu()
    assert tu.default_context() == (mx.gpu(0) if torch.cuda.is_available()
                                    else mx.cpu(0))
