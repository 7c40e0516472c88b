"""ResNet v2 of the port (``resnet18_v2`` ... ``resnet152_v2``) against the
JAX package's on the CPU: the structure's names, the forward with the
reference's weights carried across by ``resnet_params_from_reference``
in NCHW and NHWC, and three f32 NAG ``TrainStep`` steps (GluonCV's
ImageNet optimizer) against the JAX ``TrainStep``.

Weights and running statistics are drawn with numpy ``RandomState`` and
handed to both packages (tests/test_torch_resnet_train.py's
``_jax_resnet``). The forward agrees to 1e-4 of the logits' largest
magnitude (f32 sums in other orders through 18 or 50 layers); the
training steps at the tolerances of the v1 TrainStep test, with its
ReLU-kink premise checked first (a ReLU input within f32 rounding of 0
flips between two correct implementations and moves every upstream
gradient far past f32 noise).
"""
import re

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import resnet_params_from_reference
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
from mxnet_tpu_torch.parallel import TrainStep

import test_torch_resnet_train as rt

# resnet50_v2 with one bottleneck a stage: the published widths, the
# depth cut to keep the CPU test small
CUT50 = ([1, 1, 1, 1], [64, 256, 512, 1024, 2048])


def _jax_cut50(layout="NCHW", **kw):
    return jresnet.ResNetV2(jresnet.BottleneckV2, *CUT50, layout=layout,
                            **kw)


def _port_cut50(named, layout="NCHW", **kw):
    net = pvision.ResNetV2(pvision.BottleneckV2, *CUT50, layout=layout,
                           ctx=mx.cpu(), **kw)
    net.load_state_dict(resnet_params_from_reference(named))
    return net


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("which", ["resnet18_v2", "resnet50_v2_cut",
                                   "resnet18_v2_thumbnail"])
def test_forward_matches_the_reference(which, layout):
    size, kw = (32, {"classes": 10})
    if which == "resnet18_v2":
        jnet, named = rt._jax_resnet(jvision.resnet18_v2, size, 11, layout,
                                     **kw)
        net = rt._port_resnet("resnet18_v2", named, layout, **kw)
    elif which == "resnet18_v2_thumbnail":
        kw = dict(kw, thumbnail=True)
        jnet, named = rt._jax_resnet(jvision.resnet18_v2, size, 12, layout,
                                     **kw)
        net = rt._port_resnet("resnet18_v2", named, layout, **kw)
    else:
        jnet, named = rt._jax_resnet(
            lambda **k: _jax_cut50(**k), size, 13, layout, **kw)
        net = _port_cut50(named, layout, **kw)
    x = np.random.RandomState(5).randn(2, 3, size, size).astype(np.float32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 10)
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * top
    # NDArrays in, NDArrays out, the same numbers
    with mx.cpu():
        nd_out = net(mx.nd.array(x))
    np.testing.assert_array_equal(nd_out.asnumpy(), got)


def _canon(names):
    """The names without the model's own prefix, each layer counter
    (``conv2d7``, ``dense0``) replaced by its rank among the model's
    layers of that kind: both packages count layers process-wide, so
    the numbers depend on what the process built before."""
    seen = {}

    def rank(m):
        key = (m.group(1), m.group(2))
        kind = seen.setdefault(m.group(1), {})
        return f"{m.group(1)}#{kind.setdefault(key, len(kind))}"

    return [re.sub(r"(conv2d|batchnorm|dense)(\d+)", rank,
                   n[n.index("_") + 1:]) for n in names]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", ["resnet18_v2", "resnet34_v2",
                                  "resnet50_v2", "resnet101_v2"])
def test_collect_params_names_equal_the_reference(name, layout):
    """Every parameter name (after the model's own counter prefix, the
    layer counters by rank, :func:`_canon`), in order, and every
    structural name; the data BatchNorm has no trained
    scale or shift; the converter maps the reference's names onto the
    port's ``state_dict`` exactly."""
    jnet = getattr(jvision, name)(classes=10, layout=layout)
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 3, 32, 32)))
    net = getattr(pvision, name)(classes=10, layout=layout, ctx=mx.cpu())
    assert _canon(jnet.collect_params()) == _canon(net.collect_params())
    assert sorted(jnet._collect_params_with_prefix()) == \
        sorted(net._collect_params_with_prefix())
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    assert set(resnet_params_from_reference(named)) == set(net.state_dict())
    data_bn = net.features[0]
    assert data_bn.gamma.grad_req == data_bn.beta.grad_req == "null"
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == sum(
        int(np.prod(p.shape)) for n, p in jnet.collect_params().items()
        if p.grad_req != "null")


def test_resnet152_v2_and_get_resnet():
    net = pvision.get_resnet(2, 152, classes=7, ctx=mx.cpu())
    assert isinstance(net, pvision.ResNetV2)
    assert isinstance(net.features[5][0], pvision.BottleneckV2)
    assert len(net.features[7]) == 36
    net18 = pvision.resnet18_v2(classes=7, ctx=mx.cpu())
    assert isinstance(net18.features[5][0], pvision.BasicBlockV2)
    with torch.no_grad():
        assert net18(torch.zeros(1, 3, 32, 32)).shape == (1, 7)


NAG = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 1e-4}
# v2 normalises its input by the batch statistics of 4 images before the
# stem, and its residual stream runs from block to block with no ReLU to
# cut it, so f32 rounding carries further than in v1: measured 1.4e-5
# relative in the loss at step 3 and 2.0e-5 in a stage-3 running
# variance, against the v1 test's 1e-5 limits
LOSS_RTOL = 3e-5
STATS_TOL = 5e-5


def test_trainstep_nag_matches_the_jax_trainstep():
    """Three f32 NAG steps (momentum 0.9, wd 1e-4) of
    ``resnet18_v2(classes=10)`` at 32x32 on a batch of 4, from the same
    weights, against the JAX ``TrainStep``: each step's loss to
    ``LOSS_RTOL``, the running statistics to ``STATS_TOL``, each
    parameter's delta to
    1e-3 of its norm, the ReLU decisions of both steps the same (the
    premise: weights 51 and batch 52 were picked among seeds whose three
    steps put no ReLU input within f32 rounding of 0; 21/22, 31/32 and
    41/42 each put one there, and the check names it). NAG has no sweep:
    every parameter takes the per-parameter update, and no fused sweep
    runs."""
    jnet, named = rt._jax_resnet(jvision.resnet18_v2, 32, 51, classes=10)
    net = rt._port_resnet("resnet18_v2", named, classes=10)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), "nag",
                     optimizer_params=dict(NAG))
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(), "nag",
                           mesh=mesh, optimizer_params=dict(NAG))
    x, y = rt._batch(4, 32, seed=52)
    start = resnet_params_from_reference(named)
    with rt._KinkDecisions() as kinks:
        for k in range(3):
            jl = float(jstep(jmx.nd.array(x), jmx.nd.array(y))[0].asnumpy())
            loss, _ = step(x, y)
            flips = kinks.disagreements()
            assert not flips, (f"step {k + 1}: the port and JAX decide a "
                               "kink differently; the seeds are ill-posed "
                               "for this comparison: " + "; ".join(flips))
            np.testing.assert_allclose(float(loss), jl, rtol=LOSS_RTOL)
            jstats = rt._stats({n: p.data().asnumpy()
                                for n, p in jnet.collect_params().items()})
            for key, v in rt._stats(net).items():
                np.testing.assert_allclose(v, jstats[key], rtol=STATS_TOL,
                                           atol=STATS_TOL, err_msg=key)
    assert not step._buckets and len(step._per_param) == len(step._params)
    moved = resnet_params_from_reference(
        {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    got = net.state_dict()
    for key, _ in net.named_parameters():
        dj = moved[key].numpy() - start[key].numpy()
        dp = got[key].numpy() - start[key].numpy()
        ratio = float(np.linalg.norm(dp - dj)) / float(np.linalg.norm(dj))
        assert ratio < 1e-3, (key, ratio)
