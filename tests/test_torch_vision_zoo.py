"""The port's vision model zoo against the JAX package's on the CPU:
MobileNet v1/v2/v3, SqueezeNet, VGG, AlexNet, DenseNet and Inception v3
at the reference's own test sizes (``tests/test_model_zoo.py``:
``classes=10``, 64x64; AlexNet and DenseNet-121 at 224 and Inception v3
at 299 with a batch of 1), the weights drawn with numpy on the JAX side
and carried to the port by a ``.params`` file; the port's NHWC build
against its NCHW build from the same file; the hybridized forward
against the eager one; ``get_model`` over every name of the reference's
``_models``; and one ``TrainStep`` SGD step of ``mobilenet_v2_0_25``
against the JAX ``TrainStep``.

Forwards agree to 1e-4 of the logits' largest magnitude (f32 sums in
other orders through up to 120 layers); NHWC against NCHW to the same.
The training step: the loss to 1e-5 relative, each parameter's delta to
1e-3 of its norm, BatchNorm's running statistics to 1e-5.
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

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
from mxnet_tpu_torch.parallel import TrainStep

# name -> (input size, batch), the reference's test sizes
FAMILIES = {
    "mobilenet0.25": (64, 2),
    "mobilenetv2_0.25": (64, 2),
    "mobilenetv3_small": (64, 2),
    "squeezenet1.1": (64, 2),
    "vgg11": (64, 2),
    "alexnet": (224, 1),
    "densenet121": (224, 1),
    "inceptionv3": (299, 1),
}


def _draw(net, seed):
    """Numpy weights for every parameter of a JAX net: gammas near 1,
    positive variances, small betas, means and biases, He-scaled
    convolution and Dense weights."""
    rs = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        s = p.shape
        if name.endswith("gamma"):
            a = 1.0 + 0.1 * rs.randn(*s)
        elif name.endswith("running_var"):
            a = 1.0 + 0.5 * rs.rand(*s)
        elif name.endswith(("beta", "running_mean", "bias")):
            a = 0.1 * rs.randn(*s)
        else:
            a = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        p.set_data(jmx.nd.array(a.astype(np.float32)))


def _jax_net(name, size, seed, path, batch=1, **kw):
    """The reference's model with numpy weights, saved to ``path``; its
    shapes settled by an eager forward at ``batch``, which compiles
    each op for the test's own shapes."""
    net = jvision.get_model(name, classes=10, **kw)
    net.initialize()
    net(jmx.nd.zeros((batch, 3, size, size)))
    _draw(net, seed)
    net.save_parameters(str(path))
    return net


def _port_net(name, path, layout="NCHW", **kw):
    net = pvision.get_model(name, classes=10, layout=layout, ctx=mx.cpu(),
                            **kw)
    net.load_parameters(str(path), ctx=mx.cpu())
    return net


def _close_to_max(got, want, rtol, what):
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape and err <= rtol * top, (what, err, top)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_the_reference_in_both_layouts(name, tmp_path):
    """Each family's forward, the reference's weights crossing by
    ``.params``: NCHW against the reference, NHWC against NCHW, the
    hybridized call against the eager one bit for bit, NDArrays in and
    out."""
    size, batch = FAMILIES[name]
    path = tmp_path / "w.params"
    jnet = _jax_net(name, size, 20 + len(name), path, batch)
    x = np.random.RandomState(5).rand(batch, 3, size, size) \
        .astype(np.float32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    net = _port_net(name, path)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    _close_to_max(got, want, 1e-4, name)
    nhwc = _port_net(name, path, layout="NHWC")
    with torch.no_grad():
        got_last = nhwc(torch.from_numpy(x)).numpy()
    _close_to_max(got_last, got, 1e-4, name + " NHWC")
    with mx.cpu():
        eager = nhwc(mx.nd.array(x)).asnumpy()
        nhwc.hybridize()
        hyb = nhwc(mx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(hyb, eager)
    _close_to_max(eager, got_last, 1e-6, name + " NDArray")


def _canon(names):
    """The names without the model's own prefix, each layer counter
    replaced by its rank among the model's layers of that kind (both
    packages count layers process-wide)."""
    seen = {}

    def rank(m):
        kind = seen.setdefault(m.group(1), {})
        return f"{m.group(1)}#{kind.setdefault(m.group(0), len(kind))}"

    return [re.sub(r"([a-z_]+?)(\d+)(?=_)", rank, n[n.index("_") + 1:])
            for n in names]


@pytest.mark.parametrize("name", ["mobilenet1.0", "mobilenetv2_1.0",
                                  "mobilenetv3_large", "squeezenet1.0",
                                  "vgg16_bn", "densenet169", "inceptionv3"])
def test_structure_and_names_equal_the_references(name):
    """The published widths and depths: every structural (``.params``)
    name and every shape the reference knows before a forward (its
    deferred axes are 0), and every prefixed parameter name (layer
    counters by rank), equal the reference's."""
    jnet = jvision.get_model(name)
    net = pvision.get_model(name, ctx=mx.cpu())
    with torch.no_grad():
        net(torch.zeros(1, 3, 299 if name == "inceptionv3" else 224,
                        299 if name == "inceptionv3" else 224))
    jshapes = {k: tuple(p.shape)
               for k, p in jnet._collect_params_with_prefix().items()}
    shapes = {k: tuple(p.shape)
              for k, p in net._collect_params_with_prefix().items()}
    assert sorted(shapes) == sorted(jshapes)
    for k, js in jshapes.items():
        assert len(js) == len(shapes[k]) and all(
            a in (0, b) for a, b in zip(js, shapes[k])), (k, js, shapes[k])
    assert _canon(net.collect_params()) == _canon(jnet.collect_params())
    if name == "mobilenetv2_1.0":
        # Sandler et al.'s 3.47M weights (BatchNorm's running statistics
        # are not trained)
        n = sum(p.numel() for p in net.parameters())
        assert 3_400_000 < n < 3_600_000, n


def test_get_model_covers_every_reference_name():
    assert set(pvision._models) == set(jvision._models)
    for name in sorted(pvision._models):
        if name == "ssd_toy":
            net = pvision.get_model(name, num_classes=3)
            assert isinstance(net, pvision.SSD) and net.num_classes == 3
            continue
        net = pvision.get_model(name.upper() if name == "alexnet" else name,
                                classes=7)
        assert isinstance(net, torch.nn.Module)
    with pytest.raises(MXNetError, match="not supported"):
        pvision.get_model("resnet999")
    public = {n for n in dir(jvision) if not n.startswith("_")
              and callable(getattr(jvision, n))}
    assert public - set(pvision.__all__) <= {"get_resnet",
                                             "get_model"} | {
        n for n in public if n[0].isupper() and n not in pvision.__all__
        and not hasattr(pvision, n)} - {"VGG", "AlexNet", "DenseNet",
                                        "SqueezeNet", "Inception3",
                                        "MobileNet", "MobileNetV2",
                                        "MobileNetV3"}
    with pytest.raises(MXNetError, match="no sha1 registered"):
        pvision.mobilenet_v2_0_25(pretrained=True, ctx=mx.cpu())


def test_layers_of_every_form_hold_the_reference():
    """The 1-D and 3-D convolutions, the transposed convolutions, the
    1-D/3-D and ``ceil_mode`` pools and the global pools of
    ``gluon.nn``, weights crossing by ``.params``."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn as pnn

    rs = np.random.RandomState(9)
    cases = [
        ("Conv1D", (4, 3), dict(strides=2, padding=1, dilation=2, groups=2,
                                in_channels=4), (2, 4, 11)),
        ("Conv3D", (4, 3), dict(padding=1, in_channels=2), (1, 2, 4, 5, 5)),
        ("Conv1DTranspose", (6, 3), dict(strides=2, output_padding=1,
                                         groups=2, in_channels=4),
         (2, 4, 5)),
        ("Conv2DTranspose", (3, (3, 2)), dict(strides=2, padding=1,
                                              in_channels=2), (2, 2, 4, 5)),
        ("Conv3DTranspose", (2, 2), dict(strides=2, in_channels=3),
         (1, 3, 2, 3, 3)),
        ("MaxPool1D", (3, 2), dict(ceil_mode=True), (2, 3, 8)),
        ("AvgPool3D", (2, 2, 1), dict(count_include_pad=False),
         (1, 2, 5, 5, 5)),
        ("AvgPool2D", (3, 2), dict(ceil_mode=True), (1, 2, 6, 6)),
        ("GlobalMaxPool1D", (), {}, (2, 3, 7)),
        ("GlobalAvgPool3D", (), {}, (1, 2, 3, 4, 5)),
    ]
    for cls, args, kw, shape in cases:
        jl, pl = getattr(jnn, cls)(*args, **kw), getattr(pnn, cls)(*args,
                                                                   **kw)
        jl.initialize()
        pl.initialize(ctx=mx.cpu())
        for name, p in jl.collect_params().items():
            a = rs.randn(*p.shape).astype(np.float32)
            p.set_data(jmx.nd.array(a))
            pp = [q for n, q in pl.collect_params().items()
                  if n.endswith(name.rsplit("_", 1)[1])]
            pp[0].set_data(a)
        x = rs.randn(*shape).astype(np.float32)
        want = jl(jmx.nd.array(x)).asnumpy()
        with mx.cpu():
            got = pl(mx.nd.array(x)).asnumpy()
        _close_to_max(got, want, 1e-5, cls)


SGD = {"learning_rate": 0.05, "momentum": 0.9}


class _ClipDecisions:
    """Every ReLU6 input of the port's forward and of the JAX
    ``TrainStep``'s (``jnp.clip``, which the reference's ``clip`` op
    calls, hands its input from inside the compiled step to the host
    through ``jax.debug.callback``), so the side each takes of the kinks
    at 0 and 6 can be compared: an input within f32 rounding of a kink
    takes one side in one framework and the other in the other, and every
    gradient upstream of it moves far past f32 noise."""

    active = None

    @staticmethod
    def _sink(v):
        if _ClipDecisions.active is not None:
            _ClipDecisions.active.jax.append(np.asarray(v))

    def __init__(self):
        from mxnet_tpu_torch.gluon.model_zoo.vision import mobilenet

        self.port, self.jax = [], []
        self._mod = mobilenet
        self._fwd = mobilenet.ReLU6.hybrid_forward
        self._jclip = jax.numpy.clip

    def __enter__(self):
        fwd, jclip = self._fwd, self._jclip

        def port_fwd(blk, F, x):
            self.port.append(x.detach().clone())
            return fwd(blk, F, x)

        def jax_clip(x, *args, **kw):
            jax.debug.callback(_ClipDecisions._sink, x, ordered=True)
            return jclip(x, *args, **kw)

        _ClipDecisions.active = self
        self._mod.ReLU6.hybrid_forward = port_fwd
        jax.numpy.clip = jax_clip
        jax.clear_caches()
        return self

    def __exit__(self, *exc):
        _ClipDecisions.active = None
        self._mod.ReLU6.hybrid_forward = self._fwd
        jax.numpy.clip = self._jclip
        jax.clear_caches()

    def flips(self):
        # the JAX step clips elsewhere too (the loss): the feature maps'
        # clips are the ReLU6s
        self.jax = [a for a in self.jax if a.ndim == 4]
        assert [a.shape for a in self.jax] == [tuple(a.shape)
                                               for a in self.port]
        found = 0
        for p, j in zip(self.port, self.jax):
            p = p.numpy()
            for kink in (0.0, 6.0):
                found += int(((p > kink) != (j > kink)).sum())
        return found


def test_mobilenet_v2_trainstep_matches_the_reference(tmp_path):
    """One f32 SGD-momentum ``TrainStep`` of ``mobilenet_v2_0_25
    (classes=10)`` at 64x64 on a batch of 4, from the same weights,
    against the JAX ``TrainStep``: each parameter's delta to 1e-3 of its
    norm, the loss to 3e-5 relative, BatchNorm's running statistics to
    1e-4 relative (+ 1e-5).

    The loss's and the statistics' limits are not the 1e-5 of the
    ResNet tests: the 17 bottlenecks' train-mode BatchNorms carry f32
    rounding forward, 1.5e-4 of the largest activation by the last
    bottleneck, so the JAX step's own logits sit 6.7e-5 of their
    magnitude from an f64 forward of the same weights and batch, the
    port's 2.1e-5 (measured on this batch). So the test also holds the
    port's f32 loss no farther from the f64 forward's than the JAX
    step's is.

    The last BatchNorm of each bottleneck feeds a 1x1 convolution and a
    train-mode BatchNorm, which removes any per-channel shift, so its
    beta's true gradient is 0: those betas are held to moving by f32
    noise only (under 1e-5). The premise is checked first: both take
    the same side of every ReLU6 kink (_ClipDecisions). About half the
    seeds tried put an input within f32 rounding of a kink in this step;
    these (weights 5, batch 6) do not."""
    import copy

    path = tmp_path / "w.params"
    jnet = _jax_net("mobilenetv2_0.25", 64, 5, path, 4)
    net = _port_net("mobilenetv2_0.25", path)
    start = {k: v.detach().clone() for k, v in net.state_dict().items()}
    rs = np.random.RandomState(6)
    x = rs.rand(4, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)
    net64 = copy.deepcopy(net).double()
    with mx.autograd.train_mode():
        l64 = float(SoftmaxCrossEntropyLoss()(
            net64(torch.from_numpy(x).double()),
            torch.from_numpy(y).double()).mean().detach())
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    with _ClipDecisions() as kinks:
        jstep = jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(), "sgd",
                               mesh=mesh, optimizer_params=dict(SGD))
        jl = float(jstep(jmx.nd.array(x), jmx.nd.array(y))[0].asnumpy())
        step = TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                         optimizer_params=dict(SGD))
        loss, _ = step(x, y)
        assert kinks.flips() == 0, "a ReLU6 input sits on a kink: the " \
            "seeds are ill-posed for this comparison"
    np.testing.assert_allclose(float(loss), jl, rtol=3e-5)
    assert abs(float(loss) - l64) <= abs(jl - l64) + 1e-6 * abs(l64)
    jparams = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    for key, v in net.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(v.numpy(), jparams[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)
            continue
        dj = jparams[key] - start[key].numpy()
        dp = v.numpy() - start[key].numpy()
        if re.search(r"\.out\.7\.beta$", key):
            assert max(np.abs(dj).max(), np.abs(dp).max()) < 1e-5, key
            continue
        ratio = float(np.linalg.norm(dp - dj)) / float(np.linalg.norm(dj))
        assert ratio < 1e-3, (key, ratio)
