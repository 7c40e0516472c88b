"""The port's ResNet v1 training slice held against the JAX package on the
CPU: the SGD sweep, the BatchNorm op with its hand-derived VJP, the
convolution and pooling ops, ``SoftmaxCrossEntropyLoss`` with float
labels, the ResNet v1 models (``resnet18_v1`` and the bottleneck
``resnet50_v1``) through ``resnet_params_from_reference``, and
``parallel.TrainStep`` with SGD momentum (f32, and bf16 multi-precision)
against the JAX ``TrainStep``, BatchNorm's running statistics included;
then what the slice refuses.

Inputs and weights are drawn with numpy and handed to both packages; the
JAX sweep runs the Pallas kernel in interpret mode (``packed_apply(...,
interpret=True)``). The CUDA sweep kernel runs only on the card:
tests/test_torch_cuda_kernels.py holds it against the plain version
there.

A ReLU network's gradient jumps where a ReLU input crosses 0 (or two
inputs of a max-pool window swap places). Two correct f32
implementations round differently, so an input within f32 rounding of
such a point may take the other side in one of them, and then every
gradient upstream of it moves by that element's share of its layer's
gradient, far more at these sizes than the f32 noise the limits below
allow. The f32 TrainStep test compares every such decision of the two
steps before it compares their numbers, so a flip fails as a flip.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.optimizer import multi_tensor as jmt

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import resnet_params_from_reference
from mxnet_tpu_torch.gluon import nn as pnn
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision as pvision
from mxnet_tpu_torch.kernels import fused_sgd_sweep, sgd_sweep_reference
from mxnet_tpu_torch.ops import nn as pops
from mxnet_tpu_torch.optimizer import SGD
from mxnet_tpu_torch.optimizer import multi_tensor as pmt
from mxnet_tpu_torch.parallel import TrainStep


def _np(x):
    """A torch or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, copy=True)).to(dtype)


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _close_to_max(got, want, rtol, what):
    """max |got - want| <= ``rtol`` of max |want|: sums of many products
    in other orders, where an element that cancels to near 0 carries the
    error of its large terms."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * float(np.max(np.abs(want))), (what, err)


def _within_ulps_of_max(got, want, ulps, what):
    """max |got - want| <= ``ulps`` bf16 ulps of max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    top = float(np.max(np.abs(want)))
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    err = float(np.max(np.abs(got - want)))
    assert err <= ulps * ulp, (what, err, ulp)


# ---------------------------------------------------------------------------
# the SGD sweep
# ---------------------------------------------------------------------------

SHAPES = [(4, 5), (7,), (2, 3, 2), (33, 17), (6,), (3, 4)]
LRS = [0.1, 0.05, 0.02, 0.01, 0.03, 0.04]
WDS = [0.0, 1e-4, 0.01, 0.1, 5e-4, 0.05]


def _sgd_members(rs, bf16_grads):
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [(3 * rs.randn(*s)).astype(np.float32) for s in SHAPES]
    moms = [0.1 * rs.randn(*s).astype(np.float32) for s in SHAPES]
    if bf16_grads:
        gs = [np.array(jnp.asarray(g).astype(jnp.bfloat16)
                       .astype(jnp.float32)) for g in gs]
    return ws, gs, moms


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("bucket", ["f32", "bf16-mp"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_sweep_plain_matches_jax_packed_apply(momentum, bucket, clip):
    """The plain sweep against ``packed_apply("sgd", interpret=True)``,
    the Pallas sweep in interpret mode, with per-member lr and wd (wd
    nonzero but for one member) and a grad rescale of 0.5: an f32 bucket
    and a bf16 multi-precision one (f32 masters and momenta, bf16 grads,
    the bf16 weights written in the same pass), with and without
    momentum (a ``mom`` role only at momentum 0.9, as ``state_roles``
    says), clip on and off. Not bit-exact: XLA contracts some products
    into FMAs the plain version rounds apart, so the masters and momenta
    agree to the Adam test's rtol 1e-6 / atol 1e-7 (measured: one f32
    ulp); the bf16 weights, rounded from those masters, agree exactly
    here. The sweep updates every tensor in place and keeps its dtype."""
    mp = bucket == "bf16-mp"
    rs = np.random.RandomState(71)
    ws, gs, moms = _sgd_members(rs, mp)
    static = {"momentum": momentum, "clip_gradient": clip}
    roles = pmt.state_roles("sgd", static)
    assert roles == (("mom",) if momentum else ())
    assert jmt.state_roles("sgd", static) == roles
    ins = {"w": [jnp.asarray(a) for a in ws],
           "g": [jnp.asarray(a) for a in gs]}
    t_ins = {"w": [_t(a) for a in ws],
             "g": [_t(a, torch.bfloat16 if mp else torch.float32)
                   for a in gs]}
    if momentum:
        ins["mom"] = [jnp.asarray(a) for a in moms]
        t_ins["mom"] = [_t(a) for a in moms]
    want = jmt.packed_apply("sgd", static, SHAPES, ins,
                            {"lr": LRS, "wd": WDS}, 0.5,
                            low_dtype=jnp.bfloat16 if mp else None,
                            platform="cpu", interpret=True)
    low = [torch.zeros(s, dtype=torch.bfloat16) for s in SHAPES] \
        if mp else None
    ptrs = {role: [t.data_ptr() for t in ts] for role, ts in t_ins.items()}
    before = fused_sgd_sweep.launches
    got = pmt.packed_apply("sgd", tuple(sorted(static.items())), t_ins,
                           {"lr": LRS, "wd": WDS}, 0.5, low=low)
    assert fused_sgd_sweep.launches == before        # CPU: plain version
    for role in ("w",) + roles:
        assert [t.data_ptr() for t in got[role]] == ptrs[role], role
        for a, b in zip(got[role], want[role]):
            assert a.dtype == torch.float32, role
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                       err_msg=role)
    if mp:
        for a, b, w in zip(got["w_low"], want["w_low"], got["w"]):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(_np(a), _np(b))
            assert torch.equal(a, w.to(torch.bfloat16))


def test_sgd_sweep_by_hand():
    """One member by hand, in f32: ``mom = 0.9 mom - lr (g + wd w)``,
    ``w += mom``; without momentum ``w -= lr (g + wd w)``; momentum 0
    with a state still rewrites it to ``-lr g`` (the op's contract); a
    NaN in the grad propagates (SGD has no overflow skip)."""
    rs = np.random.RandomState(72)
    w0, g, m0 = (_t(rs.randn(16).astype(np.float32)) for _ in range(3))
    g[3] = float("nan")
    w, m = w0.clone(), m0.clone()
    sgd_sweep_reference([w], [g], [m], None, [0.1], [0.01], momentum=0.9,
                        rescale_grad=1.0)
    g2 = g + 0.01 * w0
    m_want = 0.9 * m0 - 0.1 * g2
    ok = torch.arange(16) != 3
    assert torch.equal(m[ok], m_want[ok])
    assert torch.equal(w[ok], (w0 + m_want)[ok])
    assert torch.isnan(w[3]) and torch.isnan(m[3])
    w = w0.clone()
    sgd_sweep_reference([w], [g], None, None, [0.1], [0.01], momentum=0.0,
                        rescale_grad=1.0)
    assert torch.equal(w[ok], (w0 - 0.1 * g2)[ok])
    w, m = w0.clone(), m0.clone()
    sgd_sweep_reference([w], [g], [m], None, [0.1], [0.0], momentum=0.0,
                        rescale_grad=1.0)
    assert torch.equal(m[ok], (-0.1 * g)[ok])


def test_sgd_optimizer_matches_the_jax_one():
    """``create("sgd")`` with the path's settings: the family, its static
    items and roles and the per-member scalars equal the JAX ones; the
    state is None at momentum 0, else a zero buffer in the weight's dtype
    (beside the f32 master under multi-precision)."""
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
          "multi_precision": True}
    popt = mx.optimizer.create("sgd", **kw)
    jopt = jmx.optimizer.create("sgd", **kw)
    assert isinstance(popt, SGD) and pmt.family_of(popt) == "sgd"
    assert pmt.family_static(popt, "sgd") == jmt.family_static(jopt, "sgd")
    got = pmt.collect_scalars(popt, "sgd", [0, 1])
    want = jmt.collect_scalars(jopt, "sgd", [0, 1])
    assert got == {k: [float(x) for x in v] for k, v in want.items()}
    w = torch.ones(3, 4, dtype=torch.bfloat16)
    w32, mom = popt.create_state_multi_precision(0, w)
    assert w32.dtype == mom.dtype == torch.float32
    assert torch.equal(w32, w.float()) and not mom.any()
    assert popt.create_state(0, w).dtype == torch.bfloat16
    plain = mx.optimizer.create("sgd", learning_rate=0.1)
    assert plain.create_state(0, w) is None
    assert plain.create_state_multi_precision(0, w) is None
    assert pmt.state_roles("sgd", dict(pmt.family_static(plain, "sgd"))) \
        == ()


# ---------------------------------------------------------------------------
# BatchNorm, convolution, pooling, the loss
# ---------------------------------------------------------------------------

def _bn_inputs(layout, seed):
    rs = np.random.RandomState(seed)
    shape = (4, 6, 5, 5) if layout == "NCHW" else (4, 5, 5, 6)
    x = (2.0 + 1.5 * rs.randn(*shape)).astype(np.float32)
    g = (1.0 + 0.2 * rs.randn(6)).astype(np.float32)
    b = (0.3 * rs.randn(6)).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_jax_op_and_vjp(dtype, layout):
    """Training-mode ``batch_norm`` (out, batch mean, batch var) and the
    gradients of data, gamma and beta against the JAX op with
    ``_training=True`` and ``jax.vjp`` of its hand-derived backward;
    gamma and beta f32 as a bf16 model keeps them. f32: rtol / atol
    1e-5 (sums in other orders). bf16 input (the one-pass variance):
    the statistics to rtol 1e-5 / atol 1e-5, the output and dx within
    one bf16 ulp of their largest magnitude (one rounding of f32 values
    that agree to f32 noise), dgamma and dbeta (f32 sums) to rtol 1e-4 /
    atol 1e-4 of their bf16-rounded inputs' sums."""
    axis = 1 if layout == "NCHW" else -1
    x, g, b, dy = _bn_inputs(layout, 81)
    rm, rv = np.zeros(6, np.float32), np.ones(6, np.float32)

    def jbn(a, c, e):
        return jnn.batch_norm(a, c, e, jnp.asarray(rm), jnp.asarray(rv),
                              eps=1e-5, fix_gamma=False, axis=axis,
                              _training=True)

    (jout, jmean, jvar), vjp = jax.vjp(jbn, _j(x, dtype), _j(g), _j(b))
    jdx, jdg, jdb = vjp((_j(dy, dtype), jnp.zeros_like(jmean),
                         jnp.zeros_like(jvar)))
    tdt = getattr(torch, dtype)
    tx = _t(x, tdt).requires_grad_()
    tg, tb = _t(g).requires_grad_(), _t(b).requires_grad_()
    out, mean, var = pops.batch_norm(tx, tg, tb, _t(rm), _t(rv), eps=1e-5,
                                     fix_gamma=False, axis=axis,
                                     training=True)
    assert out.dtype == tdt and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    out.backward(_t(dy, tdt))
    for got, want in ((mean, jmean), (var, jvar)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        for got, want, name in ((out, jout, "out"), (tx.grad, jdx, "dx"),
                                (tg.grad, jdg, "dgamma"),
                                (tb.grad, jdb, "dbeta")):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    else:
        _within_ulps_of_max(out, jout, 1, "out")
        _within_ulps_of_max(tx.grad, jdx, 1, "dx")
        for got, want, name in ((tg.grad, jdg, "dgamma"),
                                (tb.grad, jdb, "dbeta")):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=1e-4, err_msg=name)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_inference_and_fix_gamma_match_jax_op(layout):
    """Inference mode normalises by the moving statistics (f32, rtol /
    atol 1e-5), with ``output_mean_var`` handing them back; outside
    ``autograd.train_mode()`` the op takes this branch by itself; under
    ``use_global_stats`` training takes it too; ``fix_gamma`` uses ones
    and gives gamma no gradient."""
    axis = 1 if layout == "NCHW" else -1
    x, g, b, _ = _bn_inputs(layout, 82)
    rs = np.random.RandomState(83)
    rm = rs.randn(6).astype(np.float32)
    rv = (0.5 + rs.rand(6)).astype(np.float32)
    for fix_gamma in (False, True):
        want = jnn.batch_norm(_j(x), _j(g), _j(b), _j(rm), _j(rv), eps=1e-5,
                              fix_gamma=fix_gamma, axis=axis)
        tg = _t(g).requires_grad_()
        got = pops.batch_norm(_t(x), tg, _t(b), _t(rm), _t(rv), eps=1e-5,
                              fix_gamma=fix_gamma, axis=axis)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
        assert got.requires_grad != fix_gamma
    out, mean, var = pops.batch_norm(_t(x), _t(g), _t(b), _t(rm), _t(rv),
                                     eps=1e-5, fix_gamma=False, axis=axis,
                                     output_mean_var=True, training=False)
    assert torch.equal(mean, _t(rm)) and torch.equal(var, _t(rv))
    glob = pops.batch_norm(_t(x), _t(g), _t(b), _t(rm), _t(rv), eps=1e-5,
                           fix_gamma=False, axis=axis, training=True,
                           use_global_stats=True)
    assert torch.equal(glob, out)


CONV_CASES = [(1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (7, 2, 3)]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,s,p", CONV_CASES)
def test_convolution_matches_jax_op(k, s, p, layout):
    """``convolution`` forward and its data and weight gradients against
    the JAX op and ``jax.vjp``, f32, each within 1e-5 of its largest
    magnitude (sums of up to 512 products in other orders): 1x1, 3x3 and 7x7 kernels at strides 1 and 2, as the
    ResNets have them, in both layouts with the OIHW weight (the NHWC
    7x7 stride-2 stem on 3 channels takes the reference's
    space-to-depth route, ``_conv_s2d``); a bias on the 3x3 cases."""
    rs = np.random.RandomState(90 + k + s)
    c_in = 3 if k == 7 else 8
    shape = (2, c_in, 16, 16) if layout == "NCHW" else (2, 16, 16, c_in)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(12, c_in, k, k) / np.sqrt(c_in * k * k)).astype(np.float32)
    bias = rs.randn(12).astype(np.float32) if k == 3 else None
    kw = dict(kernel=(k, k), stride=(s, s), pad=(p, p), num_filter=12,
              no_bias=bias is None, layout=layout)
    args = (_j(x), _j(w)) + ((_j(bias),) if bias is not None else ())

    def jconv(*a):
        return jnn.convolution(a[0], a[1], a[2] if len(a) > 2 else None,
                               **kw)

    jout, vjp = jax.vjp(jconv, *args)
    rsd = np.random.RandomState(91)
    dy = rsd.randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(dy))
    targs = [_t(a).requires_grad_() for a in (x, w) + (
        (bias,) if bias is not None else ())]
    out = pops.convolution(targs[0], targs[1],
                           targs[2] if bias is not None else None, **kw)
    assert out.shape == jout.shape
    out.backward(_t(dy))
    _close_to_max(out, jout, 1e-5, "out")
    for t, jg, name in zip(targs, jgrads, ("data", "weight", "bias")):
        _close_to_max(t.grad, jg, 1e-5, name)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", ["max3s2p1", "global_avg", "avg2",
                                  "avg3s2p1", "global_max"])
def test_pooling_matches_jax_op(case, layout):
    """``pooling`` against the JAX op, forward and the data gradient, f32
    (rtol / atol 1e-6): the ResNet stem's max pool (3, stride 2, pad 1,
    the pad at -inf), the global average and max pools, and 2x2 and
    padded 3x3 average pools (the padding counted, MXNet's default);
    random inputs, so no window holds a tie."""
    rs = np.random.RandomState(95)
    shape = (2, 4, 9, 9) if layout == "NCHW" else (2, 9, 9, 4)
    x = rs.randn(*shape).astype(np.float32)
    kw = {"max3s2p1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max"),
          "global_avg": dict(kernel=(1, 1), pool_type="avg",
                             global_pool=True),
          "avg2": dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"),
          "avg3s2p1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="avg"),
          "global_max": dict(kernel=(1, 1), pool_type="max",
                             global_pool=True)}[case]
    kw["layout"] = layout
    jout, vjp = jax.vjp(lambda a: jnn.pooling(a, **kw), _j(x))
    dy = rs.randn(*jout.shape).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(dy))
    tx = _t(x).requires_grad_()
    out = pops.pooling(tx, **kw)
    assert out.shape == jout.shape
    out.backward(_t(dy))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_ce_loss_with_float_labels_matches_jax(dtype):
    """``SoftmaxCrossEntropyLoss`` on (8, 10) logits with float labels
    (as the benchmark's batch has them; one out of range, clipped as the
    reference's ``pick`` clips it): the per-sample f32 loss against the
    JAX loss (f32: rtol / atol 1e-6; bf16 logits: the same f32 sums of
    the same bf16 inputs, rtol / atol 1e-5), and in f32 the logits'
    gradient against the JAX one through its autograd (rtol / atol
    1e-6)."""
    rs = np.random.RandomState(97)
    pred = (3.0 * rs.randn(8, 10)).astype(np.float32)
    if dtype == "bfloat16":
        pred = _np(_j(pred, dtype))
    label = rs.randint(0, 10, (8,)).astype(np.float32)
    label[5] = 11.0
    jp = jmx.nd.array(pred).astype(dtype)
    jp.attach_grad()
    with jmx.autograd.record():
        jl = jloss.SoftmaxCrossEntropyLoss()(jp, jmx.nd.array(label))
    jl.backward()
    tp = _t(pred, getattr(torch, dtype)).requires_grad_()
    loss = SoftmaxCrossEntropyLoss()(tp, _t(label))
    assert loss.shape == (8,) and loss.dtype == torch.float32
    tol = 1e-6 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(_np(loss), jl.asnumpy().astype(np.float32),
                               rtol=tol, atol=tol)
    if dtype == "float32":
        loss.backward(torch.ones(8))
        np.testing.assert_allclose(_np(tp.grad), jp.grad.asnumpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [{"from_logits": True},
                                {"sparse_label": False},
                                {"weight": 0.5, "sample_weight": True}])
def test_softmax_ce_loss_other_forms_match_jax(kw):
    """The loss's other forms against the JAX loss, f32 (rtol / atol
    1e-6): log-probabilities in (``from_logits``), dense label
    distributions (``sparse_label=False``), and a scalar ``weight`` with
    a per-sample weight."""
    rs = np.random.RandomState(98)
    pred = (2.0 * rs.randn(6, 5)).astype(np.float32)
    kw = dict(kw)
    sample = rs.rand(6, 1).astype(np.float32) \
        if kw.pop("sample_weight", False) else None
    if kw.get("from_logits"):
        pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    if kw.get("sparse_label") is False:
        label = rs.rand(6, 5).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rs.randint(0, 5, (6,)).astype(np.float32)
    jargs = [jmx.nd.array(pred), jmx.nd.array(label)] + (
        [jmx.nd.array(sample)] if sample is not None else [])
    want = jloss.SoftmaxCrossEntropyLoss(**kw)(*jargs).asnumpy()
    targs = [_t(pred), _t(label)] + ([_t(sample)] if sample is not None
                                     else [])
    got = SoftmaxCrossEntropyLoss(**kw)(*targs)
    assert got.shape == (6,)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)


def test_batch_norm_block_without_scale_or_center():
    """``BatchNorm(scale=False, center=False)`` (ResNet v2's first
    block) trains nothing: gamma and beta are buffers of ones and zeros,
    and its training output is the op's with ``fix_gamma``."""
    bn = pnn.BatchNorm(in_channels=3, scale=False, center=False)
    assert list(bn.parameters()) == []
    assert sorted(dict(bn.named_buffers())) == [
        "beta", "gamma", "running_mean", "running_var"]
    x = _t(np.random.RandomState(99).randn(4, 3, 2, 2).astype(np.float32))
    with mx.autograd.train_mode():
        out = bn(x)
    want = pops.batch_norm(x, torch.zeros(3), torch.zeros(3),
                           torch.zeros(3), torch.ones(3), eps=1e-5,
                           fix_gamma=True, training=True)[0]
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _jax_resnet(fn, size, seed, layout="NCHW", **kw):
    """A JAX ResNet v1 with numpy weights and running statistics drawn
    from ``seed``; returns it and the named arrays."""
    net = fn(layout=layout, **kw)
    net.initialize()
    net(jmx.nd.zeros((1, 3, size, size)))
    rs = np.random.RandomState(seed)
    named = {}
    for name, p in net.collect_params().items():
        s = p.shape
        if name.endswith("gamma"):
            a = 1.0 + 0.1 * rs.randn(*s)
        elif name.endswith("running_var"):
            a = 1.0 + 0.5 * rs.rand(*s)
        elif name.endswith(("beta", "running_mean", "bias")):
            a = 0.1 * rs.randn(*s)
        elif len(s) == 4:
            a = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        else:
            a = 0.05 * rs.randn(*s)
        a = a.astype(np.float32)
        p.set_data(jmx.nd.array(a))
        named[name] = a
    return net, named


def _port_resnet(name, named, layout="NCHW", dtype=torch.float32, **kw):
    net = getattr(pvision, name)(ctx=mx.cpu(), layout=layout, dtype=dtype,
                                 **kw)
    net.load_state_dict(resnet_params_from_reference(named))
    return net


def _stats(named_or_net):
    """Every BatchNorm's running statistics, by the port's names, as
    numpy."""
    if isinstance(named_or_net, dict):
        sd = resnet_params_from_reference(named_or_net)
    else:
        sd = named_or_net.state_dict()
    return {k: _np(v) for k, v in sd.items() if "running" in k}


MODELS = [("resnet18_v1", 64, {"classes": 10}),
          ("resnet50_v1", 32, {"classes": 10, "thumbnail": True})]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name,size,kw", MODELS)
def test_resnet_forward_matches_jax(name, size, kw, layout):
    """f32 logits of the port's model with converted weights against the
    JAX model's, in predict mode (moving statistics) and in train mode
    (batch statistics), and the running statistics the train-mode
    forward folds in: ``resnet18_v1`` at 64x64 (7x7 stem, max pool,
    basic blocks) and ``resnet50_v1(thumbnail=True)`` at 32x32
    (bottlenecks, the stride on their first 1x1), in both layouts. Limit:
    5e-5 of the largest logit, f32 sums in other orders through 20 and
    53 layers, which train mode's normalisation by a batch of 2 amplifies
    (measured: at most 6e-7 in predict mode, 1.9e-5 in train mode); the
    statistics to rtol / atol 1e-5."""
    jnet, named = _jax_resnet(getattr(jvision, name), size, 101,
                              layout=layout, **kw)
    net = _port_resnet(name, named, layout, **kw)
    x = np.random.RandomState(102).randn(2, 3, size, size).astype(
        np.float32)
    for train in (False, True):
        if train:
            with jmx.autograd.train_mode():
                want = jnet(jmx.nd.array(x)).asnumpy()
        else:
            want = jnet(jmx.nd.array(x)).asnumpy()
        with torch.no_grad(), mx.autograd.train_mode() if train else \
                mx.autograd.predict_mode():
            got = net(_t(x))
        assert got.shape == (2, 10)
        err = float(np.max(np.abs(_np(got) - want)))
        assert err <= 5e-5 * float(np.max(np.abs(want))), (train, err)
    jstats = _stats({n: p.data().asnumpy()
                     for n, p in jnet.collect_params().items()})
    pstats = _stats(net)
    assert pstats.keys() == jstats.keys() and len(pstats) == 2 * (
        20 if name == "resnet18_v1" else 52)
    for k in pstats:
        np.testing.assert_allclose(pstats[k], jstats[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_resnet50_shapes_and_converter_names():
    """``resnet50_v1`` at its published widths: 25,557,032 parameters in
    161 tensors, 53 convolutions (the stride-2 ones are the first 1x1 of
    each downsampling bottleneck, its downsample and the stem) and 53
    BatchNorms; under bf16 the BatchNorm parameters and buffers stay f32
    and NHWC stores the convolution weights channels-last. The converter
    maps a JAX ``resnet50_v1``'s 267 named arrays onto exactly the port's
    state-dict names."""
    net = pvision.resnet50_v1(ctx=mx.cpu(), layout="NHWC",
                              dtype=torch.bfloat16)
    params = list(net.parameters())
    assert len(params) == 161 and sum(p.numel() for p in params) \
        == 25_557_032
    convs = [m for m in net.modules() if isinstance(m, pnn.Conv2D)]
    bns = [m for m in net.modules() if isinstance(m, pnn.BatchNorm)]
    assert len(convs) == 53 and len(bns) == 53
    strided = [tuple(c.weight.shape[2:]) for c in convs
               if c._kwargs["stride"] == (2, 2)]
    assert strided == [(7, 7)] + [(1, 1)] * 6
    for c in convs:
        assert c.weight.dtype == torch.bfloat16
        assert c.weight.is_contiguous(memory_format=torch.channels_last)
    for b in bns:
        assert {t.dtype for t in (b.gamma, b.beta, b.running_mean,
                                  b.running_var)} == {torch.float32}
    jnet = jvision.resnet50_v1()
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 3, 64, 64)))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    assert len(named) == 267
    assert set(resnet_params_from_reference(named)) == set(net.state_dict())


def test_converter_refuses_what_is_not_a_resnet():
    _, named = _jax_resnet(jvision.resnet18_v1, 64, 103, classes=10)
    bad = dict(named)
    bad["resnetv1x_foo_weight"] = np.zeros(3, np.float32)
    with pytest.raises(mx.MXNetError, match="unexpected parameter"):
        resnet_params_from_reference(bad)
    missing = {k: v for k, v in named.items()
               if "stage2_batchnorm" not in k or "running_var" not in k}
    with pytest.raises(mx.MXNetError, match="running_var"):
        resnet_params_from_reference(missing)
    conv = next(k for k in named if "stage3_conv2d" in k)
    wrong = dict(named)
    wrong[conv] = np.zeros((256, 7, 3, 3), np.float32)
    with pytest.raises(mx.MXNetError):
        resnet_params_from_reference(wrong)


# ---------------------------------------------------------------------------
# TrainStep against the JAX step
# ---------------------------------------------------------------------------

SGD_F32 = {"learning_rate": 1e-3, "momentum": 0.9}
SGD_MP = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True}


def _batch(b, size, seed=104):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, 3, size, size).astype(np.float32)
    y = rs.randint(0, 10, (b,)).astype(np.float32)
    return x, y


class _KinkDecisions:
    """Every ReLU decision (input above 0 or not) of the port's forward
    and of the JAX ``TrainStep``'s, and the stem max pool's choice in
    each window, compared step by step: the premise of holding the two
    f32 trainings to f32 noise (module docstring). Inside it, the port's
    ReLU keeps a copy of its input, and ``jax.nn.relu``, as the JAX
    ``Activation`` op reads it when it is traced, hands its input from
    inside the compiled step to the host (``jax.debug.callback``), so
    the inputs compared are the ones each step used."""

    active = None

    @staticmethod
    def _sink(v):
        # the JAX package may hand a later step the executable it
        # compiled for an earlier one, callbacks and all: they report to
        # whichever instance is active
        if _KinkDecisions.active is not None:
            _KinkDecisions.active.jax.append(np.asarray(v))

    def __init__(self):
        self.port, self.jax = [], []
        self._relu = pops._ACTIVATIONS["relu"]
        self._jrelu = jax.nn.relu

    def __enter__(self):
        def port_relu(x):
            self.port.append(x.detach().clone())
            return self._relu(x)

        def jax_relu(x):
            jax.debug.callback(_KinkDecisions._sink, x, ordered=True)
            return self._jrelu(x)

        _KinkDecisions.active = self
        pops._ACTIVATIONS["relu"] = port_relu
        jax.nn.relu = jax_relu
        jax.clear_caches()         # trace the JAX ops anew, with it
        return self

    def __exit__(self, *exc):
        _KinkDecisions.active = None
        pops._ACTIVATIONS["relu"] = self._relu
        jax.nn.relu = self._jrelu
        jax.clear_caches()

    def disagreements(self):
        """What the last forward of each decided differently, one line
        per ReLU or pool; then forgets both forwards."""
        port = [_np(x) for x in self.port]
        jx = self.jax
        assert [a.shape for a in jx] == [a.shape for a in port]
        found = []
        for i, (p, j) in enumerate(zip(port, jx)):
            flip = (p > 0) != (j > 0)
            if flip.any():
                found.append(f"ReLU {i}: {int(flip.sum())} of {flip.size} "
                             f"inputs, |x| <= {np.abs(p[flip]).max():.1e}")
        # the stem's max pool (3, stride 2, pad 1) reads the first ReLU's
        # output; a window whose largest input is 0 passes no gradient
        pooled = [torch.nn.functional.max_pool2d(
            torch.from_numpy(np.maximum(a[0], 0)), 3, 2, 1,
            return_indices=True) for a in (port, jx)]
        (pv, pi), (_, ji) = pooled
        swap = (pi != ji) & (pv > 0)
        if swap.any():
            found.append(f"max pool: {int(swap.sum())} windows")
        self.port.clear()
        self.jax.clear()
        return found


def _jax_step(jnet, opt):
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    return jpar.TrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(), "sgd",
                          mesh=mesh, optimizer_params=dict(opt))


def test_trainstep_f32_sgd_matches_jax_trainstep():
    """Three f32 SGD-momentum steps (lr 1e-3, momentum 0.9, no
    multi-precision) of ``resnet18_v1(classes=10)`` at 64x64 on a batch of
    4 with float labels, from the same weights, against the JAX
    ``TrainStep``: each step's loss to 1e-5 relative, BatchNorm's running
    statistics after each step to rtol / atol 1e-5 (the port's BatchNorm
    folds them in during the forward, the JAX step writes them back after
    it), and each parameter's delta over the run to 1e-3 of its norm
    (f32 sums in other orders). The loss stays above 0.05 over the run,
    so the relative limit reads f32 noise, not a vanished loss. One
    f32 bucket, one sweep per step, the momenta f32.

    The premise is checked first, each step: the port and the JAX step
    take the same side of every ReLU and the same input of every stem
    max-pool window (_KinkDecisions). An input within f32 rounding of
    its kink moves every gradient upstream of it far past these limits
    (module docstring); about half the seeds tried put one in these
    three steps, and these seeds (weights 0, batch 3) were picked among
    those that do not. A failure of the premise names the ReLU, and is
    not a fault of the port: any other failure is."""
    jnet, named = _jax_resnet(jvision.resnet18_v1, 64, 0, classes=10)
    net = _port_resnet("resnet18_v1", named, classes=10)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                     optimizer_params=dict(SGD_F32))
    x, y = _batch(4, 64, seed=3)
    start = resnet_params_from_reference(named)
    before = fused_sgd_sweep.launches
    with _KinkDecisions() as kinks:
        jstep = _jax_step(jnet, SGD_F32)
        for k in range(3):
            jl = float(jstep(jmx.nd.array(x), jmx.nd.array(y))[0].asnumpy())
            loss, outs = step(x, y)
            flips = kinks.disagreements()
            assert not flips, (f"step {k + 1}: the port and JAX decide a "
                               "kink differently; the seeds are ill-posed "
                               "for this comparison: " + "; ".join(flips))
            assert outs.shape == (4, 10) and loss.dtype == torch.float32
            assert float(loss) > 0.05
            np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
            jstats = _stats({n: p.data().asnumpy()
                             for n, p in jnet.collect_params().items()})
            for key, v in _stats(net).items():
                np.testing.assert_allclose(v, jstats[key], rtol=1e-5,
                                           atol=1e-5, err_msg=key)
    assert fused_sgd_sweep.launches == before           # CPU: plain version
    moved = resnet_params_from_reference(
        {n: p.data().asnumpy() for n, p in jnet.collect_params().items()})
    got = net.state_dict()
    for key, p in net.named_parameters():
        dj = moved[key].numpy() - start[key].numpy()
        dp = got[key].numpy() - start[key].numpy()
        ratio = float(np.linalg.norm(dp - dj)) / float(np.linalg.norm(dj))
        assert ratio < 1e-3, (key, ratio)
    assert len(step._buckets) == 1 and not step._buckets[0].mp
    assert step.optimizer.num_update == 3
    assert all(s.dtype == torch.float32 for s in step._states)


def test_trainstep_bf16_multi_precision_sgd_loosely_matches_jax():
    """bf16 convolutions and classifier with f32 masters and momenta, f32
    BatchNorm (its own bucket), lr 0.1 as the benchmark: one step from
    the same weights on a bf16 batch, against the JAX step with the net
    cast to bf16. The frameworks round at other places, so the losses
    agree to 2e-2; the running statistics to 2e-2 relative of their
    largest magnitude. Two buckets (the bf16 multi-precision one with
    the 20 convolutions and the classifier's weight and bias, the f32
    one with the 40 gammas and betas), one sweep each; the bf16 weights
    are their masters rounded."""
    jnet, named = _jax_resnet(jvision.resnet18_v1, 64, 106, classes=10)
    jnet.cast("bfloat16")
    net = _port_resnet("resnet18_v1", named, dtype=torch.bfloat16,
                       classes=10)
    x, y = _batch(4, 64, seed=107)
    xb = _np(_j(x, "bfloat16"))
    jl = float(_jax_step(jnet, SGD_MP)(
        jmx.nd.array(xb).astype("bfloat16"), jmx.nd.array(y))[0].asnumpy())
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                     optimizer_params=dict(SGD_MP))
    loss, _ = step(_t(xb, torch.bfloat16), y)
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), jl, rtol=2e-2)
    jstats = _stats({n: p.data().asnumpy().astype(np.float32)
                     for n, p in jnet.collect_params().items()})
    for k, v in _stats(net).items():
        top = float(np.max(np.abs(jstats[k])))
        assert float(np.max(np.abs(v - jstats[k]))) <= 2e-2 * top, k
    mp, f32 = step._buckets
    assert mp.mp and mp.wdtype == torch.bfloat16 and len(mp.members) == 22
    assert not f32.mp and f32.wdtype == torch.float32 \
        and len(f32.members) == 40
    for k, p in enumerate(step._params):
        if p.dtype == torch.bfloat16:
            w32, mom = step._states[k]
            assert w32.dtype == mom.dtype == torch.float32
            assert torch.equal(p.detach(), w32.to(torch.bfloat16))
        else:
            assert step._states[k].dtype == torch.float32


def _sgd_mp_curves(name, size, batch, steps, classes, seed=0, lr=0.1):
    """The losses of ``steps`` bf16 multi-precision SGD steps (lr 0.1,
    momentum 0.9, as the benchmark) of ``name`` (NHWC) on one repeated
    ``RandomState(seed)`` batch with float labels, as ``bench.py``
    builds it: the JAX ``TrainStep`` from the JAX package's own
    initialisation (``Uniform(0.07)``), and the port's from the same
    weights. Returns ``(jax_losses, port_losses)``."""
    jmx.random.seed(seed)
    jnet = getattr(jvision, name)(classes=classes, layout="NHWC")
    jnet.initialize()
    jnet(jmx.nd.zeros((1, 3, size, size)))
    named = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    jnet.cast("bfloat16")
    net = _port_resnet(name, named, "NHWC", torch.bfloat16, classes=classes)
    rs = np.random.RandomState(seed)
    x = _np(_j(rs.randn(batch, 3, size, size).astype(np.float32),
               "bfloat16"))
    y = rs.randint(0, classes, (batch,)).astype(np.float32)
    opt = dict(SGD_MP, learning_rate=lr)
    jstep = _jax_step(jnet, opt)
    jx, jy = jmx.nd.array(x).astype("bfloat16"), jmx.nd.array(y)
    jl = [float(jstep(jx, jy)[0].asnumpy()) for _ in range(steps)]
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                     optimizer_params=opt)
    xt = _t(x, torch.bfloat16)
    pl = [float(step(xt, y)[0]) for _ in range(steps)]
    return jl, pl


def _masters_and_momenta(step):
    """Each trained parameter's (master, momentum) in f64: the f32 master
    for the bf16 multi-precision bucket, the parameter itself for the
    f32 one."""
    out = []
    for p, st in zip(step._params, step._states):
        w, mom = st if isinstance(st, tuple) else (p.detach(), st)
        out.append((w.double().clone(), mom.double().clone()))
    return out


def test_trainstep_bf16_multi_precision_sgd_follows_its_rule_each_step():
    """Three bf16 multi-precision SGD-momentum steps at the benchmark's
    lr 0.1 and momentum 0.9: after the second and the third, every
    momentum is ``0.9 * (its value before) - 0.1 * (the step's
    gradient)`` and every master moved by exactly that momentum, each to
    1e-6 of its largest term (f32 rounding of each operation), and each
    bf16 weight is its f32 master rounded. The masters are f32 copies of
    the bf16 weights and BatchNorm's f32 gamma and beta themselves. A
    momentum or master update wired wrong after the first step (where
    the momentum is still 0) fails here; the one-step comparison with
    JAX above cannot see it, and over several bf16 steps the two
    frameworks' losses part by far more than such a fault would move
    them (``_sgd_mp_curves``)."""
    _, named = _jax_resnet(jvision.resnet18_v1, 64, 106, classes=10)
    net = _port_resnet("resnet18_v1", named, dtype=torch.bfloat16,
                       classes=10)
    x, y = _batch(4, 64, seed=107)
    xb = _t(x, torch.bfloat16)
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                     optimizer_params=dict(SGD_MP))
    step(xb, y)
    for _ in range(2):
        before = _masters_and_momenta(step)
        step(xb, y)
        for p, (w0, m0), (w1, m1) in zip(step._params, before,
                                         _masters_and_momenta(step)):
            g = p.grad.double()
            want = 0.9 * m0 - 0.1 * g
            scale = float((0.9 * m0.abs() + 0.1 * g.abs()).max())
            assert float((m1 - want).abs().max()) <= 1e-6 * scale
            assert float((w1 - (w0 + m1)).abs().max()) \
                <= 1e-6 * float(w0.abs().max())
            assert float(m1.abs().max()) > 0
            if p.dtype == torch.bfloat16:
                assert torch.equal(p.detach(), w1.to(torch.bfloat16))


class _Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.conv = pnn.Conv2D(6, 3, padding=1, in_channels=3,
                               use_bias=False)
        self.bn = pnn.BatchNorm(in_channels=6, momentum=0.9)
        self.pool = pnn.GlobalAvgPool2D()
        self.out = pnn.Dense(4, 6)
        with torch.no_grad():
            self.conv.weight.normal_(0, 0.3, generator=g)
            self.out.weight.normal_(0, 0.3, generator=g)

    def forward(self, x):
        return self.out(self.pool(torch.relu(self.bn(self.conv(x)))))


def test_one_step_moves_the_running_stats_by_the_reference_expression():
    """A ``TrainStep`` call runs the forward once in training mode: the
    running statistics become ``run * 0.9 + batch_stat * (1 - 0.9)``
    bit for bit (the batch statistics of the step's own conv output,
    biased variance); a forward outside ``autograd.train_mode()`` leaves
    them as they are, and the buffers are never swept."""
    net = _Small()
    x, y = _batch(4, 8)
    y = y % 4
    with torch.no_grad():
        _, mean, var = pops.batch_norm(net.conv(_t(x)), net.bn.gamma,
                                       net.bn.beta, net.bn.running_mean,
                                       net.bn.running_var, eps=1e-5,
                                       fix_gamma=False, training=True)
    rm0, rv0 = net.bn.running_mean.clone(), net.bn.running_var.clone()
    step = TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd",
                     optimizer_params={"learning_rate": 0.1,
                                       "momentum": 0.9})
    assert not any(p is net.bn.running_mean or p is net.bn.running_var
                   for p in step._params)
    step(x, y)
    assert torch.equal(net.bn.running_mean, rm0 * 0.9 + mean * (1 - 0.9))
    assert torch.equal(net.bn.running_var, rv0 * 0.9 + var * (1 - 0.9))
    rm1, rv1 = net.bn.running_mean.clone(), net.bn.running_var.clone()
    assert not mx.autograd.is_training()
    with torch.no_grad():
        net(_t(x))
    with mx.autograd.predict_mode():
        net(_t(x))
    assert torch.equal(net.bn.running_mean, rm1)
    assert torch.equal(net.bn.running_var, rv1)


# ---------------------------------------------------------------------------
# what the slice refuses
# ---------------------------------------------------------------------------

def test_trainstep_refuses_a_mesh_and_unported_optimizers():
    net = _Small()
    with pytest.raises(mx.MXNetError, match="items 9 and 11"):
        TrainStep(net, SoftmaxCrossEntropyLoss(), "sgd", mesh={"dp": 2})
    for name in ("lamb", "nag", "rmsprop", "adagrad"):
        with pytest.raises(mx.MXNetError, match="item 7"):
            TrainStep(net, SoftmaxCrossEntropyLoss(), name)

    class MySGD(SGD):
        pass

    with pytest.raises(mx.MXNetError, match="item 7"):
        TrainStep(net, SoftmaxCrossEntropyLoss(), MySGD())


def test_resnet_refuses_what_is_not_ported():
    with pytest.raises(mx.MXNetError, match="v2"):
        pvision.get_resnet(2, 18, ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="model store"):
        pvision.resnet18_v1(pretrained=True, ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="layers"):
        pvision.get_resnet(1, 20, ctx=mx.cpu())
    x = torch.zeros(1, 2, 4, 4)
    for kw in ({"pool_type": "sum"}, {"pool_type": "lp"},
               {"pooling_convention": "full"}):
        with pytest.raises(mx.MXNetError, match="item 4"):
            pops.pooling(x, kernel=(2, 2), **kw)
    w = torch.zeros(3, 2, 2, 2)
    for op, args in ((pops.convolution, (torch.zeros(1, 2, 4), w)),
                     (pops.convolution, (torch.zeros(1, 2, 4, 4, 4), w)),
                     (pops.pooling, (torch.zeros(1, 2, 4),))):
        with pytest.raises(mx.MXNetError, match="spatial axes.*item 4"):
            op(*args, kernel=(2, 2))
    for layout in ("NCW", "NDHWC"):
        with pytest.raises(mx.MXNetError, match="layout.*item 4"):
            pops.convolution(x, w, kernel=(2, 2), layout=layout)
        with pytest.raises(mx.MXNetError, match="layout.*item 4"):
            pops.pooling(x, kernel=(2, 2), layout=layout)
    with pytest.raises(ValueError, match="in_channels"):
        pnn.Conv2D(4, 3)
    with pytest.raises(ValueError, match="in_channels"):
        pnn.BatchNorm()


if __name__ == "__main__":
    # resnet50_v1 (1000 classes, NHWC, bf16 multi-precision SGD at lr 0.1,
    # momentum 0.9) on one repeated RandomState(0) batch of 16 at 64x64,
    # 20 steps: the JAX TrainStep's and the port's losses, side by side
    import json
    import sys

    jl, pl = _sgd_mp_curves("resnet50_v1", 64, 16, 20, 1000)
    json.dump({"model": "resnet50_v1(layout='NHWC')", "batch": [16, 3, 64,
                                                                  64],
               "optimizer": SGD_MP, "jax": jl, "port": pl}, sys.stdout)
    print()
