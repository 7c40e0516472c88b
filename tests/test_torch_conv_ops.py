"""The port's convolution, pooling and resize ops against the JAX
package's on the CPU, forward and gradients: ``Convolution`` over 1, 2
and 3 spatial axes with groups and dilation in the six layouts,
``Deconvolution`` (the reference's orientation: torch's transposed
convolution with the weight flipped on every spatial axis), ``Pooling``
in every type and convention, ``UpSampling``, ``BilinearResize2D``
(antialiased, half-pixel centres) and ``AdaptiveAvgPooling2D``.

Inputs, weights and head gradients are drawn with numpy and handed to
both packages; the JAX side runs the op functions of
``mxnet_tpu.ops`` under ``jax.vjp``. f32 throughout: every output and
gradient within 1e-5 of its largest magnitude (sums of products in other
orders), pooling's max and window sums to 1e-6. Each trap where torch's
own call means something else than the reference (the deconvolution's
flip, the resize's antialiasing, the ``full`` average pool's divisor)
has a case of its own that shows the torch call missing.
"""
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as pops
from mxnet_tpu_torch.ops import spatial as pspatial

TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_to_max(got, want, what, rtol=TOL):
    """max |got - want| <= ``rtol`` of max |want| over the finite
    elements; the others (a max-pool window wholly in its -inf padding)
    equal."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    got, want = got[fin], want[fin]
    top = float(np.max(np.abs(want))) if want.size else 0.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * max(top, 1e-30), (what, err, top)


def _vjp_both(jfn, pfn, arrays, seed):
    """Run ``jfn`` under ``jax.vjp`` and ``pfn`` under torch autograd on
    the same numpy ``arrays`` with one numpy head gradient; returns
    ((port out, port grads), (jax out, jax grads))."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    dy = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(dy))
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = pfn(*targs)
    out.backward(torch.from_numpy(dy))
    return (out, [t.grad for t in targs]), (jout, jgrads)


def _check_vjp(jfn, pfn, arrays, seed, what, rtol=TOL):
    (out, grads), (jout, jgrads) = _vjp_both(jfn, pfn, arrays, seed)
    _close_to_max(out, jout, what + " out", rtol)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        _close_to_max(g, jg, f"{what} grad {i}", rtol)


def _layout_shape(nd, last, n, c, sizes):
    return (n,) + tuple(sizes) + (c,) if last else (n, c) + tuple(sizes)


_LAYOUT = {(1, False): "NCW", (2, False): "NCHW", (3, False): "NCDHW",
           (1, True): "NWC", (2, True): "NHWC", (3, True): "NDHWC"}


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

# (spatial sizes, kernel, stride, pad, dilate, groups, C in, C out)
CONV_CASES = {
    "1d_dilated": ((11,), (3,), (1,), (2,), (2,), 1, 4, 6),
    "1d_grouped_strided": ((12,), (4,), (2,), (1,), (1,), 2, 4, 6),
    "2d_grouped_dilated": ((9, 10), (3, 3), (1, 1), (2, 2), (2, 2), 4, 8, 8),
    "2d_depthwise_s2": ((10, 10), (3, 3), (2, 2), (1, 1), (1, 1), 6, 6, 6),
    "2d_asym_kernel": ((8, 9), (1, 3), (1, 2), (0, 1), (1, 1), 1, 3, 5),
    "3d": ((5, 6, 6), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1), 1, 3, 4),
    "3d_grouped_dilated": ((5, 7, 7), (1, 3, 3), (1, 2, 2), (0, 2, 1),
                           (1, 2, 1), 2, 4, 6),
}


@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_the_reference(case, last):
    """``Convolution`` forward and its data, weight and bias gradients,
    with groups, dilation, asymmetric kernels and strides, 1-D to 3-D,
    channels first and last (the weight ``(O, I/g, *k)`` in both)."""
    sizes, k, s, p, d, g, ci, co = CONV_CASES[case]
    nd = len(k)
    rs = np.random.RandomState(zlib.crc32(case.encode()) % 1000)
    x = rs.randn(*_layout_shape(nd, last, 2, ci, sizes)).astype(np.float32)
    w = (rs.randn(co, ci // g, *k) / np.sqrt(ci // g * np.prod(k))) \
        .astype(np.float32)
    b = rs.randn(co).astype(np.float32)
    kw = dict(kernel=k, stride=s, pad=p, dilate=d, num_filter=co,
              num_group=g, layout=_LAYOUT[nd, last])
    _check_vjp(lambda *a: jnn.convolution(*a, **kw),
               lambda *a: pops.convolution(*a, **kw), [x, w, b], 1, case)


def test_convolution_through_the_registered_op():
    """``mx.nd.Convolution`` takes ``num_group`` and ``dilate`` (it
    refused both before) and gives the function's numbers."""
    rs = np.random.RandomState(2)
    x = rs.randn(1, 4, 7, 7).astype(np.float32)
    w = rs.randn(4, 2, 3, 3).astype(np.float32)
    with mx.cpu():
        got = mx.nd.Convolution(mx.nd.array(x), mx.nd.array(w), kernel=(3, 3),
                                num_filter=4, num_group=2, dilate=(2, 2),
                                no_bias=True).asnumpy()
    want = jmx.nd.Convolution(jmx.nd.array(x), jmx.nd.array(w),
                              kernel=(3, 3), num_filter=4, num_group=2,
                              dilate=(2, 2), no_bias=True).asnumpy()
    _close_to_max(got, want, "registered")
    with pytest.raises(MXNetError, match="layout"):
        pops.convolution(torch.zeros(1, 2, 4, 4), torch.zeros(1, 2, 1, 1),
                         kernel=(1, 1), layout="NCW")


# ---------------------------------------------------------------------------
# Deconvolution
# ---------------------------------------------------------------------------

# (spatial sizes, kernel, stride, pad, adj, dilate, groups, C in, C out)
DECONV_CASES = {
    "1d": ((7,), (4,), (2,), (1,), (1,), (1,), 1, 3, 4),
    "2d_asym": ((5, 6), (3, 4), (2, 2), (1, 1), (0, 1), (1, 1), 1, 3, 5),
    "2d_grouped_dilated": ((5, 5), (3, 3), (1, 1), (1, 1), (0, 0), (2, 2),
                           2, 4, 6),
    "2d_depthwise_upsample": ((4, 5), (4, 4), (2, 2), (1, 1), (0, 0),
                              (1, 1), 3, 3, 3),
    "3d": ((3, 4, 4), (2, 3, 3), (1, 2, 2), (0, 1, 1), (0, 1, 0),
           (1, 1, 1), 1, 2, 3),
}


@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("case", sorted(DECONV_CASES))
def test_deconvolution_matches_the_reference(case, last):
    """``Deconvolution`` with ``(I, O/g, *k)`` weights, asymmetric
    kernels, ``adj``, dilation and groups, forward and gradients."""
    sizes, k, s, p, a, d, g, ci, co = DECONV_CASES[case]
    nd = len(k)
    rs = np.random.RandomState(zlib.crc32(case.encode()) % 1000 + 7)
    x = rs.randn(*_layout_shape(nd, last, 2, ci, sizes)).astype(np.float32)
    w = rs.randn(ci, co // g, *k).astype(np.float32)
    b = rs.randn(co).astype(np.float32)
    kw = dict(kernel=k, stride=s, pad=p, adj=a, dilate=d, num_filter=co,
              num_group=g, no_bias=False, layout=_LAYOUT[nd, last])
    _check_vjp(lambda *t: jnn.deconvolution(*t, **kw),
               lambda *t: pops.deconvolution(*t, **kw), [x, w, b], 3, case)


@pytest.mark.parametrize("groups", [1, 2])
def test_deconvolution_orientation_is_the_references_not_torchs(groups):
    """The trap: torch's ``conv_transpose`` on the reference's weight
    misses the reference by far (upstream MXNet's orientation); on the
    weight flipped on every spatial axis it equals it."""
    rs = np.random.RandomState(40 + groups)
    x = rs.randn(2, 4, 9).astype(np.float32)
    w = rs.randn(4, 6 // groups, 3).astype(np.float32)
    kw = dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=6,
              num_group=groups)
    want = _np(jnn.deconvolution(jnp.asarray(x), jnp.asarray(w), **kw))
    got = pops.deconvolution(torch.from_numpy(x), torch.from_numpy(w), **kw)
    _close_to_max(got, want, "flipped")
    torch_own = F.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                                   stride=2, padding=1, groups=groups)
    assert float(np.abs(_np(torch_own) - want).max()) > 0.5
    with pytest.raises(MXNetError, match="target_shape"):
        pops.deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                           target_shape=(17,), **kw)
    with mx.cpu(), pytest.raises(MXNetError, match="target_shape"):
        mx.nd.Deconvolution(mx.nd.array(x), mx.nd.array(w),
                            target_shape=(17,), **kw)


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

# (spatial sizes, pooling kwargs)
POOL_CASES = {
    "1d_max_valid_pad": ((11,), dict(kernel=(3,), stride=(2,), pad=(1,),
                                     pool_type="max")),
    "1d_avg_full": ((10,), dict(kernel=(3,), stride=(2,), pool_type="avg",
                                pooling_convention="full")),
    "1d_lp1": ((9,), dict(kernel=(2,), stride=(2,), pool_type="lp",
                          p_value=1)),
    "2d_max_full": ((6, 7), dict(kernel=(3, 3), stride=(2, 2),
                                 pool_type="max",
                                 pooling_convention="full")),
    "2d_avg_full_pad": ((7, 6), dict(kernel=(3, 3), stride=(2, 2),
                                     pad=(1, 1), pool_type="avg",
                                     pooling_convention="full")),
    "2d_avg_same": ((7, 8), dict(kernel=(3, 2), stride=(2, 3),
                                 pool_type="avg",
                                 pooling_convention="same")),
    "2d_max_same": ((7, 8), dict(kernel=(3, 3), stride=(2, 2),
                                 pool_type="max",
                                 pooling_convention="same")),
    "2d_avg_exclude_pad": ((7, 7), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(1, 1), pool_type="avg",
                                        count_include_pad=False)),
    "2d_avg_exclude_full": ((6, 6), dict(kernel=(3, 3), stride=(2, 2),
                                         pool_type="avg",
                                         pooling_convention="full",
                                         count_include_pad=False)),
    "2d_avg_s1p1": ((8, 8), dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                 pool_type="avg")),
    "2d_sum": ((8, 7), dict(kernel=(2, 3), stride=(2, 1), pad=(1, 0),
                            pool_type="sum")),
    "2d_lp2_full": ((7, 7), dict(kernel=(3, 3), stride=(2, 2),
                                 pool_type="lp", p_value=2,
                                 pooling_convention="full")),
    "2d_lp3": ((6, 6), dict(kernel=(2, 2), stride=(2, 2), pool_type="lp",
                            p_value=3)),
    "2d_max_big_pad": ((5, 5), dict(kernel=(2, 2), stride=(1, 1),
                                    pad=(2, 2), pool_type="max")),
    "3d_max_valid": ((5, 6, 6), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                     pool_type="max")),
    "3d_avg_full": ((5, 5, 6), dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                                    pool_type="avg",
                                    pooling_convention="full")),
    "3d_sum_same": ((4, 5, 5), dict(kernel=(2, 3, 3), stride=(2, 2, 2),
                                    pool_type="sum",
                                    pooling_convention="same")),
}


@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_the_reference(case, last):
    """Every pool type and convention, 1-D to 3-D, both channel
    positions: the forward and the data gradient; random inputs, so no
    window holds a tie (the ties have a test of their own)."""
    sizes, kw = POOL_CASES[case]
    nd = len(sizes)
    kw = dict(kw, layout=_LAYOUT[nd, last])
    rs = np.random.RandomState(zlib.crc32(case.encode()) % 1000 + 11)
    x = rs.randn(*_layout_shape(nd, last, 2, 3, sizes)).astype(np.float32)
    if kw["pool_type"] == "lp":
        x = x + np.sign(x) * 0.1        # |x|^p's kink at 0 stays away
    _check_vjp(lambda a: jnn.pooling(a, **kw),
               lambda a: pops.pooling(a, **kw), [x], 5, case, rtol=1e-6)


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "lp"])
def test_global_pooling_of_every_type(pool_type, nd):
    for last in (False, True):
        kw = dict(kernel=(1,) * nd, pool_type=pool_type, global_pool=True,
                  p_value=3, layout=_LAYOUT[nd, last])
        rs = np.random.RandomState(nd * 10 + len(pool_type))
        x = rs.randn(*_layout_shape(nd, last, 2, 3, (4,) * nd)) \
            .astype(np.float32) + 0.05
        _check_vjp(lambda a: jnn.pooling(a, **kw),
                   lambda a: pops.pooling(a, **kw), [x], 6,
                   f"global {pool_type} {nd}d {last}")


def test_full_average_pool_divides_by_the_whole_window():
    """The trap: on a 6x6 input, kernel 3, stride 2, ``full`` pads the
    high side and the reference divides by 9 there too; torch's
    ``ceil_mode=True`` leaves that padding out of the divisor."""
    x = np.random.RandomState(60).rand(1, 2, 6, 6).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
              pooling_convention="full")
    want = _np(jnn.pooling(jnp.asarray(x), **kw))
    got = pops.pooling(torch.from_numpy(x), **kw)
    assert want.shape == (1, 2, 3, 3)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-6)
    ceil = F.avg_pool2d(torch.from_numpy(x), 3, 2, ceil_mode=True)
    assert float(np.abs(_np(ceil) - want).max()) > 0.05
    # max under "full" is torch's ceil_mode exactly
    kw["pool_type"] = "max"
    np.testing.assert_array_equal(
        _np(pops.pooling(torch.from_numpy(x), **kw)),
        _np(F.max_pool2d(torch.from_numpy(x), 3, 2, ceil_mode=True)))


def test_same_convention_with_a_pad_raises():
    with pytest.raises(ValueError):
        jnn.pooling(jnp.zeros((1, 1, 4, 4)), kernel=(2, 2), pad=(1, 1),
                    pooling_convention="same")
    with pytest.raises(MXNetError, match="pad=0"):
        pops.pooling(torch.zeros(1, 1, 4, 4), kernel=(2, 2), pad=(1, 1),
                     pooling_convention="same")


def _max_pool_edges():
    """A (1, 2, 4, 4) input whose 2x2 windows hold +0 beside -0, NaN,
    +inf, -inf everywhere, and ties of a finite value."""
    nan, inf = np.nan, np.inf
    c0 = [[0.0, -0.0, 1.5, 1.5],
          [-0.0, 0.0, 1.5, -2.0],
          [nan, 3.0, inf, 2.0],
          [1.0, -1.0, -inf, 5.0]]
    c1 = [[-inf, -inf, -0.0, -0.0],
          [-inf, -inf, -1.0, -0.0],
          [2.0, 2.0, 4.0, -inf],
          [-3.0, 2.0, 4.0, 4.0]]
    return np.array([[c0, c1]], dtype=np.float32)


@pytest.mark.parametrize("pad", [0, 1])
def test_max_pooling_edges_and_ties(pad):
    """±0, NaN, ±inf and ties in max pooling: the values bit for bit
    (NaN propagates, the sign of a zero max is the reference's), and the
    whole gradient, every window's head carried: a finite tie's to its
    first input, a NaN or -inf window's where the reference selects."""
    x = _max_pool_edges()
    kw = dict(kernel=(2, 2), stride=(2, 2), pad=(pad, pad), pool_type="max")
    jout, vjp = jax.vjp(lambda a: jnn.pooling(a, **kw), jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out = pops.pooling(tx, **kw)
    want = np.asarray(jout)
    assert out.shape == want.shape
    np.testing.assert_array_equal(np.signbit(_np(out)), np.signbit(want))
    np.testing.assert_array_equal(_np(out), want)
    dy = 1.0 + np.arange(want.size, dtype=np.float32).reshape(want.shape)
    (jdx,) = vjp(jnp.asarray(dy))
    out.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(_np(tx.grad), np.asarray(jdx))


# ---------------------------------------------------------------------------
# pooling's faults against the reference (ROADMAP.md, queue 3, F1-F3, D1),
# each case failing before the fix
# ---------------------------------------------------------------------------


def _zero_windows(nd, last, seed):
    """An input of (2, 3) channels whose windows of 2 (per axis) hold
    -0 before +0, +0 before -0, -0 alone, and ordinary values; laid out
    channels first or last."""
    rs = np.random.RandomState(seed)
    sizes = (4,) * nd
    x = rs.choice(np.array([-0.0, 0.0, -0.0, -1.0, 0.5], np.float32),
                  size=(2, 3) + sizes)
    flat = x.reshape(2, 3, -1)
    flat[0, 0, :2] = [-0.0, 0.0]
    flat[0, 1] = np.where(np.arange(flat.shape[2]) % 2, 0.0, -0.0)
    flat[0, 2] = np.where(np.arange(flat.shape[2]) % 3, -0.0, 0.0)
    flat[1, 0] = -0.0
    if last:
        x = np.moveaxis(x, 1, -1)
    return np.ascontiguousarray(x)


def _vjp_exact(jfn, pfn, x, dy_seed=0):
    jout, vjp = jax.vjp(jfn, jnp.asarray(x))
    want = np.asarray(jout)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out = pfn(tx)
    dy = (1.0 + np.random.RandomState(dy_seed).randint(
        0, 8, want.shape)).astype(np.float32)
    (jdx,) = vjp(jnp.asarray(dy))
    out.backward(torch.from_numpy(dy))
    return out, want, tx.grad, np.asarray(jdx)


@pytest.mark.parametrize("global_pool", [False, True],
                         ids=["window", "global"])
@pytest.mark.parametrize("pad", [0, 1])
@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_pooling_gives_the_references_zero_sign(nd, last, pad,
                                                    global_pool):
    """F1: a window's zero max is +0 where a +0 is in it, whichever zero
    comes first; the gradient still goes to the window's first zero."""
    x = _zero_windows(nd, last, 10 * nd + pad)
    kw = dict(kernel=(2,) * nd, stride=(2,) * nd, pad=(pad,) * nd,
              pool_type="max", global_pool=global_pool,
              layout=_LAYOUT[(nd, last)])
    out, want, gx, jgx = _vjp_exact(lambda a: jnn.pooling(a, **kw),
                                    lambda a: pops.pooling(a, **kw), x)
    np.testing.assert_array_equal(_np(out), want)
    np.testing.assert_array_equal(np.signbit(_np(out)), np.signbit(want))
    assert (want == 0).any() and not np.signbit(want[want == 0]).all()
    np.testing.assert_array_equal(_np(gx), jgx)


@pytest.mark.parametrize("global_pool", [False, True],
                         ids=["window", "global"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_lp_pooling_gradient_at_zero(p, global_pool):
    """F2: ``|x| ** p`` takes ``jnp.abs``'s gradient, 1 at +-0: the 2x2
    window [0, 1, 2, 0] at p = 1 gives [1, 1, 1, 1]."""
    x = np.array([[[[0.0, 1.0], [2.0, -0.0]], [[-0.0, 0.0], [3.0, -4.0]]]],
                 np.float32)
    kw = dict(kernel=(2, 2), stride=(2, 2), pool_type="lp", p_value=p,
              global_pool=global_pool)
    tx = torch.from_numpy(x.copy()).requires_grad_()
    pops.pooling(tx, **kw).sum().backward()
    jgx = np.asarray(jax.grad(lambda a: jnn.pooling(a, **kw).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(_np(tx.grad), jgx, rtol=1e-6)
    if p == 1:
        np.testing.assert_array_equal(_np(tx.grad), jgx)
        np.testing.assert_array_equal(jgx[0, 0], np.ones((2, 2)))


INT_POOL_CASES = {
    "avg": dict(pool_type="avg"),
    "sum": dict(pool_type="sum"),
    "avg_pad": dict(pool_type="avg", pad=(1, 1)),
    "sum_pad": dict(pool_type="sum", pad=(1, 1)),
    "avg_no_pad_count": dict(pool_type="avg", pad=(1, 1),
                             count_include_pad=False),
    "avg_full_k3": dict(pool_type="avg", kernel=(3, 3),
                        pooling_convention="full"),
    "avg_nhwc": dict(pool_type="avg", layout="NHWC"),
    "sum_1d": dict(pool_type="sum", kernel=(2,), stride=(2,)),
    "avg_3d": dict(pool_type="avg", kernel=(2, 2, 2), stride=(2, 2, 2)),
    "avg_global": dict(pool_type="avg", global_pool=True),
    "max": dict(pool_type="max"),
}


@pytest.mark.parametrize("case", sorted(INT_POOL_CASES))
def test_integer_avg_and_sum_pooling(case):
    """F3: int32 ``avg`` gives float32 and ``sum`` int32, as the
    reference: ``arange(16).reshape(1, 1, 4, 4) - 8``, kernel 2, stride
    2: avg [-5.5, -3.5, 2.5, 4.5], sum [-22, -14, 10, 18]."""
    kw = dict(kernel=(2, 2), stride=(2, 2))
    kw.update(INT_POOL_CASES[case])
    nd = len(kw["kernel"])
    x = (np.arange(2 * 4 ** nd, dtype=np.int32)
         .reshape((1, 2) + (4,) * nd) - 8)
    if kw.get("layout") == "NHWC":
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    want = np.asarray(jnn.pooling(jnp.asarray(x), **kw))
    got = pops.pooling(torch.from_numpy(x), **kw).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)
    if case in ("avg", "sum"):
        ref = {"avg": [-5.5, -3.5, 2.5, 4.5], "sum": [-22, -14, 10, 18]}
        np.testing.assert_array_equal(got[0, 0].ravel(), ref[case])


_INF, _NAN = np.inf, np.nan
D1_CASES = {
    "nan_first": ([_NAN, 1, 2, 3], (2, 2), (2, 2), (0, 0), [0, 0, 0, 1]),
    "inf_nan_inf": ([_INF, _NAN, _INF, -1], (2, 2), (2, 2), (0, 0),
                    [0, 0, 1, 0]),
    "all_minus_inf_padded": ([-_INF] * 9, (3, 3), (2, 2), (1, 1),
                             [0, 0, 0, 0, 1, 0, 0, 0, 0]),
    "two_nans": ([1, _NAN, 3, _NAN], (2, 2), (2, 2), (0, 0), [0, 0, 0, 1]),
    "nan_between_minus_infs": ([-_INF, -_INF, _NAN, -_INF], (2, 2), (2, 2),
                               (0, 0), [0, 0, 0, 1]),
    "finite_ties": ([2, 2, -1, 2], (2, 2), (2, 2), (0, 0), [1, 0, 0, 0]),
    "zero_ties": ([-0.0, 0.0, 0.0, -0.0], (2, 2), (2, 2), (0, 0),
                  [1, 0, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(D1_CASES))
def test_max_pooling_gradient_where_the_max_is_not_finite(case):
    """D1: the reference's selection (XLA's select-and-scatter): start at
    the window's first element (a padded one is -inf and takes nothing),
    move to each next element c when ``not (sel >= c)``."""
    vals, k, s, p, grad = D1_CASES[case]
    side = int(round(len(vals) ** 0.5))
    x = np.array(vals, np.float32).reshape(1, 1, side, side)
    kw = dict(kernel=k, stride=s, pad=p, pool_type="max")
    out, want, gx, jgx = _vjp_exact(lambda a: jnn.pooling(a, **kw),
                                    lambda a: pops.pooling(a, **kw), x)
    np.testing.assert_array_equal(_np(out), want)
    heads = jax.vjp(lambda a: jnn.pooling(a, **kw), jnp.asarray(x))[1](
        jnp.ones(want.shape, jnp.float32))[0]
    np.testing.assert_array_equal(np.asarray(heads).ravel(), grad)
    np.testing.assert_array_equal(_np(gx), jgx)


@pytest.mark.parametrize("conv", ["valid", "full", "same"])
@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_pooling_selection_on_mixed_windows(nd, last, conv):
    """D1 over many windows at once: NaN, +-inf, -inf-only and finite
    ties mixed, overlapping 3-wide windows at stride 2, every head
    carried: the whole gradient equals the reference's."""
    rs = np.random.RandomState(nd * 7 + len(conv))
    pool = np.array([np.nan, np.inf, -np.inf, -np.inf, 1.0, 1.0, -2.0,
                     0.0, -0.0], np.float32)
    x = rs.choice(pool, size=(2, 2) + (5,) * nd)
    x[(0, 1) + (slice(0, 3),) * nd] = -np.inf    # a window of -inf alone
    if last:
        x = np.ascontiguousarray(np.moveaxis(x, 1, -1))
    kw = dict(kernel=(3,) * nd, stride=(2,) * nd,
              pad=(0 if conv == "same" else 1,) * nd, pool_type="max",
              pooling_convention=conv, layout=_LAYOUT[(nd, last)])
    out, want, gx, jgx = _vjp_exact(lambda a: jnn.pooling(a, **kw),
                                    lambda a: pops.pooling(a, **kw), x, 3)
    np.testing.assert_array_equal(_np(out), want)
    np.testing.assert_array_equal(_np(gx), jgx)
    assert np.isnan(want).any() and (want == -np.inf).any()


# ---------------------------------------------------------------------------
# the resize ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["single", "concat", "sum"])
def test_nearest_upsampling_matches_the_reference(mode):
    """Nearest ``UpSampling``: one input, or several at other
    resolutions each brought to ``data[0]``'s size times ``scale``, then
    concatenated or summed."""
    rs = np.random.RandomState(70)
    arrays = [rs.randn(2, 3, 4, 5).astype(np.float32)]
    if mode != "single":
        arrays.append(rs.randn(2, 3, 2, 5).astype(np.float32))
        arrays.append(rs.randn(2, 3, 8, 10).astype(np.float32))
    kw = dict(scale=2, sample_type="nearest", num_args=len(arrays),
              multi_input_mode="sum" if mode == "sum" else "concat")
    _check_vjp(lambda *a: jnn.upsampling(*a, **kw),
               lambda *a: pspatial.upsampling(*a, **kw), arrays, 8, mode)


@pytest.mark.parametrize("scale", [2, 3])
def test_bilinear_upsampling_is_the_grouped_deconvolution(scale):
    k = 2 * scale - scale % 2
    rs = np.random.RandomState(71 + scale)
    x = rs.randn(2, 3, 4, 5).astype(np.float32)
    w = rs.rand(3, 1, k, k).astype(np.float32)
    kw = dict(scale=scale, sample_type="bilinear", num_args=2)
    _check_vjp(lambda *a: jnn.upsampling(*a, **kw),
               lambda *a: pspatial.upsampling(*a, **kw), [x, w], 9,
               f"bilinear x{scale}")
    with pytest.raises(MXNetError, match="weight"):
        pspatial.upsampling(torch.from_numpy(x), scale=2,
                            sample_type="bilinear")


RESIZE_CASES = {
    "down_7x11": dict(height=7, width=11),
    "down_8x8": dict(height=8, width=8),
    "up_23x30": dict(height=23, width=30),
    "scales": dict(scale_height=0.5, scale_width=1.5),
    "align_corners_ignored": dict(height=9, width=5, align_corners=True),
}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_bilinear_resize_matches_the_reference(case):
    """``BilinearResize2D`` as ``jax.image.resize(method="bilinear")``:
    antialiased when it downscales, half-pixel centres, ``align_corners``
    ignored; forward and gradient from a 16x16 input."""
    kw = RESIZE_CASES[case]
    x = np.random.RandomState(80).randn(2, 3, 16, 16).astype(np.float32)
    _check_vjp(lambda a: jnn.bilinear_resize_2d(a, **kw),
               lambda a: pspatial.bilinear_resize_2d(a, **kw), [x], 10,
               case)


def test_bilinear_resize_trap_and_mode_refusal():
    """The trap: torch's plain bilinear (no antialiasing) or with
    ``align_corners=True`` misses the reference's downscale by far."""
    x = np.random.RandomState(81).randn(1, 2, 16, 16).astype(np.float32)
    want = _np(jnn.bilinear_resize_2d(jnp.asarray(x), height=7, width=11))
    t = torch.from_numpy(x)
    for kw in (dict(align_corners=False), dict(align_corners=True)):
        miss = F.interpolate(t, size=(7, 11), mode="bilinear", **kw)
        assert float(np.abs(_np(miss) - want).max()) > 0.3
    with pytest.raises(MXNetError, match="mode"):
        pspatial.bilinear_resize_2d(t, height=4, width=4, mode="odd_scale")
    with mx.cpu():
        got = mx.nd.BilinearResize2D(mx.nd.array(x), height=7, width=11)
    _close_to_max(got.asnumpy(), want, "registered")


@pytest.mark.parametrize("case", ["down_7x11", "up_23x30"])
def test_bilinear_resize_bf16_rounds_once(case):
    """A bf16 input resizes in f32 and rounds once, forward and gradient
    (the f32 resize of the same values, rounded: bit for bit), so no
    bf16 sum is rounded add by add; within 2^-7 of the reference's bf16
    resize, which rounds its weights to bf16 before the product
    (``jax.image.scale_and_translate``)."""
    kw = RESIZE_CASES[case]
    x = np.random.RandomState(82).randn(2, 3, 16, 16).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    t16 = xb.clone().requires_grad_()
    t32 = xb.float().requires_grad_()
    y16 = pspatial.bilinear_resize_2d(t16, **kw)
    y32 = pspatial.bilinear_resize_2d(t32, **kw)
    g = torch.from_numpy(np.random.RandomState(83).randn(*y16.shape)
                         .astype(np.float32)).bfloat16()
    y16.backward(g)
    y32.backward(g.float())
    assert y16.dtype == t16.grad.dtype == torch.bfloat16
    assert torch.equal(y16, y32.bfloat16())
    assert torch.equal(t16.grad, t32.grad.bfloat16())
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jy, pull = jax.vjp(lambda a: jnn.bilinear_resize_2d(a, **kw), jx)
    (jg,) = pull(jnp.asarray(g.float().numpy()).astype(jnp.bfloat16))
    assert jy.dtype == jnp.bfloat16
    for got, want in ((y16, jy), (t16.grad, jg)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= 2.0 ** -7 * np.abs(want).max(), (case, err)


@pytest.mark.parametrize("size", [(), 1, 3, (5, 2), (7,)])
def test_adaptive_avg_pooling_matches_the_reference(size):
    x = np.random.RandomState(90).randn(2, 3, 11, 9).astype(np.float32)
    _check_vjp(lambda a: jcontrib.adaptive_avg_pooling2d(a, output_size=size),
               lambda a: pspatial.adaptive_avg_pooling_2d(
                   a, output_size=size), [x], 11, f"adaptive {size}",
               rtol=1e-6)
    with mx.cpu():
        got = mx.nd.AdaptiveAvgPooling2D(mx.nd.array(x), output_size=size)
    want = jmx.nd.AdaptiveAvgPooling2D(jmx.nd.array(x), output_size=size)
    _close_to_max(got.asnumpy(), want.asnumpy(), "registered", rtol=1e-6)
