"""The spatial group of ops (ROADMAP.md, port queue 1, item 4 (c)) in the
port against the JAX package's on the CPU: ``ROIAlign``, ``ROIPooling``,
``PSROIPooling``, ``DeformableConvolution``, ``Correlation``,
``BilinearSampler``, ``SpatialTransformer``, ``GridGenerator``, ``Crop``,
``im2col`` and ``col2im``, forward and every gradient the reference takes
(``jax.vjp``), from numpy inputs drawn from a seed; and the plain versions
of the two hand-written kernels (``roi_align_reference``,
``correlation_reference``), which the card tests hold the kernels
against.

Tolerances, each relative to the largest magnitude of the reference's
value: forwards and gradients 1e-5 (f32 sums in other orders; XLA may
contract a product and a sum into one rounding); ``ROIPooling``'s forward
bit for bit (a max selects) and its gradients 1e-6; the deformable
convolution's weight gradient 1e-4 (a sum of a few thousand products);
``im2col`` bit for bit (it copies). Output dtypes equal the reference's
for f32 and bf16 inputs.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import contrib as jcontrib
from mxnet_tpu.ops import deformable as jdeform
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import spatial as jspatial

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.kernels import correlation_reference, roi_align_reference
from mxnet_tpu_torch.ops import contrib as pcontrib
from mxnet_tpu_torch.ops import deformable as pdeform
from mxnet_tpu_torch.ops import nn as pnn
from mxnet_tpu_torch.ops import spatial as pspatial
from mxnet_tpu_torch.ops.registry import get_op


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    return float(np.abs(got - want).max()) / scale if want.size else 0.0


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _both(jfn, pfn, arrays, wrt, seed=0):
    """Run ``jfn`` on jnp arrays and ``pfn`` on torch tensors made from the
    same numpy ``arrays``; the head gradient is drawn from ``seed``.
    Returns (reference out, port out, {i: (reference grad, port grad)}
    for each input index in ``wrt``)."""
    jin = [jnp.asarray(a) for a in arrays]
    jout, pull = jax.vjp(jfn, *jin)
    g = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jgrads = pull(jnp.asarray(g).astype(jout.dtype))
    tin = [torch.from_numpy(np.array(a)).requires_grad_(i in wrt)
           for i, a in enumerate(arrays)]
    tout = pfn(*tin)
    tout.backward(torch.from_numpy(g).to(tout.dtype))
    grads = {i: (np.asarray(jgrads[i]), _np(tin[i].grad)) for i in wrt}
    return np.asarray(jout), tout, grads


def _assert_close(jout, tout, grads, tol, gtol=None, what=""):
    assert str(tout.dtype).split(".")[-1] == str(jout.dtype), \
        (what, tout.dtype, jout.dtype)
    assert _rel(_np(tout), jout) <= tol, (what, _rel(_np(tout), jout))
    for i, (jg, pg) in grads.items():
        assert _rel(pg, jg) <= (gtol or tol), (what, i, _rel(pg, jg))


def _map(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _rois(rs, n_rois, n_img, h, w, scale=1.0, extra=()):
    """RoIs [b, x1, y1, x2, y2] in input pixels (``scale`` maps them to
    the map): some inside, some partly outside, some degenerate, batch
    indices in range plus ``extra``."""
    out = []
    for i in range(n_rois):
        x1 = rs.uniform(-0.3 * w, 0.9 * w) / scale
        y1 = rs.uniform(-0.3 * h, 0.9 * h) / scale
        x2 = x1 + rs.uniform(0.2, 0.8 * w) / scale
        y2 = y1 + rs.uniform(0.2, 0.8 * h) / scale
        out.append([rs.randint(0, n_img), x1, y1, x2, y2])
    out = np.array(out, np.float32)
    for j, b in enumerate(extra):
        out[j, 0] = b
    return out


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aligned", [False, True], ids=["plain", "aligned"])
@pytest.mark.parametrize("sample_ratio", [2, -1, 3])
def test_roi_align(aligned, sample_ratio):
    """Forward and the gradients to the map and to the RoIs: RoIs partly
    outside the map, batch indices -1 (the last image), -2, 1.7 and -0.5
    (truncated), 5 and -7 (out of range: clamped after one wrap);
    ``sample_ratio <= 0`` is 2."""
    rs = np.random.RandomState(sample_ratio + 2 + 10 * aligned)
    data = _map(rs, 2, 3, 9, 11)
    rois = _rois(rs, 9, 2, 9 * 4, 11 * 4, 1.0,
                 extra=(-1, -2, 1.7, -0.5, 5, -7))
    kw = dict(pooled_size=(3, 4), spatial_scale=0.25,
              sample_ratio=sample_ratio, aligned=aligned)
    jout, tout, grads = _both(
        lambda d, r: jcontrib.roi_align(d, r, **kw),
        lambda d, r: pcontrib.roi_align(d, r, **kw), [data, rois], (0, 1))
    _assert_close(jout, tout, grads, 1e-5)
    # the batch column carries no gradient, the corners do
    jg, pg = grads[1]
    assert not np.any(pg[:, 0]) and not np.any(jg[:, 0])
    assert np.abs(pg[:, 1:]).max() > 0


def test_roi_align_sample_at_integer_positions():
    """Samples exactly on pixel rows and columns (the clip's half gradient
    at its bound) and RoIs of the least size (the max's half gradient at a
    tie), ``aligned`` off: size 1."""
    rs = np.random.RandomState(4)
    data = _map(rs, 1, 2, 8, 8)
    rois = np.array([[0, 1.5, 1.5, 5.5, 5.5], [0, 2, 2, 3, 3],
                     [0, 6.75, 0.25, 7.75, 1.25], [0, -2, -3, 9, 10]],
                    np.float32)
    kw = dict(pooled_size=(2, 2), spatial_scale=1.0, sample_ratio=2)
    jout, tout, grads = _both(
        lambda d, r: jcontrib.roi_align(d, r, **kw),
        lambda d, r: pcontrib.roi_align(d, r, **kw), [data, rois], (0, 1))
    _assert_close(jout, tout, grads, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_dtype(dtype):
    """A bf16 map gives an f32 output, as the reference's f32 weights
    promote it."""
    rs = np.random.RandomState(5)
    data = _map(rs, 1, 2, 6, 6)
    rois = np.array([[0, 0.5, 0.5, 4.0, 5.0]], np.float32)
    want = jcontrib.roi_align(jnp.asarray(data).astype(dtype),
                              jnp.asarray(rois), pooled_size=(2, 2))
    got = pcontrib.roi_align(torch.from_numpy(data).to(getattr(torch,
                                                               dtype)),
                             torch.from_numpy(rois), pooled_size=(2, 2))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "float32"
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


def test_roi_align_reference_is_the_references():
    """The kernel's plain version, called directly, at a shape whose RoIs
    span two chunks of its RoI loop."""
    kmod = importlib.import_module("mxnet_tpu_torch.kernels.roi_align")

    rs = np.random.RandomState(6)
    data = _map(rs, 2, 4, 7, 9)
    rois = _rois(rs, 7, 2, 28, 36, extra=(-1,))
    kw = dict(pooled_size=(3, 3), spatial_scale=0.25, sample_ratio=2,
              aligned=True)
    want = jcontrib.roi_align(jnp.asarray(data), jnp.asarray(rois), **kw)
    saved = kmod._CHUNK_ELEMS
    kmod._CHUNK_ELEMS = 3 * 3 * 4 * 4 * 3        # three RoIs a chunk
    try:
        got = roi_align_reference(torch.from_numpy(data),
                                  torch.from_numpy(rois), **kw)
    finally:
        kmod._CHUNK_ELEMS = saved
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------


def test_roi_pooling():
    """Bit for bit forward, gradients within 1e-6: RoIs partly outside
    the map, RoIs smaller than the grid (overlapping bins), empty bins
    (0), batch -1 (the last image) and indices out of range (a zero
    output, ``jnp.take``'s fill)."""
    rs = np.random.RandomState(7)
    data = _map(rs, 2, 3, 10, 12)
    rois = np.concatenate([_rois(rs, 6, 2, 20, 24, 0.5),
                           np.array([[-1, 30, 30, 40, 40],
                                     [1, 2, 2, 3, 3],
                                     [5, 1, 1, 8, 8],
                                     [-3, 1, 1, 8, 8],
                                     [-1, -2.5, 1, 6, 30],
                                     [0, 0, 0, 13, 13]], np.float32)])
    kw = dict(pooled_size=(3, 2), spatial_scale=0.5)
    jout, tout, grads = _both(lambda d, r: jnn.roi_pooling(d, r, **kw),
                              lambda d, r: pnn.roi_pooling(d, r, **kw),
                              [data, rois], (0,))
    np.testing.assert_array_equal(_np(tout), jout)
    _assert_close(jout, tout, grads, 0.0, gtol=1e-6)
    assert not np.any(_np(tout)[6])            # a bin past the map: 0
    assert not np.any(_np(tout)[8]) and not np.any(_np(tout)[9])


def test_roi_pooling_ties_split_the_gradient():
    """Tied maxima share their bin's gradient evenly at each of the two
    max stages, as JAX's max does: two equal maxima in one row of a bin
    get half each, and a maximum tied across two rows half each too."""
    data = np.zeros((1, 1, 4, 4), np.float32)
    data[0, 0, 0, 0] = data[0, 0, 0, 1] = 3.0       # one row, a tie
    data[0, 0, 2, 2] = data[0, 0, 3, 3] = 5.0       # two rows, a tie
    rois = np.array([[0, 0, 0, 1, 1], [0, 2, 2, 3, 3]], np.float32)
    kw = dict(pooled_size=(1, 1), spatial_scale=1.0)
    jout, tout, grads = _both(lambda d, r: jnn.roi_pooling(d, r, **kw),
                              lambda d, r: pnn.roi_pooling(d, r, **kw),
                              [data, rois], (0,), seed=1)
    np.testing.assert_array_equal(_np(tout), jout)
    jg, pg = grads[0]
    np.testing.assert_allclose(pg, jg, rtol=1e-6, atol=0)
    g = np.random.RandomState(1).randn(2, 1, 1, 1).astype(np.float32)
    np.testing.assert_allclose(pg[0, 0, 0, :2], [g[0, 0, 0, 0] / 2] * 2,
                               rtol=1e-6)
    np.testing.assert_allclose([pg[0, 0, 2, 2], pg[0, 0, 3, 3]],
                               [g[1, 0, 0, 0] / 2] * 2, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_pooling_dtype(dtype):
    rs = np.random.RandomState(8)
    data = _map(rs, 1, 2, 6, 6)
    rois = np.array([[0, 0, 0, 4, 5]], np.float32)
    want = jnn.roi_pooling(jnp.asarray(data).astype(dtype), jnp.asarray(rois),
                           pooled_size=(2, 2))
    got = pnn.roi_pooling(torch.from_numpy(data).to(getattr(torch, dtype)),
                          torch.from_numpy(rois), pooled_size=(2, 2))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# PSROIPooling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group_size", [0, 3], ids=["gs=ps", "gs=3"])
def test_psroi_pooling(group_size):
    """R-FCN's pooling with ``group_size`` equal to and apart from
    ``pooled_size`` (4): the routed channel groups, half-to-even corners,
    bins past the map, batch -1."""
    rs = np.random.RandomState(9 + group_size)
    gs = group_size or 4
    data = _map(rs, 2, 2 * gs * gs, 9, 10)
    rois = np.concatenate([_rois(rs, 5, 2, 18, 20, 0.5, extra=(-1,)),
                           np.array([[0, 2.5, 3.5, 4.5, 40],
                                     [1, 30, 30, 40, 40]], np.float32)])
    kw = dict(spatial_scale=0.5, output_dim=2, pooled_size=4,
              group_size=group_size)
    jout, tout, grads = _both(lambda d, r: jdeform.psroi_pooling(d, r, **kw),
                              lambda d, r: pdeform.psroi_pooling(d, r, **kw),
                              [data, rois], (0,))
    _assert_close(jout, tout, grads, 1e-5)


def test_psroi_pooling_bin_edges_on_integers():
    """Bins whose edges fall on integers (21 pixels in 7 bins): a
    division formed as a reciprocal's multiply would move a ``ceil``."""
    rs = np.random.RandomState(20)
    data = _map(rs, 1, 2 * 49, 24, 24)
    rois = np.array([[0, 0, 0, 20, 20], [0, 2, 1, 22, 21]], np.float32)
    kw = dict(spatial_scale=1.0, output_dim=2, pooled_size=7)
    jout, tout, grads = _both(lambda d, r: jdeform.psroi_pooling(d, r, **kw),
                              lambda d, r: pdeform.psroi_pooling(d, r, **kw),
                              [data, rois], (0,))
    _assert_close(jout, tout, grads, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_psroi_pooling_dtype(dtype):
    rs = np.random.RandomState(10)
    data = _map(rs, 1, 4, 5, 5)
    rois = np.array([[0, 0, 0, 4, 4]], np.float32)
    kw = dict(output_dim=1, pooled_size=2)
    want = jdeform.psroi_pooling(jnp.asarray(data).astype(dtype),
                                 jnp.asarray(rois), **kw)
    got = pdeform.psroi_pooling(torch.from_numpy(data).to(getattr(torch,
                                                                  dtype)),
                                torch.from_numpy(rois), **kw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _rel(_np(got), np.asarray(want, np.float32)) <= 1e-5


# ---------------------------------------------------------------------------
# Correlation
# ---------------------------------------------------------------------------

CORR = {
    # FlowNetC's parameters at a smaller displacement
    "flownet": dict(kernel_size=1, max_displacement=4, stride1=1, stride2=2,
                    pad_size=4),
    "k3_stride1_2": dict(kernel_size=3, max_displacement=2, stride1=2,
                         stride2=1, pad_size=3),
    "abs": dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1,
                pad_size=2, is_multiply=False),
    "abs_k3": dict(kernel_size=3, max_displacement=3, stride1=1, stride2=3,
                   pad_size=2, is_multiply=False),
    "unpadded": dict(kernel_size=1, max_displacement=1, stride1=1, stride2=1,
                     pad_size=0),
}


@pytest.mark.parametrize("case", sorted(CORR))
def test_correlation(case):
    """Forward and both gradients, through the op and through the
    kernel's plain version; ``abs`` cases hold a map equal to the other
    in places (JAX's |x| gradient is +1 at 0)."""
    rs = np.random.RandomState(len(case))
    a = _map(rs, 2, 5, 9, 11)
    b = _map(rs, 2, 5, 9, 11)
    b[:, :, ::2] = a[:, :, ::2]
    kw = CORR[case]
    for pfn in (lambda x, y: pdeform.correlation(x, y, **kw),
                lambda x, y: correlation_reference(x, y, **kw)):
        jout, tout, grads = _both(
            lambda x, y: jdeform.correlation(x, y, **kw), pfn, [a, b],
            (0, 1))
        _assert_close(jout, tout, grads, 1e-5, what=case)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_correlation_dtype(dtype):
    rs = np.random.RandomState(11)
    a, b = _map(rs, 1, 3, 6, 6), _map(rs, 1, 3, 6, 6)
    kw = dict(max_displacement=1, pad_size=1)
    want = jdeform.correlation(jnp.asarray(a).astype(dtype),
                               jnp.asarray(b).astype(dtype), **kw)
    got = pdeform.correlation(torch.from_numpy(a).to(getattr(torch, dtype)),
                              torch.from_numpy(b).to(getattr(torch, dtype)),
                              **kw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _rel(_np(got), np.asarray(want, np.float32)) <= \
        (1e-5 if dtype == "float32" else 2.0 ** -8)


# ---------------------------------------------------------------------------
# DeformableConvolution
# ---------------------------------------------------------------------------

DCN = {
    "grouped_dilated": dict(shape=(2, 4, 9, 10), num_filter=6, kernel=(3, 3),
                            stride=(1, 1), dilate=(2, 2), pad=(2, 2),
                            num_group=2, num_deformable_group=2),
    "strided": dict(shape=(1, 4, 8, 9), num_filter=3, kernel=(2, 3),
                    stride=(2, 1), dilate=(1, 1), pad=(1, 0), num_group=1,
                    num_deformable_group=2),
}


@pytest.mark.parametrize("offsets", ["fractional", "integer"])
@pytest.mark.parametrize("case", sorted(DCN))
def test_deformable_convolution(case, offsets):
    """Forward within 1e-5 and the gradients to data, offset and bias
    within 1e-5, the weight's within 1e-4; offsets fractional (samples
    between pixels and past the map) and integer (on pixels)."""
    cfg = dict(DCN[case])
    shape = cfg.pop("shape")
    rs = np.random.RandomState(len(case) + len(offsets))
    b, c, h, w = shape
    kh, kw = cfg["kernel"]
    ho = (h + 2 * cfg["pad"][0] - (cfg["dilate"][0] * (kh - 1) + 1)) \
        // cfg["stride"][0] + 1
    wo = (w + 2 * cfg["pad"][1] - (cfg["dilate"][1] * (kw - 1) + 1)) \
        // cfg["stride"][1] + 1
    g = cfg["num_deformable_group"]
    off = rs.randn(b, 2 * g * kh * kw, ho, wo).astype(np.float32) * 1.7
    if offsets == "integer":
        off = np.round(off)
    data = _map(rs, *shape)
    weight = _map(rs, cfg["num_filter"], c // cfg["num_group"], kh, kw)
    bias = _map(rs, cfg["num_filter"])
    jout, tout, grads = _both(
        lambda d, o, wt, bs: jdeform.deformable_convolution(d, o, wt, bs,
                                                            **cfg),
        lambda d, o, wt, bs: pdeform.deformable_convolution(d, o, wt, bs,
                                                            **cfg),
        [data, off, weight, bias], (0, 1, 2, 3))
    weight_grad = grads.pop(2)
    _assert_close(jout, tout, grads, 1e-5)
    assert _rel(weight_grad[1], weight_grad[0]) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deformable_convolution_dtype(dtype):
    rs = np.random.RandomState(12)
    data = _map(rs, 1, 2, 5, 5)
    off = _map(rs, 1, 8, 4, 4)
    wt = _map(rs, 3, 2, 2, 2)
    kw = dict(kernel=(2, 2), num_filter=3, no_bias=True)
    dt = getattr(torch, dtype)
    want = jdeform.deformable_convolution(
        jnp.asarray(data).astype(dtype), jnp.asarray(off).astype(dtype),
        jnp.asarray(wt).astype(dtype), **kw)
    got = pdeform.deformable_convolution(
        torch.from_numpy(data).to(dt), torch.from_numpy(off).to(dt),
        torch.from_numpy(wt).to(dt), **kw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert _rel(_np(got), np.asarray(want, np.float32)) <= \
        (1e-5 if dtype == "float32" else 2.0 ** -8)


# ---------------------------------------------------------------------------
# BilinearSampler, SpatialTransformer, GridGenerator
# ---------------------------------------------------------------------------


def test_bilinear_sampler():
    """The zero border (grids past [-1, 1] on every side) and the
    gradients to data and grid."""
    rs = np.random.RandomState(13)
    data = _map(rs, 2, 3, 6, 7)
    grid = rs.uniform(-1.4, 1.4, (2, 2, 5, 4)).astype(np.float32)
    grid[0, :, 0, 0] = [-1.0, -1.0]
    grid[0, :, 0, 1] = [1.0, 1.0]
    jout, tout, grads = _both(jspatial.bilinear_sampler,
                              pspatial.bilinear_sampler, [data, grid],
                              (0, 1))
    _assert_close(jout, tout, grads, 1e-5)
    far = np.full((1, 2, 1, 1), 3.0, np.float32)
    out = pspatial.bilinear_sampler(torch.from_numpy(data[:1]),
                                    torch.from_numpy(far))
    assert not out.abs().sum()


def test_spatial_transformer():
    """The gradient reaches ``loc`` (and data); a transform other than
    affine + bilinear raises as the reference does."""
    rs = np.random.RandomState(14)
    data = _map(rs, 2, 3, 6, 7)
    loc = (np.array([1, 0, 0, 0, 1, 0], np.float32)
           + rs.randn(2, 6).astype(np.float32) * 0.3)
    kw = dict(target_shape=(4, 5))
    jout, tout, grads = _both(
        lambda d, l: jspatial.spatial_transformer(d, l, **kw),
        lambda d, l: pspatial.spatial_transformer(d, l, **kw), [data, loc],
        (0, 1))
    _assert_close(jout, tout, grads, 1e-5)
    assert np.abs(grads[1][1]).max() > 0
    with pytest.raises(NotImplementedError, match="affine"):
        pspatial.spatial_transformer(torch.from_numpy(data),
                                     torch.from_numpy(loc),
                                     target_shape=(4, 5),
                                     transform_type="warp")


def test_grid_generator():
    """The affine grid in float64 (the reference's x64 promotion) and its
    gradient to the thetas."""
    rs = np.random.RandomState(15)
    theta = rs.randn(3, 6).astype(np.float32)
    kw = dict(transform_type="affine", target_shape=(4, 5))
    jout, tout, grads = _both(lambda t: jnn.grid_generator(t, **kw),
                              lambda t: pnn.grid_generator(t, **kw),
                              [theta], (0,))
    _assert_close(jout, tout, grads, 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sampling_dtypes(dtype):
    """BilinearSampler and SpatialTransformer give f32, GridGenerator
    f64, whatever the input's dtype, as the reference does."""
    rs = np.random.RandomState(16)
    data = _map(rs, 1, 2, 4, 4)
    grid = rs.uniform(-1, 1, (1, 2, 3, 3)).astype(np.float32)
    loc = rs.randn(1, 6).astype(np.float32)
    jd, td = jnp.asarray(data).astype(dtype), \
        torch.from_numpy(data).to(getattr(torch, dtype))
    pairs = [
        (jspatial.bilinear_sampler(jd, jnp.asarray(grid).astype(dtype)),
         pspatial.bilinear_sampler(td, torch.from_numpy(grid).to(td.dtype))),
        (jspatial.spatial_transformer(jd, jnp.asarray(loc).astype(dtype),
                                      target_shape=(3, 3)),
         pspatial.spatial_transformer(td, torch.from_numpy(loc).to(td.dtype),
                                      target_shape=(3, 3))),
        (jnn.grid_generator(jnp.asarray(loc).astype(dtype),
                            target_shape=(3, 3)),
         pnn.grid_generator(torch.from_numpy(loc).to(td.dtype),
                            target_shape=(3, 3)))]
    for want, got in pairs:
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert _rel(_np(got), np.asarray(want, np.float64)) <= 1e-5


# ---------------------------------------------------------------------------
# Crop, im2col, col2im
# ---------------------------------------------------------------------------


def test_crop_modes():
    """``h_w`` at an offset, centred, to a ``crop_like`` input (with and
    without ``center_crop``), and the reference's error without ``h_w``;
    the gradient is the crop's scatter."""
    rs = np.random.RandomState(17)
    data = _map(rs, 2, 3, 9, 8)
    like = _map(rs, 2, 1, 4, 5)
    cases = [([data], dict(h_w=(4, 3), offset=(2, 1))),
             ([data], dict(h_w=(5, 4), center_crop=True)),
             ([data, like], dict(num_args=2)),
             ([data, like], dict(num_args=2, center_crop=True))]
    for arrays, kw in cases:
        jout, tout, grads = _both(lambda *xs: jnn.crop(*xs, **kw),
                                  lambda *xs: pnn.crop(*xs, **kw), arrays,
                                  (0,))
        _assert_close(jout, tout, grads, 0.0, what=str(kw))
    for fn, arr in ((jnn.crop, jnp.asarray(data)),
                    (pnn.crop, torch.from_numpy(data))):
        with pytest.raises(ValueError, match="h_w must be given"):
            fn(arr)


IM2COL = {
    "1d_dilated": ((2, 3, 13), dict(kernel=(3,), stride=(2,), dilate=(2,),
                                    pad=(1,))),
    "2d": ((2, 3, 7, 8), dict(kernel=(3, 2), stride=(1, 2), pad=(1, 0))),
    "2d_dilated": ((1, 2, 9, 9), dict(kernel=(3, 3), dilate=(2, 3),
                                      pad=(2, 1))),
    "3d_dilated": ((1, 2, 5, 6, 7), dict(kernel=(2, 3, 2), stride=(1, 2, 1),
                                         dilate=(2, 1, 2), pad=(1, 1, 0))),
}


@pytest.mark.parametrize("case", sorted(IM2COL))
def test_im2col_and_col2im(case):
    """``im2col`` bit for bit with its channel-major features, its
    gradient, ``col2im`` and its gradient within 1e-5, and the two
    adjoint: <im2col(x), y> = <x, col2im(y)>."""
    shape, kw = IM2COL[case]
    rs = np.random.RandomState(len(case))
    x = _map(rs, *shape)
    jout, tout, grads = _both(lambda t: jnn.im2col(t, **kw),
                              lambda t: pnn.im2col(t, **kw), [x], (0,))
    np.testing.assert_array_equal(_np(tout), jout)
    _assert_close(jout, tout, grads, 1e-5)
    y = _map(rs, *jout.shape)
    ckw = dict(kw, output_size=shape[2:])
    jout2, tout2, grads2 = _both(lambda t: jnn.col2im(t, **ckw),
                                 lambda t: pnn.col2im(t, **ckw), [y], (0,))
    _assert_close(jout2, tout2, grads2, 1e-5)
    lhs = float((_np(tout).astype(np.float64) * y).sum())
    rhs = float((x.astype(np.float64) * _np(tout2)).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_and_im2col_dtypes(dtype):
    rs = np.random.RandomState(18)
    x = _map(rs, 1, 2, 5, 5)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    cols = pnn.im2col(tx, kernel=(2, 2))
    pairs = [(jnn.crop(jx, h_w=(3, 3)), pnn.crop(tx, h_w=(3, 3))),
             (jnn.im2col(jx, kernel=(2, 2)), cols),
             (jnn.col2im(jnn.im2col(jx, kernel=(2, 2)), output_size=(5, 5),
                         kernel=(2, 2)),
              pnn.col2im(cols, output_size=(5, 5), kernel=(2, 2)))]
    for want, got in pairs:
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert _rel(_np(got), np.asarray(want, np.float32)) <= 1e-5


# ---------------------------------------------------------------------------
# the names, and the NDArray path
# ---------------------------------------------------------------------------

NAMES = ["ROIPooling", "Correlation", "correlation", "BilinearSampler",
         "SpatialTransformer", "GridGenerator", "Crop", "im2col", "col2im",
         "ROIAlign", "psroipooling", "DeformableConvolution",
         "_contrib_ROIAlign", "_contrib_PSROIPooling",
         "_contrib_DeformableConvolution"]
CONTRIB = ["ROIAlign", "PSROIPooling", "DeformableConvolution"]


@pytest.mark.parametrize("name", NAMES)
def test_the_names_and_aliases(name):
    """Each name the reference registers for the group is an ``mx.nd``
    wrapper of one op, the alias and the name the same op."""
    from mxnet_tpu.ops.registry import get_op as jget

    assert hasattr(mx.nd, name) and hasattr(jmx.nd, name)
    same = {"correlation": "Correlation", "ROIAlign": "_contrib_ROIAlign",
            "psroipooling": "_contrib_PSROIPooling",
            "DeformableConvolution": "_contrib_DeformableConvolution"}
    if name in same:
        assert get_op(name) is get_op(same[name])
        assert jget(name) is jget(same[name])


@pytest.mark.parametrize("name", CONTRIB)
def test_the_contrib_names(name):
    assert hasattr(mx.nd.contrib, name) and hasattr(jmx.nd.contrib, name)
    assert getattr(mx.nd.contrib, name) is getattr(mx.nd,
                                                   "_contrib_" + name)


def test_roi_align_through_ndarray_autograd():
    """``mx.nd.contrib.ROIAlign`` under ``autograd.record()`` and
    ``backward()``: the output and both inputs' gradients as the
    reference's NDArray path gives them."""
    rs = np.random.RandomState(19)
    data = _map(rs, 2, 3, 8, 8)
    rois = _rois(rs, 4, 2, 32, 32, extra=(-1,))
    g = _map(rs, 4, 3, 2, 2)
    kw = dict(pooled_size=(2, 2), spatial_scale=0.25, sample_ratio=2)
    got = {}
    for m, ag in ((mx, autograd), (jmx, jmx.autograd)):
        d = m.nd.array(data, ctx=m.cpu())
        r = m.nd.array(rois, ctx=m.cpu())
        d.attach_grad()
        r.attach_grad()
        with ag.record():
            y = m.nd.contrib.ROIAlign(d, r, **kw)
        y.backward(m.nd.array(g, ctx=m.cpu()))
        got[m] = [y.asnumpy(), d.grad.asnumpy(), r.grad.asnumpy()]
    for a, b in zip(got[mx], got[jmx]):
        assert _rel(a, b) <= 1e-5
