"""The spatial group on the card: the ``roi_align`` and ``correlation``
kernels (``kernels/csrc/roi_align.cu``, ``correlation.cu``) against their
plain versions on the same card, forward and backward, at small shapes,
ragged ones (maps not a multiple of the 8 x 32 tile, D^2 not a multiple
of the 24-wide displacement block), bf16 maps, with and without the RoIs'
gradient; their launches per call and per step; a CUDA graph's replays
against the eager call; and every op of the group on the card against
the CPU from the same inputs.

f32 with TF32 off. Kernel against plain, f32: forwards within 1e-6
(``roi_align``) and 1e-5 (``correlation``) of the largest magnitude,
gradients within 1e-5 (sums in other orders, atomics in ``roi_align``'s
backward). bf16 maps: the kernel against the plain version in f32 on the
same bf16-rounded inputs, within 2^-8 (one bf16 rounding of an f32 sum).
Card against CPU: 1e-5, the deformable convolution's weight gradient
1e-4.

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_spatial.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import (correlation, correlation_bwd,
                                     correlation_reference, roi_align,
                                     roi_align_bwd, roi_align_reference)
from mxnet_tpu_torch.kernels._build import kernels_per_call
from mxnet_tpu_torch.ops import contrib, deformable
from mxnet_tpu_torch.ops import nn as ops_nn
from mxnet_tpu_torch.ops import spatial

BF16_TOL = 2.0 ** -8


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with pytest -m cuda on the GPU)")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def rois_for(rs, n_rois, n_img, h, w, scale):
    """RoIs [b, x1, y1, x2, y2] in input pixels (the map is the image
    times ``scale``): some partly outside the map, every 17th of batch
    index -1 (``chip_smoke.py``'s ``_roi_rows`` draws them alike)."""
    x1 = rs.uniform(-0.2 * w, 0.95 * w, n_rois)
    y1 = rs.uniform(-0.2 * h, 0.95 * h, n_rois)
    x2 = x1 + rs.uniform(0.05, 0.6, n_rois) * w
    y2 = y1 + rs.uniform(0.05, 0.6, n_rois) * h
    b = rs.randint(0, n_img, n_rois).astype(np.float64)
    b[::17] = -1
    return (np.stack([b, x1, y1, x2, y2], 1) / [1, scale, scale, scale,
                                                scale]).astype(np.float32)


ROI = {
    # a Faster R-CNN head cut down: stride 16, 14 x 14 bins, sr 2
    "frcnn_small": dict(n=2, c=16, h=19, w=31, rois=40, pooled=(14, 14),
                        scale=1 / 16, sr=2, aligned=False),
    # ragged and aligned, adaptive sample ratio (2), odd grid
    "ragged_aligned": dict(n=3, c=5, h=7, w=13, rois=23, pooled=(3, 5),
                           scale=0.5, sr=-1, aligned=True),
    "sr3": dict(n=1, c=7, h=12, w=9, rois=9, pooled=(7, 7), scale=1.0,
                sr=3, aligned=False),
    # sample ratio past the merged lists (2 sr > 16): per-sample atomics
    "sr9": dict(n=1, c=3, h=10, w=10, rois=5, pooled=(2, 2), scale=1.0,
                sr=9, aligned=False),
}


def _roi_inputs(cfg, seed, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    data = torch.from_numpy(rs.randn(cfg["n"], cfg["c"], cfg["h"], cfg["w"])
                            .astype(np.float32)).to(dtype)
    rois = torch.from_numpy(rois_for(rs, cfg["rois"], cfg["n"],
                                     cfg["h"] / cfg["scale"],
                                     cfg["w"] / cfg["scale"], cfg["scale"]))
    g = torch.from_numpy(rs.randn(cfg["rois"], cfg["c"], *cfg["pooled"])
                         .astype(np.float32))
    return data, rois, g


def _roi_kw(cfg):
    return dict(pooled_size=cfg["pooled"], spatial_scale=cfg["scale"],
                sample_ratio=cfg["sr"], aligned=cfg["aligned"])


@pytest.mark.cuda
@pytest.mark.parametrize("rois_grad", [False, True], ids=["data", "rois"])
@pytest.mark.parametrize("case", sorted(ROI))
def test_roi_align_kernel_against_plain(case, rois_grad, no_tf32):
    """Forward within 1e-6, d data and d rois within 1e-5, one launch of
    each kernel, and no RoI gradient unless asked."""
    _require_card()
    cfg = ROI[case]
    data, rois, g = _roi_inputs(cfg, len(case))
    kw = _roi_kw(cfg)
    got = {}
    for dev in ("cuda", "plain"):
        d = data.cuda().requires_grad_()
        r = rois.cuda().requires_grad_(rois_grad)
        f0, b0 = roi_align.launches, roi_align_bwd.launches
        fn = roi_align if dev == "cuda" else roi_align_reference
        y = fn(d, r, **kw)
        y.backward(g.cuda())
        if dev == "cuda":
            assert (roi_align.launches - f0, roi_align_bwd.launches - b0) \
                == (1, 1)
        got[dev] = (y, d.grad, r.grad)
    assert _rel(got["cuda"][0], got["plain"][0]) <= 1e-6
    assert _rel(got["cuda"][1], got["plain"][1]) <= 1e-5
    if rois_grad:
        assert _rel(got["cuda"][2], got["plain"][2]) <= 1e-5
        assert not got["cuda"][2][:, 0].any()
    else:
        assert got["cuda"][2] is None


@pytest.mark.cuda
def test_roi_align_kernel_bf16(no_tf32):
    """A bf16 map: the f32 output as the plain version's on the same
    values, and d data (summed in f32, cast once) within 2^-8 of the
    plain version's in f32."""
    _require_card()
    cfg = ROI["frcnn_small"]
    data, rois, g = _roi_inputs(cfg, 3, torch.bfloat16)
    kw = _roi_kw(cfg)
    d = data.cuda().requires_grad_()
    y = roi_align(d, rois.cuda(), **kw)
    y.backward(g.cuda())
    assert y.dtype == torch.float32 and d.grad.dtype == torch.bfloat16
    d32 = data.float().cuda().requires_grad_()
    want = roi_align_reference(d32, rois.cuda(), **kw)
    want.backward(g.cuda())
    assert _rel(y, want) <= 1e-6
    assert _rel(d.grad.float(), d32.grad) <= BF16_TOL


@pytest.mark.cuda
def test_roi_align_graph_replays_are_the_eager_call():
    """The forward and backward kernels captured into one CUDA graph and
    replayed: every replay the eager call's output and, to the atomics'
    order, its gradients."""
    _require_card()
    cfg = ROI["frcnn_small"]
    data, rois, g = (t.cuda() for t in _roi_inputs(cfg, 5))
    kw = _roi_kw(cfg)

    def body():
        out = roi_align(data, rois, **kw)
        dd, dr = roi_align_bwd(g, data, rois, kw["pooled_size"],
                               kw["spatial_scale"], kw["sample_ratio"],
                               kw["aligned"], rois_grad=True)
        return out, dd, dr

    eager = body()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    assert kernels_per_call(lambda: roi_align(data, rois, **kw)) == 1
    for _ in range(5):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(outs[0], eager[0])
        assert _rel(outs[1], eager[1]) <= 1e-5
        assert _rel(outs[2], eager[2]) <= 1e-5


CORR = {
    # FlowNetC's parameters at a smaller batch and displacement
    "flownet_small": dict(shape=(2, 16, 24, 40), kernel_size=1,
                          max_displacement=8, stride1=1, stride2=2,
                          pad_size=8),
    # D = 29: two displacement blocks (24 + 5); ragged 8 x 32 tiles
    "two_blocks": dict(shape=(1, 6, 13, 37), kernel_size=1,
                       max_displacement=14, stride1=1, stride2=1,
                       pad_size=14),
    "k3_s2": dict(shape=(2, 5, 17, 19), kernel_size=3, max_displacement=4,
                  stride1=2, stride2=2, pad_size=5),
    "abs": dict(shape=(1, 7, 11, 35), kernel_size=1, max_displacement=3,
                stride1=1, stride2=1, pad_size=3, is_multiply=False),
    "abs_k3": dict(shape=(1, 4, 9, 10), kernel_size=3, max_displacement=2,
                   stride1=1, stride2=2, pad_size=1, is_multiply=False),
}


def _corr_inputs(cfg, seed, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    shape = cfg["shape"]
    a = rs.randn(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    b[:, :, ::3] = a[:, :, ::3]             # ties for |a - b|
    kw = {k: v for k, v in cfg.items() if k != "shape"}
    return torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype), kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CORR))
def test_correlation_kernel_against_plain(case, no_tf32):
    """Forward and both gradients within 1e-5, one launch of each
    kernel."""
    _require_card()
    a, b, kw = _corr_inputs(CORR[case], len(case))
    got = {}
    for dev in ("cuda", "plain"):
        x = a.cuda().requires_grad_()
        y = b.cuda().requires_grad_()
        f0, b0 = correlation.launches, correlation_bwd.launches
        fn = correlation if dev == "cuda" else correlation_reference
        out = fn(x, y, **kw)
        g = torch.from_numpy(np.random.RandomState(1).randn(*out.shape)
                             .astype(np.float32)).cuda()
        out.backward(g)
        if dev == "cuda":
            assert (correlation.launches - f0,
                    correlation_bwd.launches - b0) == (1, 1)
        got[dev] = (out, x.grad, y.grad)
    for k, v in zip(got["cuda"], got["plain"]):
        assert _rel(k, v) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flownet_small", "abs"])
def test_correlation_kernel_bf16(case, no_tf32):
    """bf16 maps: output and gradients in bf16, within 2^-8 of the plain
    version in f32 on the same values."""
    _require_card()
    a, b, kw = _corr_inputs(CORR[case], 7, torch.bfloat16)
    x, y = a.cuda().requires_grad_(), b.cuda().requires_grad_()
    out = correlation(x, y, **kw)
    g = torch.from_numpy(np.random.RandomState(2).randn(*out.shape)
                         .astype(np.float32)).cuda()
    out.backward(g.to(torch.bfloat16))
    assert out.dtype == x.grad.dtype == torch.bfloat16
    x32, y32 = a.float().cuda().requires_grad_(), \
        b.float().cuda().requires_grad_()
    want = correlation_reference(x32, y32, **kw)
    want.backward(g.to(torch.bfloat16).float())
    assert _rel(out.float(), want) <= BF16_TOL
    assert _rel(x.grad.float(), x32.grad) <= BF16_TOL
    assert _rel(y.grad.float(), y32.grad) <= BF16_TOL


@pytest.mark.cuda
def test_correlation_graph_replays_are_the_eager_call():
    """Forward and backward captured into one CUDA graph: each replay the
    eager call's bits (neither kernel has atomics)."""
    _require_card()
    a, b, kw = _corr_inputs(CORR["flownet_small"], 9)
    a, b = a.cuda(), b.cuda()
    args = [kw[k] for k in ("kernel_size", "max_displacement", "stride1",
                            "stride2", "pad_size")]

    def body():
        out = correlation(a, b, **kw)
        return (out,) + correlation_bwd(out, a, b, *args)

    eager = body()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = body()
    assert kernels_per_call(lambda: correlation(a, b, **kw)) == 1
    for _ in range(5):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, e in zip(outs, eager):
            assert torch.equal(o, e)


def _card_vs_cpu(fn, arrays, wrt, kw):
    """``fn`` forward and backward on the card and on the CPU from the
    same f32 arrays: each output and gradient's error relative to the
    CPU's largest magnitude, by name."""
    got = {}
    for dev in ("cuda", "cpu"):
        ts = [torch.from_numpy(a).to(dev).requires_grad_(i in wrt)
              for i, a in enumerate(arrays)]
        y = fn(*ts, **kw)
        g = torch.from_numpy(np.random.RandomState(3).randn(*y.shape)
                             .astype(np.float32)).to(dev, y.dtype)
        y.backward(g)
        got[dev] = [y] + [ts[i].grad for i in wrt]
    return [_rel(a, b) for a, b in zip(got["cuda"], got["cpu"])]


def _op_cases():
    rs = np.random.RandomState(11)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    data = f(2, 8, 12, 14)
    rois = rois_for(rs, 12, 2, 24, 28, 0.5)
    return {
        "ROIAlign": (contrib.roi_align, [data, rois], (0, 1),
                     dict(pooled_size=(4, 3), spatial_scale=0.5,
                          sample_ratio=2)),
        "ROIPooling": (ops_nn.roi_pooling, [data, rois], (0,),
                       dict(pooled_size=(3, 3), spatial_scale=0.5)),
        "PSROIPooling": (deformable.psroi_pooling, [f(2, 18, 12, 14), rois],
                         (0,), dict(spatial_scale=0.5, output_dim=2,
                                    pooled_size=3)),
        "DeformableConvolution": (
            deformable.deformable_convolution,
            [data, f(2, 36, 12, 14) * 1.5, f(6, 4, 3, 3), f(6)],
            (0, 1, 2, 3), dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
                               num_filter=6, num_group=2,
                               num_deformable_group=2)),
        "Correlation": (deformable.correlation, [data, f(2, 8, 12, 14)],
                        (0, 1), dict(kernel_size=3, max_displacement=2,
                                     stride2=2, pad_size=2)),
        "BilinearSampler": (spatial.bilinear_sampler,
                            [data, rs.uniform(-1.2, 1.2, (2, 2, 9, 7))
                             .astype(np.float32)], (0, 1), {}),
        "SpatialTransformer": (spatial.spatial_transformer,
                               [data, np.array([[0.9, 0.1, 0.05, -0.1, 1.1,
                                                 0.02]] * 2, np.float32)],
                               (0, 1), dict(target_shape=(6, 5))),
        # bins whose edges fall on integers (7 rows in 7 bins, 21 in 7):
        # a division by a reciprocal's multiply moves a floor or a ceil
        "ROIPooling_bin_edges": (
            ops_nn.roi_pooling, [data, np.array(
                [[0, 0, 0, 6, 6], [1, 1, 2, 7, 8], [0, 3, 1, 9, 7]],
                np.float32)], (0,), dict(pooled_size=(7, 7),
                                         spatial_scale=1.0)),
        "PSROIPooling_bin_edges": (
            deformable.psroi_pooling, [f(1, 98, 24, 24), np.array(
                [[0, 0, 0, 20, 20], [0, 2, 1, 22, 21]], np.float32)],
            (0,), dict(spatial_scale=1.0, output_dim=2, pooled_size=7)),
        "GridGenerator": (ops_nn.grid_generator, [f(3, 6)], (0,),
                          dict(target_shape=(5, 4))),
        "Crop": (ops_nn.crop, [data], (0,), dict(h_w=(5, 6),
                                                 center_crop=True)),
        "im2col": (ops_nn.im2col, [data], (0,),
                   dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2),
                        pad=(1, 2))),
        "col2im": (ops_nn.col2im, [f(2, 8 * 9, 42)], (0,),
                   dict(output_size=(12, 14), kernel=(3, 3), stride=(2, 2),
                        pad=(1, 1))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_op_on_the_card(name, no_tf32):
    """Each op of the group on the card against the CPU: output and every
    gradient within 1e-5 of the CPU's largest (the deformable
    convolution's weight gradient 1e-4)."""
    _require_card()
    fn, arrays, wrt, kw = _op_cases()[name]
    errs = _card_vs_cpu(fn, arrays, wrt, kw)
    tols = [1e-5] * len(errs)
    if name == "DeformableConvolution":
        tols[3] = 1e-4
    assert all(e <= t for e, t in zip(errs, tols)), errs
