"""The vision ops, layers and cells on the card against the CPU: the
1-D/2-D/3-D, grouped, depthwise and dilated convolutions and the
transposed ones (cuDNN) in both channel positions, every pooling type
and convention, the resize ops (the antialiased bilinear resize on the
card), a convolutional LSTM cell unrolled, and a MobileNet v3 block's
hybridized graph against its eager forward.

f32 with TF32 off: every output and gradient within 1e-5 of its largest
magnitude. bf16: the card on bf16 inputs against the CPU in f32 on the
same (bf16-rounded) inputs, within 2^-6 of the largest magnitude (one
bf16 rounding of the output and of sums of up to a few hundred
products).

Marked ``cuda``: each test skips where there is no CUDA card. This file
imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_vision.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import nn as ops_nn
from mxnet_tpu_torch.ops import spatial

F32_TOL, BF16_TOL = 1e-5, 2.0 ** -6


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
    assert a.shape == b.shape
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin)
    return float((a[fin] - b[fin]).abs().max()
                 / b[fin].abs().max().clamp_min(1e-30))


def _both(fn, arrays, kw, dtype):
    """``fn`` forward and backward on the card in ``dtype`` and on the
    CPU in f32 over the same ``dtype``-rounded inputs: the worst error
    relative to the largest magnitude over the output and gradients."""
    base = [torch.from_numpy(a).to(dtype) for a in arrays]
    got = {}
    for dev, dt in (("cuda", dtype), ("cpu", torch.float32)):
        ts = [b.to(dev, dt).requires_grad_() for b in base]
        y = fn(*ts, **kw)
        dy = torch.from_numpy(np.random.RandomState(2).randn(*y.shape)
                              .astype(np.float32)).to(dtype).to(dev, dt)
        y.backward(dy)
        got[dev] = [y] + [t.grad for t in ts]
    return max(_rel(a, b) for a, b in zip(got["cuda"], got["cpu"]))


def _arr(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


CONV = {
    "1d_dilated": ((4, 16, 50), (32, 16, 5), dict(kernel=(5,), pad=(4,),
                                                  dilate=(2,))),
    "2d_grouped_dilated": ((4, 32, 20, 20), (32, 8, 3, 3),
                           dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2),
                                num_group=4)),
    "2d_depthwise_s2": ((8, 96, 28, 28), (96, 1, 3, 3),
                        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             num_group=96)),
    "2d_depthwise_5x5": ((8, 72, 28, 28), (72, 1, 5, 5),
                         dict(kernel=(5, 5), pad=(2, 2), num_group=72)),
    "3d": ((2, 8, 8, 16, 16), (16, 8, 3, 3, 3),
           dict(kernel=(3, 3, 3), pad=(1, 1, 1))),
    "3d_depthwise": ((2, 16, 6, 12, 12), (16, 1, 3, 3, 3),
                     dict(kernel=(3, 3, 3), pad=(1, 1, 1), num_group=16)),
}
_LAST = {3: "NWC", 4: "NHWC", 5: "NDHWC"}


def _to_last(shape):
    return (shape[0],) + tuple(shape[2:]) + (shape[1],)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("case", sorted(CONV))
def test_convolution_on_the_card(case, last, dtype, no_tf32):
    """cuDNN's grouped, depthwise, dilated and 3-D convolutions, with
    their data, weight and bias gradients, channels first and last."""
    _require_card()
    xs, ws, kw = CONV[case]
    rs = np.random.RandomState(len(case))
    x = _arr(rs, *(_to_last(xs) if last else xs))
    w = _arr(rs, *ws) / np.sqrt(np.prod(ws[1:]))
    b = _arr(rs, ws[0])
    kw = dict(kw, num_filter=ws[0],
              layout=_LAST[len(xs)] if last else None)
    dt = getattr(torch, dtype)
    err = _both(ops_nn.convolution, [x, w, b], kw, dt)
    assert err <= (F32_TOL if dtype == "float32" else BF16_TOL), err


DECONV = {
    "1d": ((4, 16, 30), (16, 8, 4), dict(kernel=(4,), stride=(2,),
                                         pad=(1,), adj=(1,))),
    "2d_grouped": ((2, 16, 12, 13), (16, 4, 3, 4),
                   dict(kernel=(3, 4), stride=(2, 2), pad=(1, 1),
                        num_group=2)),
    "2d_depthwise_upsample": ((2, 32, 14, 14), (32, 1, 4, 4),
                              dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                                   num_group=32)),
    "3d_dilated": ((2, 4, 5, 6, 6), (4, 6, 3, 3, 3),
                   dict(kernel=(3, 3, 3), stride=(1, 2, 2),
                        dilate=(2, 1, 1))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("case", sorted(DECONV))
def test_deconvolution_on_the_card(case, last, dtype, no_tf32):
    """``Deconvolution`` (the flipped weight through cuDNN's transposed
    convolution) and its gradients."""
    _require_card()
    xs, ws, kw = DECONV[case]
    rs = np.random.RandomState(len(case) + 50)
    x = _arr(rs, *(_to_last(xs) if last else xs))
    w = _arr(rs, *ws) / np.sqrt(np.prod(ws[1:]))
    g = kw.get("num_group", 1)
    b = _arr(rs, ws[1] * g)
    kw = dict(kw, num_filter=ws[1] * g, no_bias=False,
              layout=_LAST[len(xs)] if last else None)
    err = _both(ops_nn.deconvolution, [x, w, b], kw, getattr(torch, dtype))
    assert err <= (F32_TOL if dtype == "float32" else BF16_TOL), err


POOL = {
    "max_valid_pad": ((4, 16, 33, 35), dict(kernel=(3, 3), stride=(2, 2),
                                            pad=(1, 1))),
    "max_full": ((4, 16, 33, 35), dict(kernel=(3, 3), stride=(2, 2),
                                       pooling_convention="full")),
    "max_same_1d": ((4, 16, 33), dict(kernel=(3,), stride=(2,),
                                      pooling_convention="same")),
    "avg_full": ((4, 16, 6, 6), dict(kernel=(3, 3), stride=(2, 2),
                                     pool_type="avg",
                                     pooling_convention="full")),
    "avg_s1p1": ((4, 16, 17, 17), dict(kernel=(3, 3), stride=(1, 1),
                                       pad=(1, 1), pool_type="avg")),
    "avg_exclude_pad_3d": ((2, 8, 9, 12, 13),
                           dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                                pad=(1, 1, 1), pool_type="avg",
                                count_include_pad=False)),
    "sum_same": ((4, 16, 33, 35), dict(kernel=(2, 3), stride=(2, 2),
                                       pool_type="sum",
                                       pooling_convention="same")),
    "lp2_3d": ((2, 8, 9, 12, 12), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                       pool_type="lp", p_value=2)),
    "global_max": ((4, 16, 9, 9), dict(kernel=(1, 1), global_pool=True)),
    "global_avg_3d": ((2, 8, 4, 5, 6), dict(kernel=(1, 1, 1),
                                            pool_type="avg",
                                            global_pool=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("last", [False, True], ids=["first", "last"])
@pytest.mark.parametrize("case", sorted(POOL))
def test_pooling_on_the_card(case, last, dtype):
    _require_card()
    shape, kw = POOL[case]
    rs = np.random.RandomState(len(case) + 70)
    x = _arr(rs, *(_to_last(shape) if last else shape))
    if kw.get("pool_type") == "lp":
        x = x + np.sign(x) * 0.1
    kw = dict(kw, layout=_LAST[len(shape)] if last else None)
    err = _both(ops_nn.pooling, [x], kw, getattr(torch, dtype))
    assert err <= (1e-6 if dtype == "float32" else BF16_TOL), err


RESIZE = {
    "bilinear_down": (spatial.bilinear_resize_2d, [(2, 8, 64, 64)],
                      dict(height=23, width=37)),
    "bilinear_down_even": (spatial.bilinear_resize_2d, [(2, 8, 64, 64)],
                           dict(height=32, width=16)),
    "bilinear_up": (spatial.bilinear_resize_2d, [(2, 8, 16, 16)],
                    dict(height=45, width=40)),
    "nearest_concat": (spatial.upsampling, [(2, 8, 14, 14), (2, 8, 7, 7)],
                       dict(scale=2, num_args=2)),
    "nearest_sum": (spatial.upsampling, [(2, 8, 14, 14), (2, 8, 28, 28)],
                    dict(scale=2, num_args=2, multi_input_mode="sum")),
    "upsampling_bilinear": (spatial.upsampling,
                            [(2, 8, 14, 14), (8, 1, 6, 6)],
                            dict(scale=3, sample_type="bilinear",
                                 num_args=2)),
    "adaptive_avg": (spatial.adaptive_avg_pooling_2d, [(2, 8, 29, 31)],
                     dict(output_size=(7, 5))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RESIZE))
def test_resize_on_the_card(case, dtype, no_tf32):
    """The resize ops, the antialiased bilinear downscale among them,
    forward and gradient."""
    _require_card()
    fn, shapes, kw = RESIZE[case]
    rs = np.random.RandomState(len(case) + 90)
    arrays = [_arr(rs, *s) for s in shapes]
    err = _both(fn, arrays, kw, getattr(torch, dtype))
    assert err <= (F32_TOL if dtype == "float32" else BF16_TOL), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_conv_cell_on_the_card(kind, no_tf32):
    """A Conv2D cell of each kind unrolled 6 steps on the card against
    the CPU from the same weights: outputs and states to 1e-5, every
    parameter's gradient to 1e-4 of its largest magnitude."""
    _require_card()
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn

    rs = np.random.RandomState(len(kind))
    xs = rs.rand(6, 2, 3, 24, 24).astype(np.float32)
    head = rs.randn(6, 2, 16, 24, 24).astype(np.float32)
    got, weights = {}, None
    for dev, ctx in (("cuda", mx.gpu(0)), ("cpu", mx.cpu())):
        cell = getattr(crnn, f"Conv2D{kind}Cell")(
            (3, 24, 24), 16, i2h_kernel=3, h2h_kernel=3, i2h_pad=1,
            h2h_dilate=2)
        cell.initialize(ctx=ctx)
        params = list(cell.collect_params().values())
        if weights is None:
            weights = [0.2 * rs.randn(*p.shape).astype(np.float32)
                       for p in params]
        for p, w in zip(params, weights):
            p.set_data(w)
        with mx.autograd.record():
            outs, states = cell.unroll(6, mx.nd.array(xs, ctx=ctx),
                                       layout="TNC", merge_outputs=True)
            loss = (outs * mx.nd.array(head, ctx=ctx)).sum()
        loss.backward()
        got[dev] = ([outs._data] + [s._data for s in states],
                    [p.grad()._data for p in params])
    for a, b in zip(*(got[d][0] for d in ("cuda", "cpu"))):
        assert _rel(a, b) <= 1e-5
    for a, b in zip(*(got[d][1] for d in ("cuda", "cpu"))):
        assert _rel(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_mobilenet_v3_small_graph_equals_eager(layout, no_tf32):
    """``mobilenet_v3_small`` (depthwise 3x3 and 5x5, squeeze-and-excite,
    hard swish) on the card: the NCHW and NHWC builds from one .params
    file agree with the CPU to 1e-4 of the largest logit, and the
    hybridized graph gives the eager NDArray forward bit for bit with one
    capture."""
    _require_card()
    import tempfile

    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    net = get_model("mobilenetv3_small", classes=10, layout=layout,
                    ctx=mx.gpu(0))
    x = np.random.RandomState(3).rand(2, 3, 96, 96).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x).cuda())
    with tempfile.TemporaryDirectory() as tmp:
        net.save_parameters(f"{tmp}/w.params")
        cpu_net = get_model("mobilenetv3_small", classes=10, ctx=mx.cpu())
        cpu_net.load_parameters(f"{tmp}/w.params", ctx=mx.cpu())
    with torch.no_grad():
        ref = cpu_net(torch.from_numpy(x))
    assert _rel(got, ref) <= 1e-4
    xn = mx.nd.array(x, ctx=mx.gpu(0))
    eager = net(xn)._data.clone()
    net.hybridize()
    assert torch.equal(net(xn)._data, eager)
    assert torch.equal(net(xn)._data, eager)
    assert net.cached_graph.captures == 1
