"""``mx.rtc`` of the port on the CPU: the signature parser and the launch
checks as plain functions, the refusals where there is no card
(``CudaModule``, a launch on ``mx.cpu()``, ``PallasModule``), and the
plain version of each user kernel of the card phase held against the
JAX package's ``PallasModule`` running the same function in interpret
mode, as ``tests/test_rtc.py`` runs it. The kernels themselves compile
and run only on the card (``tests/test_torch_cuda_rtc.py``).
"""
import ctypes
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import rtc as jrtc

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.rtc import Arg


def _card_module():
    path = pathlib.Path(__file__).with_name("test_torch_cuda_rtc.py")
    spec = importlib.util.spec_from_file_location("_cuda_rtc_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = _card_module()


# ---------------------------------------------------------------------------
# the signature parser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, float alpha",
     [Arg(True, torch.float32, True), Arg(False, torch.float32, True),
      Arg(False, torch.float32, False)]),
    ("const  __half* x,int64_t n", [Arg(True, torch.float16, True),
                                    Arg(False, torch.int64, False)]),
    ("__nv_bfloat16 *w, const __nv_bfloat16 *g, __nv_bfloat16 lr, int n",
     [Arg(False, torch.bfloat16, True), Arg(True, torch.bfloat16, True),
      Arg(False, torch.bfloat16, False), Arg(False, torch.int32, False)]),
    ("double *d, uint8_t u, int8_t i, char c, int32_t j",
     [Arg(False, torch.float64, True), Arg(False, torch.uint8, False),
      Arg(False, torch.int8, False), Arg(False, torch.int8, False),
      Arg(False, torch.int32, False)]),
    ("float*", [Arg(False, torch.float32, True)]),
])
def test_parse_signature(sig, want):
    assert rtc.parse_signature(sig) == want


@pytest.mark.parametrize("sig,msg", [
    ("const *x", "form"), ("float **x", "form"), ("const const x", "form"),
    ("float x y z", "form"), ("long *x", "unsupported"),
    ("unsigned int n", "form"), ("float *x,", "form"),
])
def test_parse_signature_refuses(sig, msg):
    with pytest.raises(MXNetError, match=msg):
        rtc.parse_signature(sig)


# ---------------------------------------------------------------------------
# the launch checks
# ---------------------------------------------------------------------------

def test_check_dims():
    assert rtc.check_dims((4,), (128,)) == ((4, 1, 1), (128, 1, 1))
    assert rtc.check_dims(7, [8, 4, 2]) == ((7, 1, 1), (8, 4, 2))
    assert rtc.check_dims((2 ** 31 - 1, 65535, 65535), (1024,))[0][0] == \
        2 ** 31 - 1
    for grid, block, msg in (((4,), (2048,), "2048 threads"),
                             ((4,), (32, 32, 2), "2048 threads"),
                             ((1, 1, 1, 1), (1,), "one to three"),
                             ((0,), (1,), "positive"),
                             ((2.0,), (1,), "positive"),
                             ((True,), (1,), "positive"),
                             ((), (1,), "one to three"),
                             ((1, 65536), (1,), "limits"),
                             ((1,), (1, 1, 65), "limits")):
        with pytest.raises(MXNetError, match=msg):
            rtc.check_dims(grid, block)


def test_check_shared_mem():
    assert rtc.check_shared_mem(0) == 0
    assert rtc.check_shared_mem(rtc.MAX_SMEM) == 232448
    for bad, msg in ((232449, "227 KiB"), (-1, "non-negative"),
                     (1.5, "non-negative")):
        with pytest.raises(MXNetError, match=msg):
            rtc.check_shared_mem(bad)


SIG = rtc.parse_signature("const float *x, float *y, float alpha, int n")


def test_check_args_values():
    x = mx.nd.ones((4, 8), ctx=mx.cpu())
    vals = rtc.check_args(SIG, [x, x, 2.5, 32], mx.cpu())
    assert vals[:2] == [None, None]
    assert isinstance(vals[2], ctypes.c_float) and vals[2].value == 2.5
    assert isinstance(vals[3], ctypes.c_int32) and vals[3].value == 32
    half = rtc.parse_signature("__half a, __nv_bfloat16 b, int64_t c")
    a, b, c = rtc.check_args(half, [0.1, 0.1, np.int64(5)], mx.cpu())
    assert a.value == int(np.float16(0.1).view(np.uint16))
    assert b.value == torch.tensor(0.1, dtype=torch.bfloat16).view(
        torch.int16).item() == 0x3DCD
    assert isinstance(c, ctypes.c_int64) and c.value == 5


@pytest.mark.parametrize("case,msg", [
    ("count", "takes 4 arguments"), ("pointer_scalar", "takes an NDArray"),
    ("value_array", "takes a Python scalar"), ("dtype", "signature says"),
    ("strided", "contiguous"), ("context", "cpu"), ("int_value", "integer"),
    ("bool_value", "Python scalar"),
])
def test_check_args_refuses(case, msg):
    x = mx.nd.ones((4, 8), ctx=mx.cpu())
    args = {"count": [x, x, 1.0],
            "pointer_scalar": [x, 1.0, 1.0, 1],
            "value_array": [x, x, x, 1],
            "dtype": [x.astype("float64"), x, 1.0, 1],
            "strided": [x, x[:, 1:3], 1.0, 1],
            "context": [x, x, 1.0, 1],
            "int_value": [x, x, 1.0, 2.5],
            "bool_value": [x, x, True, 1]}[case]
    ctx = mx.Context("gpu", 0) if case == "context" else mx.cpu()
    with pytest.raises(MXNetError, match=msg):
        rtc.check_args(SIG, args, ctx)


def test_strided_view_is_refused_not_copied():
    x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4),
                    ctx=mx.cpu())
    view = x[:, 1:3]
    assert view._data._base is x._data      # a real view of x
    with pytest.raises(MXNetError, match="contiguous"):
        rtc.check_args(rtc.parse_signature("float *y"), [view], mx.cpu())
    # a contiguous view (a row) is taken as it is
    assert rtc.check_args(rtc.parse_signature("float *y"), [x[1]],
                          mx.cpu()) == [None]


# ---------------------------------------------------------------------------
# no CPU route
# ---------------------------------------------------------------------------

def test_cuda_module_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(MXNetError, match="no CPU route"):
        mx.rtc.CudaModule(CASES.JAX_TESTS_SRC)


def test_launch_on_the_cpu_raises():
    k = rtc.CudaKernel(None, "axpy", SIG)
    x = mx.nd.ones((4,), ctx=mx.cpu())
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, x, 1.0, 4], mx.cpu(), (1,), (4,))
    assert k.launches == 0


def test_pallas_module_points_to_cuda_module():
    with pytest.raises(MXNetError, match="CudaModule"):
        mx.rtc.PallasModule({"k": lambda *a: None})


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's PallasModule (interpret)
# ---------------------------------------------------------------------------

def _axpy(x_ref, y_ref, o_ref, *, alpha):
    o_ref[...] = alpha * x_ref[...] + y_ref[...]


def _blocky(x_ref, o_ref):
    from jax.experimental import pallas as pl

    i = pl.program_id(0)
    band = pl.ds(2 * i, 2)
    o_ref[band, :] = x_ref[band, :] * (i + 1).astype("float32")


def test_axpy_plain_against_pallas_module():
    rs = np.random.RandomState(0)
    x = rs.randn(*CASES.AXPY_SHAPE).astype(np.float32)
    y = rs.randn(*CASES.AXPY_SHAPE).astype(np.float32)
    k = jrtc.PallasModule({"axpy": _axpy}).get_kernel(
        "axpy", out_shapes=[("o", "float32", CASES.AXPY_SHAPE)],
        alpha=CASES.AXPY_ALPHA, interpret=True)
    want, = k.launch([jmx.nd.array(x), jmx.nd.array(y)])
    got = CASES.axpy_plain(torch.from_numpy(x), torch.from_numpy(y),
                           CASES.AXPY_ALPHA)
    # XLA may fuse the product into the sum (one rounding, not two)
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6,
                               atol=1e-6)


def test_blocky_plain_against_pallas_module():
    x = np.random.RandomState(1).randn(*CASES.BLOCKY_SHAPE).astype(
        np.float32)
    k = jrtc.PallasModule({"blocky": _blocky}).get_kernel(
        "blocky", grid=(CASES.BLOCKY_GRID,),
        out_shapes=[("o", "float32", CASES.BLOCKY_SHAPE)], interpret=True)
    want, = k.launch([jmx.nd.array(x)])
    got = CASES.blocky_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want.asnumpy())


def test_sgd_plain_is_the_ndarray_update():
    """The plain version of the imperative phase's SGD kernel is what the
    NDArray ops w -= lr * g compute, bit for bit, in bf16."""
    rs = np.random.RandomState(2)
    w = torch.from_numpy(rs.randn(64, 48).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rs.randn(64, 48).astype(np.float32)).bfloat16()
    a = mx.nd.NDArray(w.clone())
    a -= 0.01 * mx.nd.NDArray(g)
    assert torch.equal(a._data, CASES.sgd_plain(w, g, 0.01))


def test_row_sum_and_grid_helpers():
    x = torch.from_numpy(np.random.RandomState(3).rand(4, 768).astype(
        np.float32))
    np.testing.assert_allclose(CASES.row_sum_plain(x).numpy(),
                               x.double().sum(1).numpy())
    assert CASES.row_sum_smem(768) == 4096
    assert CASES.grid_for(10) == 1 and CASES.grid_for(1 << 30) == 132 * 16
