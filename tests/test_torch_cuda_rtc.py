"""``mx.rtc.CudaModule`` and the ``mx.nd`` NDArray on the card.

The user kernels below are the one copy of each CUDA source and its
plain PyTorch version: these tests, the CPU tests of
``tests/test_torch_rtc.py`` (each plain version against the JAX
package's ``PallasModule`` in interpret mode) and ``chip_smoke.py``'s
``rtc`` and ``imperative`` phases all use them.

Marked ``cuda``: each test skips where there is no CUDA card and runs on
a machine with one. This file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda_rtc.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

FMAD_OFF = ("--fmad=false",)

# upstream MXNet's rtc test kernel, axpy, as a template (exported per
# type), and its shared-memory form
UPSTREAM_SRC = r"""
#include <cuda_fp16.h>
template <typename T>
__global__ void axpy(const T *x, T *y, T alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = alpha * x[i] + y[i];
}

extern "C" __global__ void saxpy(const float *x, float *y, float alpha) {
  extern __shared__ float smem[];
  int i = threadIdx.x + blockIdx.x * blockDim.x;
  smem[threadIdx.x] = x[i];
  y[i] += alpha * smem[threadIdx.x];
}
"""
UPSTREAM_EXPORTS = ("axpy<float>", "axpy<double>", "axpy<__half>")
UPSTREAM_TYPES = {"axpy<float>": ("float", torch.float32),
                  "axpy<double>": ("double", torch.float64),
                  "axpy<__half>": ("__half", torch.float16)}

# the JAX package's two tests/test_rtc.py kernels, written in CUDA
JAX_TESTS_SRC = r"""
extern "C" __global__ void axpy_out(const float *x, const float *y,
                                    float *o, float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = alpha * x[i] + y[i];
}

// block b scales its two-row band of x by b + 1
extern "C" __global__ void blocky(const float *x, float *o, int cols) {
  int b = blockIdx.x;
  for (int j = threadIdx.x; j < 2 * cols; j += blockDim.x) {
    int k = 2 * b * cols + j;
    o[k] = x[k] * (float)(b + 1);
  }
}
"""
AXPY_ALPHA = 2.5
AXPY_SHAPE = (16, 128)
BLOCKY_GRID = 4
BLOCKY_SHAPE = (8, 128)

# one block per row; the row is staged in dynamic shared memory, then
# blockDim.x partial sums (blockDim.x a power of two) are halved in turn
ROW_SUM_SRC = r"""
extern "C" __global__ void row_sum(const float *x, float *out, int cols) {
  extern __shared__ float smem[];
  float *row = smem, *part = smem + cols;
  const float *src = x + (size_t)blockIdx.x * cols;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) row[j] = src[j];
  __syncthreads();
  float s = 0.f;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) s += row[j];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}
"""
ROW_SUM_SHAPE = (16384, 768)
ROW_SUM_THREADS = 256
ROW_SUM_RTOL = 1e-6       # of an f64 sum; 768 terms in [0, 1), f32 tree


def row_sum_smem(cols: int) -> int:
    return (cols + ROW_SUM_THREADS) * 4


# a user's axpy at BERT-base width, y = a * x + y in place, rounding as
# torch's two ops round (the product to the dtype, then the sum) when
# compiled with --fmad=false. Each thread of a grid-stride loop takes 16
# bytes (8 bf16 or 4 f32 elements, one vector load of x and of y) where
# both pointers are 16-byte aligned, and the tail of n (all of it, where
# a pointer is not aligned) one element at a time. BERT_AXPY_VEC and
# SGD_VEC are these elements per thread, which size the launch's grid.
BERT_AXPY_SRC = r"""
#include <cuda_bf16.h>
__device__ __forceinline__ __nv_bfloat16 axpy1(__nv_bfloat16 x,
                                               __nv_bfloat16 y, float a) {
  __nv_bfloat16 t = __float2bfloat16(__bfloat162float(x) * a);
  return __float2bfloat16(__bfloat162float(y) + __bfloat162float(t));
}

extern "C" __global__ void axpy_bf16(const __nv_bfloat16 *x,
                                     __nv_bfloat16 *y, __nv_bfloat16 a,
                                     int n) {
  float af = __bfloat162float(a);
  int stride = gridDim.x * blockDim.x, first = blockIdx.x * blockDim.x
      + threadIdx.x;
  int nv = ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y))
            & 15) ? 0 : n / 8;
  const uint4 *x8 = reinterpret_cast<const uint4 *>(x);
  uint4 *y8 = reinterpret_cast<uint4 *>(y);
  for (int i = first; i < nv; i += stride) {
    uint4 xr = x8[i], yr = y8[i];     // one 16-byte load each
    const __nv_bfloat16 *xv = reinterpret_cast<const __nv_bfloat16 *>(&xr);
    __nv_bfloat16 *yv = reinterpret_cast<__nv_bfloat16 *>(&yr);
#pragma unroll
    for (int j = 0; j < 8; ++j) yv[j] = axpy1(xv[j], yv[j], af);
    y8[i] = yr;
  }
  for (int i = nv * 8 + first; i < n; i += stride)
    y[i] = axpy1(x[i], y[i], af);
}

extern "C" __global__ void axpy_f32(const float *x, float *y, float a,
                                    int n) {
  int stride = gridDim.x * blockDim.x, first = blockIdx.x * blockDim.x
      + threadIdx.x;
  int nv = ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(y))
            & 15) ? 0 : n / 4;
  const float4 *x4 = reinterpret_cast<const float4 *>(x);
  float4 *y4 = reinterpret_cast<float4 *>(y);
  for (int i = first; i < nv; i += stride) {
    float4 xv = x4[i], yv = y4[i];
    yv.x = yv.x + xv.x * a;
    yv.y = yv.y + xv.y * a;
    yv.z = yv.z + xv.z * a;
    yv.w = yv.w + xv.w * a;
    y4[i] = yv;
  }
  for (int i = nv * 4 + first; i < n; i += stride) y[i] = y[i] + x[i] * a;
}
"""
BERT_AXPY_SHAPE = (32, 512, 768)
BERT_AXPY_ALPHA = 0.1
BERT_AXPY_SIGS = {"axpy_bf16": "const __nv_bfloat16 *x, __nv_bfloat16 *y, "
                               "__nv_bfloat16 a, int n",
                  "axpy_f32": "const float *x, float *y, float a, int n"}
BERT_AXPY_VEC = {"axpy_bf16": 8, "axpy_f32": 4}

# a user's manual SGD step on one bf16 parameter, w -= lr * g, rounding
# as the NDArray ops w -= lr * g do (lr cast to bf16 first; the product
# rounded to bf16, then the difference) when compiled with --fmad=false;
# 8 elements a thread, aligned or not, as the bf16 axpy takes them
SGD_SRC = r"""
#include <cuda_bf16.h>
__device__ __forceinline__ __nv_bfloat16 sgd1(__nv_bfloat16 w,
                                              __nv_bfloat16 g, float lr) {
  __nv_bfloat16 t = __float2bfloat16(__bfloat162float(g) * lr);
  return __float2bfloat16(__bfloat162float(w) - __bfloat162float(t));
}

extern "C" __global__ void sgd_bf16(__nv_bfloat16 *w,
                                    const __nv_bfloat16 *g,
                                    __nv_bfloat16 lr, int n) {
  float lf = __bfloat162float(lr);
  int stride = gridDim.x * blockDim.x, first = blockIdx.x * blockDim.x
      + threadIdx.x;
  int nv = ((reinterpret_cast<size_t>(w) | reinterpret_cast<size_t>(g))
            & 15) ? 0 : n / 8;
  uint4 *w8 = reinterpret_cast<uint4 *>(w);
  const uint4 *g8 = reinterpret_cast<const uint4 *>(g);
  for (int i = first; i < nv; i += stride) {
    uint4 wr = w8[i], gr = g8[i];     // one 16-byte load each
    __nv_bfloat16 *wv = reinterpret_cast<__nv_bfloat16 *>(&wr);
    const __nv_bfloat16 *gv = reinterpret_cast<const __nv_bfloat16 *>(&gr);
#pragma unroll
    for (int j = 0; j < 8; ++j) wv[j] = sgd1(wv[j], gv[j], lf);
    w8[i] = wr;
  }
  for (int i = nv * 8 + first; i < n; i += stride)
    w[i] = sgd1(w[i], g[i], lf);
}
"""
SGD_SIG = "__nv_bfloat16 *w, const __nv_bfloat16 *g, __nv_bfloat16 lr, int n"
SGD_VEC = 8
THREADS = 256


def grid_for(n: int, threads: int = THREADS, cap: int = 132 * 16,
             vec: int = 1) -> int:
    """Blocks of a grid-stride launch over n elements taken ``vec`` to a
    thread (at most 16 blocks per SM of the H100's 132)."""
    return max(1, min(cap, -(-n // (threads * vec))))


# ---------------------------------------------------------------------------
# the plain PyTorch versions (two roundings where the kernel has two)
# ---------------------------------------------------------------------------


def axpy_plain(x, y, alpha):
    """alpha * x + y: the product rounded to the dtype, then the sum."""
    return x * alpha + y


def blocky_plain(x, grid=BLOCKY_GRID):
    band = x.shape[0] // grid
    scale = torch.arange(1, grid + 1, dtype=x.dtype,
                         device=x.device).repeat_interleave(band)
    return x * scale[:, None]


def row_sum_plain(x):
    return x.double().sum(dim=1)


def sgd_plain(w, g, lr):
    """w - bf16(lr) * g, each op rounded to bf16."""
    return w - g * torch.tensor(lr, dtype=w.dtype).item()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return mx.gpu(0)


def _nd(a, ctx, dtype=None):
    return mx.nd.array(a, ctx=ctx, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("export", UPSTREAM_EXPORTS)
def test_upstream_template_axpy(gpu, export):
    mod = mx.rtc.CudaModule(UPSTREAM_SRC, options=FMAD_OFF,
                            exports=UPSTREAM_EXPORTS)
    ctype, dtype = UPSTREAM_TYPES[export]
    k = mod.get_kernel(export, f"const {ctype} *x, {ctype} *y, "
                               f"{ctype} alpha, int n")
    rs = np.random.RandomState(0)
    x = _nd(rs.randn(*AXPY_SHAPE), gpu, dtype)
    y = _nd(rs.randn(*AXPY_SHAPE), gpu, dtype)
    want = axpy_plain(x._data, y._data, torch.tensor(
        AXPY_ALPHA, dtype=dtype).item())
    n = x.size
    k.launch([x, y, AXPY_ALPHA, n], gpu, (grid_for(n),), (THREADS,))
    assert torch.equal(y._data, want)
    assert k.launches == 1


@pytest.mark.cuda
def test_upstream_saxpy_shared_memory(gpu):
    mod = mx.rtc.CudaModule(UPSTREAM_SRC, exports=UPSTREAM_EXPORTS)
    k = mod.get_kernel("saxpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=gpu)
    y = mx.nd.zeros((10,), ctx=gpu)
    k.launch([x, y, 4.0], gpu, (1, 1, 1), (10, 1, 1), 40)
    assert (y.asnumpy() == 4).all()
    k.launch([x, y, 5.0], gpu, (2, 1, 1), (5, 1, 1), 20)
    assert (y.asnumpy() == 9).all()


@pytest.mark.cuda
def test_jax_axpy_and_blocky(gpu):
    mod = mx.rtc.CudaModule(JAX_TESTS_SRC, options=FMAD_OFF)
    rs = np.random.RandomState(0)
    x = _nd(rs.randn(*AXPY_SHAPE), gpu)
    y = _nd(rs.randn(*AXPY_SHAPE), gpu)
    o = mx.nd.zeros(AXPY_SHAPE, ctx=gpu)
    mod.get_kernel("axpy_out", "const float *x, const float *y, float *o, "
                               "float alpha, int n").launch(
        [x, y, o, AXPY_ALPHA, x.size], gpu, (grid_for(x.size),), (THREADS,))
    assert torch.equal(o._data, axpy_plain(x._data, y._data, AXPY_ALPHA))
    xb = _nd(rs.randn(*BLOCKY_SHAPE), gpu)
    ob = mx.nd.zeros(BLOCKY_SHAPE, ctx=gpu)
    mod.get_kernel("blocky", "const float *x, float *o, int cols").launch(
        [xb, ob, BLOCKY_SHAPE[1]], gpu, (BLOCKY_GRID,), (128,))
    assert torch.equal(ob._data, blocky_plain(xb._data))


@pytest.mark.cuda
@pytest.mark.parametrize("smem_extra", [0, 100 << 10])
def test_row_sum_dynamic_shared_memory(gpu, smem_extra):
    mod = mx.rtc.CudaModule(ROW_SUM_SRC)
    k = mod.get_kernel("row_sum", "const float *x, float *out, int cols")
    rows, cols = ROW_SUM_SHAPE
    x = _nd(np.random.RandomState(1).rand(rows, cols), gpu)
    out = mx.nd.zeros((rows,), ctx=gpu)
    k.launch([x, out, cols], gpu, (rows,), (ROW_SUM_THREADS,),
             row_sum_smem(cols) + smem_extra)
    want = row_sum_plain(x._data)
    rel = ((out._data.double() - want).abs() / want.abs()).max().item()
    assert rel <= ROW_SUM_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("axpy_bf16", torch.bfloat16),
                                        ("axpy_f32", torch.float32)])
def test_bert_width_axpy_bit_identical(gpu, name, dtype):
    mod = mx.rtc.CudaModule(BERT_AXPY_SRC, options=FMAD_OFF)
    k = mod.get_kernel(name, BERT_AXPY_SIGS[name])
    g = torch.Generator(device="cuda").manual_seed(0)
    x = mx.nd.NDArray(torch.randn(BERT_AXPY_SHAPE, generator=g,
                                  device="cuda").to(dtype))
    y = mx.nd.NDArray(torch.randn(BERT_AXPY_SHAPE, generator=g,
                                  device="cuda").to(dtype))
    a = torch.tensor(BERT_AXPY_ALPHA, dtype=dtype).item()
    want = axpy_plain(x._data, y._data, a)
    k.launch([x, y, BERT_AXPY_ALPHA, x.size], gpu,
             (grid_for(x.size, vec=BERT_AXPY_VEC[name]),), (THREADS,))
    assert torch.equal(y._data, want)


@pytest.mark.cuda
def test_sgd_kernel_matches_ndarray_ops(gpu):
    mod = mx.rtc.CudaModule(SGD_SRC, options=FMAD_OFF)
    k = mod.get_kernel("sgd_bf16", SGD_SIG)
    g = torch.Generator(device="cuda").manual_seed(0)
    w0 = torch.randn(768, 3072, generator=g, device="cuda").bfloat16()
    gr = torch.randn(768, 3072, generator=g, device="cuda").bfloat16()
    a, b = mx.nd.NDArray(w0.clone()), mx.nd.NDArray(w0.clone())
    lr = 0.01
    a -= lr * mx.nd.NDArray(gr)
    k.launch([b, mx.nd.NDArray(gr), lr, b.size], gpu,
             (grid_for(b.size, vec=SGD_VEC),), (THREADS,))
    assert torch.equal(a._data, b._data)
    assert torch.equal(a._data, sgd_plain(w0, gr, lr))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_sgd_kernel_unaligned_and_tail(gpu, offset):
    """A view that starts 2 bytes past the allocation takes the
    one-element loop; 1001 elements leave a tail after the vector loop."""
    mod = mx.rtc.CudaModule(SGD_SRC, options=FMAD_OFF)
    k = mod.get_kernel("sgd_bf16", SGD_SIG)
    g = torch.Generator(device="cuda").manual_seed(1)
    w0 = torch.randn(1002, generator=g, device="cuda").bfloat16()
    gr = torch.randn(1002, generator=g, device="cuda").bfloat16()
    w = mx.nd.NDArray(w0.clone())[offset:offset + 1001]
    gv = mx.nd.NDArray(gr)[offset:offset + 1001]
    k.launch([w, gv, 0.01, w.size], gpu, (grid_for(w.size, vec=SGD_VEC),),
             (THREADS,))
    assert torch.equal(w._data, sgd_plain(w0[offset:offset + 1001],
                                          gr[offset:offset + 1001], 0.01))

@pytest.mark.cuda
def test_errors_raise(gpu):
    with pytest.raises(MXNetError, match="error"):
        mx.rtc.CudaModule('extern "C" __global__ void k( { }')
    mod = mx.rtc.CudaModule(JAX_TESTS_SRC)
    k = mod.get_kernel("blocky", "const float *x, float *o, int cols")
    x = mx.nd.ones((8, 128), ctx=gpu)
    o = mx.nd.zeros((8, 128), ctx=gpu)
    with pytest.raises(MXNetError, match="signature says"):
        k.launch([x.astype("float64"), o, 128], gpu, (4,), (128,))
    with pytest.raises(MXNetError, match="contiguous"):
        k.launch([x[:, 1:3], o, 2], gpu, (4,), (128,))
    with pytest.raises(MXNetError, match="2048 threads"):
        k.launch([x, o, 128], gpu, (4,), (2048,))
    with pytest.raises(MXNetError, match="cpu"):
        k.launch([mx.nd.ones((8, 128), ctx=mx.cpu()), o, 128], gpu, (4,),
                 (128,))
    with pytest.raises(MXNetError, match="GPU context"):
        k.launch([x, o, 128], mx.cpu(), (4,), (128,))
    assert k.launches == 0


@pytest.mark.cuda
def test_launch_orders_with_ndarray_ops_and_bumps_versions(gpu):
    mod = mx.rtc.CudaModule(UPSTREAM_SRC, exports=UPSTREAM_EXPORTS)
    k = mod.get_kernel("axpy<float>", "const float *x, float *y, "
                                      "float alpha, int n")
    x = mx.nd.ones((1 << 20,), ctx=gpu)
    y = x * 2                               # queued before the launch
    v = y._data._version
    k.launch([x, y, 3.0, y.size], gpu, (-(-y.size // THREADS),),
             (THREADS,))
    z = y + 1                               # queued after it
    assert (z.asnumpy() == 6).all()
    assert y._data._version == v + 1 and y._version == 1


@pytest.mark.cuda
def test_launch_from_another_thread(gpu):
    import threading

    mod = mx.rtc.CudaModule(UPSTREAM_SRC, exports=UPSTREAM_EXPORTS)
    k = mod.get_kernel("axpy<float>", "const float *x, float *y, "
                                      "float alpha, int n")
    x = mx.nd.ones((256,), ctx=gpu)
    y = mx.nd.zeros((256,), ctx=gpu)
    errors = []

    def run():
        try:
            k.launch([x, y, 1.0, 256], gpu, (1,), (256,))
        except MXNetError as e:
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors
    assert (y.asnumpy() == 1).all()


# NDArray ops on the card against the same ops on the CPU: bit for bit
# where the arithmetic is one rounding of the same operands, to f32 noise
# for the transcendental functions, the reductions and the products
_EXACT = [lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
          lambda a, b: a / b, lambda a, b: (a > b), lambda a, b: a * 0.1,
          lambda a, b: a.sqrt()]
_CLOSE = [lambda a, b: a % 0.7, lambda a, b: a.exp(),
          lambda a, b: a.sum(axis=1),
          lambda a, b: mx.nd.dot(a, b.T), lambda a, b: a.softmax(),
          lambda a, b: a.mean()]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ndarray_ops_card_against_cpu(gpu, dtype):
    rs = np.random.RandomState(0)
    a_np, b_np = rs.rand(64, 96) + 0.5, rs.rand(64, 96) + 0.5
    out = {}
    for ctx in (gpu, mx.cpu()):
        a, b = _nd(a_np, ctx, dtype), _nd(b_np, ctx, dtype)
        out[ctx] = [f(a, b).asnumpy() for f in _EXACT + _CLOSE]
    for i, (g, c) in enumerate(zip(out[gpu], out[mx.cpu()])):
        if i < len(_EXACT):
            np.testing.assert_array_equal(g, c)
        else:
            tol = 1e-5 if dtype == "float32" else 2.0 ** -7
            np.testing.assert_allclose(g, c, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_params_round_trip_on_card(gpu, tmp_path):
    arrays = {"w": mx.nd.NDArray(torch.randn(300, 70, device="cuda")
                                 .bfloat16()),
              "b": mx.nd.arange(11, ctx=gpu, dtype="int32")}
    mx.nd.save(str(tmp_path / "x.params"), arrays)
    back = mx.nd.load(str(tmp_path / "x.params"), ctx=gpu)
    for k, v in arrays.items():
        assert back[k].context == gpu
        assert torch.equal(back[k]._data, v._data)
