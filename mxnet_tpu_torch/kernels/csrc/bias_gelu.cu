// Fused bias + exact-erf GELU forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/fused_layers.py
// `_bias_gelu_pallas` / `_bias_gelu_fwd_kernel` (the Dense epilogue
// gelu(x + b), fused_layers.py:505-508).
//
// What bounds it on an H100: device-memory bytes. It reads each element
// of x once and writes one output, with ~20 flops (one erff) in between:
// well below the 295 flop/byte ridge. So it is one pass over x: each
// thread takes 8 consecutive elements of a row through 16-byte vector
// loads and stores (two for f32), the bias chunk comes from L1/L2 (D
// floats per row, shared by every row), and a grid-stride loop over the
// (rows * D / 8) chunks keeps every SM busy whatever the row count.
//
// Numerics follow the Pallas kernel: u = x + b in f32, cdf = 0.5 * (1 +
// erf(u / sqrt(2))), out = u * cdf rounded once to x's dtype.
#include "common.cuh"

namespace {

constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;

__device__ __forceinline__ float gelu_erf(float u) {
  return u * (0.5f * (1.f + erff(u * kInvSqrt2)));
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
    bias_gelu_vec_kernel(const TX* __restrict__ x, const TB* __restrict__ b,
                         TX* __restrict__ out, long long n_chunks, int d) {
  const int row_chunks = d / kChunk;
  for (long long c = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       c < n_chunks; c += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v[kChunk], bv[kChunk];
    mxk::load_f<TX, kChunk>(x + c * kChunk, v);
    mxk::load_f<TB, kChunk>(b + (c % row_chunks) * kChunk, bv);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = gelu_erf(v[e] + bv[e]);
    mxk::store_f<TX, kChunk>(out + c * kChunk, v);
  }
}

// Any D, any alignment: one element per step.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
    bias_gelu_scalar_kernel(const TX* __restrict__ x,
                            const TB* __restrict__ b, TX* __restrict__ out,
                            long long n, int d) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[i] = mxk::from_f<TX>(
        gelu_erf(mxk::to_f(x[i]) + mxk::to_f(b[i % d])));
  }
}

int grid_for(long long work) {
  // enough CTAs for ~8 resident per SM on 132 SMs; the grid-stride loop
  // covers the rest
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 132 * 8;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* b, void* out, long long rows,
                   int d, bool vec, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TB* bp = static_cast<const TB*>(b);
  TX* op = static_cast<TX*>(out);
  const long long n = rows * d;
  if (vec) {
    const long long n_chunks = n / kChunk;
    bias_gelu_vec_kernel<TX, TB>
        <<<grid_for(n_chunks), kThreads, 0, stream>>>(xp, bp, op, n_chunks,
                                                      d);
  } else {
    bias_gelu_scalar_kernel<TX, TB>
        <<<grid_for(n), kThreads, 0, stream>>>(xp, bp, op, n, d);
  }
  return cudaGetLastError();
}

}  // namespace

// x: (rows, d) contiguous; b: (d,); out: (rows, d) in x's dtype. vec != 0
// requires d % 8 == 0 and 16-byte aligned x, b and out. Returns
// cudaGetLastError() after the launch.
extern "C" int mx_bias_gelu_fwd(const void* x, const void* b, void* out,
                                long long rows, int d, int x_dtype,
                                int b_dtype, int vec, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_dtype == mxk::kFloat32 && b_dtype == mxk::kFloat32)
    return launch<float, float>(x, b, out, rows, d, v, s);
  if (x_dtype == mxk::kBFloat16 && b_dtype == mxk::kBFloat16)
    return launch<bf16, bf16>(x, b, out, rows, d, v, s);
  if (x_dtype == mxk::kBFloat16 && b_dtype == mxk::kFloat32)
    return launch<bf16, float>(x, b, out, rows, d, v, s);
  if (x_dtype == mxk::kFloat32 && b_dtype == mxk::kBFloat16)
    return launch<float, bf16>(x, b, out, rows, d, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
