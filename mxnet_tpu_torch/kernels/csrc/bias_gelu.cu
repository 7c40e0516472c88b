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
//
// The backward (mx_bias_gelu_bwd) replaces `_bias_gelu_bwd_kernel`
// (fused_layers.py:511-519, the pallas_call at :539): it recomputes u and
// gelu'(u) = cdf + u * pdf from (x, b), writes dx = dy * gelu'(u) in x's
// dtype, and sums dx in f32 over rows for the bias gradient. Bound by
// bytes (x and dy read once, dx written once). A CTA is 32 column chunks
// by 8 row lanes: a warp reads 32 consecutive chunks of one row, each
// thread walks every (8 * gridDim.y)-th row of its chunk and keeps the
// chunk's db sum in registers, and the 8 row lanes reduce through shared
// memory into one f32 partial row per CTA row; the wrapper sums the
// partials, as the TPU path sums its per-block partials (:546).
#include "common.cuh"

namespace {

constexpr int kChunk = 8;
constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr int kBwdCols = 32;       // column chunks per CTA
constexpr int kBwdRows = 8;        // row lanes per CTA

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

// dx = dy * gelu'(x + b); db_part[blockIdx.y] = this CTA's column sums
// of dx. C = 8 elements per chunk with 16-byte accesses, or 1 for any D.
template <typename TX, typename TB, int C>
__global__ void __launch_bounds__(kBwdCols * kBwdRows)
    bias_gelu_bwd_kernel(const TX* __restrict__ x, const TB* __restrict__ b,
                         const TX* __restrict__ dy, TX* __restrict__ dx,
                         float* __restrict__ db_part, long long rows, int d) {
  __shared__ float red[kBwdRows][kBwdCols * C];
  const int chunks = d / C;
  const int c = blockIdx.x * kBwdCols + threadIdx.x;
  float acc[C];
#pragma unroll
  for (int e = 0; e < C; ++e) acc[e] = 0.f;
  if (c < chunks) {
    float bv[C];
    mxk::load_f<TB, C>(b + c * C, bv);
    for (long long r = blockIdx.y * kBwdRows + threadIdx.y; r < rows;
         r += static_cast<long long>(kBwdRows) * gridDim.y) {
      float u[C], g[C];
      mxk::load_f<TX, C>(x + r * d + c * C, u);
      mxk::load_f<TX, C>(dy + r * d + c * C, g);
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const float uu = u[e] + bv[e];
        const float cdf = 0.5f * (1.f + erff(uu * kInvSqrt2));
        const float pdf = expf(-0.5f * uu * uu) * kInvSqrt2Pi;
        g[e] = g[e] * (cdf + uu * pdf);
        acc[e] += g[e];
      }
      mxk::store_f<TX, C>(dx + r * d + c * C, g);
    }
  }
#pragma unroll
  for (int e = 0; e < C; ++e) red[threadIdx.y][threadIdx.x * C + e] = acc[e];
  __syncthreads();
  if (threadIdx.y == 0 && c < chunks) {
#pragma unroll
    for (int e = 0; e < C; ++e) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kBwdRows; ++i) s += red[i][threadIdx.x * C + e];
      db_part[static_cast<long long>(blockIdx.y) * d + c * C + e] = s;
    }
  }
}

template <typename TX, typename TB>
cudaError_t launch_bwd(const void* x, const void* b, const void* dy,
                       void* dx, float* db_part, long long rows, int d,
                       int row_blocks, bool vec, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TB* bp = static_cast<const TB*>(b);
  const TX* dyp = static_cast<const TX*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  const dim3 block(kBwdCols, kBwdRows);
  if (vec) {
    const dim3 grid((d / kChunk + kBwdCols - 1) / kBwdCols, row_blocks);
    bias_gelu_bwd_kernel<TX, TB, kChunk>
        <<<grid, block, 0, stream>>>(xp, bp, dyp, dxp, db_part, rows, d);
  } else {
    const dim3 grid((d + kBwdCols - 1) / kBwdCols, row_blocks);
    bias_gelu_bwd_kernel<TX, TB, 1>
        <<<grid, block, 0, stream>>>(xp, bp, dyp, dxp, db_part, rows, d);
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

// Backward. x, dy, dx: (rows, d) contiguous in x's dtype; b: (d,);
// db_part: (row_blocks, d) f32, one partial row per row block of CTAs
// (the caller sums them; row_blocks <= 65535). vec != 0 requires d % 8 ==
// 0 and 16-byte aligned x, b, dy and dx. Returns cudaGetLastError() after
// the launch.
extern "C" int mx_bias_gelu_bwd(const void* x, const void* b, const void* dy,
                                void* dx, float* db_part, long long rows,
                                int d, int row_blocks, int x_dtype,
                                int b_dtype, int vec, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (d < 1 || row_blocks < 1 || row_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == mxk::kFloat32 && b_dtype == mxk::kFloat32)
    return launch_bwd<float, float>(x, b, dy, dx, db_part, rows, d,
                                    row_blocks, v, s);
  if (x_dtype == mxk::kBFloat16 && b_dtype == mxk::kBFloat16)
    return launch_bwd<bf16, bf16>(x, b, dy, dx, db_part, rows, d,
                                  row_blocks, v, s);
  if (x_dtype == mxk::kBFloat16 && b_dtype == mxk::kFloat32)
    return launch_bwd<bf16, float>(x, b, dy, dx, db_part, rows, d,
                                   row_blocks, v, s);
  if (x_dtype == mxk::kFloat32 && b_dtype == mxk::kBFloat16)
    return launch_bwd<float, bf16>(x, b, dy, dx, db_part, rows, d,
                                   row_blocks, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
