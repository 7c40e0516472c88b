// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/fused_layers.py
// `_norm_fwd_pallas` / `_norm_fwd_kernel` in RMS mode (no residual, no
// dropout: the Llama path's norm).
//
// What bounds it on an H100: device-memory bytes. It reads rows*D
// elements of x and D of the weight and writes rows*D outputs, doing
// ~4 flops per element, far below the card's 295 flop/byte ridge.
// The design therefore touches each element of x exactly once in device
// memory: one CTA per row loads the row into registers with 16-byte
// vector loads (8 elements per access chunk, at most 4 chunks per
// thread), the weight's matching chunks in the same breath (decode calls
// it with rows = batch size, 8 CTAs, where the launch and one trip to
// memory are the whole cost, so w must not wait for the reduction),
// reduces the f32 sum of squares with warp shuffles plus one
// shared-memory hop, and normalises from the registers it already holds.
//
// Numerics match the JAX kernel exactly in structure: f32 statistics,
// rstd = rsqrt(mean(x^2) + eps), xhat rounded to x's dtype BEFORE the
// multiply by weight (fused_layers.py:218-223), output in
// result_type(x, weight) (fused_layers.py:312-314). The optional f32
// per-row rstd output is what the backward recomputes xhat from (the
// JAX `_rms_fwd` saves the same, :473-476); serving passes a null
// pointer and writes nothing more. The backward is the `Rms` instance of
// layer_norm.cu's kernels (mx_rms_norm_bwd), as the JAX package has one
// `_norm_bwd_kernel` with an rms flag.
#include "common.cuh"

namespace {

constexpr int kChunk = 8;          // elements per vector chunk
constexpr int kMaxThreads = 256;   // 256 * 4 * 8 = 8192 = max D

// One CTA per row. CPT is the fewest chunks per thread that cover the
// row, so the registers held are no more than needed.
template <typename TX, typename TW, typename TO, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_vec_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        TO* __restrict__ out, float* __restrict__ rstd_out,
                        int d, float eps) {
  __shared__ float scratch[32];
  const int chunks = d / kChunk;
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * d;
  TO* orow = out + static_cast<size_t>(blockIdx.x) * d;

  float v[CPT][kChunk], wv[CPT][kChunk];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      mxk::load_f<TX, kChunk>(xr + c * kChunk, v[i]);
      mxk::load_f<TW, kChunk>(w + c * kChunk, wv[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) ss += v[i][e] * v[i][e];
    }
  }
  ss = mxk::block_sum(ss, scratch);
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      float o[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        o[e] = mxk::round_to<TX>(v[i][e] * rstd) * wv[i][e];
      mxk::store_f<TO, kChunk>(orow + c * kChunk, o);
    }
  }
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;
}

// Any D (not a multiple of 8, or unaligned rows): scalar loads, the row
// read twice (the second read hits L1/L2, not device memory).
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kMaxThreads)
    rms_norm_scalar_kernel(const TX* __restrict__ x,
                           const TW* __restrict__ w, TO* __restrict__ out,
                           float* __restrict__ rstd_out, int d, float eps) {
  __shared__ float scratch[32];
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * d;
  TO* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float a = mxk::to_f(xr[j]);
    ss += a * a;
  }
  ss = mxk::block_sum(ss, scratch);
  const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float o =
        mxk::round_to<TX>(mxk::to_f(xr[j]) * rstd) * mxk::to_f(w[j]);
    orow[j] = mxk::from_f<TO>(o);
  }
  if (rstd_out != nullptr && threadIdx.x == 0) rstd_out[blockIdx.x] = rstd;
}

template <typename TX, typename TW, typename TO>
cudaError_t launch(const void* x, const void* w, void* out, float* rstd,
                   int rows, int d, float eps, bool vec,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TO* op = static_cast<TO*>(out);
  if (!vec) {
    rms_norm_scalar_kernel<TX, TW, TO>
        <<<rows, mxk::row_threads(d, kMaxThreads), 0, stream>>>(
            xp, wp, op, rstd, d, eps);
    return cudaGetLastError();
  }
  const int chunks = d / kChunk;
  const int threads = mxk::row_threads(chunks, kMaxThreads);
  const int cpt = (chunks + threads - 1) / threads;
#define MX_RMS_ROWS(CPT)                                             \
  rms_norm_vec_kernel<TX, TW, TO, CPT>                               \
      <<<rows, threads, 0, stream>>>(xp, wp, op, rstd, d, eps)
  if (cpt == 1) {
    MX_RMS_ROWS(1);
  } else if (cpt == 2) {
    MX_RMS_ROWS(2);
  } else {
    MX_RMS_ROWS(4);
  }
#undef MX_RMS_ROWS
  return cudaGetLastError();
}

}  // namespace

// x: (rows, d) contiguous; w: (d,); out: (rows, d) in result_type(x, w);
// rstd: (rows,) f32, or null to skip it. vec != 0 requires d % 8 == 0,
// d <= 8192 and 16-byte aligned x, w, out. Returns cudaGetLastError()
// after the launch.
extern "C" int mx_rms_norm_fwd(const void* x, const void* w, void* out,
                               float* rstd, int rows, int d, float eps,
                               int x_dtype, int w_dtype, int vec,
                               void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kFloat32)
    return launch<float, float, float>(x, w, out, rstd, rows, d, eps, v, s);
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kBFloat16)
    return launch<bf16, bf16, bf16>(x, w, out, rstd, rows, d, eps, v, s);
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kFloat32)
    return launch<bf16, float, float>(x, w, out, rstd, rows, d, eps, v, s);
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kBFloat16)
    return launch<float, bf16, float>(x, w, out, rstd, rows, d, eps, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
