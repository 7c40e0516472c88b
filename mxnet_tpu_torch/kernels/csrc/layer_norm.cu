// Fused LayerNorm(+ residual) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/fused_layers.py
// `_norm_fwd_pallas` / `_norm_fwd_kernel` in LayerNorm mode (rms=False),
// with and without the residual, dropout off: the post-LN transformer
// cell's add+norm and BERT's embedding norm.
//
// What bounds it on an H100: device-memory bytes. Per element it reads x
// (and the residual) once and writes the output once, for ~8 flops: far
// below the card's 295 flop/byte ridge. So each element of x and of the
// residual is read from device memory exactly once: one CTA per row
// loads the row into registers with 16-byte vector loads (8 elements per
// chunk, at most 4 chunks per thread for D <= 8192), sums h = x + res in
// f32, reduces the mean with warp shuffles plus one shared-memory hop,
// then the variance from the same registers (two-pass: mean of
// (h - mean)^2, never E[h^2] - mean^2), and normalises in place.
//
// Numerics follow `_norm_fwd_kernel` (fused_layers.py:208-233): f32
// statistics, rstd = rsqrt(var + eps), out = (h - mean) * rstd * gamma +
// beta in f32, rounded once to x's dtype. The optional f32 (mean, rstd)
// row outputs are what a backward recomputes xhat from; a null pointer
// skips each.
#include "common.cuh"

namespace {

constexpr int kChunk = 8;          // elements per vector chunk
constexpr int kMaxChunksPerThread = 4;
constexpr int kMaxThreads = 256;   // 256 * 4 * 8 = 8192 = max D

template <typename TX, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    ln_vec_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                  const TW* __restrict__ gamma, const TW* __restrict__ beta,
                  TX* __restrict__ out, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int d, float eps) {
  __shared__ float scratch_mean[32];
  __shared__ float scratch_var[32];
  const int chunks = d / kChunk;
  const size_t row = static_cast<size_t>(blockIdx.x) * d;

  float v[kMaxChunksPerThread][kChunk];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunksPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      mxk::load_f<TX, kChunk>(x + row + c * kChunk, v[i]);
      if (res != nullptr) {
        float r[kChunk];
        mxk::load_f<TX, kChunk>(res + row + c * kChunk, r);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) v[i][e] += r[e];
      }
#pragma unroll
      for (int e = 0; e < kChunk; ++e) sum += v[i][e];
    }
  }
  const float mean =
      mxk::block_sum(sum, scratch_mean) / static_cast<float>(d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunksPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        v[i][e] -= mean;
        sq += v[i][e] * v[i][e];
      }
    }
  }
  const float var = mxk::block_sum(sq, scratch_var) / static_cast<float>(d);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxChunksPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      float g[kChunk], b[kChunk], o[kChunk];
      mxk::load_f<TW, kChunk>(gamma + c * kChunk, g);
      mxk::load_f<TW, kChunk>(beta + c * kChunk, b);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) o[e] = v[i][e] * rstd * g[e] + b[e];
      mxk::store_f<TX, kChunk>(out + row + c * kChunk, o);
    }
  }
  if (threadIdx.x == 0) {
    if (mean_out != nullptr) mean_out[blockIdx.x] = mean;
    if (rstd_out != nullptr) rstd_out[blockIdx.x] = rstd;
  }
}

// Any D (not a multiple of 8, or unaligned rows): scalar loads, the row
// read three times (the later reads hit L1/L2, not device memory).
template <typename TX, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    ln_scalar_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                     const TW* __restrict__ gamma,
                     const TW* __restrict__ beta, TX* __restrict__ out,
                     float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int d, float eps) {
  __shared__ float scratch_mean[32];
  __shared__ float scratch_var[32];
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  auto h_at = [&](int j) {
    float h = mxk::to_f(x[row + j]);
    if (res != nullptr) h += mxk::to_f(res[row + j]);
    return h;
  };
  float sum = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) sum += h_at(j);
  const float mean =
      mxk::block_sum(sum, scratch_mean) / static_cast<float>(d);
  float sq = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float c = h_at(j) - mean;
    sq += c * c;
  }
  const float var = mxk::block_sum(sq, scratch_var) / static_cast<float>(d);
  const float rstd = rsqrtf(var + eps);
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float o = (h_at(j) - mean) * rstd * mxk::to_f(gamma[j]) +
                    mxk::to_f(beta[j]);
    out[row + j] = mxk::from_f<TX>(o);
  }
  if (threadIdx.x == 0) {
    if (mean_out != nullptr) mean_out[blockIdx.x] = mean;
    if (rstd_out != nullptr) rstd_out[blockIdx.x] = rstd;
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* res, const void* gamma,
                   const void* beta, void* out, float* mean, float* rstd,
                   int rows, int d, float eps, bool vec,
                   cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TX* rp = static_cast<const TX*>(res);
  const TW* gp = static_cast<const TW*>(gamma);
  const TW* bp = static_cast<const TW*>(beta);
  TX* op = static_cast<TX*>(out);
  if (vec) {
    ln_vec_kernel<TX, TW>
        <<<rows, mxk::row_threads(d / kChunk, kMaxThreads), 0, stream>>>(
            xp, rp, gp, bp, op, mean, rstd, d, eps);
  } else {
    ln_scalar_kernel<TX, TW>
        <<<rows, mxk::row_threads(d, kMaxThreads), 0, stream>>>(
            xp, rp, gp, bp, op, mean, rstd, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, res: (rows, d) contiguous in x's dtype (res may be null); gamma,
// beta: (d,) in one dtype; out: (rows, d) in x's dtype; mean, rstd:
// (rows,) f32 or null. vec != 0 requires d % 8 == 0, d <= 8192 and
// 16-byte aligned x, res, gamma, beta and out. Returns cudaGetLastError()
// after the launch.
extern "C" int mx_layer_norm_fwd(const void* x, const void* res,
                                 const void* gamma, const void* beta,
                                 void* out, float* mean, float* rstd,
                                 int rows, int d, float eps, int x_dtype,
                                 int w_dtype, int vec, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kFloat32)
    return launch<float, float>(x, res, gamma, beta, out, mean, rstd, rows,
                                d, eps, v, s);
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kBFloat16)
    return launch<bf16, bf16>(x, res, gamma, beta, out, mean, rstd, rows, d,
                              eps, v, s);
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kFloat32)
    return launch<bf16, float>(x, res, gamma, beta, out, mean, rstd, rows,
                               d, eps, v, s);
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kBFloat16)
    return launch<float, bf16>(x, res, gamma, beta, out, mean, rstd, rows,
                               d, eps, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
