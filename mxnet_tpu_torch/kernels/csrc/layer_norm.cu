// Fused LayerNorm(+ residual) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/fused_layers.py
// `_norm_fwd_pallas` / `_norm_fwd_kernel` in LayerNorm mode (rms=False),
// with and without the residual, with and without dropout: the post-LN
// transformer cell's add+norm and BERT's embedding norm.
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
// row outputs are what the backward recomputes xhat from; a null pointer
// skips each.
//
// Dropout (the Drop instances): x only is dropped, before the residual
// add, h = (keep ? x * f32(1 / (1 - p)) : 0) + res in f32, keep from the
// position hash of the element's flat id row * d + col under the seed
// (`_row_keep_mask`, fused_layers.py:113; hash_dropout.cuh), the row
// being the global row index. The backward regenerates the same bits.
//
// The backward (mx_layer_norm_bwd) replaces `_norm_bwd_pallas` /
// `_norm_bwd_kernel` (fused_layers.py:237-291, :361) in LayerNorm mode,
// dropout off. It is bound by bytes as well: it reads x (and the
// residual) and dy once and writes dx once. One CTA walks a strided set of
// rows; each thread owns the same chunk of columns in every row, so it
// recomputes xhat = (h - mean) * rstd from the saved f32 statistics in
// registers, reduces mean(dy * gamma) and mean(dy * gamma * xhat) over
// the row with one block reduction each, and keeps its columns' f32
// dgamma/dbeta sums in registers across rows. Each CTA writes one f32
// partial row of each; the wrapper sums the partials, as the TPU path
// sums its per-block partials outside the kernel (:369-370). Numerics
// follow the Pallas kernel: wdy = dy * gamma, dh = rstd * (wdy -
// mean(wdy) - xhat * mean(wdy * xhat)), dx = dh in x's dtype (and the
// residual's gradient is the same dx). With dropout, dx = keep ? dh *
// f32(1 / (1 - p)) : 0 and the residual's gradient dh is a separate
// output, dres (`_norm_bwd_kernel`'s dres, :257, :290-291); the keep bits
// of a thread's columns stay in one register between the two passes.
//
// mx_rms_norm_bwd is the same kernel in RMS mode (the `Rms` instances),
// replacing `_norm_bwd_kernel` with rms=True, no residual, no dropout
// (reached through `_rms_bwd`, fused_layers.py:479-486), the backward of
// rms_norm.cu's forward: xhat = x * rstd from the forward's saved f32
// rstd, in f32 and not rounded to x's dtype (the forward rounds it, the
// Pallas backward does not); wdy = dy * w; dx = rstd * (wdy - xhat *
// mean(wdy * xhat)) in x's dtype; one f32 partial row of dw = sum(dy *
// xhat) per CTA. dy comes in the forward output's dtype, result_type(x,
// w). Its bytes bound it as the LayerNorm backward's do: x and dy read,
// dx written, once.
#include "common.cuh"
#include "hash_dropout.cuh"

namespace {

constexpr int kChunk = 8;          // elements per vector chunk
constexpr int kMaxChunksPerThread = 4;
constexpr int kMaxThreads = 256;   // 256 * 4 * 8 = 8192 = max D

// Dropout of x's element (row, col) for a Drop instance; the identity
// otherwise.
template <bool Drop>
__device__ __forceinline__ float drop_at(float h, int row, int col, int d,
                                         const mxk::Dropout& dr) {
  if constexpr (Drop) {
    const uint32_t flat =
        static_cast<uint32_t>(row) * static_cast<uint32_t>(d) +
        static_cast<uint32_t>(col);
    return mxk::mx_row_keep(flat, dr.seed, dr.thresh) ? h * dr.scale : 0.f;
  }
  return h;
}

template <typename TX, typename TW, bool Drop>
__global__ void __launch_bounds__(kMaxThreads)
    ln_vec_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                  const TW* __restrict__ gamma, const TW* __restrict__ beta,
                  TX* __restrict__ out, float* __restrict__ mean_out,
                  float* __restrict__ rstd_out, int d, float eps,
                  mxk::Dropout dr) {
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
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        v[i][e] = drop_at<Drop>(v[i][e], blockIdx.x, c * kChunk + e, d, dr);
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
template <typename TX, typename TW, bool Drop>
__global__ void __launch_bounds__(kMaxThreads)
    ln_scalar_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                     const TW* __restrict__ gamma,
                     const TW* __restrict__ beta, TX* __restrict__ out,
                     float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int d, float eps,
                     mxk::Dropout dr) {
  __shared__ float scratch_mean[32];
  __shared__ float scratch_var[32];
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  auto h_at = [&](int j) {
    float h = drop_at<Drop>(mxk::to_f(x[row + j]), blockIdx.x, j, d, dr);
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

template <typename TX, typename TW, bool Drop>
cudaError_t launch(const void* x, const void* res, const void* gamma,
                   const void* beta, void* out, float* mean, float* rstd,
                   int rows, int d, float eps, bool vec,
                   const mxk::Dropout& dr, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TX* rp = static_cast<const TX*>(res);
  const TW* gp = static_cast<const TW*>(gamma);
  const TW* bp = static_cast<const TW*>(beta);
  TX* op = static_cast<TX*>(out);
  if (vec) {
    ln_vec_kernel<TX, TW, Drop>
        <<<rows, mxk::row_threads(d / kChunk, kMaxThreads), 0, stream>>>(
            xp, rp, gp, bp, op, mean, rstd, d, eps, dr);
  } else {
    ln_scalar_kernel<TX, TW, Drop>
        <<<rows, mxk::row_threads(d, kMaxThreads), 0, stream>>>(
            xp, rp, gp, bp, op, mean, rstd, d, eps, dr);
  }
  return cudaGetLastError();
}

// Backward over rows blockIdx.x, blockIdx.x + gridDim.x, ...: each thread
// owns chunks threadIdx.x + i * blockDim.x (i < CPT) of C elements (C = 8
// with 16-byte accesses, or 1 for any D and alignment).
// Drop: dx is the dropped dh and dres (if not null) gets dh; the keep
// bits of the thread's CPT * C <= 32 elements are kept in ``kbits``.
// Rms: no mean, no mean(wdy) term and no db (mean and db_part unread);
// dy is TY, the forward output's dtype (TX in LayerNorm mode).
template <typename TX, typename TW, typename TY, int C, int CPT, bool Drop,
          bool Rms>
__global__ void __launch_bounds__(kMaxThreads)
    ln_bwd_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                  const TW* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const TY* __restrict__ dy,
                  TX* __restrict__ dx, TX* __restrict__ dres,
                  float* __restrict__ dg_part, float* __restrict__ db_part,
                  int rows, int d, mxk::Dropout dr) {
  static_assert(!Drop || CPT * C <= 32, "keep bits exceed one register");
  static_assert(!(Drop && Rms), "RMS mode has no dropout");
  __shared__ float scratch1[32];
  __shared__ float scratch2[32];
  const int chunks = d / C;
  float dg[CPT][C], db[CPT][C];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int e = 0; e < C; ++e) dg[i][e] = db[i][e] = 0.f;

  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * d;
    const float mu = Rms ? 0.f : mean[r];
    const float rs = rstd[r];
    float xh[CPT][C], w[CPT][C];
    float s1 = 0.f, s2 = 0.f;
    uint32_t kbits = 0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < chunks) {
        float h[C], g[C], gy[C];
        mxk::load_f<TX, C>(x + row + c * C, h);
        if constexpr (Drop) {
#pragma unroll
          for (int e = 0; e < C; ++e) {
            const uint32_t flat = static_cast<uint32_t>(r) *
                                      static_cast<uint32_t>(d) +
                                  static_cast<uint32_t>(c * C + e);
            const bool keep = mxk::mx_row_keep(flat, dr.seed, dr.thresh);
            kbits |= static_cast<uint32_t>(keep) << (i * C + e);
            h[e] = keep ? h[e] * dr.scale : 0.f;
          }
        }
        if (res != nullptr) {
          float rv[C];
          mxk::load_f<TX, C>(res + row + c * C, rv);
#pragma unroll
          for (int e = 0; e < C; ++e) h[e] += rv[e];
        }
        mxk::load_f<TY, C>(dy + row + c * C, gy);
        mxk::load_f<TW, C>(gamma + c * C, g);
#pragma unroll
        for (int e = 0; e < C; ++e) {
          xh[i][e] = (h[e] - mu) * rs;
          w[i][e] = gy[e] * g[e];
          s2 += w[i][e] * xh[i][e];
          dg[i][e] += gy[e] * xh[i][e];
          if constexpr (!Rms) {
            s1 += w[i][e];
            db[i][e] += gy[e];
          }
        }
      }
    }
    const float m1 =
        Rms ? 0.f : mxk::block_sum(s1, scratch1) / static_cast<float>(d);
    const float m2 = mxk::block_sum(s2, scratch2) / static_cast<float>(d);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < chunks) {
        float o[C];
#pragma unroll
        for (int e = 0; e < C; ++e)
          o[e] = rs * (w[i][e] - m1 - xh[i][e] * m2);
        if constexpr (Drop) {
          if (dres != nullptr) mxk::store_f<TX, C>(dres + row + c * C, o);
#pragma unroll
          for (int e = 0; e < C; ++e)
            o[e] = (kbits >> (i * C + e)) & 1u ? o[e] * dr.scale : 0.f;
        }
        mxk::store_f<TX, C>(dx + row + c * C, o);
      }
    }
    __syncthreads();                   // the scratches are read
  }
  const size_t part = static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
#pragma unroll
      for (int e = 0; e < C; ++e) {
        dg_part[part + c * C + e] = dg[i][e];
        if constexpr (!Rms) db_part[part + c * C + e] = db[i][e];
      }
    }
  }
}

template <typename TX, typename TW, typename TY, bool Drop, bool Rms>
cudaError_t launch_bwd(const void* x, const void* res, const void* gamma,
                       const float* mean, const float* rstd, const void* dy,
                       void* dx, void* dres, float* dg_part, float* db_part,
                       int rows, int d, int n_blocks, bool vec,
                       const mxk::Dropout& dr, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TX* rp = static_cast<const TX*>(res);
  const TW* gp = static_cast<const TW*>(gamma);
  const TY* dyp = static_cast<const TY*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  TX* drp = static_cast<TX*>(dres);
  // at most 256 threads, each with CPT chunks: the fewest chunks per
  // thread that cover the row (d <= 8192)
  const int chunks = vec ? d / kChunk : d;
#define MX_LN_BWD(C, CPT)                                                   \
  ln_bwd_kernel<TX, TW, TY, C, CPT, Drop, Rms>                              \
      <<<n_blocks, mxk::row_threads((chunks + CPT - 1) / CPT, kMaxThreads), \
         0, stream>>>(xp, rp, gp, mean, rstd, dyp, dxp, drp, dg_part,       \
                      db_part, rows, d, dr)
  if (vec && chunks <= kMaxThreads) {
    MX_LN_BWD(kChunk, 1);
  } else if (vec && chunks <= 2 * kMaxThreads) {
    MX_LN_BWD(kChunk, 2);
  } else if (vec) {
    MX_LN_BWD(kChunk, 4);
  } else {
    MX_LN_BWD(1, 32);
  }
#undef MX_LN_BWD
  return cudaGetLastError();
}

}  // namespace

// x, res: (rows, d) contiguous in x's dtype (res may be null); gamma,
// beta: (d,) in one dtype; out: (rows, d) in x's dtype; mean, rstd:
// (rows,) f32 or null. vec != 0 requires d % 8 == 0, d <= 8192 and
// 16-byte aligned x, res, gamma, beta and out. drop != 0 drops x under
// (seed, thresh) with keep scale ``scale`` = f32(1 / (1 - p)). Returns
// cudaGetLastError() after the launch.
extern "C" int mx_layer_norm_fwd(const void* x, const void* res,
                                 const void* gamma, const void* beta,
                                 void* out, float* mean, float* rstd,
                                 int rows, int d, float eps, int x_dtype,
                                 int w_dtype, int vec, int drop,
                                 unsigned seed, unsigned thresh, float scale,
                                 void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  const mxk::Dropout dr{seed, thresh, scale};
#define MX_LN_FWD(TX, TW)                                                    \
  return drop ? launch<TX, TW, true>(x, res, gamma, beta, out, mean, rstd,   \
                                     rows, d, eps, v, dr, s)                 \
              : launch<TX, TW, false>(x, res, gamma, beta, out, mean, rstd,  \
                                      rows, d, eps, v, dr, s)
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kFloat32) {
    MX_LN_FWD(float, float);
  }
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kBFloat16) {
    MX_LN_FWD(bf16, bf16);
  }
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kFloat32) {
    MX_LN_FWD(bf16, float);
  }
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kBFloat16) {
    MX_LN_FWD(float, bf16);
  }
#undef MX_LN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward. x, res, dy, dx: (rows, d) contiguous in x's dtype (res may be
// null); gamma: (d,); mean, rstd: (rows,) f32 from the forward;
// dg_part, db_part: (n_blocks, d) f32, one partial row per CTA (the
// caller sums them). drop != 0: the forward's dropout (same seed,
// thresh, scale); dx is then the dropped gradient of x, and dres (rows,
// d) in x's dtype, or null, receives the residual's gradient. vec != 0
// requires d % 8 == 0, d <= 8192 and 16-byte aligned x, res, gamma, dy,
// dx and dres; otherwise d <= 8192. Returns cudaGetLastError() after
// the launch.
extern "C" int mx_layer_norm_bwd(const void* x, const void* res,
                                 const void* gamma, const float* mean,
                                 const float* rstd, const void* dy, void* dx,
                                 void* dres, float* dg_part, float* db_part,
                                 int rows, int d, int n_blocks, int x_dtype,
                                 int w_dtype, int vec, int drop,
                                 unsigned seed, unsigned thresh, float scale,
                                 void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  const mxk::Dropout dr{seed, thresh, scale};
  if (d < 1 || d > 8192 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MX_LN_BWD_T(TX, TW)                                                 \
  return drop ? launch_bwd<TX, TW, TX, true, false>(                        \
                   x, res, gamma, mean, rstd, dy, dx, dres, dg_part,        \
                   db_part, rows, d, n_blocks, v, dr, s)                    \
              : launch_bwd<TX, TW, TX, false, false>(                       \
                    x, res, gamma, mean, rstd, dy, dx, dres, dg_part,       \
                    db_part, rows, d, n_blocks, v, dr, s)
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kFloat32) {
    MX_LN_BWD_T(float, float);
  }
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kBFloat16) {
    MX_LN_BWD_T(bf16, bf16);
  }
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kFloat32) {
    MX_LN_BWD_T(bf16, float);
  }
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kBFloat16) {
    MX_LN_BWD_T(float, bf16);
  }
#undef MX_LN_BWD_T
  return static_cast<int>(cudaErrorInvalidValue);
}

// RMSNorm backward (the Rms instances). x, dx: (rows, d) contiguous in
// x's dtype; w: (d,); rstd: (rows,) f32 from mx_rms_norm_fwd; dy: (rows,
// d) in result_type(x, w); dw_part: (n_blocks, d) f32, one partial row
// per CTA (the caller sums them). vec != 0 requires d % 8 == 0 and
// 16-byte aligned x, w, dy and dx; d <= 8192 either way. Returns
// cudaGetLastError() after the launch.
extern "C" int mx_rms_norm_bwd(const void* x, const void* w,
                               const float* rstd, const void* dy, void* dx,
                               float* dw_part, int rows, int d, int n_blocks,
                               int x_dtype, int w_dtype, int vec,
                               void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  const mxk::Dropout none{0u, 0u, 1.f};
  if (d < 1 || d > 8192 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MX_RMS_BWD_T(TX, TW, TY)                                          \
  return launch_bwd<TX, TW, TY, false, true>(x, nullptr, w, nullptr, rstd, \
                                             dy, dx, nullptr, dw_part,     \
                                             nullptr, rows, d, n_blocks, v, \
                                             none, s)
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kFloat32) {
    MX_RMS_BWD_T(float, float, float);
  }
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kBFloat16) {
    MX_RMS_BWD_T(bf16, bf16, bf16);
  }
  if (x_dtype == mxk::kBFloat16 && w_dtype == mxk::kFloat32) {
    MX_RMS_BWD_T(bf16, float, float);
  }
  if (x_dtype == mxk::kFloat32 && w_dtype == mxk::kBFloat16) {
    MX_RMS_BWD_T(float, bf16, float);
  }
#undef MX_RMS_BWD_T
  return static_cast<int>(cudaErrorInvalidValue);
}
