// Fused LayerNorm(+ residual) forward and backward, and the RMSNorm
// backward, for Hopper (sm_90a).
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
// with and without the residual and dropout. Numerics follow the Pallas
// kernel: h recomputed as the forward formed it, xhat = (h - mean) *
// rstd from the saved f32 statistics, wdy = dy * gamma, dh = rstd * (wdy
// - mean(wdy) - xhat * mean(wdy * xhat)) in f32, dx = dh rounded once to
// x's dtype (the residual's gradient is the same dx); with dropout dx =
// keep ? dh * f32(1 / (1 - p)) : 0 and the residual's gradient dh is a
// separate output, dres (`_norm_bwd_kernel`'s dres, :257, :290-291);
// dgamma = sum(dy * xhat), dbeta = sum(dy) over the rows in f32, then
// in gamma's dtype.
//
// What bounds it on an H100: device-memory bytes (x, the residual and
// dy read once, dx and dres written once), ~12 f32 operations per
// element. So the design keeps loads in flight through the row
// reductions and reads nothing twice from device memory
// (ln_bwd_ring_kernel): a persistent grid of one 16-warp CTA per SM; a
// row is one warp's (d <= 1024; 2-8 warps meeting on a named barrier up
// to d 8192), so its two reductions are warp shuffles with no CTA-wide
// barrier; the rows stream through a per-warp ring of shared-memory
// stages filled by the bulk-copy engine (one 1-D cp.async.bulk per
// operand row, completing on the stage's mbarrier), several rows ahead;
// the second pass reads the row again from the stage; gamma sits in
// shared memory and dgamma/dbeta in registers for the CTA's life. The
// column sums over the CTAs finish in the same launch (final_sums): one
// f32 partial row per CTA, then the last CTAs to arrive sum them in a
// fixed order, so there is one launch per call and the bits repeat.
// Any d or alignment the 16-byte route cannot take goes through
// ln_bwd_scalar_kernel (one CTA walks strided rows with block
// reductions), which ends the same way.
//
// mx_rms_norm_bwd is the same kernels in RMS mode (the `Rms` instances),
// replacing `_norm_bwd_kernel` with rms=True, no residual, no dropout
// (reached through `_rms_bwd`, fused_layers.py:479-486), the backward of
// rms_norm.cu's forward: xhat = x * rstd from the forward's saved f32
// rstd, in f32 and not rounded to x's dtype (the forward rounds it, the
// Pallas backward does not); wdy = dy * w; dx = rstd * (wdy - xhat *
// mean(wdy * xhat)) in x's dtype; dw = sum(dy * xhat) in w's dtype. dy
// comes in the forward output's dtype, result_type(x, w). Its bytes
// bound it as the LayerNorm backward's do.
#include "common.cuh"
#include "hash_dropout.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// The vec route's layout (ln_bwd_ring_kernel).
// mxnet_tpu_torch/tools/norm_bwd_ablation.py times text edits of these
// lines and of the kernel in copies of this file.
constexpr int kBwdWarps = 16;            // warps per CTA at most
constexpr int kBwdMaxStages = 4;         // ring stages per row group
constexpr int kBwdSmemBudget = 200 * 1024;
constexpr int kBwdReducers = 32;         // CTAs that share the final sum
constexpr int kBwdMaxBlocksPerSm = 8;    // the scalar route's grid

// How ln_bwd_ring_kernel lays a (rows, d) problem on the card.
struct BwdPlan {
  int wpr;          // warps per row, a power of two (1 up to d 1024)
  int cpt;          // 8-element chunks per thread and row, 1..4
  int gpc;          // row groups (rows in flight) per CTA
  int stages;       // ring stages per group
  int stage_bytes;  // one row of x (the residual) and dy
  int smem;         // dynamic shared memory: gamma in f32, then the ring
};

inline BwdPlan bwd_plan(int d, int sx, int sy, bool has_res, bool rms) {
  BwdPlan p;
  const int chunks = d / kChunk;
  p.wpr = 1;
  while (p.wpr * 32 * kMaxChunksPerThread < chunks) p.wpr *= 2;
  p.cpt = (chunks + p.wpr * 32 - 1) / (p.wpr * 32);
  p.gpc = kBwdWarps / p.wpr;     // wpr <= 8 at d <= 8192
  p.stage_bytes = d * (sx * (has_res ? 2 : 1) + sy);
  const int gam = d * 4;
  while (p.gpc > 1 && gam + p.gpc * p.stage_bytes > kBwdSmemBudget)
    p.gpc /= 2;
  p.stages = (kBwdSmemBudget - gam) / (p.gpc * p.stage_bytes);
  p.stages = p.stages < 1 ? 1
             : (p.stages > kBwdMaxStages ? kBwdMaxStages : p.stages);
  const int ring = p.gpc * p.stages * p.stage_bytes;
  const int red = p.gpc * (rms ? 1 : 2) * d * 4;
  p.smem = gam + (ring > red ? ring : red);
  return p;
}

// The grid of ln_bwd_ring_kernel: kBwdWarps warps per SM, as many CTAs as
// hold them (shared memory permitting), never more CTAs than row groups.
inline int bwd_ring_blocks(const BwdPlan& p, int rows, int sms) {
  int per_sm = kBwdWarps / (p.gpc * p.wpr);
  const int by_smem = (227 * 1024) / (p.smem + 2048);
  if (per_sm > by_smem) per_sm = by_smem;
  if (per_sm < 1) per_sm = 1;
  const long long want = (static_cast<long long>(rows) + p.gpc - 1) / p.gpc;
  const long long cap = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(want < cap ? want : cap);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The end of every backward CTA, after it has written its f32 partial
// rows parts[a][blockIdx.x][0, d) (a = 0: dgamma, 1: dbeta; n_arr of
// them): one thread releases the CTA's writes and counts it in on
// ``counter`` (zeroed on the stream before the launch; the only atomic),
// and the last kBwdReducers CTAs to arrive wait for the rest, then each
// sums its share of the columns over the gridDim.x partial rows and
// writes them in TW. The order of every sum is fixed by the grid and d
// alone, so the bits are the same run to run. Fewer reducers leave the
// sum to a few SMs (with 8 it took about 9 of the 53 us of BERT's
// residual case on an H100); more would hold more SMs spinning while
// the last CTAs finish. V columns per load (4: d % 4 == 0, 16-byte
// aligned).
template <int V, typename TW>
__device__ void final_sums(const float* __restrict__ parts, int n_arr,
                           int d, int* counter, TW* __restrict__ dg,
                           TW* __restrict__ db) {
  __shared__ int slot;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();     // cumulative: the CTA's writes, seen at the barrier
    slot = atomicAdd(counter, 1);
  }
  __syncthreads();
  const int n_parts = gridDim.x;
  const int n_red = n_parts < kBwdReducers ? n_parts : kBwdReducers;
  const int j = slot - (n_parts - n_red);
  if (j < 0) return;
  if (threadIdx.x == 0) {
    while (ld_acquire(counter) < n_parts) __nanosleep(64);
  }
  __syncthreads();
  const int groups = d / V;
  const int items = n_arr * groups;          // (array, V columns)
  const int per = (items + n_red - 1) / n_red;
  const int lo = j * per;
  const int hi = items < lo + per ? items : lo + per;
  // tpi lanes share an item (a power of two <= 32), each summing every
  // tpi-th partial row, then a fixed shuffle tree
  int tpi = 32;
  while (tpi > 1 && static_cast<int>(blockDim.x) / tpi < per) tpi >>= 1;
  const int slots = blockDim.x / tpi;
  const int sub = threadIdx.x % tpi;
  for (int base = lo; base < hi; base += slots) {
    const int item = base + static_cast<int>(threadIdx.x) / tpi;
    const bool ok = item < hi;
    const int a = ok ? item / groups : 0;
    const int col = ok ? (item - a * groups) * V : 0;
    float s[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = 0.f;
    if (ok) {
      const float* src = parts + static_cast<size_t>(a) * n_parts * d + col;
#pragma unroll 8
      for (int g = sub; g < n_parts; g += tpi) {
        if constexpr (V == 4) {
          const float4 t = __ldcg(
              reinterpret_cast<const float4*>(src + static_cast<size_t>(g) * d));
          s[0] += t.x;
          s[1] += t.y;
          s[2] += t.z;
          s[3] += t.w;
        } else {
          s[0] += __ldcg(src + static_cast<size_t>(g) * d);
        }
      }
    }
    for (int o = tpi / 2; o > 0; o >>= 1)
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] += __shfl_xor_sync(0xffffffffu, s[v], o);
    if (ok && sub == 0) {
      TW* out = a == 0 ? dg : db;
#pragma unroll
      for (int v = 0; v < V; ++v) out[col + v] = mxk::from_f<TW>(s[v]);
    }
  }
}

// h = dropout(x) + res for one 8-element chunk, from ``xr``/``rr`` (the
// ring's stage). First pass (First = true): the keep
// bits come from the hash of the flat ids and are recorded in ``kbits``
// (bit i * 8 + e); second pass: read back from it.
template <typename TX, bool Drop, bool First>
__device__ __forceinline__ void chunk_h(const TX* xr, const TX* rr, int c,
                                        int i, int row, int d,
                                        const mxk::Dropout& dr,
                                        uint32_t& kbits, float (&h)[kChunk]) {
  mxk::load_f<TX, kChunk>(xr + c * kChunk, h);
  if constexpr (Drop) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      bool keep;
      if constexpr (First) {
        const uint32_t flat =
            static_cast<uint32_t>(row) * static_cast<uint32_t>(d) +
            static_cast<uint32_t>(c * kChunk + e);
        keep = mxk::mx_row_keep(flat, dr.seed, dr.thresh);
        kbits |= static_cast<uint32_t>(keep) << (i * kChunk + e);
      } else {
        keep = (kbits >> (i * kChunk + e)) & 1u;
      }
      h[e] = keep ? h[e] * dr.scale : 0.f;
    }
  }
  if (rr != nullptr) {
    float rv[kChunk];
    mxk::load_f<TX, kChunk>(rr + c * kChunk, rv);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) h[e] += rv[e];
  }
}

// The vec route (d % 8 == 0, 16-byte aligned rows). A persistent grid;
// CTA b owns rows [b * rows / G, (b + 1) * rows / G), dealt round-robin
// to its p.gpc row groups of p.wpr warps. A group's first thread keeps
// p.stages rows in flight: one bulk copy per operand row (x, the
// residual, dy) into the group's ring stage, completing on the stage's
// mbarrier. Per row the group reads the stage twice: the first pass sums
// mean(wdy) and mean(wdy * xhat) (warp shuffles; across the group's
// warps through shared memory and a named barrier) and adds dy * xhat
// and dy to the thread's dgamma/dbeta columns in registers; the second
// recomputes xhat and wdy from the stage and writes dx (and dres). Then
// the group releases the stage and its first thread refills it with the
// row p.stages ahead. gamma sits in shared memory, in f32, for the CTA's
// life. At the end the groups' columns are summed in shared memory into
// one partial row per CTA, and final_sums adds those up in this launch.
template <typename TX, typename TW, typename TY, int CPT, bool Drop,
          bool Rms>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
    ln_bwd_ring_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                       const TW* __restrict__ gamma,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const TY* __restrict__ dy, TX* __restrict__ dx,
                       TX* __restrict__ dres, float* __restrict__ parts,
                       int* counter, TW* __restrict__ dgamma,
                       TW* __restrict__ dbeta, int rows, int d,
                       BwdPlan p, mxk::Dropout dr) {
  static_assert(!(Drop && Rms), "RMS mode has no dropout");
  static_assert(CPT * kChunk <= 32, "keep bits exceed one register");
  constexpr int A = Rms ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kBwdWarps * kBwdMaxStages];
  __shared__ float wsum[kBwdWarps][2];
  const int chunks = d / kChunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = warp / p.wpr;
  const int gthreads = p.wpr * 32;
  const int gt = threadIdx.x - grp * gthreads;
  float* gam = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + d * 4 + grp * p.stages * p.stage_bytes;
  uint64_t* bars = full + grp * kBwdMaxStages;
  const int r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * rows /
                                  gridDim.x);
  const int r1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * rows / gridDim.x);
  const int n_rows = r1 - r0 > grp ? (r1 - r0 - grp + p.gpc - 1) / p.gpc : 0;
  const uint32_t x_bytes = static_cast<uint32_t>(d * sizeof(TX));
  const uint32_t y_off = (res != nullptr ? 2u : 1u) * x_bytes;

  // the group's k-th row into stage k % p.stages
  auto issue = [&](int k) {
    const size_t off = static_cast<size_t>(r0 + grp + k * p.gpc) * d;
    uint64_t* bar = bars + k % p.stages;
    unsigned char* st = ring + (k % p.stages) * p.stage_bytes;
    mxhop::mbar_expect_tx(bar, static_cast<uint32_t>(p.stage_bytes));
    mxhop::bulk_g2s(st, x + off, x_bytes, bar);
    if (res != nullptr) mxhop::bulk_g2s(st + x_bytes, res + off, x_bytes, bar);
    mxhop::bulk_g2s(st + y_off, dy + off,
                    static_cast<uint32_t>(d * sizeof(TY)), bar);
  };
  if (gt == 0) {
    for (int s = 0; s < p.stages; ++s) mxhop::mbar_init(bars + s, 1);
    mxhop::mbar_init_fence();
    for (int k = 0; k < p.stages && k < n_rows; ++k) issue(k);
  }
  for (int j = threadIdx.x; j < d; j += blockDim.x)
    gam[j] = mxk::to_f(gamma[j]);
  __syncthreads();

  float dg[CPT][kChunk], db[CPT][kChunk];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int e = 0; e < kChunk; ++e) dg[i][e] = db[i][e] = 0.f;
  int r = r0 + grp;
  float mu_next = 0.f, rs_next = 0.f;
  if (n_rows > 0) {
    mu_next = Rms ? 0.f : mean[r];
    rs_next = rstd[r];
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0; k < n_rows; ++k, r += p.gpc) {
    const float mu = mu_next, rs = rs_next;
    if (k + 1 < n_rows) {           // the next row's statistics, early
      mu_next = Rms ? 0.f : mean[r + p.gpc];
      rs_next = rstd[r + p.gpc];
    }
    mxhop::mbar_wait(bars + stage, phase);
    const unsigned char* st = ring + stage * p.stage_bytes;
    const TX* xr = reinterpret_cast<const TX*>(st);
    const TX* rr =
        res != nullptr ? reinterpret_cast<const TX*>(st + x_bytes) : nullptr;
    const TY* yr = reinterpret_cast<const TY*>(st + y_off);
    float s1 = 0.f, s2 = 0.f;
    uint32_t kbits = 0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = gt + i * gthreads;
      if (c < chunks) {
        float h[kChunk], gy[kChunk], g[kChunk];
        chunk_h<TX, Drop, true>(xr, rr, c, i, r, d, dr, kbits, h);
        mxk::load_f<TY, kChunk>(yr + c * kChunk, gy);
        mxk::load_f<float, kChunk>(gam + c * kChunk, g);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          const float xh = (h[e] - mu) * rs;
          const float w = gy[e] * g[e];
          s2 += w * xh;
          dg[i][e] += gy[e] * xh;
          if constexpr (!Rms) {
            s1 += w;
            db[i][e] += gy[e];
          }
        }
      }
    }
    s2 = mxk::warp_sum(s2);
    if constexpr (!Rms) s1 = mxk::warp_sum(s1);
    if (p.wpr > 1) {
      if (lane == 0) {
        wsum[warp][0] = s1;
        wsum[warp][1] = s2;
      }
      mxhop::named_sync(1 + grp, gthreads);
      s1 = s2 = 0.f;
      for (int w = grp * p.wpr; w < (grp + 1) * p.wpr; ++w) {
        s1 += wsum[w][0];
        s2 += wsum[w][1];
      }
    }
    const float m1 = Rms ? 0.f : s1 / static_cast<float>(d);
    const float m2 = s2 / static_cast<float>(d);
    const size_t row = static_cast<size_t>(r) * d;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = gt + i * gthreads;
      if (c < chunks) {
        float h[kChunk], gy[kChunk], g[kChunk], o[kChunk];
        chunk_h<TX, Drop, false>(xr, rr, c, i, r, d, dr, kbits, h);
        mxk::load_f<TY, kChunk>(yr + c * kChunk, gy);
        mxk::load_f<float, kChunk>(gam + c * kChunk, g);
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          o[e] = rs * (gy[e] * g[e] - m1 - (h[e] - mu) * rs * m2);
        if constexpr (Drop) {
          if (dres != nullptr) mxk::store_f<TX, kChunk>(dres + row + c * kChunk, o);
#pragma unroll
          for (int e = 0; e < kChunk; ++e)
            o[e] = (kbits >> (i * kChunk + e)) & 1u ? o[e] * dr.scale : 0.f;
        }
        mxk::store_f<TX, kChunk>(dx + row + c * kChunk, o);
      }
    }
    // every thread of the group is done with the stage (and wsum)
    if (p.wpr > 1) {
      mxhop::named_sync(1 + grp, gthreads);
    } else {
      __syncwarp();
    }
    if (gt == 0 && k + p.stages < n_rows) issue(k + p.stages);
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1u;
    }
  }

  // the groups' columns, summed in group order into this CTA's partial row
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + d * 4);
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = gt + i * gthreads;
    if (c < chunks) {
      mxk::store_f<float, kChunk>(red + (grp * A) * d + c * kChunk, dg[i]);
      if constexpr (!Rms)
        mxk::store_f<float, kChunk>(red + (grp * A + 1) * d + c * kChunk,
                                    db[i]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < A * d; j += blockDim.x) {
    const int a = j / d;
    const int col = j - a * d;
    float s = 0.f;
    for (int g = 0; g < p.gpc; ++g) s += red[(g * A + a) * d + col];
    parts[(static_cast<size_t>(a) * gridDim.x + blockIdx.x) * d + col] = s;
  }
  final_sums<4, TW>(parts, A, d, counter, dgamma, dbeta);
}

// The scalar route (any d <= 8192, any alignment): rows blockIdx.x,
// blockIdx.x + gridDim.x, ...; each thread owns elements threadIdx.x +
// i * blockDim.x (i < 32) of every row, keeps xhat and wdy in registers
// between the two block reductions, and its dgamma/dbeta columns across
// rows; one f32 partial row per CTA, then final_sums. Drop: the keep
// bits of the thread's 32 elements stay in ``kbits``.
template <typename TX, typename TW, typename TY, bool Drop, bool Rms>
__global__ void __launch_bounds__(kMaxThreads)
    ln_bwd_scalar_kernel(const TX* __restrict__ x, const TX* __restrict__ res,
                         const TW* __restrict__ gamma,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const TY* __restrict__ dy, TX* __restrict__ dx,
                         TX* __restrict__ dres, float* __restrict__ parts,
                         int* counter, TW* __restrict__ dgamma,
                         TW* __restrict__ dbeta, int rows, int d,
                         mxk::Dropout dr) {
  static_assert(!(Drop && Rms), "RMS mode has no dropout");
  constexpr int CPT = 32;
  __shared__ float scratch1[32];
  __shared__ float scratch2[32];
  float dg[CPT], db[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) dg[i] = db[i] = 0.f;

  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t row = static_cast<size_t>(r) * d;
    const float mu = Rms ? 0.f : mean[r];
    const float rs = rstd[r];
    float xh[CPT], w[CPT];
    float s1 = 0.f, s2 = 0.f;
    uint32_t kbits = 0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < d) {
        float h = mxk::to_f(x[row + c]);
        if constexpr (Drop) {
          const uint32_t flat = static_cast<uint32_t>(r) *
                                    static_cast<uint32_t>(d) +
                                static_cast<uint32_t>(c);
          const bool keep = mxk::mx_row_keep(flat, dr.seed, dr.thresh);
          kbits |= static_cast<uint32_t>(keep) << i;
          h = keep ? h * dr.scale : 0.f;
        }
        if (res != nullptr) h += mxk::to_f(res[row + c]);
        const float gy = mxk::to_f(dy[row + c]);
        xh[i] = (h - mu) * rs;
        w[i] = gy * mxk::to_f(gamma[c]);
        s2 += w[i] * xh[i];
        dg[i] += gy * xh[i];
        if constexpr (!Rms) {
          s1 += w[i];
          db[i] += gy;
        }
      }
    }
    const float m1 =
        Rms ? 0.f : mxk::block_sum(s1, scratch1) / static_cast<float>(d);
    const float m2 = mxk::block_sum(s2, scratch2) / static_cast<float>(d);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < d) {
        float o = rs * (w[i] - m1 - xh[i] * m2);
        if constexpr (Drop) {
          if (dres != nullptr) dres[row + c] = mxk::from_f<TX>(o);
          o = (kbits >> i) & 1u ? o * dr.scale : 0.f;
        }
        dx[row + c] = mxk::from_f<TX>(o);
      }
    }
    __syncthreads();                   // the scratches are read
  }
  const int a_rows = Rms ? 1 : 2;
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < d) {
      parts[static_cast<size_t>(blockIdx.x) * d + c] = dg[i];
      if constexpr (!Rms)
        parts[(static_cast<size_t>(gridDim.x) + blockIdx.x) * d + c] = db[i];
    }
  }
  final_sums<1, TW>(parts, a_rows, d, counter, dgamma, dbeta);
}

template <typename TX, typename TW, typename TY, bool Drop, bool Rms>
cudaError_t launch_bwd(const void* x, const void* res, const void* gamma,
                       const float* mean, const float* rstd, const void* dy,
                       void* dx, void* dres, void* dgamma, void* dbeta,
                       float* parts, int* counter, int rows, int d,
                       int n_blocks, bool vec, const mxk::Dropout& dr,
                       cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TX* rp = static_cast<const TX*>(res);
  const TW* gp = static_cast<const TW*>(gamma);
  const TY* dyp = static_cast<const TY*>(dy);
  TX* dxp = static_cast<TX*>(dx);
  TX* drp = static_cast<TX*>(dres);
  TW* dgp = static_cast<TW*>(dgamma);
  TW* dbp = static_cast<TW*>(dbeta);
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  if (!vec) {
    ln_bwd_scalar_kernel<TX, TW, TY, Drop, Rms>
        <<<n_blocks, mxk::row_threads((d + 31) / 32, kMaxThreads), 0,
           stream>>>(xp, rp, gp, mean, rstd, dyp, dxp, drp, parts, counter,
                     dgp, dbp, rows, d, dr);
    return cudaGetLastError();
  }
  const BwdPlan p = bwd_plan(d, sizeof(TX), sizeof(TY), res != nullptr, Rms);
#define MX_LN_BWD_RING(CPT)                                                \
  {                                                                        \
    auto kernel = ln_bwd_ring_kernel<TX, TW, TY, CPT, Drop, Rms>;          \
    e = mxk::allow_smem(kernel, p.smem);                                   \
    if (e != cudaSuccess) return e;                                        \
    kernel<<<n_blocks, p.gpc * p.wpr * 32, p.smem, stream>>>(              \
        xp, rp, gp, mean, rstd, dyp, dxp, drp, parts, counter, dgp, dbp,   \
        rows, d, p, dr);                                                   \
  }
  switch (p.cpt) {
    case 1: MX_LN_BWD_RING(1) break;
    case 2: MX_LN_BWD_RING(2) break;
    case 3: MX_LN_BWD_RING(3) break;
    default: MX_LN_BWD_RING(4) break;
  }
#undef MX_LN_BWD_RING
  return cudaGetLastError();
}

int dtype_size(int code) { return code == mxk::kFloat32 ? 4 : 2; }

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

// The n_blocks that mx_layer_norm_bwd (rms == 0) or mx_rms_norm_bwd
// (rms != 0) takes for these arguments on a card of ``sms`` SMs, which
// is also the number of f32 partial rows (per array) their ``parts``
// scratch must hold; y_dtype is dy's. Returns it, or -1 for arguments
// the kernels do not take.
extern "C" int mx_norm_bwd_blocks(int rows, int d, int x_dtype, int y_dtype,
                                  int has_res, int vec, int rms, int sms) {
  if (rows < 1 || d < 1 || d > 8192 || sms < 1) return -1;
  if (vec == 0) {
    const long long cap = static_cast<long long>(sms) * kBwdMaxBlocksPerSm;
    return static_cast<int>(rows < cap ? rows : cap);
  }
  const BwdPlan p = bwd_plan(d, dtype_size(x_dtype), dtype_size(y_dtype),
                             has_res != 0, rms != 0);
  return bwd_ring_blocks(p, rows, sms);
}

// Backward. x, res, dy, dx: (rows, d) contiguous in x's dtype (res may be
// null); gamma: (d,); mean, rstd: (rows,) f32 from the forward; dgamma,
// dbeta: (d,) in gamma's dtype, written. parts: (2, n_blocks, d) f32 and
// counter: one int32, scratch (the counter is zeroed on ``stream`` here);
// n_blocks from mx_norm_bwd_blocks. drop != 0: the forward's dropout
// (same seed, thresh, scale); dx is then the dropped gradient of x, and
// dres (rows, d) in x's dtype, or null, receives the residual's
// gradient. vec != 0 requires d % 8 == 0 and 16-byte aligned x, res,
// gamma, dy, dx and dres; d <= 8192 either way. Returns the first CUDA
// error of the memset and the launch.
extern "C" int mx_layer_norm_bwd(const void* x, const void* res,
                                 const void* gamma, const float* mean,
                                 const float* rstd, const void* dy, void* dx,
                                 void* dres, void* dgamma, void* dbeta,
                                 float* parts, int* counter, int rows, int d,
                                 int n_blocks, int x_dtype, int w_dtype,
                                 int vec, int drop, unsigned seed,
                                 unsigned thresh, float scale,
                                 void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  const mxk::Dropout dr{seed, thresh, scale};
  if (d < 1 || d > 8192 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MX_LN_BWD_T(TX, TW)                                                 \
  return drop ? launch_bwd<TX, TW, TX, true, false>(                        \
                   x, res, gamma, mean, rstd, dy, dx, dres, dgamma, dbeta,  \
                   parts, counter, rows, d, n_blocks, v, dr, s)             \
              : launch_bwd<TX, TW, TX, false, false>(                       \
                    x, res, gamma, mean, rstd, dy, dx, dres, dgamma, dbeta, \
                    parts, counter, rows, d, n_blocks, v, dr, s)
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
// d) in result_type(x, w); dw: (d,) in w's dtype, written. parts: (1,
// n_blocks, d) f32 and counter: one int32, scratch, as for
// mx_layer_norm_bwd. vec != 0 requires d % 8 == 0 and 16-byte aligned x,
// w, dy and dx; d <= 8192 either way. Returns the first CUDA error of
// the memset and the launch.
extern "C" int mx_rms_norm_bwd(const void* x, const void* w,
                               const float* rstd, const void* dy, void* dx,
                               void* dw, float* parts, int* counter,
                               int rows, int d, int n_blocks, int x_dtype,
                               int w_dtype, int vec, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  const mxk::Dropout none{0u, 0u, 1.f};
  if (d < 1 || d > 8192 || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define MX_RMS_BWD_T(TX, TW, TY)                                           \
  return launch_bwd<TX, TW, TY, false, true>(                              \
      x, nullptr, w, nullptr, rstd, dy, dx, nullptr, dw, nullptr, parts,   \
      counter, rows, d, n_blocks, v, none, s)
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
