// Paged single-query (decode) attention for Hopper (sm_90a):
// flash-decoding over the page table.
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/paged_attention.py
// `paged_attention_kernel` (the pallas_call at :150) / `_decode_kernel`
// (:60).
//
// On the TPU the grid (batch, pages) runs in order on one core, the
// scalar-prefetched page table steers each step's DMA at one arena page,
// and the online-softmax accumulator lives in VMEM scratch across the
// page axis. Hopper runs CTAs in parallel with no order, so the page axis
// is split: CTA (batch row * KV + kv head, split) owns a contiguous run
// of `pps` = ceil(P / n_split) table columns, reads their page ids into
// shared memory once, and streams that run's K/V rows; a second, small
// kernel merges the splits' f32 partials in a fixed order.
//
// What bounds it on an H100: device-memory bytes. A step reads
// 2 * sum(len) * KV * D elements of K/V and does ~4 flops per element
// per grouped q head (G = H / KV = 4 at Llama-3-8B): far below the 295
// flop/byte ridge, and at batch 8 the whole read is ~13 MB, a few
// microseconds at 3.35 TB/s. What the design does about it:
//
//  * enough CTAs to fill the card: n_split is taken by the wrapper from
//    static shapes alone (the table's width x page size, B * KV and the
//    SM count: about four CTAs per SM), never from `lengths`, so the
//    decode path has no device-to-host sync. A CTA whose run lies past
//    its row's length writes an empty partial (m = -inf, l = 0) and
//    exits; load imbalance between long and short rows is cut to one
//    run's length;
//  * the K/V rows stream through shared memory with cp.async (16 bytes a
//    lane, zero-filled past the row's end): each of the CTA's two warps
//    runs its own two-stage ring of 32-token tiles, so while it scores
//    one tile (two pages at page size 16) the next is in flight, and no
//    CTA-wide barrier stalls the loads;
//  * a tile is scored for all G grouped heads at once, so there is no
//    per-token warp reduction. bf16 runs it on the tensor cores:
//    mma.sync m16n8k16 with the G heads as the rows of A (q's fragments
//    held in registers for the run), K rows as B, P back as A (bf16 hi
//    + lo parts) for O += P . V with V read transposed by ldmatrix; the
//    tile's row max is two shuffles. f32 gives a lane to each token (q
//    pre-scaled in shared memory, read as broadcasts), one warp max per
//    head per 32 tokens, then D / 32 output dims a lane for P.V. Padded
//    rows keep the K/V reads conflict-free. K and V are read once per KV
//    head: grouped-query attention never repeats them;
//  * the merge is deterministic: each split's (m, l, acc) go to an f32
//    workspace the wrapper allocates, and the combine kernel merges them
//    in split order and rounds once to q's dtype. The same inputs give
//    the same bits on every call. A length-0 row emits zeros, like
//    `_decode_kernel`'s l == 0 pin.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kWarps = 2;    // warps per CTA, each its own pipeline
constexpr int kTile = 32;    // tokens per warp tile: a lane per token
constexpr int kStages = 2;   // tiles in a warp's ring

template <typename T, int D>
struct Plan {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kStage = 2 * kTile * kRowBytes;   // K rows, V rows
  static constexpr int kRing = kWarps * kStages * kStage;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A warp's online-softmax state over its tiles, two ways:
//
// LaneTokens (f32): a lane per token for the scores, q pre-scaled in f32
// in shared memory read as broadcasts; D / 32 output dims a lane for
// P.V, the probabilities passed through the warp's `pw` slice.
template <typename T, int G, int D>
struct LaneTokens {
  static constexpr int EPL = D / 32;
  float m[G], l[G], acc[G][EPL];   // l: this lane's share of the row sum

  __device__ __forceinline__ void init(const T*, const float*, int) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = -CUDART_INF_F;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
    }
  }

  __device__ __forceinline__ void tile(const unsigned char* st, int nv,
                                       const float* qs, float* pw, float,
                                       int lane) {
    using P = Plan<T, D>;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    const T* kr = reinterpret_cast<const T*>(st + lane * P::kRowBytes);
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      float kf[8];
      mxk::load_f<T, 8>(kr + c, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(qs + g * D + c);
        const float4 b =
            *reinterpret_cast<const float4*>(qs + g * D + c + 4);
        s[g] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                b.x * kf[4] + b.y * kf[5] + b.z * kf[6] + b.w * kf[7];
      }
    }
    const bool valid = lane < nv;
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = valid ? s[g] : -CUDART_INF_F;
      // lane 0's token is valid, so m_new is finite; expf(-inf) = 0
      // rescales the empty initial state away
      const float m_new = fmaxf(m[g], warp_max(x));
      alpha[g] = expf(m[g] - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      l[g] = l[g] * alpha[g] + p;
      m[g] = m_new;
      pw[lane * G + g] = p;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha[g];
    const unsigned char* vt = st + kTile * P::kRowBytes +
                              lane * EPL * static_cast<int>(sizeof(T));
    for (int t = 0; t < nv; ++t) {
      float vf[EPL], pg[G];
      mxk::load_f<T, EPL>(
          reinterpret_cast<const T*>(vt + t * P::kRowBytes), vf);
      mxk::load_f<float, G>(pw + t * G, pg);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += pg[g] * vf[e];
    }
  }

  // (m, l) of each head and its D outputs into this warp's slots
  __device__ __forceinline__ void store(float* mm, float* ll, float* aa,
                                        int lane) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float lg = mxk::warp_sum(l[g]);
      if (lane == 0) {
        mm[g] = m[g];
        ll[g] = lg;
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) aa[g * D + lane * EPL + e] = acc[g][e];
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

// HeadRows (bf16): the tile on the tensor cores, mma.sync m16n8k16 with
// the G heads as the rows of A (rows G..15 zero) and f32 accumulation.
// S = q . K^T takes q as A fragments held in registers for the whole
// run and K rows from the tile as B; P goes back as the A operand of
// O += P . V, split into bf16 hi and lo parts so that it keeps the f32
// plain version's precision, V read transposed by ldmatrix. Lane (gr =
// lane / 4, tq = lane % 4) holds head gr's scores at tokens 8 n + 2 tq
// (+1) and its outputs at dims 8 n + 2 tq (+1); the tile's row max
// takes two shuffles.
template <int G, int D>
struct HeadRows {
  using T = __nv_bfloat16;
  uint32_t qa[D / 16][2];   // A fragments a0, a2 (a1 = a3 = 0: rows 8..15)
  float o[D / 8][4];
  float m, l;               // head gr's max, this lane's share of its sum

  __device__ __forceinline__ void init(const T* q, const float*, int lane) {
    const int gr = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int kb = 0; kb < D / 16; ++kb) {
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(
          q + gr * D + kb * 16 + 2 * tq);
      qa[kb][0] = gr < G ? qr[0] : 0u;
      qa[kb][1] = gr < G ? qr[4] : 0u;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m = -CUDART_INF_F;
    l = 0.f;
  }

  __device__ __forceinline__ void tile(const unsigned char* st, int nv,
                                       const float*, float*, float scale,
                                       int lane) {
    using P = Plan<T, D>;
    const int gr = lane >> 2;
    const int tq = lane & 3;
    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < D / 16; ++kb) {
      const uint32_t a[4] = {qa[kb][0], 0u, qa[kb][1], 0u};
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const unsigned char* kr =
            st + (n * 8 + gr) * P::kRowBytes + (kb * 16 + 2 * tq) * 2;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                               *reinterpret_cast<const uint32_t*>(kr + 16)};
        mxflash::mma_bf16(s[n], a, b);
      }
    }
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = n * 8 + 2 * tq + e < nv;
        s[n][e] = valid ? s[n][e] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // token 0 is valid, so m_new is finite; expf(-inf) = 0 rescales the
    // empty initial state away
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - m_new);
        ps += s[n][e];
      }
    l = l * alpha + ps;
    m = m_new;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }
    const unsigned char* vt = st + kTile * P::kRowBytes;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      // P as bf16 hi + lo parts (P - hi rounded again): the product
      // keeps ~16 of P's bits, as the f32 plain version's P.V does
      uint32_t a[4] = {0u, 0u, 0u, 0u}, b[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p = s[2 * kk + h];
        const float h0 = mxk::round_to<T>(p[0]);
        const float h1 = mxk::round_to<T>(p[1]);
        a[2 * h] = mxk::pack_bf16x2(h0, h1);
        b[2 * h] = mxk::pack_bf16x2(p[0] - h0, p[1] - h1);
      }
      // lane l addresses row 16 kk + 8 ((l >> 3) & 1) + (l & 7) of V at
      // dims 16 n + 8 (l >> 4): the four 8 x 8 blocks, transposed, are
      // the B fragments of dims 16 n and 16 n + 8
      const unsigned char* vr =
          vt + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * P::kRowBytes +
          8 * (lane >> 4) * 2;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vr + n * 32);
        const uint32_t v0[2] = {r[0], r[1]};
        const uint32_t v1[2] = {r[2], r[3]};
        mxflash::mma_bf16(o[2 * n], a, v0);
        mxflash::mma_bf16(o[2 * n], b, v0);
        mxflash::mma_bf16(o[2 * n + 1], a, v1);
        mxflash::mma_bf16(o[2 * n + 1], b, v1);
      }
    }
  }

  __device__ __forceinline__ void store(float* mm, float* ll, float* aa,
                                        int lane) {
    const int gr = lane >> 2;
    const int tq = lane & 3;
    float lg = l + __shfl_xor_sync(0xffffffffu, l, 1);
    lg += __shfl_xor_sync(0xffffffffu, lg, 2);
    if (gr < G) {
      if (tq == 0) {
        mm[gr] = m;
        ll[gr] = lg;
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        aa[gr * D + 8 * n + 2 * tq] = o[n][0];
        aa[gr * D + 8 * n + 2 * tq + 1] = o[n][1];
      }
    }
  }
};

template <typename T, int G, int D>
struct WarpState {
  using type = LaneTokens<T, G, D>;
};
template <int G, int D>
struct WarpState<__nv_bfloat16, G, D> {
  using type = HeadRows<G, D>;
};

// One split of one (batch row, kv head): the f32 online-softmax partial
// (m, l, acc) of its G grouped heads over the run's tokens.
template <typename T, int G, int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       float* __restrict__ ws_acc,
                       float2* __restrict__ ws_ml, int h, int kv,
                       int n_pages, int page_size, int n_split, int pps,
                       float scale) {
  using P = Plan<T, D>;
  using W = typename WarpState<T, G, D>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + P::kRing);     // G x D
  float* pbuf = qs + G * D;                  // warps x tile x G
  int* pid = reinterpret_cast<int*>(pbuf + kWarps * kTile * G);

  const int row = blockIdx.x / kv;
  const int kvh = blockIdx.x % kv;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t head0 = static_cast<size_t>(row) * h + kvh * G;

  const int cap = n_pages * page_size;
  int n = lengths[row];
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const int p0 = split * pps;
  const int p1 = min(n_pages, p0 + pps);
  const int t0 = p0 * page_size;            // the run's first token
  const int t1 = min(n, p1 * page_size);    // one past its last valid one
  if (t0 >= t1) {                           // past the row's length
    for (int g = threadIdx.x; g < G; g += blockDim.x)
      ws_ml[(head0 + g) * n_split + split] = make_float2(-CUDART_INF_F, 0.f);
    return;
  }
  const int* pt = page_table + static_cast<size_t>(row) * n_pages;
  for (int i = threadIdx.x; i < p1 - p0; i += blockDim.x) pid[i] = pt[p0 + i];
  if constexpr (std::is_same<T, float>::value) {   // LaneTokens reads qs
    for (int i = threadIdx.x; i < G * D; i += blockDim.x)
      qs[i] = q[head0 * D + i] * scale;
  }
  __syncthreads();

  unsigned char* ring = smem + warp * kStages * P::kStage;
  float* pw = pbuf + warp * kTile * G;
  const int n_tiles = (t1 - t0 + kTile - 1) / kTile;

  // cp.async of tile j (this lane's share of its 2 x 32 rows) into a
  // stage, as one commit group (empty past the run's last tile)
  auto fetch = [&](int j, int stage) {
    if (j < n_tiles) {
      const int tb = t0 + j * kTile;
      long long slot = 0;
      if (tb + lane < t1) {
        const int u = tb + lane - t0;
        slot = static_cast<long long>(pid[u / page_size]) * page_size +
               u % page_size;
      }
      unsigned char* st = ring + stage * P::kStage;
#pragma unroll
      for (int it = 0; it < 2 * kTile * P::kChunks / 32; ++it) {
        const int i = it * 32 + lane;
        const int r = i / P::kChunks;   // rows 0..31 K, 32..63 V
        const int c = i % P::kChunks;
        const int tok = r % kTile;
        const long long s = __shfl_sync(0xffffffffu, slot, tok);
        const bool ok = tb + tok < t1;
        const T* base = r < kTile ? k : v;
        const T* src = base + (s * kv + kvh) * D + c * (16 / sizeof(T));
        cp_async16(st + r * P::kRowBytes + c * 16, ok ? src : base, ok);
      }
    }
    cp_async_commit();
  };

  W w;
  w.init(q + head0 * D, qs, lane);

  fetch(warp, 0);
  fetch(warp + kWarps, 1);
  int stage = 0;
  for (int j = warp; j < n_tiles; j += kWarps) {
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int nv = min(kTile, t1 - (t0 + j * kTile));   // >= 1
    w.tile(ring + stage * P::kStage, nv, qs, pw, scale, lane);
    __syncwarp();   // the stage and pw are consumed
    fetch(j + kStages * kWarps, stage);
    stage ^= 1;
  }
  cp_async_wait<0>();

  // merge the warps' states (the rings are free now) and write the
  // split's partial
  __syncthreads();
  float* mm = reinterpret_cast<float*>(smem);   // warps x G
  float* ll = mm + kWarps * G;
  float* aa = ll + kWarps * G;                  // warps x G x D
  w.store(mm + warp * G, ll + warp * G, aa + warp * G * D, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int dd = i % D;
    float m_all = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, mm[w * G + g]);
    // warp 0 holds the run's first tile, so m_all is finite; a warp
    // with no tile has m = -inf and weighs 0
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(mm[w * G + g] - m_all);
      l_all += ll[w * G + g] * c;
      o += aa[(w * G + g) * D + dd] * c;
    }
    const size_t hp = (head0 + g) * n_split + split;
    ws_acc[hp * D + dd] = o;
    if (dd == 0) ws_ml[hp] = make_float2(m_all, l_all);
  }
}

// Merge the n_split partials of one (batch row, head) in split order,
// rounding once to T; a row with no token (every split empty) emits 0.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ ws_acc,
                                     const float2* __restrict__ ws_ml,
                                     T* __restrict__ out, int n_split) {
  const int d = blockDim.x;
  const size_t bh = blockIdx.x;
  const float2* ml = ws_ml + bh * n_split;
  float m_all = -CUDART_INF_F;
  for (int s = 0; s < n_split; ++s) m_all = fmaxf(m_all, ml[s].x);
  float l_all = 0.f, o = 0.f;
  if (m_all != -CUDART_INF_F) {
    for (int s = 0; s < n_split; ++s) {
      const float2 e = ml[s];
      if (e.x == -CUDART_INF_F) continue;   // an empty split
      const float c = expf(e.x - m_all);
      l_all += e.y * c;
      o += ws_acc[(bh * n_split + s) * d + threadIdx.x] * c;
    }
  }
  out[bh * d + threadIdx.x] = mxk::from_f<T>(l_all > 0.f ? o / l_all : 0.f);
}

template <typename T, int G, int D>
cudaError_t launch_gd(const void* q, const void* k, const void* v,
                      const int* pt, const int* len, void* out, float* ws,
                      int b, int h, int kv, int n_pages, int page_size,
                      int n_split, float scale, cudaStream_t stream) {
  using P = Plan<T, D>;
  const int pps = (n_pages + n_split - 1) / n_split;
  const size_t smem = P::kRing + sizeof(float) * (G * D + kWarps * kTile * G) +
                      sizeof(int) * pps;
  float* ws_acc = ws;
  float2* ws_ml = reinterpret_cast<float2*>(
      ws + static_cast<size_t>(b) * h * n_split * D);
  auto split = paged_split_kernel<T, G, D>;
  cudaError_t e = mxk::allow_smem(split, smem);
  if (e != cudaSuccess) return e;
  split<<<dim3(b * kv, n_split), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pt, len, ws_acc, ws_ml, h, kv, n_pages,
      page_size, n_split, pps, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_combine_kernel<T><<<b * h, D, 0, stream>>>(
      ws_acc, ws_ml, static_cast<T*>(out), n_split);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* pt, const int* len, void* out, float* ws,
                     int b, int h, int kv, int d, int n_pages, int page_size,
                     int n_split, float scale, cudaStream_t s) {
  if (d == 128)
    return launch_gd<T, G, 128>(q, k, v, pt, len, out, ws, b, h, kv, n_pages,
                                page_size, n_split, scale, s);
  if (d == 64)
    return launch_gd<T, G, 64>(q, k, v, pt, len, out, ws, b, h, kv, n_pages,
                               page_size, n_split, scale, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pt, const int* len, void* out, float* ws,
                   int b, int h, int kv, int d, int n_pages, int page_size,
                   int n_split, float scale, cudaStream_t s) {
  switch (h / kv) {
    case 1:
      return launch_g<T, 1>(q, k, v, pt, len, out, ws, b, h, kv, d, n_pages,
                            page_size, n_split, scale, s);
    case 2:
      return launch_g<T, 2>(q, k, v, pt, len, out, ws, b, h, kv, d, n_pages,
                            page_size, n_split, scale, s);
    case 4:
      return launch_g<T, 4>(q, k, v, pt, len, out, ws, b, h, kv, d, n_pages,
                            page_size, n_split, scale, s);
    case 8:
      return launch_g<T, 8>(q, k, v, pt, len, out, ws, b, h, kv, d, n_pages,
                            page_size, n_split, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, D); k_arena/v_arena: (slots, KV, D) for one layer;
// page_table: (B, n_pages) int32 (page 0 is scratch); lengths: (B,) int32;
// out: (B, H, D) in q's dtype; ws: f32 scratch of B * H * n_split *
// (D + 2) elements. H / KV must be 1, 2, 4 or 8, D 64 or 128 and
// 1 <= n_split <= n_pages. Launches the split kernel on a (B * KV,
// n_split) grid, then the combine kernel; returns the first launch error.
extern "C" int mx_paged_attention_decode(
    const void* q, const void* k_arena, const void* v_arena,
    const int* page_table, const int* lengths, void* out, void* ws, int b,
    int h, int kv, int d, int n_pages, int page_size, int n_split,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > n_pages || page_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  if (dtype == mxk::kFloat32)
    return launch<float>(q, k_arena, v_arena, page_table, lengths, out, w, b,
                         h, kv, d, n_pages, page_size, n_split, scale, s);
  if (dtype == mxk::kBFloat16)
    return launch<__nv_bfloat16>(q, k_arena, v_arena, page_table, lengths,
                                 out, w, b, h, kv, d, n_pages, page_size,
                                 n_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
