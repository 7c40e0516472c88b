// Flash attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// Replaces the TPU kernels of mxnet_tpu/pallas_kernels/flash_attention.py
// `_flash_bwd_pallas`: the whole-head fused kernels at :914
// (`_bwd_fused_kernel_g`, g heads per step, bhld) and :937
// (`_bwd_fused_kernel`, any layout), and the streaming pair at :959
// (`_bwd_dkdv_kernel`, dK/dV walking the query blocks) and :977
// (`_bwd_dq_kernel`, dQ walking the key blocks). They are one algorithm,
// the FlashAttention-2 backward, with the forward's conventions:
//
//   p    = exp2(s * scale * log2(e) - lse)   (lse: the forward's base-2
//                                              logsumexp, f32)
//   delta = rowsum(dO * O)                   (f32)
//   dV  += P^T . dO                          (P rounded to v's dtype)
//   dS   = P * (dP - delta) * scale,  dP = dO . V^T
//   dK  += dS^T . Q,  dQ += dS . K           (dS rounded to q's dtype)
//
// dS takes the natural scale, not the base-2 one: the base-2 exponent
// only re-expresses exp. With dropout (the Drop instances) both kernels
// regenerate the forward's mask from the seed and the absolute (b * h +
// head, query, key) ids (hash_dropout.cuh; the dK/dV kernel holds keys
// as rows, so it reads the mask transposed, `_drop_mask_2d(...,
// transposed=True)`), as the TPU kernels do:
//
//   dV  += (keep ? P * inv_keep : 0)^T . dO      (inv_keep = f32(1/(1-p)))
//   dP   = keep ? dP * inv_keep : 0,  dS = P * (dP - delta) * scale
//
// and the delta pre-pass is unchanged (delta = rowsum(dO * O) of the
// dropped output). Causal masking is bottom-right (key j visible to
// query i iff j <= i + lk - lq); a row that sees no key (lse = -1e30) has
// p = 0 everywhere and so zero gradients.
//
// What bounds it on an H100: at BERT's shape (B*H = 384, L = 512, D = 64,
// bf16) the five products are 64.4 GFLOP (0.065 ms at 989 TFLOP/s), the
// inputs and gradients ~201 MB (0.060 ms at 3.35 TB/s); at proxy1b's
// causal (8, 16, 2048, 128) the triangle's five products are 0.344 ms of
// tensor-core time against 0.16 ms of bytes: operations. The TPU kernels
// hold a whole 512 x 512 f32 tile per head in VMEM; here nothing of that
// size fits, so the design streams, as the TPU's own streaming pair does,
// with no atomics (the same bits on every run): a delta pre-pass (16
// bytes a lane, up to a warp per query row, so the f32 products dO * O
// never reach device memory), a dK/dV kernel
// that walks query tiles and a dQ kernel that walks key tiles. It keeps
// two routes, fixed by the inputs alone:
//
//  * bf16 at head dim 64 or 128 (every training path: BERT's fused-QKV
//    views at 64, proxy1b's causal heads at 128) takes the warpgroup
//    route. A CTA owns 128 keys (dK/dV) or 128 queries (dQ): two
//    consumer warpgroups of 64 rows each and a producer warpgroup. The
//    producer copies the streamed tiles (64 queries of Q, dO, lse and
//    delta, or 64 keys of K and V) with cp.async, 16 bytes a thread,
//    into a four-stage ring of 128-byte-swizzled shared-memory tiles
//    (hopper.cuh) guarded by mbarriers: full, on which each producer
//    thread's copies arrive as they land (cp.async.mbarrier.arrive), so
//    the producer never waits for a load; empty, released by the
//    consumer warps. S^T = K . Q^T and dP^T =
//    V . dO^T (dQ: S = Q . K^T, dP = dO . V^T) are wgmma m64n64k16 with
//    both operands in shared memory; P^T and dS^T are formed in
//    registers, rounded to bf16 and fed back as wgmma's register A
//    operand to dV += P^T . dO and dK += dS^T . Q (dQ += dS . K), the B
//    tile read transposed through its descriptor. setmaxnreg moves
//    registers from the producer to the consumers, which hold both
//    64 x D f32 accumulators. Causal: query tiles that no key of the
//    CTA sees are not visited, a warpgroup skips the math of a tile it
//    cannot see, and only tiles that cross the diagonal (or the ragged
//    edge) are masked;
//  * f32, and bf16 at other head dims, take the first design: one CTA of
//    4 warps per (batch*head, 64-row block), mma.sync m16n8k16 (bf16) or
//    FMA (f32) from padded shared-memory tiles loaded between two
//    barriers. Head dims above 128 (up to 256, as the JAX kernels take)
//    split the accumulators' columns over the grid's z dimension, 128 a
//    CTA, each CTA recomputing P and dP over the full head dim.
//
// Both routes address q, k, v, o, dO and the gradients by (batch, head,
// seq) strides, so the heads of a fused QKV projection go in as views,
// and both recompute P and dP in each kernel (seven products where the
// algorithm needs five: the price of determinism without atomics).
#include <type_traits>

#include "flash_common.cuh"
#include "hash_dropout.cuh"
#include "hopper.cuh"

namespace {

using mxflash::bf16;

constexpr int kRows = 64;              // owned rows per CTA (4 warps x 16)
constexpr int kWarps = kRows / 16;
constexpr int kThreads = kWarps * 32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                    // (b*h, lq)
  float* delta;                        // (b*h, lq), written by the pre-pass
  void* dq;
  void* dk;
  void* dv;
  // element strides (batch, head, seq); the head-dim stride is 1
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl, do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl;
  int b, h, lq, lk, d;
  int causal, causal_offset;           // key visible iff key <= q + offset
  float scale2;                        // scale * log2(e)
  float scale;
  mxk::Dropout drop;                   // drop.scale = f32(1 / (1 - p))
};

// Shared-memory plan: two tiles of the owned rows, two of the streamed
// rows (BS of them), the streamed rows' lse and delta (dK/dV only), and
// the f32 path's per-warp P staging.
template <typename T, int DP, int BS>
struct Smem {
  static constexpr int kLd = DP + 16 / static_cast<int>(sizeof(T));
  static constexpr int kPld = BS + 4;
  static constexpr size_t kOwn = size_t(kRows) * kLd * sizeof(T);
  static constexpr size_t kStream = size_t(BS) * kLd * sizeof(T);
  static constexpr size_t kStats = 2 * size_t(BS) * sizeof(float);
  static constexpr size_t kP =
      sizeof(T) == 4 ? size_t(kWarps) * 16 * kPld * sizeof(float) : 0;
  static constexpr size_t kTotal = 2 * kOwn + 2 * kStream + kStats + kP;
};

// delta[row] = sum_d dO[row, d] * O[row, d] in f32: kLanes lanes a row,
// 16 bytes of O and dO each per step, the row's partial sums folded by
// shuffles (DP is the padded head dim; columns past d are not read).
template <typename T, int DP>
__global__ void __launch_bounds__(256) delta_kernel(Params p) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kLanes = DP / kVec < 32 ? DP / kVec : 32;
  const long long rows = static_cast<long long>(p.b) * p.h * p.lq;
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) /
      kLanes;
  const int lane = threadIdx.x % kLanes;
  float s = 0.f;
  if (row < rows) {
    const int i = static_cast<int>(row % p.lq);
    const int bh = static_cast<int>(row / p.lq);
    const int bi = bh / p.h;
    const int hi = bh % p.h;
    const T* o = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh +
                 i * p.o_sl;
    const T* g = static_cast<const T*>(p.dout) + bi * p.do_sb +
                 hi * p.do_sh + i * p.do_sl;
    for (int c = lane * kVec; c < p.d; c += kLanes * kVec) {
      float a[kVec], b[kVec];
      mxk::load_f<T, kVec>(o + c, a);
      mxk::load_f<T, kVec>(g + c, b);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += a[e] * b[e];
    }
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0 && row < rows) p.delta[row] = s;
}

// dK, dV for one (batch*head, 64-key block), walking query blocks of BQ;
// this CTA's DA accumulator columns start at blockIdx.z * DA.
template <typename T, int DP, int DA, int BQ, bool Drop>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Params p) {
  using S = Smem<T, DP, BQ>;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + S::kOwn);
  T* qs = reinterpret_cast<T*>(smem + 2 * S::kOwn);
  T* dos = reinterpret_cast<T*>(smem + 2 * S::kOwn + S::kStream);
  float* lse_s = reinterpret_cast<float*>(smem + 2 * S::kOwn + 2 * S::kStream);
  float* delta_s = lse_s + BQ;
  float* pw = lse_s + 2 * BQ;

  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int k0 = blockIdx.y * kRows;
  const int c0 = blockIdx.z * DA;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;        // this lane's keys: r0 and r0 + 8
  pw += warp * 16 * S::kPld;

  const uint32_t head_seed =
      Drop ? mxk::mx_attn_head_seed(static_cast<uint32_t>(bh), p.drop.seed)
           : 0u;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + hi * p.k_sh +
               k0 * p.k_sl;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + hi * p.v_sh +
               k0 * p.v_sl;
  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + bi * p.do_sb +
                  hi * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.lq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.lq;
  const int n_keys = min(kRows, p.lk - k0);
  mxflash::load_tile<T, DP, kThreads>(ks, LD, k, p.k_sl, kRows, n_keys, p.d);
  mxflash::load_tile<T, DP, kThreads>(vs, LD, v, p.v_sl, kRows, n_keys, p.d);

  float dk[DA / 8][4], dv[DA / 8][4];
  mxflash::zero(dk);
  mxflash::zero(dv);

  // the first query that sees a key of this block: query >= k0 - offset
  int q_begin = 0;
  if (p.causal) q_begin = (max(0, k0 - p.causal_offset) / BQ) * BQ;

  for (int q0 = q_begin; q0 < p.lq; q0 += BQ) {
    __syncthreads();                   // the previous tiles are consumed
    const int n_q = min(BQ, p.lq - q0);
    mxflash::load_tile<T, DP, kThreads>(qs, LD, q + q0 * p.q_sl, p.q_sl, BQ,
                                        n_q, p.d);
    mxflash::load_tile<T, DP, kThreads>(dos, LD, dout + q0 * p.do_sl,
                                        p.do_sl, BQ, n_q, p.d);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      // a padding query gets p = exp2(s - inf) = 0
      lse_s[i] = i < n_q ? lse[q0 + i] : CUDART_INF_F;
      delta_s[i] = i < n_q ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    // P^T (this warp's 16 keys x BQ queries)
    float pt[BQ / 8][4];
    mxflash::row_products<T, DP, BQ, LD>(pt, ks, qs, r0, g, t);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + r0 + 8 * (e >> 1);
        const int qi = nt * 8 + 2 * t + (e & 1);
        const bool hidden =
            key >= p.lk || (p.causal && key > q0 + qi + p.causal_offset);
        pt[nt][e] = hidden ? 0.f : exp2f(pt[nt][e] * p.scale2 - lse_s[qi]);
      }
    }
    if constexpr (!Drop)
      mxflash::accumulate<T, DA, BQ, LD, S::kPld>(dv, pt, dos + c0, pw, g,
                                                  t);

    // dS^T = P^T * (dP^T - delta) * scale, dP^T = V . dO^T
    float ds[BQ / 8][4];
    mxflash::row_products<T, DP, BQ, LD>(ds, vs, dos, r0, g, t);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        if constexpr (Drop) {
          // the forward's mask, transposed: same absolute ids; P^T then
          // becomes the dropped P^T that dV reads
          const bool keep = mxk::mx_attn_keep_in_head(
              head_seed, q0 + qi, k0 + r0 + 8 * (e >> 1), p.lk,
              p.drop.thresh);
          const float dp = keep ? ds[nt][e] * p.drop.scale : 0.f;
          ds[nt][e] = pt[nt][e] * (dp - delta_s[qi]) * p.scale;
          pt[nt][e] = keep ? pt[nt][e] * p.drop.scale : 0.f;
        } else {
          ds[nt][e] = pt[nt][e] * (ds[nt][e] - delta_s[qi]) * p.scale;
        }
      }
    }
    if constexpr (Drop)
      mxflash::accumulate<T, DA, BQ, LD, S::kPld>(dv, pt, dos + c0, pw, g,
                                                  t);
    mxflash::accumulate<T, DA, BQ, LD, S::kPld>(dk, ds, qs + c0, pw, g, t);
  }

  T* dkp = static_cast<T*>(p.dk) + bi * p.dk_sb + hi * p.dk_sh + k0 * p.dk_sl;
  T* dvp = static_cast<T*>(p.dv) + bi * p.dv_sb + hi * p.dv_sh + k0 * p.dv_sl;
  mxflash::store_rows<T, DA>(dkp + c0, p.dk_sl, dk, r0, n_keys, p.d - c0, t);
  mxflash::store_rows<T, DA>(dvp + c0, p.dv_sl, dv, r0, n_keys, p.d - c0, t);
}

// dQ for one (batch*head, 64-query block), walking key blocks of BK;
// this CTA's DA accumulator columns start at blockIdx.z * DA.
template <typename T, int DP, int DA, int BK, bool Drop>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  using S = Smem<T, DP, BK>;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + S::kOwn);
  T* ks = reinterpret_cast<T*>(smem + 2 * S::kOwn);
  T* vs = reinterpret_cast<T*>(smem + 2 * S::kOwn + S::kStream);
  float* pw = reinterpret_cast<float*>(smem + 2 * S::kOwn + 2 * S::kStream +
                                       S::kStats);

  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int q0 = blockIdx.y * kRows;
  const int c0 = blockIdx.z * DA;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;        // this lane's queries: r0, r0 + 8
  pw += warp * 16 * S::kPld;

  const uint32_t head_seed =
      Drop ? mxk::mx_attn_head_seed(static_cast<uint32_t>(bh), p.drop.seed)
           : 0u;
  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh +
               q0 * p.q_sl;
  const T* dout = static_cast<const T*>(p.dout) + bi * p.do_sb +
                  hi * p.do_sh + q0 * p.do_sl;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  const int n_q = min(kRows, p.lq - q0);
  mxflash::load_tile<T, DP, kThreads>(qs, LD, q, p.q_sl, kRows, n_q, p.d);
  mxflash::load_tile<T, DP, kThreads>(dos, LD, dout, p.do_sl, kRows, n_q,
                                      p.d);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const long long at = static_cast<long long>(bh) * p.lq + q0 + r;
    lse_r[i] = r < n_q ? p.lse[at] : CUDART_INF_F;
    delta_r[i] = r < n_q ? p.delta[at] : 0.f;
  }

  float dq[DA / 8][4];
  mxflash::zero(dq);

  int k_end = p.lk;
  if (p.causal) k_end = min(p.lk, max(0, q0 + kRows + p.causal_offset));

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    const int n_k = min(BK, p.lk - k0);
    mxflash::load_tile<T, DP, kThreads>(ks, LD, k + k0 * p.k_sl, p.k_sl, BK,
                                        n_k, p.d);
    mxflash::load_tile<T, DP, kThreads>(vs, LD, v + k0 * p.v_sl, p.v_sl, BK,
                                        n_k, p.d);
    __syncthreads();

    float pr[BK / 8][4], ds[BK / 8][4];
    mxflash::row_products<T, DP, BK, LD>(pr, qs, ks, r0, g, t);
    mxflash::row_products<T, DP, BK, LD>(ds, dos, vs, r0, g, t);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        const bool hidden =
            key >= p.lk ||
            (p.causal && key > q0 + r0 + 8 * i + p.causal_offset);
        const float pe =
            hidden ? 0.f : exp2f(pr[nt][e] * p.scale2 - lse_r[i]);
        float dp = ds[nt][e];
        if constexpr (Drop)
          dp = mxk::mx_attn_keep_in_head(head_seed, q0 + r0 + 8 * i, key,
                                         p.lk, p.drop.thresh)
                   ? dp * p.drop.scale
                   : 0.f;
        ds[nt][e] = pe * (dp - delta_r[i]) * p.scale;
      }
    }
    mxflash::accumulate<T, DA, BK, LD, S::kPld>(dq, ds, ks + c0, pw, g, t);
  }

  T* dqp = static_cast<T*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh + q0 * p.dq_sl;
  mxflash::store_rows<T, DA>(dqp + c0, p.dq_sl, dq, r0, n_q, p.d - c0, t);
}

template <typename T, int DP>
cudaError_t launch_delta(const Params& p, cudaStream_t stream) {
  constexpr int kLanes = DP * static_cast<int>(sizeof(T)) / 16 < 32
                             ? DP * static_cast<int>(sizeof(T)) / 16
                             : 32;
  const long long rows = static_cast<long long>(p.b) * p.h * p.lq;
  const long long per_block = 256 / kLanes;
  delta_kernel<T, DP><<<static_cast<unsigned>((rows + per_block - 1) /
                                              per_block),
                        256, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP, int DA, int BS, bool Drop>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Smem<T, DP, BS>;
  cudaError_t e = launch_delta<T, DP>(p, stream);
  if (e != cudaSuccess) return e;
  auto dkdv = dkdv_kernel<T, DP, DA, BS, Drop>;
  e = mxk::allow_smem(dkdv, S::kTotal);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(p.b * p.h, (p.lk + kRows - 1) / kRows, DP / DA), kThreads,
         S::kTotal, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto dq = dq_kernel<T, DP, DA, BS, Drop>;
  e = mxk::allow_smem(dq, S::kTotal);
  if (e != cudaSuccess) return e;
  dq<<<dim3(p.b * p.h, (p.lq + kRows - 1) / kRows, DP / DA), kThreads,
       S::kTotal, stream>>>(p);
  return cudaGetLastError();
}

// the streamed tile is 64 rows, 32 at head dims above 64 (register budget
// of the owned rows' two accumulators, at most 128 columns a CTA)
template <typename T, bool Drop>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32, 32, 64, Drop>(p, stream);
  if (p.d <= 64) return launch<T, 64, 64, 64, Drop>(p, stream);
  if (p.d <= 128) return launch<T, 128, 128, 32, Drop>(p, stream);
  return launch<T, 256, 128, 32, Drop>(p, stream);
}

// ---------------------------------------------------------------------------
// the warpgroup route: bf16, head dim 64 or 128
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;                  // owned rows per CTA
constexpr int kWgTile = 64;                   // streamed rows per tile
constexpr int kWgStages = 4;
constexpr int kWgThreads = 3 * 128;           // producer + 2 consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int D>
struct WgSmem {
  static constexpr int kOwn = kWgRows * D * 2;      // one owned tile
  static constexpr int kTile = kWgTile * D * 2;     // one streamed tile
  // dK/dV stage: Q, dO, then lse and delta (64 floats each)
  static constexpr int kStage =
      ((2 * kTile + 2 * kWgTile * 4) + 1023) / 1024 * 1024;
  static constexpr int kBars = 8 * (1 + 2 * kWgStages);
  static constexpr size_t kTotal =
      1024 + 2 * size_t(kOwn) + kWgStages * size_t(kStage) + kBars;
};

using mxhop::align1024;
using mxhop::fexp2;
using mxhop::wait_tile;
using mxhop::warp_arrive;
using mxhop::WgRs;

// The ring's barriers. full (and own_full, for the owned tiles) count the
// 128 producer threads: each arrives when its own cp.async copies of the
// tile have landed, so the producer never waits for a load and keeps up
// to kWgStages tiles in flight. empty counts the 8 consumer warps; a stage
// is refilled only after both consumer warpgroups released it.
__device__ __forceinline__ void init_barriers(uint64_t* own_full,
                                              uint64_t* full,
                                              uint64_t* empty) {
  mxhop::mbar_init(own_full, 128);
  for (int s = 0; s < kWgStages; ++s) {
    mxhop::mbar_init(full + s, 128);
    mxhop::mbar_init(empty + s, 8);
  }
  mxhop::mbar_init_fence();
}

// dK, dV for one (batch*head, 128-key block), walking query tiles of 64.
template <int D, bool Drop>
__global__ void __launch_bounds__(kWgThreads, 1)
    dkdv_wgmma_kernel(Params p, int n_blocks) {
  using S = WgSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ks = smem;
  unsigned char* vs = smem + S::kOwn;
  unsigned char* stages = smem + 2 * S::kOwn;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + kWgStages * S::kStage);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kWgStages;

  const int bh = blockIdx.x / n_blocks;
  const int k0 = (blockIdx.x % n_blocks) * kWgRows;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;

  int q_begin = 0;   // the first query tile any key of this block sees
  if (p.causal) q_begin = (max(0, k0 - p.causal_offset) / kWgTile) * kWgTile;
  const int n_tiles =
      q_begin < p.lq ? (p.lq - q_begin + kWgTile - 1) / kWgTile : 0;

  if (threadIdx.x == 0) init_barriers(own_full, full, empty);
  __syncthreads();

  const bf16* q = static_cast<const bf16*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const bf16* dout =
      static_cast<const bf16*>(p.dout) + bi * p.do_sb + hi * p.do_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.lq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.lq;

  if (wg == 0) {
    // producer: K and V of the block once, then the ring of query tiles
    mxhop::setmaxnreg_dec<kProducerRegs>();
    const bf16* k = static_cast<const bf16*>(p.k) + bi * p.k_sb +
                    hi * p.k_sh + k0 * p.k_sl;
    const bf16* v = static_cast<const bf16*>(p.v) + bi * p.v_sb +
                    hi * p.v_sh + k0 * p.v_sl;
    const int n_keys = min(kWgRows, p.lk - k0);
    mxhop::load_tile_async<kWgRows, D, 128>(ks, k, p.k_sl, n_keys, p.k, tid);
    mxhop::load_tile_async<kWgRows, D, 128>(vs, v, p.v_sl, n_keys, p.v, tid);
    mxhop::cp_async_arrive(own_full);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kWgStages;
      const int u = i / kWgStages;
      if (u > 0) mxhop::mbar_wait(empty + s, (u - 1) & 1);
      const int q0 = q_begin + i * kWgTile;
      const int n_q = min(kWgTile, p.lq - q0);
      unsigned char* st = stages + s * S::kStage;
      mxhop::load_tile_async<kWgTile, D, 128>(st, q + q0 * p.q_sl, p.q_sl,
                                              n_q, p.q, tid);
      mxhop::load_tile_async<kWgTile, D, 128>(
          st + S::kTile, dout + q0 * p.do_sl, p.do_sl, n_q, p.dout, tid);
      float* stats = reinterpret_cast<float*>(st + 2 * S::kTile);
      const int r = tid & 63;
      const float* src = tid < 64 ? lse : delta;
      mxhop::cp_async4(stats + tid, r < n_q ? src + q0 + r : src, r < n_q);
      mxhop::cp_async_arrive(full + s);
    }
    mxhop::cp_async_wait_all();
  } else {
    mxhop::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;                    // this warpgroup's 64 keys
    const int wk0 = k0 + 64 * cw;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t head_seed =
        Drop ? mxk::mx_attn_head_seed(static_cast<uint32_t>(bh), p.drop.seed)
             : 0u;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    wait_tile(own_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kWgStages;
      wait_tile(full + s, (i / kWgStages) & 1);
      const int q0 = q_begin + i * kWgTile;
      const int q_last = min(q0 + kWgTile, p.lq) - 1;
      // every key of this warpgroup hidden from every query of the tile
      const bool skip = wk0 >= p.lk ||
                        (p.causal && q_last + p.causal_offset < wk0);
      if (!skip) {
        const unsigned char* st = stages + s * S::kStage;
        const unsigned char* qs = st;
        const unsigned char* dos = st + S::kTile;
        const float* lse_s = reinterpret_cast<const float*>(st + 2 * S::kTile);
        const float* delta_s = lse_s + kWgTile;
        float sp[32], dp[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sp[j] = dp[j] = 0.f;
        mxhop::wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb)
          mxhop::wgmma_ss_n64(sp, mxhop::desc_k<kWgRows>(ks, 64 * cw, kb),
                              mxhop::desc_k<kWgTile>(qs, 0, kb), kb > 0);
        mxhop::wgmma_commit();
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb)
          mxhop::wgmma_ss_n64(dp, mxhop::desc_k<kWgRows>(vs, 64 * cw, kb),
                              mxhop::desc_k<kWgTile>(dos, 0, kb), kb > 0);
        mxhop::wgmma_commit();
        mxhop::wgmma_wait<1>();
        mxhop::fence_regs(sp);

        // P^T: keys are rows, queries columns. Element j of this thread
        // sits at key row 16 warp + g + 8 ((j >> 1) & 1) and query column
        // qi(j) = 8 (j >> 2) + 2 t + (j & 1): 16 distinct queries, whose
        // statistics come in as float2 pairs
        float lse_q[16], delta_q[16];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 a =
              *reinterpret_cast<const float2*>(lse_s + 8 * c + 2 * t);
          const float2 b =
              *reinterpret_cast<const float2*>(delta_s + 8 * c + 2 * t);
          lse_q[2 * c] = a.x;
          lse_q[2 * c + 1] = a.y;
          delta_q[2 * c] = b.x;
          delta_q[2 * c + 1] = b.y;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j)
          sp[j] = fexp2(sp[j] * p.scale2 - lse_q[2 * (j >> 2) + (j & 1)]);
        // only a tile across the diagonal or the ragged edge is masked
        if (q0 + kWgTile > p.lq || wk0 + 64 > p.lk ||
            (p.causal && wk0 + 63 > q0 + p.causal_offset)) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int key = wk0 + 16 * warp + g + 8 * ((j >> 1) & 1);
            const int query = q0 + 8 * (j >> 2) + 2 * t + (j & 1);
            if (key >= p.lk || query >= p.lq ||
                (p.causal && key > query + p.causal_offset))
              sp[j] = 0.f;
          }
        }
        mxhop::wgmma_wait<0>();
        mxhop::fence_regs(dp);
        // dS^T = P^T * (dP^T - delta) * scale; with dropout the forward's
        // mask, transposed (same absolute ids), and P^T becomes the
        // dropped P^T that dV reads
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float delta = delta_q[2 * (j >> 2) + (j & 1)];
          if constexpr (Drop) {
            const int key = wk0 + 16 * warp + g + 8 * ((j >> 1) & 1);
            const int query = q0 + 8 * (j >> 2) + 2 * t + (j & 1);
            const bool keep = mxk::mx_attn_keep_in_head(
                head_seed, query, key, p.lk, p.drop.thresh);
            const float d_p = keep ? dp[j] * p.drop.scale : 0.f;
            dp[j] = sp[j] * (d_p - delta) * p.scale;
            sp[j] = keep ? sp[j] * p.drop.scale : 0.f;
          } else {
            dp[j] = sp[j] * (dp[j] - delta) * p.scale;
          }
        }
        uint32_t ap[4][4], as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ap[kk][r] = mxk::pack_bf16x2(sp[8 * kk + 2 * r],
                                         sp[8 * kk + 2 * r + 1]);
            as[kk][r] = mxk::pack_bf16x2(dp[8 * kk + 2 * r],
                                         dp[8 * kk + 2 * r + 1]);
          }
        mxhop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgRs<D>::mma(dv, ap[kk], mxhop::desc_mn<kWgTile>(dos, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgRs<D>::mma(dk, as[kk], mxhop::desc_mn<kWgTile>(qs, kk));
        mxhop::wgmma_commit();
        mxhop::wgmma_wait<0>();
        mxhop::fence_regs(dv);
        mxhop::fence_regs(dk);
      }
      warp_arrive(empty + s);
    }

    bf16* dkp = static_cast<bf16*>(p.dk) + bi * p.dk_sb + hi * p.dk_sh;
    bf16* dvp = static_cast<bf16*>(p.dv) + bi * p.dv_sb + hi * p.dv_sh;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int key = wk0 + 16 * warp + g + 8 * ((j >> 1) & 1);
      const int c = 8 * (j >> 2) + 2 * t;
      if (key < p.lk) {
        mxflash::store2<bf16>(dkp + key * p.dk_sl + c, dk[j], dk[j + 1]);
        mxflash::store2<bf16>(dvp + key * p.dv_sl + c, dv[j], dv[j + 1]);
      }
    }
  }
}

// dQ for one (batch*head, 128-query block), walking key tiles of 64.
template <int D, bool Drop>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wgmma_kernel(Params p, int n_blocks) {
  using S = WgSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* dos = smem + S::kOwn;
  unsigned char* stages = smem + 2 * S::kOwn;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + kWgStages * S::kStage);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kWgStages;

  const int bh = blockIdx.x / n_blocks;
  const int q0 = (blockIdx.x % n_blocks) * kWgRows;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;

  int k_end = p.lk;   // one past the last key any query of the block sees
  if (p.causal) k_end = min(p.lk, max(0, q0 + kWgRows + p.causal_offset));
  const int n_tiles = (k_end + kWgTile - 1) / kWgTile;

  if (threadIdx.x == 0) init_barriers(own_full, full, empty);
  __syncthreads();

  const bf16* k = static_cast<const bf16*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + bi * p.v_sb + hi * p.v_sh;

  if (wg == 0) {
    mxhop::setmaxnreg_dec<kProducerRegs>();
    const bf16* q = static_cast<const bf16*>(p.q) + bi * p.q_sb +
                    hi * p.q_sh + q0 * p.q_sl;
    const bf16* dout = static_cast<const bf16*>(p.dout) + bi * p.do_sb +
                       hi * p.do_sh + q0 * p.do_sl;
    const int n_q = min(kWgRows, p.lq - q0);
    mxhop::load_tile_async<kWgRows, D, 128>(qs, q, p.q_sl, n_q, p.q, tid);
    mxhop::load_tile_async<kWgRows, D, 128>(dos, dout, p.do_sl, n_q, p.dout,
                                            tid);
    mxhop::cp_async_arrive(own_full);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kWgStages;
      const int u = i / kWgStages;
      if (u > 0) mxhop::mbar_wait(empty + s, (u - 1) & 1);
      const int k0 = i * kWgTile;
      const int n_k = min(kWgTile, p.lk - k0);
      unsigned char* st = stages + s * S::kStage;
      mxhop::load_tile_async<kWgTile, D, 128>(st, k + k0 * p.k_sl, p.k_sl,
                                              n_k, p.k, tid);
      mxhop::load_tile_async<kWgTile, D, 128>(st + S::kTile, v + k0 * p.v_sl,
                                              p.v_sl, n_k, p.v, tid);
      mxhop::cp_async_arrive(full + s);
    }
    mxhop::cp_async_wait_all();
  } else {
    mxhop::setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;                    // this warpgroup's 64 queries
    const int wq0 = q0 + 64 * cw;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t head_seed =
        Drop ? mxk::mx_attn_head_seed(static_cast<uint32_t>(bh), p.drop.seed)
             : 0u;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + 16 * warp + g + 8 * r;
      const long long at = static_cast<long long>(bh) * p.lq + row;
      lse_r[r] = row < p.lq ? p.lse[at] : 0.f;
      delta_r[r] = row < p.lq ? p.delta[at] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    wait_tile(own_full, 0);
    const int q_last = min(wq0 + 64, p.lq) - 1;

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kWgStages;
      wait_tile(full + s, (i / kWgStages) & 1);
      const int k0 = i * kWgTile;
      // every key of the tile hidden from every query of this warpgroup
      const bool skip = wq0 >= p.lq ||
                        (p.causal && k0 > q_last + p.causal_offset);
      if (!skip) {
        const unsigned char* kst = stages + s * S::kStage;
        const unsigned char* vst = kst + S::kTile;
        float sp[32], dp[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sp[j] = dp[j] = 0.f;
        mxhop::wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb)
          mxhop::wgmma_ss_n64(sp, mxhop::desc_k<kWgRows>(qs, 64 * cw, kb),
                              mxhop::desc_k<kWgTile>(kst, 0, kb), kb > 0);
        mxhop::wgmma_commit();
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb)
          mxhop::wgmma_ss_n64(dp, mxhop::desc_k<kWgRows>(dos, 64 * cw, kb),
                              mxhop::desc_k<kWgTile>(vst, 0, kb), kb > 0);
        mxhop::wgmma_commit();
        mxhop::wgmma_wait<1>();
        mxhop::fence_regs(sp);

#pragma unroll
        for (int j = 0; j < 32; ++j)
          sp[j] = fexp2(sp[j] * p.scale2 - lse_r[(j >> 1) & 1]);
        // only a tile across the diagonal or the ragged edge is masked
        if (wq0 + 64 > p.lq || k0 + kWgTile > p.lk ||
            (p.causal && k0 + kWgTile - 1 > wq0 + p.causal_offset)) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int row = wq0 + 16 * warp + g + 8 * ((j >> 1) & 1);
            const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
            if (key >= p.lk || row >= p.lq ||
                (p.causal && key > row + p.causal_offset))
              sp[j] = 0.f;
          }
        }
        mxhop::wgmma_wait<0>();
        mxhop::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = (j >> 1) & 1;
          float d_p = dp[j];
          if constexpr (Drop) {
            const int row = wq0 + 16 * warp + g + 8 * r;
            const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
            d_p = mxk::mx_attn_keep_in_head(head_seed, row, key, p.lk,
                                            p.drop.thresh)
                      ? d_p * p.drop.scale
                      : 0.f;
          }
          dp[j] = sp[j] * (d_p - delta_r[r]) * p.scale;
        }
        uint32_t as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            as[kk][r] = mxk::pack_bf16x2(dp[8 * kk + 2 * r],
                                         dp[8 * kk + 2 * r + 1]);
        mxhop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgRs<D>::mma(dq, as[kk], mxhop::desc_mn<kWgTile>(kst, kk));
        mxhop::wgmma_commit();
        mxhop::wgmma_wait<0>();
        mxhop::fence_regs(dq);
      }
      warp_arrive(empty + s);
    }

    bf16* dqp = static_cast<bf16*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int row = wq0 + 16 * warp + g + 8 * ((j >> 1) & 1);
      const int c = 8 * (j >> 2) + 2 * t;
      if (row < p.lq)
        mxflash::store2<bf16>(dqp + row * p.dq_sl + c, dq[j], dq[j + 1]);
    }
  }
}

template <int D, bool Drop>
cudaError_t launch_wg(const Params& p, cudaStream_t stream) {
  using S = WgSmem<D>;
  cudaError_t e = launch_delta<bf16, D>(p, stream);
  if (e != cudaSuccess) return e;
  const int nk = (p.lk + kWgRows - 1) / kWgRows;
  const int nq = (p.lq + kWgRows - 1) / kWgRows;
  auto dkdv = dkdv_wgmma_kernel<D, Drop>;
  e = mxk::allow_smem(dkdv, S::kTotal);
  if (e != cudaSuccess) return e;
  dkdv<<<p.b * p.h * nk, kWgThreads, S::kTotal, stream>>>(p, nk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto dq = dq_wgmma_kernel<D, Drop>;
  e = mxk::allow_smem(dq, S::kTotal);
  if (e != cudaSuccess) return e;
  dq<<<p.b * p.h * nq, kWgThreads, S::kTotal, stream>>>(p, nq);
  return cudaGetLastError();
}

// The route is fixed by the inputs: bf16 at head dim 64 or 128 takes the
// warpgroup kernels, everything else the mma.sync / FMA kernels.
template <typename T>
cudaError_t launch_t(const Params& p, bool drop, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.d == 64)
      return drop ? launch_wg<64, true>(p, stream)
                  : launch_wg<64, false>(p, stream);
    if (p.d == 128)
      return drop ? launch_wg<128, true>(p, stream)
                  : launch_wg<128, false>(p, stream);
  }
  return drop ? launch_d<T, true>(p, stream) : launch_d<T, false>(p, stream);
}

}  // namespace

// q, o, dout, dq: (b, h, lq, d); k, v, dk, dv: (b, h, lk, d), given by
// element strides[24] = {q, k, v, o, dout, dq, dk, dv} x {batch, head,
// seq} (the head-dim stride is 1); lse: (b*h, lq) f32 from the forward;
// delta: (b*h, lq) f32 scratch. Requires d % 8 == 0, d <= 256, every
// stride a multiple of 8 and 16-byte aligned base pointers. drop != 0:
// the forward's dropout (seed, thresh), inv_keep = f32(1 / (1 - p)).
// Runs the delta pre-pass, then the dK/dV and the dQ kernels on
// ``stream``; returns the first launch error.
extern "C" int mx_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const float* lse,
                                      float* delta, void* dq, void* dk,
                                      void* dv, const long long* strides,
                                      int b, int h, int lq, int lk, int d,
                                      float scale, float scale2, int causal,
                                      int causal_offset, int dtype, int drop,
                                      unsigned seed, unsigned thresh,
                                      float inv_keep, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  long long* dst[24] = {&p.q_sb,  &p.q_sh,  &p.q_sl,  &p.k_sb,  &p.k_sh,
                        &p.k_sl,  &p.v_sb,  &p.v_sh,  &p.v_sl,  &p.o_sb,
                        &p.o_sh,  &p.o_sl,  &p.do_sb, &p.do_sh, &p.do_sl,
                        &p.dq_sb, &p.dq_sh, &p.dq_sl, &p.dk_sb, &p.dk_sh,
                        &p.dk_sl, &p.dv_sb, &p.dv_sh, &p.dv_sl};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  p.b = b;
  p.h = h;
  p.lq = lq;
  p.lk = lk;
  p.d = d;
  p.causal = causal;
  p.causal_offset = causal_offset;
  p.scale = scale;
  p.scale2 = scale2;
  p.drop = mxk::Dropout{seed, thresh, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 8 || d > 256 || d % 8 != 0 || lq < 1 || lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == mxk::kBFloat16) return launch_t<bf16>(p, drop != 0, s);
  if (dtype == mxk::kFloat32) return launch_t<float>(p, drop != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
