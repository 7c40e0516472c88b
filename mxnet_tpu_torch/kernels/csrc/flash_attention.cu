// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels of mxnet_tpu/pallas_kernels/flash_attention.py
// `_flash_fwd_pallas`: the whole-head, g-heads-per-step `pallas_call` at
// :552 (`_fwd_kernel_single_g`, BERT's seq 512) and the streaming one at
// :590 (`_fwd_kernel` / `_fwd_kernel_single`). They are one algorithm:
// base-2 online softmax (scale * log2(e) folded into the f32 scores),
// f32 statistics, output in the input dtype, and the per-row base-2
// logsumexp `m + log2(l)` as an f32 residual (-1e30 and a zero output
// for a row that sees no key).
//
// What bounds it on an H100: at BERT's shape (B*H = 384 heads, L = 512,
// D = 64, bf16) the products are 25.8 GFLOP (0.026 ms at 989 TFLOP/s)
// and Q, K, V, O are 100.7 MB (0.030 ms at 3.35 TB/s), so the two bounds
// are close and neither is far below the other; at proxy1b's causal
// (8, 16, 2048, 128) the triangle's products are 137.5 GFLOP (0.139 ms)
// against 0.040 ms of bytes: operations. The TPU kernel kept a whole
// 512 x 512 f32 score tile in VMEM; on Hopper that tile (1 MB) fits
// neither shared memory nor registers, so the design streams K and V
// past a resident Q tile. Two routes, fixed by the inputs alone:
//
//  * bf16 at head dim 64 or 128 (every path: BERT at 64, proxy1b and
//    Llama-3-8B at 128) takes the warpgroup route (flash_fwd_wgmma_kernel), a
//    persistent kernel: one CTA per SM walks work items, each a (batch*head,
//    128-query block), handed out through an atomic counter as SMs free up.
//    Heads go in groups whose K and V fill about 8 MB of the 50 MB L2 (every
//    query block of a head reads the same K and V); inside a group the query
//    blocks run last first, so under causal masking the heaviest items start
//    first. A CTA is two consumer warpgroups of 64 query rows each and a
//    producer warpgroup; setmaxnreg moves registers from the producer to the
//    consumers. The producer copies each item's Q tile and then its K and V
//    tiles of 128 keys with cp.async, 16 bytes a thread, into
//    128-byte-swizzled shared memory (hopper.cuh), through a ring of three
//    (head dim 128) or four (64) stages guarded by mbarriers, full (each
//    producer thread's copies arrive as they land, so the producer never waits
//    for a load) and empty (released by the consumer warps); the ring runs on
//    across items, and at head dim 64 the next item's Q goes into a second
//    tile while this item runs. S = Q . K^T is wgmma m64n128k16 with both
//    operands in shared memory; the online softmax runs in registers with
//    ex2.approx (the running max of the raw scores, the row sums l, the alpha
//    rescale of the f32 accumulator); P is rounded to bf16 in registers
//    against the running max, as the TPU kernel rounds P to v's dtype, and is
//    wgmma's register A operand of O += P . V, V read through its MN-major
//    descriptor. Tile i + 1's S goes to the tensor cores with tile i's P . V,
//    one wait per tile (ptxas places the P . V wait before tile i + 1's
//    softmax, so the softmax overlaps the other warpgroup's products, not its
//    own). Causal: key tiles past the last key a warpgroup's rows see are not
//    visited, and only the tiles that cross the diagonal or the ragged edge of
//    lk are masked;
//  * f32, and bf16 at other head dims, take the first design
//    (flash_fwd_kernel): one CTA of 4 warps per (batch*head, 64-query
//    tile), each warp owning 16 rows whose statistics live in the 4
//    lanes that hold them; K and V tiles of 64 keys (32 for head dim
//    256) loaded between two barriers, zero-filled past the ragged edge
//    of L and D; mma.sync m16n8k16 (bf16) or FMA (f32, P staged through
//    shared memory per warp).
//
// Both routes: causal masking is bottom-right aligned (key <= query +
// lk - lq); q, k, v and o are addressed by (batch, head, seq) strides, so
// the heads of a fused QKV projection go in as views; dropout (the Drop
// instances, `_drop_mask` / `_drop_mask_g` of the TPU kernels): the
// online max, the row sum l and the base-2 lse stay pre-dropout; only the
// P that enters P.V is masked, keep from the two-level position hash of
// (b * h + head, query, key) with the true lk and no causal offset
// (hash_dropout.cuh; the head seed once per CTA), and 1 - p folds into
// the final normalize, which divides by l * f32(1 - p) as the TPU kernels
// do (:341, :414, :456).
#include <type_traits>

#include "flash_common.cuh"
#include "hash_dropout.cuh"
#include "hopper.cuh"

namespace {

using mxflash::bf16;

constexpr int kBM = 64;               // query rows per CTA
constexpr int kWarps = kBM / 16;      // 16 query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNoKeyLse = -1e30f;   // lse of a row that sees no key

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                          // (b*h, lq)
  // element strides (batch, head, seq); the head-dim stride is 1
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl, o_sb, o_sh, o_sl;
  int b, h, lq, lk, d;
  int causal, causal_offset;           // key visible iff key <= q + offset
  float scale2;                        // scale * log2(e)
  mxk::Dropout drop;                   // drop.scale = f32(1 - p)
};

// Shared-memory plan of one CTA (rows padded by 16 bytes, flash_common.cuh).
template <typename T, int DP, int BN>
struct Smem {
  static constexpr int kLd = DP + 16 / static_cast<int>(sizeof(T));
  static constexpr int kPld = BN + 4;  // f32 P staging row stride
  static constexpr size_t kQ = size_t(kBM) * kLd * sizeof(T);
  static constexpr size_t kKV = size_t(BN) * kLd * sizeof(T);
  static constexpr size_t kP =
      sizeof(T) == 4 ? size_t(kWarps) * 16 * kPld * sizeof(float) : 0;
  static constexpr size_t kTotal = kQ + 2 * kKV + kP;
};

template <typename T, int DP, int BN, bool Drop>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using S = Smem<T, DP, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + S::kQ);
  T* vs = reinterpret_cast<T*>(smem + S::kQ + S::kKV);
  float* ps = reinterpret_cast<float*>(smem + S::kQ + 2 * S::kKV);

  const int bh = blockIdx.x;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int q0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;        // this lane's rows: r0 and r0 + 8

  const uint32_t head_seed =
      Drop ? mxk::mx_attn_head_seed(static_cast<uint32_t>(bh), p.drop.seed)
           : 0u;
  const T* q = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh +
               q0 * p.q_sl;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bi * p.v_sb + hi * p.v_sh;
  mxflash::load_tile<T, DP, kThreads>(qs, S::kLd, q, p.q_sl, kBM,
                                      min(kBM, p.lq - q0), p.d);

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  // keys past the last one any row of this tile may see are not visited
  int k_end = p.lk;
  if (p.causal) k_end = min(p.lk, max(0, q0 + kBM + p.causal_offset));

  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();                   // the previous tile is consumed
    const int n_valid = min(BN, p.lk - k0);
    mxflash::load_tile<T, DP, kThreads>(ks, S::kLd, k + k0 * p.k_sl, p.k_sl,
                                        BN, n_valid, p.d);
    mxflash::load_tile<T, DP, kThreads>(vs, S::kLd, v + k0 * p.v_sl, p.v_sl,
                                        BN, n_valid, p.d);
    __syncthreads();

    float s[BN / 8][4];
    mxflash::row_products<T, DP, BN, S::kLd>(s, qs, ks, r0, g, t);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = q0 + r0 + 8 * (e >> 1);
        const bool hidden =
            key >= p.lk || (p.causal && key > row + p.causal_offset);
        s[nt][e] = hidden ? -CUDART_INF_F : s[nt][e] * p.scale2;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * i], s[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a row with no visible key so far keeps p = 0 (exp2(-inf - 0))
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float row_sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt][2 * i] = exp2f(s[nt][2 * i] - m_use);
        s[nt][2 * i + 1] = exp2f(s[nt][2 * i + 1] - m_use);
        row_sum += s[nt][2 * i] + s[nt][2 * i + 1];
      }
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        acc[dt][2 * i] *= alpha;
        acc[dt][2 * i + 1] *= alpha;
      }
      m[i] = m_new;
    }
    if constexpr (Drop) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = k0 + nt * 8 + 2 * t + (e & 1);
          const uint32_t row = q0 + r0 + 8 * (e >> 1);
          if (!mxk::mx_attn_keep_in_head(head_seed, row, key, p.lk,
                                         p.drop.thresh))
            s[nt][e] = 0.f;
        }
    }
    mxflash::accumulate<T, DP, BN, S::kLd, S::kPld>(
        acc, s, vs, ps + warp * 16 * S::kPld, g, t);
  }

  T* o = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + 8 * i;
    if (row >= p.lq) continue;
    const float inv =
        l[i] > 0.f ? 1.f / (Drop ? l[i] * p.drop.scale : l[i]) : 0.f;
    T* orow = o + row * p.o_sl;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < p.d)
        mxflash::store2<T>(orow + c, acc[dt][2 * i] * inv,
                           acc[dt][2 * i + 1] * inv);
    }
    if (t == 0)
      p.lse[static_cast<long long>(bh) * p.lq + row] =
          l[i] > 0.f ? m[i] + log2f(l[i]) : kNoKeyLse;
  }
}

template <typename T, int DP, int BN, bool Drop>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Smem<T, DP, BN>;
  auto kernel = flash_fwd_kernel<T, DP, BN, Drop>;
  const cudaError_t e = mxk::allow_smem(kernel, S::kTotal);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.b * p.h, (p.lq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, S::kTotal, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool Drop>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32, 64, Drop>(p, stream);
  if (p.d <= 64) return launch<T, 64, 64, Drop>(p, stream);
  if (p.d <= 128) return launch<T, 128, 64, Drop>(p, stream);
  return launch<T, 256, 32, Drop>(p, stream);
}

// ---------------------------------------------------------------------------
// The warpgroup route: bf16 at head dim 64 or 128
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;                  // query rows per CTA
constexpr int kWgTile = 128;                  // keys per streamed tile
constexpr int kWgS = kWgTile / 2;             // a thread's scores per tile
constexpr int kWgSteps = kWgTile / 16;        // 16-key steps of P . V
constexpr int kWgThreads = 3 * 128;           // producer + 2 consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr long long kL2GroupBytes = 8ll << 20;  // K and V of a head group

// Shared memory within 227 KB: at head dim 64 two Q tiles (the next
// item's loads while this one's run) and four stages, at 128 one Q tile
// and three stages.
template <int D>
struct WgSmem {
  static constexpr int kQ = kWgRows * D * 2;        // a Q tile
  static constexpr int kQBufs = D == 128 ? 1 : 2;
  static constexpr int kTile = kWgTile * D * 2;     // a K or a V tile
  static constexpr int kStage = 2 * kTile;          // K, then V
  static constexpr int kStages = D == 128 ? 3 : 4;
  // barriers, then two slots for the item the producer fetched
  static constexpr int kBars = 8 * (2 * kQBufs + 2 * kStages);
  static constexpr size_t kTotal = 1024 + kQBufs * size_t(kQ) +
                                   kStages * size_t(kStage) + kBars + 8;
};

// Key tiles that rows [r0, r0 + 64) (cut at lq) visit: up to the last
// key any of them sees.
__device__ __forceinline__ int wg_tiles(const Params& p, int r0) {
  if (r0 >= p.lq) return 0;
  int end = p.lk;
  if (p.causal)
    end = min(p.lk, max(0, min(r0 + 64, p.lq) + p.causal_offset));
  return (end + kWgTile - 1) / kWgTile;
}

// S (64 x 128, f32) = this warpgroup's 64 rows of the Q tile (from row0)
// times the K tile ``ks``, transposed; issued and committed, not waited.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kWgS],
                                             const unsigned char* qs,
                                             int row0,
                                             const unsigned char* ks) {
#pragma unroll
  for (int kb = 0; kb < D / 16; ++kb)
    mxhop::wgmma_ss_n128(s, mxhop::desc_k<kWgRows>(qs, row0, kb),
                         mxhop::desc_k<kWgTile>(ks, 0, kb), kb > 0);
  mxhop::wgmma_commit();
}

// O (64 x D) += P (registers) . the V tile ``vs``; issued and committed.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[kWgSteps][4],
                                         const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < kWgSteps; ++kk)
    mxhop::WgRs<D>::mma(o, a[kk], mxhop::desc_mn<kWgTile>(vs, kk));
  mxhop::wgmma_commit();
}

// The online softmax of one tile of raw scores ``s`` (keys k0 + 8 (j >> 2)
// + 2 t + (j & 1), rows ``row`` + 8 ((j >> 1) & 1)): masks the tile if
// ``mask`` (it crosses the diagonal or the ragged edge of lk), moves the
// running max m of the raw scores and this thread's partial row sums l,
// and leaves P = exp2((s - m) * scale2) in s (dropped with Drop, while l
// stays pre-dropout) and in alpha the factors by which the rows'
// accumulators must shrink. Maxima and sums go over four partials, so
// their dependency chains are a quarter as long.
template <bool Drop>
__device__ __forceinline__ void softmax_tile(float (&s)[kWgS], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2],
                                             const Params& p, int k0,
                                             int row, int t, bool mask,
                                             uint32_t head_seed) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < kWgS; ++j) {
      const int key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
      const int r = row + 8 * ((j >> 1) & 1);
      if (key >= p.lk || (p.causal && key > r + p.causal_offset))
        s[j] = -CUDART_INF_F;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float part[4] = {m[i], -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int c = 0; c < kWgTile / 8; ++c)
      part[c & 3] = fmaxf(part[c & 3],
                          fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]));
    float mx = fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no visible key so far keeps p = 0 (exp2(-inf - 0))
    const float mu = mx == -CUDART_INF_F ? 0.f : mx * p.scale2;
    alpha[i] = mxhop::fexp2(m[i] * p.scale2 - mu);
#pragma unroll
    for (int c = 0; c < 4; ++c) part[c] = 0.f;
#pragma unroll
    for (int c = 0; c < kWgTile / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * c + 2 * i + e];
        x = mxhop::fexp2(fmaf(x, p.scale2, -mu));
        part[c & 3] += x;
      }
    l[i] = l[i] * alpha[i] + ((part[0] + part[1]) + (part[2] + part[3]));
    m[i] = mx;
  }
  if constexpr (Drop) {
#pragma unroll
    for (int j = 0; j < kWgS; ++j) {
      const uint32_t key = k0 + 8 * (j >> 2) + 2 * t + (j & 1);
      const uint32_t r = row + 8 * ((j >> 1) & 1);
      if (!mxk::mx_attn_keep_in_head(head_seed, r, key, p.lk,
                                     p.drop.thresh))
        s[j] = 0.f;
    }
  }
}

// P (accumulator layout) as the register A operand of the 16-key steps
__device__ __forceinline__ void pack_p(uint32_t (&a)[kWgSteps][4],
                                       const float (&s)[kWgS]) {
#pragma unroll
  for (int kk = 0; kk < kWgSteps; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = mxk::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Ping-pong: a consumer warpgroup issues its wgmmas only on its turn
// (named barrier 2 + cw over both consumer warpgroups) and hands the turn
// to the other one once they are issued, so the tensor cores run one
// warpgroup's products while the other runs its softmax. Both take the
// same number of turns per item, the item's tiles + 1: a warpgroup that
// visits fewer tiles passes a turn with each tile it releases unread.
__device__ __forceinline__ void take_turn(int cw) {
  mxhop::named_sync(2 + cw, 256);
}
__device__ __forceinline__ void pass_turn(int cw) {
  mxhop::named_arrive(3 - cw, 256);
}

// Work item w: a (batch*head, 128-query block). Heads go in groups of
// ``group`` (see launch_wg); inside a group the heads run fastest and the
// query blocks from the last (the heaviest under causal masking).
__device__ __forceinline__ void wg_item(const Params& p, int w, int n_blocks,
                                        int group, int& bh, int& q0) {
  const int first = w / (group * n_blocks) * group;
  const int in_group = w % (group * n_blocks);
  const int heads = min(group, p.b * p.h - first);
  bh = first + in_group % heads;
  q0 = (n_blocks - 1 - in_group / heads) * kWgRows;
}

// O and lse of work items, walking key tiles of 128, with one CTA per SM:
// item blockIdx.x first, then the next one not taken (``next_item``
// counts the items handed out past the first gridDim.x; the producer
// claims an item as it starts the one before), so the items, heaviest
// first, spread over the SMs as they free up. The ring runs on across
// items, and a Q tile is refilled as soon as both consumer warpgroups
// have read their last S from it, so the next item's loads overlap this
// item's last P . V and its stores.
template <int D, bool Drop>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(Params p, int n_blocks, int group, int n_items,
                           int* next_item) {
  using S = WgSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = mxhop::align1024(smem_raw);
  unsigned char* stages = smem + S::kQBufs * S::kQ;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stages + S::kStages * S::kStage);
  uint64_t* q_full = bars;                    // per Q tile
  uint64_t* q_empty = bars + S::kQBufs;
  uint64_t* full = bars + 2 * S::kQBufs;      // per stage
  uint64_t* empty = full + S::kStages;
  // item j (j > 0) is slots[j & 1]; q_full's phase publishes it (the
  // fetching thread's own arrival, a release)
  volatile int* slots = reinterpret_cast<int*>(empty + S::kStages);

  // the warpgroup index through a shuffle: the compiler then knows it is
  // uniform in each warp, and so is every branch around the wgmmas
  // (ptxas serializes wgmmas on a path it cannot prove uniform)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;
  // full and q_full count the 128 producer threads, each arriving when
  // its own copies have landed (q_full also the fetching thread's
  // release); empty and q_empty the 8 consumer warps
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kQBufs; ++i) {
      mxhop::mbar_init(q_full + i, 129);
      mxhop::mbar_init(q_empty + i, 8);
    }
    for (int i = 0; i < S::kStages; ++i) {
      mxhop::mbar_init(full + i, 128);
      mxhop::mbar_init(empty + i, 8);
    }
    mxhop::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: per item the Q tile, then the item's K and V tiles
    // through the ring
    mxhop::setmaxnreg_dec<kProducerRegs>();
    int it = 0;                               // tiles through the ring
    int claimed = 0;                          // thread 0: the next item
    for (int j = 0;; ++j) {
      const int b = j % S::kQBufs;
      if (j >= S::kQBufs)
        mxhop::mbar_wait(q_empty + b, (j / S::kQBufs - 1) & 1);
      int w = blockIdx.x;
      if (j > 0) {
        if (tid == 0) slots[j & 1] = claimed;
        mxhop::named_sync(1, 128);
        w = slots[j & 1];
      }
      if (w >= n_items) {                     // no item left: say so
        mxhop::cp_async_arrive(q_full + b);
        if (tid == 0) mxhop::mbar_arrive(q_full + b);
        break;
      }
      if (tid == 0) claimed = gridDim.x + atomicAdd(next_item, 1);
      int bh, q0;
      wg_item(p, w, n_blocks, group, bh, q0);
      const int bi = bh / p.h;
      const int hi = bh % p.h;
      const int n_tiles = max(wg_tiles(p, q0), wg_tiles(p, q0 + 64));
      const bf16* q = static_cast<const bf16*>(p.q) + bi * p.q_sb +
                      hi * p.q_sh + q0 * p.q_sl;
      const bf16* k =
          static_cast<const bf16*>(p.k) + bi * p.k_sb + hi * p.k_sh;
      const bf16* v =
          static_cast<const bf16*>(p.v) + bi * p.v_sb + hi * p.v_sh;
      mxhop::load_tile_async<kWgRows, D, 128>(smem + b * S::kQ, q, p.q_sl,
                                              min(kWgRows, p.lq - q0), p.q,
                                              tid);
      mxhop::cp_async_arrive(q_full + b);
      if (tid == 0) mxhop::mbar_arrive(q_full + b);
      for (int i = 0; i < n_tiles; ++i, ++it) {
        const int s = it % S::kStages;
        const int u = it / S::kStages;
        if (u > 0) mxhop::mbar_wait(empty + s, (u - 1) & 1);
        const int k0 = i * kWgTile;
        const int n_k = min(kWgTile, p.lk - k0);
        unsigned char* st = stages + s * S::kStage;
        mxhop::load_tile_async<kWgTile, D, 128>(st, k + k0 * p.k_sl,
                                                p.k_sl, n_k, p.k, tid);
        mxhop::load_tile_async<kWgTile, D, 128>(st + S::kTile,
                                                v + k0 * p.v_sl, p.v_sl,
                                                n_k, p.v, tid);
        mxhop::cp_async_arrive(full + s);
      }
    }
    mxhop::cp_async_wait_all();
    return;
  }

  mxhop::setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1;                      // this warpgroup's 64 rows
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t = lane & 3;
  float o[D / 2], s[kWgS], m[2], l[2], alpha[2];
  uint32_t a[kWgSteps][4];
#pragma unroll
  for (int j = 0; j < kWgS; ++j) s[j] = 0.f;
  if (cw == 1) pass_turn(cw);                 // the first turn is cw 0's
  int it = 0;                                 // tiles through the ring
  for (int j = 0;; ++j) {
    const int b = j % S::kQBufs;
    const unsigned char* qs = smem + b * S::kQ;
    mxhop::wait_tile(q_full + b, (j / S::kQBufs) & 1);
    const int w = j > 0 ? slots[j & 1] : static_cast<int>(blockIdx.x);
    if (w >= n_items) break;
    int bh, q0;
    wg_item(p, w, n_blocks, group, bh, q0);
    const int bi = bh / p.h;
    const int hi = bh % p.h;
    const int n_tiles = max(wg_tiles(p, q0), wg_tiles(p, q0 + 64));
    const int wq0 = q0 + 64 * cw;
    const int row = wq0 + 16 * warp + (lane >> 2);   // and row + 8
    const uint32_t head_seed =
        Drop ? mxk::mx_attn_head_seed(static_cast<uint32_t>(bh), p.drop.seed)
             : 0u;
    const int n_mine = wg_tiles(p, wq0);
    // a tile is masked only across the diagonal or the ragged edge
    const int diag = p.causal ? wq0 + p.causal_offset : p.lk;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o[c] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;

    if (n_mine > 0) {
      mxhop::wait_tile(full + it % S::kStages, (it / S::kStages) & 1);
      take_turn(cw);
      mxhop::wgmma_fence();
      issue_scores<D>(s, qs, 64 * cw,
                      stages + (it % S::kStages) * S::kStage);
      pass_turn(cw);
      mxhop::wgmma_wait<0>();
      mxhop::fence_regs(s);
      softmax_tile<Drop>(s, m, l, alpha, p, 0, row, t,
                         kWgTile > p.lk || kWgTile - 1 > diag, head_seed);
      pack_p(a, s);
    }
    // tile i + 1's S goes to the tensor cores with tile i's P . V, one
    // wait per tile; the last tile's P . V is peeled off, so no wgmma sits
    // under a condition inside the loop (ptxas serializes the wgmmas of a
    // pipeline it cannot follow)
    for (int i = 0; i + 1 < n_mine; ++i) {
      const int k1 = (i + 1) * kWgTile;
      const int s0 = (it + i) % S::kStages;
      const int s1 = (it + i + 1) % S::kStages;
      mxhop::wait_tile(full + s1, ((it + i + 1) / S::kStages) & 1);
      take_turn(cw);
      mxhop::wgmma_fence();
      issue_scores<D>(s, qs, 64 * cw, stages + s1 * S::kStage);
      issue_pv<D>(o, a, stages + s0 * S::kStage + S::kTile);
      pass_turn(cw);
      mxhop::wgmma_wait<1>();
      mxhop::fence_regs(s);
      softmax_tile<Drop>(s, m, l, alpha, p, k1, row, t,
                         k1 + kWgTile > p.lk || k1 + kWgTile - 1 > diag,
                         head_seed);
      mxhop::wgmma_wait<0>();
      mxhop::fence_regs(o);
      mxhop::fence_regs(a);
      mxhop::warp_arrive(empty + s0);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] *= alpha[(c >> 1) & 1];
      pack_p(a, s);
    }
    // every S of this item has been read: its Q tile may be refilled
    mxhop::warp_arrive(q_empty + b);
    if (n_mine > 0) {
      const int s0 = (it + n_mine - 1) % S::kStages;
      take_turn(cw);
      mxhop::wgmma_fence();
      issue_pv<D>(o, a, stages + s0 * S::kStage + S::kTile);
      pass_turn(cw);
      mxhop::wgmma_wait<0>();
      mxhop::fence_regs(o);
      mxhop::warp_arrive(empty + s0);
    }
    // the item's tiles past this warpgroup's last: released unread, each
    // with the turn it does not take (and, with no tile at all, the turn
    // of the first S), in step with the other warpgroup
    if (n_mine == 0 && n_tiles > 0) {
      take_turn(cw);
      pass_turn(cw);
    }
    for (int i = n_mine; i < n_tiles; ++i) {
      mxhop::wait_tile(full + (it + i) % S::kStages,
                       ((it + i) / S::kStages) & 1);
      mxhop::warp_arrive(empty + (it + i) % S::kStages);
      take_turn(cw);
      pass_turn(cw);
    }
    it += n_tiles;

    bf16* op = static_cast<bf16*>(p.o) + bi * p.o_sb + hi * p.o_sh;
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = l[i] > 0.f ? 1.f / (Drop ? l[i] * p.drop.scale : l[i]) : 0.f;
      const int r = row + 8 * i;
      if (t == 0 && r < p.lq)
        p.lse[static_cast<long long>(bh) * p.lq + r] =
            l[i] > 0.f ? m[i] * p.scale2 + log2f(l[i]) : kNoKeyLse;
    }
#pragma unroll
    for (int c = 0; c < D / 2; c += 2) {
      const int i = (c >> 1) & 1;
      const int r = row + 8 * i;
      if (r < p.lq)
        mxflash::store2<bf16>(op + r * p.o_sl + 8 * (c >> 2) + 2 * t,
                              o[c] * inv[i], o[c + 1] * inv[i]);
    }
  }
}

template <int D, bool Drop>
cudaError_t launch_wg(const Params& p, int* next_item, cudaStream_t stream) {
  using S = WgSmem<D>;
  auto kernel = flash_fwd_wgmma_kernel<D, Drop>;
  cudaError_t e = mxk::allow_smem(kernel, S::kTotal);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_heads = p.b * p.h;
  const int nq = (p.lq + kWgRows - 1) / kWgRows;
  // heads whose K and V (lk x D bf16 each) fill about kL2GroupBytes of
  // L2 share a group: every query block of a head reads them
  const long long head_bytes = 4ll * p.lk * D;
  const int group = static_cast<int>(
      max(1ll, min(static_cast<long long>(n_heads),
                   kL2GroupBytes / head_bytes)));
  const int n_items = n_heads * nq;
  e = cudaMemsetAsync(next_item, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  kernel<<<min(n_items, sms), kWgThreads, S::kTotal, stream>>>(
      p, nq, group, n_items, next_item);
  return cudaGetLastError();
}

// The route is fixed by the inputs: bf16 at head dim 64 or 128 takes the
// warpgroup kernel, everything else the mma.sync / FMA kernel.
template <typename T>
cudaError_t launch_t(const Params& p, bool drop, int* next_item,
                     cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.d == 64)
      return drop ? launch_wg<64, true>(p, next_item, stream)
                  : launch_wg<64, false>(p, next_item, stream);
    if (p.d == 128)
      return drop ? launch_wg<128, true>(p, next_item, stream)
                  : launch_wg<128, false>(p, next_item, stream);
  }
  return drop ? launch_d<T, true>(p, stream) : launch_d<T, false>(p, stream);
}

}  // namespace

// q: (b, h, lq, d), k/v: (b, h, lk, d), o: (b, h, lq, d) given by element
// strides[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
// o_sb, o_sh, o_sl} (the head-dim stride is 1); lse: (b*h, lq) f32.
// Requires d % 8 == 0, d <= 256, every stride a multiple of 8 and 16-byte
// aligned base pointers. drop != 0 drops P under (seed, thresh) and
// divides by l * one_minus_p. next_item: one int of device scratch (the
// warpgroup route's work counter, zeroed here on ``stream``). Returns
// cudaGetLastError() after the launch.
extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const long long* strides, int b, int h,
                                      int lq, int lk, int d, float scale2,
                                      int causal, int causal_offset,
                                      int dtype, int drop, unsigned seed,
                                      unsigned thresh, float one_minus_p,
                                      int* next_item, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_sl = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_sl = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_sl = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_sl = strides[11];
  p.b = b;
  p.h = h;
  p.lq = lq;
  p.lk = lk;
  p.d = d;
  p.causal = causal;
  p.causal_offset = causal_offset;
  p.scale2 = scale2;
  p.drop = mxk::Dropout{seed, thresh, one_minus_p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 8 || d > 256 || d % 8 != 0 || lq < 1 || lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == mxk::kBFloat16)
    return launch_t<bf16>(p, drop != 0, next_item, s);
  if (dtype == mxk::kFloat32)
    return launch_t<float>(p, drop != 0, next_item, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
