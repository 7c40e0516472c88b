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
// inputs and gradients ~201 MB (0.060 ms at 3.35 TB/s): operations, by
// a little. The TPU kernels hold a whole 512 x 512 f32 tile per head in
// VMEM; here nothing of that size fits, so the design streams, as the
// TPU's own streaming pair does, with no atomics (deterministic):
//
//  * a pre-pass computes delta (one warp per query row), so the f32
//    products dO * O are never written to device memory;
//  * dK/dV: one CTA of 4 warps per (batch*head, 64-key block); each warp
//    owns 16 keys, holds their dK and dV accumulators in registers, and
//    the CTA walks the query blocks (Q, dO, lse, delta through shared
//    memory), recomputing P^T and dP^T in registers;
//  * dQ: one CTA per (batch*head, 64-query block) walks the key blocks
//    (K, V through shared memory) and keeps dQ in registers;
//  * the causal triangle's empty blocks are not visited;
//  * bf16 products on the tensor cores (mma.sync m16n8k16, f32
//    accumulate), the transposed operands of P^T . dO and dS^T . Q read
//    from shared memory as 16-bit pairs; f32 with FMA on the CUDA cores;
//  * q, k, v, o, dO and the gradients are addressed by (batch, head, seq)
//    strides, so the heads of a fused QKV projection go in as views.
//
// The simple first design: no cp.async/TMA pipelining, no ldmatrix, no
// wgmma, P recomputed in both kernels. PERF.md keeps its time beside its
// bound.
#include "flash_common.cuh"
#include "hash_dropout.cuh"

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

// delta[row] = sum_d dO[row, d] * O[row, d] in f32, one warp per row.
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(Params p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (row >= static_cast<long long>(p.b) * p.h * p.lq) return;
  const int lane = threadIdx.x & 31;
  const int i = static_cast<int>(row % p.lq);
  const int bh = static_cast<int>(row / p.lq);
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const T* o = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh +
               i * p.o_sl;
  const T* g = static_cast<const T*>(p.dout) + bi * p.do_sb +
               hi * p.do_sh + i * p.do_sl;
  float s = 0.f;
  for (int c = lane; c < p.d; c += 32) s += mxk::to_f(o[c]) * mxk::to_f(g[c]);
  s = mxk::warp_sum(s);
  if (lane == 0) p.delta[row] = s;
}

// dK, dV for one (batch*head, 64-key block), walking query blocks of BQ.
template <typename T, int DP, int BQ, bool Drop>
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

  float dk[DP / 8][4], dv[DP / 8][4];
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
      mxflash::accumulate<T, DP, BQ, LD, S::kPld>(dv, pt, dos, pw, g, t);

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
      mxflash::accumulate<T, DP, BQ, LD, S::kPld>(dv, pt, dos, pw, g, t);
    mxflash::accumulate<T, DP, BQ, LD, S::kPld>(dk, ds, qs, pw, g, t);
  }

  T* dkp = static_cast<T*>(p.dk) + bi * p.dk_sb + hi * p.dk_sh + k0 * p.dk_sl;
  T* dvp = static_cast<T*>(p.dv) + bi * p.dv_sb + hi * p.dv_sh + k0 * p.dv_sl;
  mxflash::store_rows<T, DP>(dkp, p.dk_sl, dk, r0, n_keys, p.d, t);
  mxflash::store_rows<T, DP>(dvp, p.dv_sl, dv, r0, n_keys, p.d, t);
}

// dQ for one (batch*head, 64-query block), walking key blocks of BK.
template <typename T, int DP, int BK, bool Drop>
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

  float dq[DP / 8][4];
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
    mxflash::accumulate<T, DP, BK, LD, S::kPld>(dq, ds, ks, pw, g, t);
  }

  T* dqp = static_cast<T*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh + q0 * p.dq_sl;
  mxflash::store_rows<T, DP>(dqp, p.dq_sl, dq, r0, n_q, p.d, t);
}

template <typename T, int DP, int BS, bool Drop>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Smem<T, DP, BS>;
  const long long rows = static_cast<long long>(p.b) * p.h * p.lq;
  delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto dkdv = dkdv_kernel<T, DP, BS, Drop>;
  e = mxk::allow_smem(dkdv, S::kTotal);
  if (e != cudaSuccess) return e;
  dkdv<<<dim3(p.b * p.h, (p.lk + kRows - 1) / kRows), kThreads, S::kTotal,
         stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto dq = dq_kernel<T, DP, BS, Drop>;
  e = mxk::allow_smem(dq, S::kTotal);
  if (e != cudaSuccess) return e;
  dq<<<dim3(p.b * p.h, (p.lq + kRows - 1) / kRows), kThreads, S::kTotal,
       stream>>>(p);
  return cudaGetLastError();
}

// the streamed tile is 64 rows, 32 at head dim 128 (register budget of
// the owned rows' two D-wide accumulators)
template <typename T, bool Drop>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 32, 64, Drop>(p, stream);
  if (p.d <= 64) return launch<T, 64, 64, Drop>(p, stream);
  return launch<T, 128, 32, Drop>(p, stream);
}

template <typename T>
cudaError_t launch_t(const Params& p, bool drop, cudaStream_t stream) {
  return drop ? launch_d<T, true>(p, stream) : launch_d<T, false>(p, stream);
}

}  // namespace

// q, o, dout, dq: (b, h, lq, d); k, v, dk, dv: (b, h, lk, d), given by
// element strides[24] = {q, k, v, o, dout, dq, dk, dv} x {batch, head,
// seq} (the head-dim stride is 1); lse: (b*h, lq) f32 from the forward;
// delta: (b*h, lq) f32 scratch. Requires d % 8 == 0, d <= 128, every
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
  if (d < 8 || d > 128 || d % 8 != 0 || lq < 1 || lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == mxk::kBFloat16) return launch_t<bf16>(p, drop != 0, s);
  if (dtype == mxk::kFloat32) return launch_t<float>(p, drop != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
