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
// are close and neither is far below the other; at longer L the
// operations dominate. The TPU kernel kept a whole 512 x 512 f32 score
// tile in VMEM; on Hopper that tile (1 MB) fits neither shared memory
// nor registers, so the design streams instead:
//
//  * one CTA of 4 warps per (batch*head, 64-query tile); each warp owns
//    16 query rows, so every row's softmax statistics live in the
//    registers of the 4 lanes that hold it (no shared-memory reductions);
//  * the Q tile is loaded once into shared memory; K and V stream
//    through shared memory in tiles of 64 keys (32 for head dim 256),
//    16-byte loads, zero-filled past the ragged edge of L and D;
//  * bf16: both products on the tensor cores with mma.sync m16n8k16
//    (f32 accumulate); the score accumulators are re-packed in registers
//    as the A operand of P.V, rounded to bf16 as the TPU kernel rounds P
//    to v's dtype. f32: FMA on the CUDA cores, P staged through shared
//    memory per warp;
//  * causal masking is bottom-right aligned (key <= query + lk - lq) and
//    key tiles wholly above the diagonal are not visited;
//  * dropout (the Drop instances, `_drop_mask` / `_drop_mask_g` of the
//    TPU kernels): the online max, the row sum l and the base-2 lse stay
//    pre-dropout; only the P that enters P.V is masked, keep from the
//    two-level position hash of (b * h + head, query, key) with the true
//    lk and no causal offset (hash_dropout.cuh; the head seed once per
//    CTA), and 1 - p folds into the final normalize, which divides by
//    l * f32(1 - p) as the TPU kernels do (:341, :414, :456).
//
// This is the simple first design: no cp.async/TMA double buffering, no
// wgmma, no warp specialisation. PERF.md keeps its time beside its bound.
#include "flash_common.cuh"
#include "hash_dropout.cuh"

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

template <typename T>
cudaError_t launch_t(const Params& p, bool drop, cudaStream_t stream) {
  return drop ? launch_d<T, true>(p, stream) : launch_d<T, false>(p, stream);
}

}  // namespace

// q: (b, h, lq, d), k/v: (b, h, lk, d), o: (b, h, lq, d) given by element
// strides[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
// o_sb, o_sh, o_sl} (the head-dim stride is 1); lse: (b*h, lq) f32.
// Requires d % 8 == 0, d <= 256, every stride a multiple of 8 and 16-byte
// aligned base pointers. drop != 0 drops P under (seed, thresh) and
// divides by l * one_minus_p. Returns cudaGetLastError() after the launch.
extern "C" int mx_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const long long* strides, int b, int h,
                                      int lq, int lk, int d, float scale2,
                                      int causal, int causal_offset,
                                      int dtype, int drop, unsigned seed,
                                      unsigned thresh, float one_minus_p,
                                      void* stream) {
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
  if (dtype == mxk::kBFloat16) return launch_t<bf16>(p, drop != 0, s);
  if (dtype == mxk::kFloat32) return launch_t<float>(p, drop != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
