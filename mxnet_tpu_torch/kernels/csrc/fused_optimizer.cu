// Fused multi-tensor SGD, Adam and AdamW sweeps for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/fused_optimizer.py
// `sweep_pallas` (the pallas_call at :128) for the Adam family: one
// elementwise pass over a whole dtype bucket of parameters, running the
// formula of `_adam_elem` (mxnet_tpu/optimizer/multi_tensor.py:342-353)
// and, for a multi-precision bucket, the downcast of the f32 master to the
// low-precision weight (`w_low`, :545) in the same pass:
//
//   g  = g * rescale  (clipped to [-clip, clip] when clip >= 0)  + wd * w
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + (1 - b2) * g * g
//   w  = w - lr * m / (sqrt(v) + eps)        [w_low = bf16(w)]
//
// lr (with Adam's bias correction folded in) and wd are per member.
//
// What bounds it on an H100: bytes. Per element of a bf16 multi-precision
// bucket it reads the bf16 grad and the f32 master, mean and var and
// writes those three and the bf16 weight: 28 bytes for ~15 flops. The TPU
// kernel reads the bucket pre-packed into flat buffers, a concatenation
// XLA fuses into its producers; done eagerly in torch, packing and
// unpacking would add four full passes over the 110M elements of
// BERT-base. So the kernel walks the members where they lie instead (the
// multi-tensor-apply pattern): a small device table holds each member's
// five pointers, its size and its first 4096-element chunk; each CTA finds
// its member by a binary search over those first chunks, and lr and wd
// come from a per-member table. One launch per bucket, each element read
// and written once, coalesced.
//
// Bit-identical to the plain PyTorch version (one torch op per step of
// the formula): every product, sum, square root and quotient is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsqrt_rn,
// __fdiv_rn), so nvcc cannot contract a*b+c into an FMA.
//
// The AdamW family (mx_adamw_scan + mx_adamw_sweep) replaces the same
// pallas_call running `_adamw_elem` (multi_tensor.py:356-372) after the
// per-member overflow scan (:474-491), MXNet's contrib adamw.cc
// semantics rather than torch.optim.AdamW's:
//
//   g  = g * rescale  (clipped when clip >= 0; no wd term)
//   ok = every element of the member's g is finite      (the scan)
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + (1 - b2) * g * g
//   w  = w - 1.0 * (lr * m / (sqrt(v) + eps) + wd * lr * w)
//   where !ok: w, m and v keep their old values      [w_low = bf16(w)]
//
// lr is the bias-corrected rate (the correction folded in per member),
// so wd multiplies it. The states are f32 whatever the weight's dtype
// (AdamW.create_state). Two launches per bucket over the same member
// table: the scan, where a CTA that sees a non-finite g stores 0 into
// its member's on-device int32 flag (started at 1; every writer writes
// the same value, so the race is benign), then the sweep, which reads
// the flag. Clipping maps +-inf to +-clip, which passes; NaN passes the
// clip and fails, as jnp.clip then jnp.isfinite do. The flags stay on
// the card. The scan reads 2 bytes per element of a bf16-mp bucket, the
// sweep 28, as Adam's.
//
// The SGD family (mx_sgd_sweep) replaces the same pallas_call running
// `_sgd_elem` (multi_tensor.py:326-339), with the multi-precision write
// of mp_sgd_mom_update (mxnet_tpu/ops/optimizer_op.py:55-61):
//
//   g  = g * rescale  (clipped when clip >= 0)  + wd * w
//   with a momentum state:  mom = momentum * mom - lr * g;  w = w + mom
//   without:                w   = w - lr * g              [w_low = bf16(w)]
//
// lr and wd per member, no bias correction; momentum 0 with a state still
// rewrites it to -lr * g (the op's contract). A non-finite g propagates,
// as in the reference (no overflow skip). The state is in w's dtype
// (SGD.create_state: the f32 master's under multi-precision). One launch
// per bucket over the member table the Adam sweeps read (the state in the
// m slot, 0 for none). Bytes per element of ResNet-50's bf16-mp bucket:
// read g 2, w 4 and mom 4; write w 4, mom 4 and w_low 2: 20 bytes for
// ~6 flops, so bytes bound it, as Adam's 28.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;          // elements per CTA
constexpr int kFields = 7;  // w, g, m, v, w_low, n, first chunk

struct Hyper {
  float b1, omb1, b2, omb2, eps, rescale, clip;  // clip < 0: none
};

// This CTA's member: the last one whose first chunk is <= blockIdx.x
// (an empty member shares its first chunk with the next one).
__device__ __forceinline__ int find_member(
    const long long* __restrict__ members, int n_members) {
  int j = 0;
  for (int hi = n_members - 1; j < hi;) {
    const int mid = (j + hi + 1) / 2;
    if (members[kFields * mid + 6] <= blockIdx.x)
      j = mid;
    else
      hi = mid - 1;
  }
  return j;
}

__device__ __forceinline__ float rescale_clip(float g, const Hyper& hp) {
  float gi = __fmul_rn(g, hp.rescale);
  if (hp.clip >= 0.f)  // NaN passes through, as jnp.clip / torch.clamp
    gi = gi < -hp.clip ? -hp.clip : (gi > hp.clip ? hp.clip : gi);
  return gi;
}

// The SGD sweep; ``hp.b1`` is the momentum. The state (mom) is in TW, or
// absent (a null address: every member of a bucket has it or none does).
template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
    sgd_kernel(const long long* __restrict__ members,
               const float* __restrict__ lr_wd, int n_members, Hyper hp) {
  const int j = find_member(members, n_members);
  const long long* mem = members + kFields * j;
  const long long start = (blockIdx.x - mem[6]) * kChunk;
  TW* w = reinterpret_cast<TW*>(mem[0]);
  const TG* g = reinterpret_cast<const TG*>(mem[1]);
  TW* mom = reinterpret_cast<TW*>(mem[2]);
  __nv_bfloat16* low = reinterpret_cast<__nv_bfloat16*>(mem[4]);
  const long long n = mem[5];
  const float lr = lr_wd[2 * j];
  const float wd = lr_wd[2 * j + 1];
  const long long end = min(n, start + kChunk);
#pragma unroll 4
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    float gi = rescale_clip(mxk::to_f(g[i]), hp);
    const float wi = mxk::to_f(w[i]);
    gi = __fadd_rn(gi, __fmul_rn(wd, wi));
    float wn;
    if (mom != nullptr) {
      const float mi = __fsub_rn(__fmul_rn(hp.b1, mxk::to_f(mom[i])),
                                 __fmul_rn(lr, gi));
      wn = __fadd_rn(wi, mi);
      mom[i] = mxk::from_f<TW>(mi);
    } else {
      wn = __fsub_rn(wi, __fmul_rn(lr, gi));
    }
    w[i] = mxk::from_f<TW>(wn);
    if (low != nullptr) low[i] = __float2bfloat16_rn(wn);
  }
}

template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const long long* __restrict__ members,
                const float* __restrict__ lr_wd, int n_members, Hyper hp) {
  const int j = find_member(members, n_members);
  const long long* mem = members + kFields * j;
  const long long start = (blockIdx.x - mem[6]) * kChunk;
  TW* w = reinterpret_cast<TW*>(mem[0]);
  const TG* g = reinterpret_cast<const TG*>(mem[1]);
  TW* m = reinterpret_cast<TW*>(mem[2]);
  TW* v = reinterpret_cast<TW*>(mem[3]);
  __nv_bfloat16* low = reinterpret_cast<__nv_bfloat16*>(mem[4]);
  const long long n = mem[5];
  const float lr = lr_wd[2 * j];
  const float wd = lr_wd[2 * j + 1];
  const long long end = min(n, start + kChunk);
#pragma unroll 4
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    float gi = rescale_clip(mxk::to_f(g[i]), hp);
    const float wi = mxk::to_f(w[i]);
    gi = __fadd_rn(gi, __fmul_rn(wd, wi));
    const float mi = __fadd_rn(__fmul_rn(hp.b1, mxk::to_f(m[i])),
                               __fmul_rn(hp.omb1, gi));
    const float vi = __fadd_rn(__fmul_rn(hp.b2, mxk::to_f(v[i])),
                               __fmul_rn(hp.omb2, __fmul_rn(gi, gi)));
    const float wn = __fsub_rn(
        wi, __fdiv_rn(__fmul_rn(lr, mi), __fadd_rn(__fsqrt_rn(vi), hp.eps)));
    w[i] = mxk::from_f<TW>(wn);
    m[i] = mxk::from_f<TW>(mi);
    v[i] = mxk::from_f<TW>(vi);
    if (low != nullptr) low[i] = __float2bfloat16_rn(wn);
  }
}

// The AdamW overflow scan: ok[j] = 0 when this CTA's chunk of member j
// holds a g that is not finite after the rescale and the clip.
template <typename TG>
__global__ void __launch_bounds__(kThreads)
    adamw_scan_kernel(const long long* __restrict__ members,
                      int* __restrict__ ok, int n_members, Hyper hp) {
  const int j = find_member(members, n_members);
  const long long* mem = members + kFields * j;
  const long long start = (blockIdx.x - mem[6]) * kChunk;
  const TG* g = reinterpret_cast<const TG*>(mem[1]);
  const long long end = min(mem[5], start + kChunk);
  int bad = 0;
#pragma unroll 4
  for (long long i = start + threadIdx.x; i < end; i += kThreads)
    bad |= !isfinite(rescale_clip(mxk::to_f(g[i]), hp));
  if (__syncthreads_or(bad) && threadIdx.x == 0) ok[j] = 0;
}

// The AdamW sweep; the states m and v are f32 whatever TW is.
template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const long long* __restrict__ members,
                 const float* __restrict__ lr_wd,
                 const int* __restrict__ ok, int n_members, Hyper hp) {
  const int j = find_member(members, n_members);
  const long long* mem = members + kFields * j;
  const long long start = (blockIdx.x - mem[6]) * kChunk;
  TW* w = reinterpret_cast<TW*>(mem[0]);
  const TG* g = reinterpret_cast<const TG*>(mem[1]);
  float* m = reinterpret_cast<float*>(mem[2]);
  float* v = reinterpret_cast<float*>(mem[3]);
  __nv_bfloat16* low = reinterpret_cast<__nv_bfloat16*>(mem[4]);
  const long long n = mem[5];
  const float lr = lr_wd[2 * j];
  const float wd_lr = __fmul_rn(lr_wd[2 * j + 1], lr);
  const bool keep = ok[j] == 0;      // an overflowed member stays as it is
  const long long end = min(n, start + kChunk);
#pragma unroll 4
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float wi = mxk::to_f(w[i]);
    if (keep) {
      if (low != nullptr) low[i] = __float2bfloat16_rn(wi);
      continue;
    }
    const float gi = rescale_clip(mxk::to_f(g[i]), hp);
    const float mi = __fadd_rn(__fmul_rn(hp.b1, m[i]), __fmul_rn(hp.omb1, gi));
    const float vi = __fadd_rn(__fmul_rn(hp.b2, v[i]),
                               __fmul_rn(hp.omb2, __fmul_rn(gi, gi)));
    const float step = __fadd_rn(
        __fdiv_rn(__fmul_rn(lr, mi), __fadd_rn(__fsqrt_rn(vi), hp.eps)),
        __fmul_rn(wd_lr, wi));
    const float wn = __fsub_rn(wi, step);
    w[i] = mxk::from_f<TW>(wn);
    m[i] = mi;
    v[i] = vi;
    if (low != nullptr) low[i] = __float2bfloat16_rn(wn);
  }
}

}  // namespace

// members: (n_members, 7) int64 on the device: the update target w (the
// f32 master of a multi-precision bucket), the grad g, the states m and v
// (w's dtype), the bf16 low-precision weight or 0, the element count, and
// the member's first 4096-element chunk (the running sum of the earlier
// members' chunk counts). lr_wd: (n_members, 2) f32 on the device.
// n_blocks: the total chunk count. w_dtype is w's (and the states')
// dtype, g_dtype the grad's; clip < 0 means no clipping. Updates in
// place; returns cudaGetLastError() after the launch.
extern "C" int mx_adam_sweep(const long long* members, const float* lr_wd,
                             int n_members, int n_blocks, float beta1,
                             float one_minus_beta1, float beta2,
                             float one_minus_beta2, float eps, float rescale,
                             float clip, int w_dtype, int g_dtype,
                             void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || n_members < 1) return static_cast<int>(cudaSuccess);
  const Hyper hp{beta1, one_minus_beta1, beta2, one_minus_beta2,
                 eps,   rescale,         clip};
  if (w_dtype == mxk::kFloat32 && g_dtype == mxk::kFloat32)
    adam_kernel<float, float>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, n_members, hp);
  else if (w_dtype == mxk::kFloat32 && g_dtype == mxk::kBFloat16)
    adam_kernel<float, bf16>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, n_members, hp);
  else if (w_dtype == mxk::kBFloat16 && g_dtype == mxk::kBFloat16)
    adam_kernel<bf16, bf16>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, n_members, hp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The AdamW scan. members: the table mx_adam_sweep reads (w, g, m, v,
// w_low, n, first chunk); ok: (n_members,) int32 on the device, all 1 on
// entry, 0 on return for each member whose g holds a value that is not
// finite after the rescale and the clip (clip < 0: none). Returns
// cudaGetLastError() after the launch.
extern "C" int mx_adamw_scan(const long long* members, int* ok,
                             int n_members, int n_blocks, float rescale,
                             float clip, int g_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || n_members < 1) return static_cast<int>(cudaSuccess);
  const Hyper hp{0.f, 0.f, 0.f, 0.f, 0.f, rescale, clip};
  if (g_dtype == mxk::kFloat32)
    adamw_scan_kernel<float>
        <<<n_blocks, kThreads, 0, s>>>(members, ok, n_members, hp);
  else if (g_dtype == mxk::kBFloat16)
    adamw_scan_kernel<bf16>
        <<<n_blocks, kThreads, 0, s>>>(members, ok, n_members, hp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The AdamW sweep, after mx_adamw_scan filled ``ok``. members, lr_wd,
// n_blocks and the hyperparameters as for mx_adam_sweep (lr with the
// bias correction folded in); the states m and v are f32, w is f32 (the
// master of a multi-precision bucket) with f32 or bf16 grads, or bf16
// with bf16 grads. Updates in place; returns cudaGetLastError() after
// the launch.
extern "C" int mx_adamw_sweep(const long long* members, const float* lr_wd,
                              const int* ok, int n_members, int n_blocks,
                              float beta1, float one_minus_beta1,
                              float beta2, float one_minus_beta2, float eps,
                              float rescale, float clip, int w_dtype,
                              int g_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || n_members < 1) return static_cast<int>(cudaSuccess);
  const Hyper hp{beta1, one_minus_beta1, beta2, one_minus_beta2,
                 eps,   rescale,         clip};
  if (w_dtype == mxk::kFloat32 && g_dtype == mxk::kFloat32)
    adamw_kernel<float, float>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, ok, n_members, hp);
  else if (w_dtype == mxk::kFloat32 && g_dtype == mxk::kBFloat16)
    adamw_kernel<float, bf16>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, ok, n_members, hp);
  else if (w_dtype == mxk::kBFloat16 && g_dtype == mxk::kBFloat16)
    adamw_kernel<bf16, bf16>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, ok, n_members, hp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The SGD sweep. members: the table mx_adam_sweep reads, with the
// momentum state in the m slot (0 for the momentum-free form) and the v
// slot unused; lr_wd: (n_members, 2) f32 on the device; the state in w's
// dtype; w f32 (the master of a multi-precision bucket) with f32 or bf16
// grads, or bf16 with bf16 grads; clip < 0 means no clipping. Updates in
// place; returns cudaGetLastError() after the launch.
extern "C" int mx_sgd_sweep(const long long* members, const float* lr_wd,
                            int n_members, int n_blocks, float momentum,
                            float rescale, float clip, int w_dtype,
                            int g_dtype, void* stream) {
  using bf16 = __nv_bfloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || n_members < 1) return static_cast<int>(cudaSuccess);
  const Hyper hp{momentum, 0.f, 0.f, 0.f, 0.f, rescale, clip};
  if (w_dtype == mxk::kFloat32 && g_dtype == mxk::kFloat32)
    sgd_kernel<float, float>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, n_members, hp);
  else if (w_dtype == mxk::kFloat32 && g_dtype == mxk::kBFloat16)
    sgd_kernel<float, bf16>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, n_members, hp);
  else if (w_dtype == mxk::kBFloat16 && g_dtype == mxk::kBFloat16)
    sgd_kernel<bf16, bf16>
        <<<n_blocks, kThreads, 0, s>>>(members, lr_wd, n_members, hp);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
