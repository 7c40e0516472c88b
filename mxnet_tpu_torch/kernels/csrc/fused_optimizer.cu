// Fused multi-tensor Adam sweep for Hopper (sm_90a).
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
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;          // elements per CTA
constexpr int kFields = 7;  // w, g, m, v, w_low, n, first chunk

struct Hyper {
  float b1, omb1, b2, omb2, eps, rescale, clip;  // clip < 0: none
};

template <typename TW, typename TG>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const long long* __restrict__ members,
                const float* __restrict__ lr_wd, int n_members, Hyper hp) {
  // this CTA's member: the last one whose first chunk is <= blockIdx.x
  // (an empty member shares its first chunk with the next one)
  int j = 0;
  for (int hi = n_members - 1; j < hi;) {
    const int mid = (j + hi + 1) / 2;
    if (members[kFields * mid + 6] <= blockIdx.x)
      j = mid;
    else
      hi = mid - 1;
  }
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
    float gi = __fmul_rn(mxk::to_f(g[i]), hp.rescale);
    if (hp.clip >= 0.f)  // NaN passes through, as jnp.clip / torch.clamp
      gi = gi < -hp.clip ? -hp.clip : (gi > hp.clip ? hp.clip : gi);
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
