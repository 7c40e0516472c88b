// 2-bit gradient quantization with error feedback for Hopper (sm_90a):
// the compressor of the kvstore's gradient compression.
//
// Replaces the quantizer `_q` of mxnet_tpu/kvstore/gradient_compression.py
// (:68-73). It is not a Pallas site: on the TPU, XLA fuses this
// elementwise code into one program; eager PyTorch would run it as five
// full passes (add, two compares, two selects) plus the casts, so the
// port gives it this kernel. Per element, for threshold t > 0:
//
//   g2 = f32(g) + r                       (rounded once, in f32)
//   o  = g2 >= t ? t : (g2 <= -t ? -t : 0)
//   r  = g2 - o                           (in place, f32)
//   q  = cast(o -> g's dtype)             (t rounded to bf16/f16)
//
// The residual keeps the unrounded f32 t, as `g2 - out` does in the
// reference before `out.astype(g.dtype)`. NaN compares false both ways,
// so it gives q = 0 and r = NaN; +-inf gives q = +-t and r = +-inf. The
// zero is +0 whatever g2's sign, as jnp.where's f32 0.0 is.
//
// What bounds it on an H100: device-memory bytes. Each element reads g
// and r once and writes q and r once: 12 bytes in bf16, 16 in f32, and
// about five f32 operations. So each thread moves 16 bytes of r per
// access (four elements; g and q as 8 or 16 bytes) in a grid-stride
// loop; a bucket whose pointers or length do not allow that runs the
// same code one element at a time.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T a) {
  return mxk::to_f(a);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half a) {
  return __half2float(a);
}
template <typename T>
__device__ __forceinline__ T from_f32(float a) {
  return mxk::from_f<T>(a);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float a) {
  return __float2half_rn(a);
}

constexpr int kThreads = 256;
constexpr int kFloat16 = 2;  // the wrapper's code for torch.float16

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
    twobit_kernel(const T* __restrict__ g, float* __restrict__ r,
                  T* __restrict__ q, long long n, float t) {
  const long long chunks = n / kVec;
  const float nt = -t;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < chunks; c += static_cast<long long>(gridDim.x) * blockDim.x) {
    const mxk::Vec<T, kVec> gv =
        *reinterpret_cast<const mxk::Vec<T, kVec>*>(g + c * kVec);
    mxk::Vec<float, kVec> rv =
        *reinterpret_cast<const mxk::Vec<float, kVec>*>(r + c * kVec);
    mxk::Vec<T, kVec> qv;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float g2 = __fadd_rn(to_f32(gv.v[e]), rv.v[e]);
      const float o = g2 >= t ? t : (g2 <= nt ? nt : 0.f);
      qv.v[e] = from_f32<T>(o);
      rv.v[e] = __fsub_rn(g2, o);
    }
    *reinterpret_cast<mxk::Vec<float, kVec>*>(r + c * kVec) = rv;
    *reinterpret_cast<mxk::Vec<T, kVec>*>(q + c * kVec) = qv;
  }
}

template <typename T>
cudaError_t launch(const void* g, void* r, void* q, long long n, float t,
                   bool vec, int n_ctas, cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  float* rt = static_cast<float*>(r);
  T* qt = static_cast<T*>(q);
  if (vec)
    twobit_kernel<T, 4><<<n_ctas, kThreads, 0, stream>>>(gt, rt, qt, n, t);
  else
    twobit_kernel<T, 1><<<n_ctas, kThreads, 0, stream>>>(gt, rt, qt, n, t);
  return cudaGetLastError();
}

}  // namespace

// g: n contiguous gradient elements (dtype: 0 f32, 1 bf16, 2 f16); r: n
// contiguous f32 residuals, updated in place; q: n elements of g's dtype,
// overlapping neither g nor r. vec != 0 requires g, q 8-byte (bf16/f16)
// or 16-byte (f32) aligned, r 16-byte aligned and n a multiple of 4. n_ctas: the grid
// (grid-stride loop). Returns cudaGetLastError() after the launch.
extern "C" int mx_twobit_quantize(const void* g, void* r, void* q,
                                  long long n, float t, int dtype, int vec,
                                  int n_ctas, void* stream) {
  if (n < 1 || n_ctas < 1 || !(t > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxk::kBFloat16)
    return launch<__nv_bfloat16>(g, r, q, n, t, vec != 0, n_ctas, s);
  if (dtype == mxk::kFloat32)
    return launch<float>(g, r, q, n, t, vec != 0, n_ctas, s);
  if (dtype == kFloat16)
    return launch<__half>(g, r, q, n, t, vec != 0, n_ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
