// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel library is built from ONE .cu file with a plain C
// interface (loaded through ctypes), so this header is included once per
// shared object. Tensors arrive as raw device pointers; the dtype codes
// below are the ones the Python wrappers pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace mxk {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(__nv_bfloat16 a) {
  return __bfloat162float(a);
}

template <typename T>
__device__ __forceinline__ T from_f(float a);
template <>
__device__ __forceinline__ float from_f<float>(float a) {
  return a;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float a) {
  return __float2bfloat16_rn(a);
}

// Round an f32 value to T's precision and back (a no-op for f32).
template <typename T>
__device__ __forceinline__ float round_to(float a) {
  return to_f(from_f<T>(a));
}

// N elements of T as one aligned access (N * sizeof(T) <= 16 bytes).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T, int N>
struct PerAccess {
  static constexpr int kMax = 16 / static_cast<int>(sizeof(T));
  static constexpr int value = N < kMax ? N : kMax;
};

// Load N consecutive elements into f32 registers with 16-byte (or
// narrower, when N is small) vector accesses. ``p`` must be aligned to
// the access width: the wrappers check the base pointers, and every
// offset the kernels form is a multiple of N.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* o) {
  constexpr int kPer = PerAccess<T, N>::value;
#pragma unroll
  for (int j = 0; j < N; j += kPer) {
    const Vec<T, kPer> a = *reinterpret_cast<const Vec<T, kPer>*>(p + j);
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[j + i] = to_f(a.v[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_f(T* __restrict__ p, const float* v) {
  constexpr int kPer = PerAccess<T, N>::value;
#pragma unroll
  for (int j = 0; j < N; j += kPer) {
    Vec<T, kPer> a;
#pragma unroll
    for (int i = 0; i < kPer; ++i) a.v[i] = from_f<T>(v[j + i]);
    *reinterpret_cast<Vec<T, kPer>*>(p + j) = a;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread gets the result. ``scratch``
// holds one float per warp. blockDim.x must be a multiple of 32. A
// second call in the same kernel needs its own ``scratch`` (or a
// __syncthreads() between the calls): a fast warp could otherwise
// overwrite a slot another warp has not read yet.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < n_warps ? scratch[lane] : 0.f;
  v = warp_sum(v);
  return v;
}

// Threads for a one-CTA-per-row kernel that gives each thread ``work``
// items (chunks or elements): a whole number of warps, at most ``cap``.
inline int row_threads(int work, int cap) {
  int t = ((work + 31) / 32) * 32;
  return t > cap ? cap : (t < 32 ? 32 : t);
}

// Two f32 values as one bf16x2 register, the lower index in the low half
// (the operand layout of mma.sync).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Set the dynamic shared memory a kernel may use (above 48 KB only after
// this call); a no-op below the default.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mxk

extern "C" const char* mx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
