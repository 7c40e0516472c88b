// Position-hash dropout for Hopper (sm_90a): the Dropout op.
//
// Replaces the hash branch of mxnet_tpu/ops/nn.py `dropout_op`
// (:1079-1131; MXNET_TPU_HASH_DROPOUT=1 or MXNET_PALLAS_FUSED=1, which
// the port always follows). It is not a Pallas site: on the TPU, XLA
// fuses this elementwise integer code into its neighbours. Eager PyTorch
// cannot, and a plain int64 murmur hash is about ten full passes over
// the tensor, so the port gives it this kernel.
//
//   keep = low16(hash_u32(flat, seed)) < thresh      (hash_dropout.cuh)
//   out  = keep ? x * inv_keep : 0                   (in x's dtype)
//
// ``flat`` is the element's flat index in the MASK shape: x's shape with
// the ``axes`` dimensions set to 1 (the mask broadcasts along them), in
// uint32 arithmetic as the reference builds it. ``inv_keep`` is
// dtype(1 / (1 - p)), rounded to x's dtype by the wrapper (bf16 at p =
// 0.1: 1.109375), and the product rounds once to x's dtype, as
// `data * inv_keep` does in the reference (ops/nn.py:1129-1130). The
// backward of dropout is the same function of the output gradient, so
// the wrapper launches this kernel for it too: only the seed crosses
// from the forward to the backward.
//
// What bounds it on an H100: device-memory bytes. It reads and writes
// each element once (2 bytes each way in bf16) and does ~12 integer
// operations for the hash; at BERT-base's (32, 512, 768) bf16 that is
// 50 MB (0.015 ms at 3.35 TB/s) against ~0.15 G integer operations. So
// each thread moves 16 bytes per access (8 bf16 or 4 f32 elements) and
// hashes them in registers; the index math of a broadcast mask (axes)
// runs only on that path.
#include "common.cuh"
#include "hash_dropout.cuh"

namespace {

constexpr int kMaxDims = 8;
constexpr int kThreads = 256;

struct Params {
  const void* x;
  void* out;
  long long n;                 // elements of x
  int ndim;                    // 0: the mask is x itself (no axes)
  long long shape[kMaxDims];   // x's shape
  uint32_t mstride[kMaxDims];  // mask stride per dim, 0 along an axis
  mxk::Dropout drop;           // drop.scale = inv_keep in x's dtype
};

// The flat mask id of x's element ``i``.
__device__ __forceinline__ uint32_t mask_id(const Params& p, long long i) {
  if (p.ndim == 0) return static_cast<uint32_t>(i);
  uint32_t id = 0;
  for (int d = p.ndim - 1; d >= 0; --d) {
    const long long c = i % p.shape[d];
    i /= p.shape[d];
    id += static_cast<uint32_t>(c) * p.mstride[d];
  }
  return id;
}

__device__ __forceinline__ float apply(const Params& p, long long i, float x) {
  return mxk::mx_row_keep(mask_id(p, i), p.drop.seed, p.drop.thresh)
             ? x * p.drop.scale
             : 0.f;
}

// kVec consecutive elements per thread and grid-stride loop; vec = 16
// bytes per access (x, out 16-byte aligned and n % kVec == 0).
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) dropout_kernel(Params p) {
  const long long chunks = p.n / kVec;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < chunks; c += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v[kVec];
    mxk::load_f<T, kVec>(x + c * kVec, v);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = apply(p, c * kVec + e, v[e]);
    mxk::store_f<T, kVec>(out + c * kVec, v);
  }
}

template <typename T>
cudaError_t launch(const Params& p, bool vec, int n_ctas,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (vec)
    dropout_kernel<T, kVec><<<n_ctas, kThreads, 0, stream>>>(p);
  else
    dropout_kernel<T, 1><<<n_ctas, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x, out: n contiguous elements (out may be x). shape[ndim] is x's shape
// and mstride[ndim] the mask's stride per dim (0 along a broadcast axis);
// ndim = 0 means the mask has x's shape. scale: inv_keep, already
// rounded to x's dtype. vec != 0 requires 16-byte aligned x and out and
// n a multiple of 16 / sizeof(element). n_ctas: the grid (grid-stride
// loop). Returns cudaGetLastError() after the launch.
extern "C" int mx_hash_dropout(const void* x, void* out, long long n,
                               int ndim, const long long* shape,
                               const unsigned* mstride, unsigned seed,
                               unsigned thresh, float scale, int dtype,
                               int vec, int n_ctas, void* stream) {
  if (n < 1 || ndim < 0 || ndim > kMaxDims || n_ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.out = out;
  p.n = n;
  p.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    p.shape[d] = shape[d];
    p.mstride[d] = mstride[d];
  }
  p.drop.seed = seed;
  p.drop.thresh = thresh;
  p.drop.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxk::kBFloat16) return launch<__nv_bfloat16>(p, vec != 0,
                                                            n_ctas, s);
  if (dtype == mxk::kFloat32) return launch<float>(p, vec != 0, n_ctas, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
