// Paged single-query (decode) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/pallas_kernels/paged_attention.py
// `paged_attention_kernel` / `_decode_kernel`.
//
// On the TPU the grid (batch, pages) runs in order on one core, the
// scalar-prefetched page table steers each step's DMA at one arena page,
// and the online-softmax accumulator lives in VMEM scratch across the
// page axis. Hopper runs CTAs in parallel with no order, so the
// sequential page axis becomes a loop inside the CTA: one CTA per
// (batch row, kv head) walks THAT ROW's own ceil(len / page_size) pages
// (never the table's full width), reading each page id from the table
// itself.
//
// What bounds it on an H100: device-memory bytes. Each step reads
// 2 * sum(len) * KV * D elements of K/V and does ~4 flops per element
// per grouped q head (4 * G flops per element, G = H / KV = 4 at
// Llama-3-8B): far below the 295 flop/byte ridge. The design reads every
// cached K/V row exactly once, as contiguous 8-byte (bf16) or 16-byte
// (f32) per-lane vectors (a 256-byte K row per warp at D = 128, bf16),
// and scores all G q heads of the group against it, so grouped-query
// attention never repeats K or V. Each of the 8 warps keeps its own
// online-softmax state (m, l, acc) over an interleaved quarter of the
// tokens, 4 tokens in flight per warp for memory-level parallelism; the
// 8 partial states merge through shared memory at the end. Scores,
// statistics and the P.V accumulation are f32; the output is rounded to
// q's dtype once.
//
// Known limit (recorded in PERF.md): B * KV CTAs is 64 at batch 8, fewer
// than the 132 SMs. Splitting the page loop across CTAs (flash-decoding)
// is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;  // tokens in flight per warp

template <typename T, int G, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int h, int kv, int n_pages, int page_size,
                        float scale) {
  constexpr int D = EPL * 32;
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][D];

  const int row = blockIdx.x / kv;
  const int kvh = blockIdx.x % kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int n = lengths[row];
  const int cap = n_pages * page_size;
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const int* pt = page_table + static_cast<size_t>(row) * n_pages;

  // this lane's EPL-wide slice of the G grouped query heads, pre-scaled
  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const size_t off =
        (static_cast<size_t>(row) * h + kvh * G + g) * D + lane * EPL;
    mxk::load_f<T, EPL>(q + off, qr[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] *= scale;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
    float kf[kUnroll][EPL], vf[kUnroll][EPL];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      valid[u] = t < n;
      if (valid[u]) {
        const size_t slot = static_cast<size_t>(pt[t / page_size]) *
                                page_size + t % page_size;
        const size_t off = (slot * kv + kvh) * D + lane * EPL;
        mxk::load_f<T, EPL>(k + off, kf[u]);
        mxk::load_f<T, EPL>(v + off, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kUnroll];
      float s_max = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[g][e] * kf[u][e];
        s[u] = valid[u] ? mxk::warp_sum(part) : -CUDART_INF_F;
        s_max = fmaxf(s_max, s[u]);
      }
      // t0 < n, so token u = 0 is valid and m_new is finite;
      // expf(-inf) = 0 rescales the empty initial state away
      const float m_new = fmaxf(m[g], s_max);
      const float alpha = expf(m[g] - m_new);
      float p_sum = 0.f;
      float p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = valid[u] ? expf(s[u] - m_new) : 0.f;
        p_sum += p[u];
      }
      l[g] = l[g] * alpha + p_sum;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a += p[u] * vf[u][e];
        acc[g][e] = a;
      }
    }
  }

  // merge the per-warp online-softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int dd = i % D;
    float m_all = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w][g]);
    float l_all = 0.f, o = 0.f;
    if (m_all != -CUDART_INF_F) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(s_m[w][g] - m_all);  // idle warp: 0
        l_all += s_l[w][g] * c;
        o += s_acc[w][g][dd] * c;
      }
    }
    // an empty row (length 0) emits 0, like _decode_kernel's l == 0 pin
    const float r = l_all > 0.f ? o / l_all : 0.f;
    out[(static_cast<size_t>(row) * h + kvh * G + g) * D + dd] =
        mxk::from_f<T>(r);
  }
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v,
                     const int* pt, const int* len, void* out, int b, int h,
                     int kv, int d, int n_pages, int page_size, float scale,
                     cudaStream_t stream) {
  const dim3 grid(b * kv);
  const dim3 block(kWarps * 32);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (d == 128)
    paged_decode_kernel<T, G, 4><<<grid, block, 0, stream>>>(
        qp, kp, vp, pt, len, op, h, kv, n_pages, page_size, scale);
  else if (d == 64)
    paged_decode_kernel<T, G, 2><<<grid, block, 0, stream>>>(
        qp, kp, vp, pt, len, op, h, kv, n_pages, page_size, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pt, const int* len, void* out, int b, int h,
                   int kv, int d, int n_pages, int page_size, float scale,
                   cudaStream_t s) {
  switch (h / kv) {
    case 1:
      return launch_g<T, 1>(q, k, v, pt, len, out, b, h, kv, d, n_pages,
                            page_size, scale, s);
    case 2:
      return launch_g<T, 2>(q, k, v, pt, len, out, b, h, kv, d, n_pages,
                            page_size, scale, s);
    case 4:
      return launch_g<T, 4>(q, k, v, pt, len, out, b, h, kv, d, n_pages,
                            page_size, scale, s);
    case 8:
      return launch_g<T, 8>(q, k, v, pt, len, out, b, h, kv, d, n_pages,
                            page_size, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, H, D); k_arena/v_arena: (slots, KV, D) for one layer;
// page_table: (B, n_pages) int32 (page 0 is scratch); lengths: (B,) int32;
// out: (B, H, D) in q's dtype. H / KV must be 1, 2, 4 or 8 and D 64 or 128.
// Returns cudaGetLastError() after the launch.
extern "C" int mx_paged_attention_decode(
    const void* q, const void* k_arena, const void* v_arena,
    const int* page_table, const int* lengths, void* out, int b, int h,
    int kv, int d, int n_pages, int page_size, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxk::kFloat32)
    return launch<float>(q, k_arena, v_arena, page_table, lengths, out, b, h,
                         kv, d, n_pages, page_size, scale, s);
  if (dtype == mxk::kBFloat16)
    return launch<__nv_bfloat16>(q, k_arena, v_arena, page_table, lengths,
                                 out, b, h, kv, d, n_pages, page_size, scale,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
