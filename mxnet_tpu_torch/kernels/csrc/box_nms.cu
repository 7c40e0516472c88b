// Greedy non-maximum suppression for Hopper (sm_90a): the kernels of
// the box_nms op (ops/spatial.py) and of MultiBoxDetection, which ends in
// it.
//
// Replaces no Pallas site: the reference's box_nms
// (mxnet_tpu/ops/spatial.py:80) is a lax.scan over the score-sorted rows
// (:113-121) that XLA compiles. Written as PyTorch glue on the card, that
// scan is one dependent group of launches per row. The wrapper
// (kernels/box_nms.py) does the glue that stays: the stable sort by
// score, the gather of the sorted rows and the truncation to the first
// min(n, topk) rows (exact: a row past topk is never valid, so it is
// never kept and suppresses nothing). Then two launches:
//
//   1. nms_mask_kernel: for each pair (i, j > i) of sorted rows, whether
//      row i suppresses row j: iou > overlap_thresh and the same class
//      (or no class test: force_suppress or id_index < 0). 64 columns
//      per 64-bit word; one CTA per (row tile, column tile, image) on
//      and above the diagonal.
//   2. nms_sweep_kernel: one CTA per image. Warp 0 walks the rows in
//      order with the removed bits in shared memory: a row is kept if
//      it is valid (score > valid_thresh) and no kept row before it
//      removed it; a kept row ORs its mask row into the removed bits.
//      Then every thread writes the output rows: a kept row as it is
//      (its box converted to out_format when that differs), every other
//      row -1, and -1 for rows m..n_out-1.
//
// The IoU follows _corner_iou (mxnet_tpu/ops/spatial.py:41) operation by
// operation, each written as an _rn intrinsic so that nvcc contracts
// nothing into an FMA (a fused area_a + area_b - inter moves decisions at
// the threshold): the plain version (kernels/box_nms.py) and the kernel
// decide alike bit for bit. max/min propagate NaN as XLA's do; clip(v, 0)
// gives +0 for v <= 0 and NaN for NaN.
//
// What bounds it on an H100: at SSD's shapes (32 images, 7,620 rows of
// 6 floats, topk 400) the bytes, 0.31 MB of sorted rows read and 5.85 MB
// of output written; the 32 x 79,800 IoUs are about 45M operations.
// What it takes in practice is the sweep's chain of 400 dependent steps
// per image; the design keeps each step in one warp (no CTA barrier) and
// the image's mask rows and sorted rows in shared memory where they fit,
// so that neither the sweep nor the output pass waits on device memory.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;            // rows and columns per mask tile
constexpr int kSweepThreads = 256;
constexpr size_t kStageSmemCap = 160 * 1024;

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// jnp.clip(v, 0): +0 at or below 0, NaN for NaN.
__device__ __forceinline__ float clip0(float v) {
  return v != v ? v : (v > 0.f ? v : 0.f);
}

// _to_corner: a center box (x, y, w, h) as corners.
__device__ __forceinline__ Box load_corner(const float* row, bool center) {
  const float a = row[0], b = row[1], c = row[2], d = row[3];
  if (!center) return {a, b, c, d};
  const float hw = __fdiv_rn(c, 2.f), hh = __fdiv_rn(d, 2.f);
  return {__fsub_rn(a, hw), __fsub_rn(b, hh), __fadd_rn(a, hw),
          __fadd_rn(b, hh)};
}

__device__ __forceinline__ float area(const Box& a) {
  return __fmul_rn(clip0(__fsub_rn(a.x2, a.x1)),
                   clip0(__fsub_rn(a.y2, a.y1)));
}

// _corner_iou of two boxes, in its order of operations.
__device__ __forceinline__ float corner_iou(const Box& a, float area_a,
                                            const Box& b) {
  const float ix1 = max_nan(a.x1, b.x1), iy1 = max_nan(a.y1, b.y1);
  const float ix2 = min_nan(a.x2, b.x2), iy2 = min_nan(a.y2, b.y2);
  const float inter = __fmul_rn(clip0(__fsub_rn(ix2, ix1)),
                                clip0(__fsub_rn(iy2, iy1)));
  const float uni = __fsub_rn(__fadd_rn(area_a, area(b)), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kTile)
    nms_mask_kernel(const float* __restrict__ rows, int m, int k, int cs,
                    int id_index, int center, float thresh,
                    unsigned long long* __restrict__ mask, int words) {
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  if (ct < rt) return;                 // below the diagonal: never read
  __shared__ Box cols[kTile];
  __shared__ float col_id[kTile];
  const float* base = rows + static_cast<size_t>(b) * m * k;
  const int t = threadIdx.x, j0 = ct * kTile;
  if (j0 + t < m) {
    const float* r = base + static_cast<size_t>(j0 + t) * k;
    cols[t] = load_corner(r + cs, center != 0);
    col_id[t] = id_index >= 0 ? r[id_index] : 0.f;
  }
  __syncthreads();
  const int i = rt * kTile + t;
  if (i >= m) return;
  const float* r = base + static_cast<size_t>(i) * k;
  const Box a = load_corner(r + cs, center != 0);
  const float area_a = area(a);
  const float id = id_index >= 0 ? r[id_index] : 0.f;
  const int n_cols = min(kTile, m - j0);
  unsigned long long bits = 0ull;
  for (int c = 0; c < n_cols; ++c) {
    if (j0 + c <= i) continue;
    if (id_index >= 0 && !(col_id[c] == id)) continue;
    if (corner_iou(a, area_a, cols[c]) > thresh) bits |= 1ull << c;
  }
  mask[(static_cast<size_t>(b) * m + i) * words + ct] = bits;
}

__global__ void __launch_bounds__(kSweepThreads)
    nms_sweep_kernel(const float* __restrict__ rows,
                     const unsigned long long* __restrict__ mask,
                     float* __restrict__ out, int m, int n_out, int k,
                     int cs, int score_index, int in_center,
                     int out_center, float valid_thresh, int words,
                     int staged) {
  // shared memory: removed, valid and kept bits (words each), then, when
  // `staged`, the image's mask rows (m * words) and its sorted rows
  // (m * k floats), so that the serial sweep and the output pass read
  // nothing from device memory
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;
  unsigned long long* valid = smem + words;
  unsigned long long* kept = smem + 2 * words;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* gbase = rows + static_cast<size_t>(b) * m * k;
  const unsigned long long* mb =
      mask + static_cast<size_t>(b) * m * words;
  const size_t n_mask = static_cast<size_t>(m) * words;
  unsigned long long* rows_mask = smem + 3 * words;
  float* srows = reinterpret_cast<float*>(rows_mask + n_mask);
  const float* base = staged ? srows : gbase;
  const unsigned long long* src = staged ? rows_mask : mb;
  if (staged) {
    // only the words on and above each row's diagonal word are read
    for (size_t e = tid; e < n_mask; e += blockDim.x)
      if (static_cast<int>(e % words) >= static_cast<int>(e / words) / 64)
        rows_mask[e] = mb[e];
    for (int e = tid; e < m * k; e += blockDim.x) srows[e] = gbase[e];
    __syncthreads();
  }
  // the valid bits, a warp's ballot over 32 rows at a time
  for (int i0 = (tid & ~31); i0 < m; i0 += blockDim.x) {
    const int i = i0 + (tid & 31);
    const bool v = i < m && base[static_cast<size_t>(i) * k + score_index] >
                                valid_thresh;
    const unsigned bits = __ballot_sync(0xffffffffu, v);
    if ((tid & 31) == 0) {
      // two ballots make a word; the lower half-word comes first
      unsigned* half = reinterpret_cast<unsigned*>(valid);
      half[i0 >> 5] = bits;
    }
  }
  for (int w = tid; w < words; w += blockDim.x) {
    removed[w] = 0ull;
    kept[w] = 0ull;
  }
  __syncthreads();
  if (tid < 32) {
    unsigned long long kept_word = 0ull;
    for (int i = 0; i < m; ++i) {
      const int w = i >> 6;
      const unsigned long long bit = 1ull << (i & 63);
      // every lane reads the same words, so the decision is uniform. A
      // kept row's own mask row has no bit at or before i, so the ORs
      // below never change the bit read here
      const bool keep = (valid[w] & bit) && !(removed[w] & bit);
      if (keep) {
        kept_word |= bit;
        const unsigned long long* mrow = src + static_cast<size_t>(i) * words;
        for (int v = w + tid; v < words; v += 32) removed[v] |= mrow[v];
      }
      if ((i & 63) == 63 || i == m - 1) {
        if (tid == 0) kept[w] = kept_word;
        kept_word = 0ull;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float* ob = out + static_cast<size_t>(b) * n_out * k;
  for (int e = tid; e < m * k; e += blockDim.x) {
    const int i = e / k, c = e - i * k;
    float v = -1.f;
    if ((kept[i >> 6] >> (i & 63)) & 1ull) {
      const float* r = base + static_cast<size_t>(i) * k;
      v = r[c];
      if (in_center != out_center && c >= cs && c < cs + 4) {
        const int q = c - cs;
        if (out_center) {
          // corner -> center: ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
          // y2 - y1)
          const float lo = r[cs + (q & 1)], hi = r[cs + 2 + (q & 1)];
          v = q < 2 ? __fdiv_rn(__fadd_rn(lo, hi), 2.f) : __fsub_rn(hi, lo);
        } else {
          // center -> corner: x -+ w / 2, y -+ h / 2
          const float ctr = r[cs + (q & 1)];
          const float half = __fdiv_rn(r[cs + 2 + (q & 1)], 2.f);
          v = q < 2 ? __fsub_rn(ctr, half) : __fadd_rn(ctr, half);
        }
      }
    }
    ob[e] = v;
  }
  // rows m..n_out-1 are -1: 16-byte stores where the tail is aligned
  float* tail = ob + static_cast<size_t>(m) * k;
  const size_t n_tail = static_cast<size_t>(n_out - m) * k;
  size_t head = 0;
  if (reinterpret_cast<uintptr_t>(tail) % 16 == 0) {
    const float4 neg = make_float4(-1.f, -1.f, -1.f, -1.f);
    for (size_t q = tid; q < n_tail / 4; q += blockDim.x)
      reinterpret_cast<float4*>(tail)[q] = neg;
    head = n_tail / 4 * 4;
  }
  for (size_t e = head + tid; e < n_tail; e += blockDim.x) tail[e] = -1.f;
}

}  // namespace

// rows: (batch, m, k) contiguous f32, each image's rows sorted by score
// (descending, stable) and cut to its first m; mask: batch * m * words
// 64-bit words of scratch, words = ceil(m / 64); out: (batch, n_out, k)
// contiguous f32, n_out >= m. cs: the first of the four box columns;
// id_index < 0: every pair is of one class. in_center / out_center: the
// box formats (0 corner, 1 center). Two launches on `stream`; returns
// cudaGetLastError() after them.
extern "C" int mx_box_nms(const float* rows, void* mask, float* out,
                          int batch, int m, int n_out, int k, int cs,
                          int score_index, int id_index, int in_center,
                          int out_center, float overlap_thresh,
                          float valid_thresh, void* stream) {
  if (batch < 1 || m < 1 || n_out < m || k < 4 || cs < 0 || cs + 4 > k ||
      score_index < 0 || score_index >= k || id_index >= k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (m + 63) / 64;
  const size_t stage_bytes = static_cast<size_t>(m) * words * 8 +
                             static_cast<size_t>(m) * k * 4;
  const int staged = stage_bytes <= kStageSmemCap;
  const size_t smem = 3 * static_cast<size_t>(words) * 8 +
                      (staged ? stage_bytes : 0);
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mxk::allow_smem(nms_sweep_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(words, words, batch);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(
      rows, m, k, cs, id_index, in_center, overlap_thresh,
      static_cast<unsigned long long*>(mask), words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<batch, kSweepThreads, smem, s>>>(
      rows, static_cast<const unsigned long long*>(mask), out, m, n_out, k,
      cs, score_index, in_center, out_center, valid_thresh, words, staged);
  return static_cast<int>(cudaGetLastError());
}
