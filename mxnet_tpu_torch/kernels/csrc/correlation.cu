// Correlation (FlowNet's cost volume) for Hopper (sm_90a): the forward
// and the backward of the Correlation op (ops/deformable.py), through
// kernels/correlation.py.
//
// Replaces no Pallas site: the reference's correlation
// (mxnet_tpu/ops/deformable.py:95-141) loops over the D x D displacements
// in Python, each a roll, a product (or |a - b|), a k x k window sum and
// a channel mean over the zero-padded maps, which XLA fuses. As PyTorch
// glue at FlowNetC's shape ((8, 256, 48, 64) pairs, pad 20, k 1,
// max_displacement 20, stride2 2: 441 displacements) that is over a
// thousand launches and some 200 GB of traffic a forward, and autograd
// would keep the 441 shifted maps. MXNet's own CUDA op is a hand-written
// kernel.
//
// The function: with p the padding (zeros, never materialised: a load
// outside the map reads 0), r = max_displacement / stride2, D = 2 r + 1,
// the output grid at padded rows border + i stride1 (border =
// max_displacement + k / 2) and columns likewise, and the window of
// output (y, x) over rows y - (k - 1) / 2 .. y + k / 2 (XLA's SAME
// window), out[b, iy D + ix, i, j] = (sum_c sum_window a[c, y', x'] *
// b[c, y' + dy, x' + dx]) / C / k^2 with (dy, dx) = stride2 (iy - r,
// ix - r), or |a - b| summed when is_multiply is 0. At the output grid
// the reference's roll never wraps (|d| <= max_displacement <= border),
// so no wrapped element is read. Arithmetic in f32; the output in the
// inputs' dtype (both f32 or both bf16: the wrapper casts).
//
// corr_fwd_kernel: a CTA takes one image, a tile of 8 x 32 output
// positions (a thread each) and a block of displacements: one dy and up
// to kDxBlock (24) dx, so FlowNetC's 21 fit one block. It stages the
// tile's window of data1 and data2's displaced window (the tile's rows
// shifted by dy, its columns widened by the block's dx span) through
// shared memory, a chunk of channels at a time, double-buffered: the
// next chunk's cp.async copies (zero-filled outside the map) fly while
// this one is summed. Each thread accumulates its kDxBlock sums in f32
// registers, then writes the (B, D^2, Ho, Wo) volume once. stride2 1
// and 2 are template arguments, so the dx offsets are immediates. A
// simple kernel: each data1 value read from shared memory serves the
// block's dx, each data2 value one product, and each dy's CTA stages
// its own copy of the tile.
//
// corr_bwd_kernel: ONE launch for both gradients (blockIdx.z picks
// which), each input element gathering its own sum, so no atomics: with
// G_d(y, x) the head gradient summed over the outputs whose window holds
// product position (y, x), d data1[c, y, x] = sum_d G_d(y, x) *
// data2[c, y + dy, x + dx] and d data2[c, y, x] = sum_d G_d(y - dy, x -
// dx) * data1[c, y - dy, x - dx] (for |a - b|: +-1 by the sign of a - b,
// +1 where a = b as JAX's abs gradient gives), both over C k^2. A thread
// takes one input position and kBwdChunk channels; G_d is formed once
// per displacement for all of them.
//
// What bounds it on an H100: the operations. At FlowNetC's shape the
// forward is 8 x 441 x 48 x 64 x 256 products and sums, 5.55 GFLOP of
// f32 (0.083 ms at 67 TFLOP/s) against 50.3 MB read and 43.4 MB written
// (0.028 ms); the backward twice the operations.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTy = 8, kTx = 32;          // output tile, a thread each
constexpr int kThreads = kTy * kTx;
constexpr int kDxBlock = 24;              // dx a forward CTA takes
constexpr int kBwdChunk = 16;             // channels a backward thread takes
constexpr int kSmemBudget = 64 * 1024;

struct Params {
  int batch, c, h, w, pad, k, klo, s1, s2, radius, d, border, ho, wo;
  int multiply;
  float inv_c, inv_kk;
};

// 4 bytes global -> shared without a register round trip; zero-filled
// (nothing read) where the element lies outside the map
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool inside) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(inside ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One row segment of a chunk into shared memory: f32 by cp.async (the
// caller commits), bf16 through registers (converted to f32).
template <typename T>
__device__ __forceinline__ void stage_row(float* dst, const T* plane, int y,
                                          int x0, int cols, int h, int w,
                                          int lane) {
  const bool row_in = y >= 0 && y < h;
  for (int col = lane; col < cols; col += kTx) {
    const int x = x0 + col;
    const bool in = row_in && x >= 0 && x < w;
    if constexpr (sizeof(T) == 4)
      cp_async4(dst + col, in ? plane + y * w + x : plane, in);
    else
      dst[col] = in ? mxk::to_f(plane[y * w + x]) : 0.f;
  }
}

// S2 > 0: stride2 at compile time (shared-memory offsets as immediates);
// 0: P.s2 at run time.
template <typename T, int S2>
__global__ void __launch_bounds__(kThreads)
    corr_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, Params P, int tiles_x, int chunk,
                    int a_rows, int a_cols, int b_cols) {
  extern __shared__ float smem[];
  const int img = blockIdx.z;
  const int tile_y = blockIdx.x / tiles_x, tile_x = blockIdx.x % tiles_x;
  const int n_blk = (P.d + kDxBlock - 1) / kDxBlock;
  const int iy = blockIdx.y / n_blk;
  const int jx0 = (blockIdx.y % n_blk) * kDxBlock;
  const int nj = min(kDxBlock, P.d - jx0);
  const int s2 = S2 > 0 ? S2 : P.s2;
  const int dy = s2 * (iy - P.radius);
  const int dx0 = s2 * (jx0 - P.radius);
  const int ty = threadIdx.x / kTx, tx = threadIdx.x % kTx;
  const int oi = tile_y * kTy + ty, oj = tile_x * kTx + tx;
  // padded coordinates of the tile's window origin, then unpadded
  const int y0 = P.border + tile_y * kTy * P.s1 - P.klo - P.pad;
  const int x0 = P.border + tile_x * kTx * P.s1 - P.klo - P.pad;
  const int a_size = chunk * a_rows * a_cols;
  const int buf_size = a_size + chunk * a_rows * b_cols;
  const long long plane = static_cast<long long>(P.h) * P.w;
  const T* a_img = a + static_cast<long long>(img) * P.c * plane;
  const T* b_img = b + static_cast<long long>(img) * P.c * plane;
  // chunk k into buffer k & 1: a warp a row, lanes along it
  auto stage = [&](int k) {
    float* sa = smem + (k & 1) * buf_size;
    float* sb = sa + a_size;
    const int c0 = k * chunk, nc = min(chunk, P.c - c0);
    for (int cc = 0; cc < nc; ++cc) {
      const T* pa = a_img + (c0 + cc) * plane;
      const T* pb = b_img + (c0 + cc) * plane;
      for (int row = ty; row < a_rows; row += kTy) {
        stage_row(sa + (cc * a_rows + row) * a_cols, pa, y0 + row, x0,
                  a_cols, P.h, P.w, tx);
        stage_row(sb + (cc * a_rows + row) * b_cols, pb, y0 + dy + row,
                  x0 + dx0, b_cols, P.h, P.w, tx);
      }
    }
    cp_async_commit();
  };
  float acc[kDxBlock];
#pragma unroll
  for (int j = 0; j < kDxBlock; ++j) acc[j] = 0.f;
  const bool live = oi < P.ho && oj < P.wo;
  const int n_chunks = (P.c + chunk - 1) / chunk;
  stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    // the next chunk's copies fly while this one is summed
    if (k + 1 < n_chunks) {
      stage(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      const float* sa = smem + (k & 1) * buf_size;
      const float* sb = sa + a_size;
      const int nc = min(chunk, P.c - k * chunk);
      for (int cc = 0; cc < nc; ++cc) {
        const float* ra = sa + cc * a_rows * a_cols;
        const float* rb = sb + cc * a_rows * b_cols;
        for (int u = 0; u < P.k; ++u) {
          for (int v = 0; v < P.k; ++v) {
            const int row = ty * P.s1 + u, col = tx * P.s1 + v;
            const float av = ra[row * a_cols + col];
            const float* bp = rb + row * b_cols + col;
            // all kDxBlock sums (the window is staged that wide); only
            // the first nj are stored
            if (P.multiply) {
#pragma unroll
              for (int j = 0; j < kDxBlock; ++j)
                acc[j] = fmaf(av, bp[s2 * j], acc[j]);
            } else {
#pragma unroll
              for (int j = 0; j < kDxBlock; ++j)
                acc[j] += fabsf(av - bp[s2 * j]);
            }
          }
        }
      }
    }
    __syncthreads();      // buffer k & 1 is refilled at k + 2
  }
  if (!live) return;
  const long long dd = static_cast<long long>(P.d) * P.d;
  T* o = out + ((img * dd + iy * P.d + jx0) * P.ho + oi) * P.wo + oj;
  const long long step = static_cast<long long>(P.ho) * P.wo;
#pragma unroll
  for (int j = 0; j < kDxBlock; ++j)
    if (j < nj) o[j * step] = mxk::from_f<T>(acc[j] * P.inv_c * P.inv_kk);
}

// the head gradient summed over the outputs whose window holds product
// position (py, px) (padded coordinates) for displacement index dd
__device__ __forceinline__ float window_grad(const float* __restrict__ g,
                                             const Params& P, int py, int px) {
  if (P.k == 1 && P.s1 == 1) {      // FlowNetC's: one output, no division
    const int i = py - P.border, j = px - P.border;
    return (i >= 0 && i < P.ho && j >= 0 && j < P.wo) ? g[i * P.wo + j]
                                                      : 0.f;
  }
  float s = 0.f;
  for (int u = 0; u < P.k; ++u) {
    const int ry = py + P.klo - u - P.border;
    if (ry < 0 || ry % P.s1 != 0) continue;
    const int i = ry / P.s1;
    if (i >= P.ho) continue;
    for (int v = 0; v < P.k; ++v) {
      const int rx = px + P.klo - v - P.border;
      if (rx < 0 || rx % P.s1 != 0) continue;
      const int j = rx / P.s1;
      if (j >= P.wo) continue;
      s += g[i * P.wo + j];
    }
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    corr_bwd_kernel(const float* __restrict__ grad, const T* __restrict__ a,
                    const T* __restrict__ b, T* __restrict__ da,
                    T* __restrict__ db, Params P, int tiles_x) {
  const int img = blockIdx.z >> 1;
  const bool first = (blockIdx.z & 1) == 0;      // d data1, else d data2
  const int tile_y = blockIdx.x / tiles_x, tile_x = blockIdx.x % tiles_x;
  const int y = tile_y * kTy + threadIdx.x / kTx;
  const int x = tile_x * kTx + threadIdx.x % kTx;
  if (y >= P.h || x >= P.w) return;
  const int c0 = blockIdx.y * kBwdChunk;
  const int nc = min(kBwdChunk, P.c - c0);
  const long long plane = static_cast<long long>(P.h) * P.w;
  const long long base = (static_cast<long long>(img) * P.c + c0) * plane;
  const T* self = (first ? a : b) + base;
  const T* other = (first ? b : a) + base;
  float mine[kBwdChunk], acc[kBwdChunk];
#pragma unroll
  for (int cc = 0; cc < kBwdChunk; ++cc) {
    acc[cc] = 0.f;
    mine[cc] = (!P.multiply && cc < nc)
                   ? mxk::to_f(self[cc * plane + y * P.w + x])
                   : 0.f;
  }
  const long long dd = static_cast<long long>(P.d) * P.d;
  const float* gi = grad + img * dd * P.ho * P.wo;
  for (int iy = 0; iy < P.d; ++iy) {
    const int dy = P.s2 * (iy - P.radius);
    // no branch on G: its load and the other map's fly together
#pragma unroll 2
    for (int ix = 0; ix < P.d; ++ix) {
      const int dx = P.s2 * (ix - P.radius);
      // product position (padded) and the partner element (unpadded)
      const int py = first ? y + P.pad : y + P.pad - dy;
      const int px = first ? x + P.pad : x + P.pad - dx;
      const float G = window_grad(
          gi + static_cast<long long>(iy * P.d + ix) * P.ho * P.wo, P, py,
          px);
      const int qy = first ? y + dy : y - dy, qx = first ? x + dx : x - dx;
      const bool in = qy >= 0 && qy < P.h && qx >= 0 && qx < P.w;
      const long long q = static_cast<long long>(qy) * P.w + qx;
#pragma unroll
      for (int cc = 0; cc < kBwdChunk; ++cc) {
        if (cc >= nc) break;
        const float o = in ? mxk::to_f(other[cc * plane + q]) : 0.f;
        if (P.multiply) {
          acc[cc] = fmaf(G, o, acc[cc]);
        } else {
          // JAX's abs: d|a - b|/da = +1 where a - b >= 0 (0 included),
          // else -1; d/db is its negation
          const float ab = first ? mine[cc] - o : o - mine[cc];
          const float sg = ab >= 0.f ? G : -G;
          acc[cc] += first ? sg : -sg;
        }
      }
    }
  }
  T* dst = (first ? da : db) + base + static_cast<long long>(y) * P.w + x;
#pragma unroll
  for (int cc = 0; cc < kBwdChunk; ++cc)
    if (cc < nc) dst[cc * plane] = mxk::from_f<T>(acc[cc] * P.inv_kk * P.inv_c);
}

bool make_params(Params& P, int batch, int c, int h, int w, int pad, int k,
                 int max_disp, int s1, int s2, int multiply) {
  if (batch < 1 || c < 1 || h < 1 || w < 1 || pad < 0 || k < 1 ||
      max_disp < 0 || s1 < 1 || s2 < 1 || batch > 32767)
    return false;
  P.batch = batch;
  P.c = c;
  P.h = h;
  P.w = w;
  P.pad = pad;
  P.k = k;
  P.klo = (k - 1) / 2;
  P.s1 = s1;
  P.s2 = s2;
  P.radius = max_disp / s2;
  P.d = 2 * P.radius + 1;
  P.border = max_disp + k / 2;
  const int span_h = h + 2 * pad - 2 * P.border;
  const int span_w = w + 2 * pad - 2 * P.border;
  P.ho = span_h > 0 ? (span_h + s1 - 1) / s1 : 0;
  P.wo = span_w > 0 ? (span_w + s1 - 1) / s1 : 0;
  P.multiply = multiply;
  P.inv_c = 1.f / static_cast<float>(c);
  P.inv_kk = 1.f / static_cast<float>(k * k);
  return true;
}

template <typename T>
int launch_fwd(const void* a, const void* b, void* out, const Params& P,
               cudaStream_t s) {
  const int tiles_x = (P.wo + kTx - 1) / kTx;
  const int tiles_y = (P.ho + kTy - 1) / kTy;
  const int a_rows = (kTy - 1) * P.s1 + P.k;
  const int a_cols = (kTx - 1) * P.s1 + P.k;
  const int b_cols = a_cols + P.s2 * (kDxBlock - 1);
  // two buffers of `chunk` channels each
  const int per_channel = (a_rows * a_cols + a_rows * b_cols) * 4;
  int chunk = kSmemBudget / (2 * per_channel);
  chunk = chunk < 1 ? 1 : (chunk > P.c ? P.c : (chunk > 32 ? 32 : chunk));
  const size_t smem = 2 * static_cast<size_t>(chunk) * per_channel;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = P.s2 == 1 ? corr_fwd_kernel<T, 1>
                : (P.s2 == 2 ? corr_fwd_kernel<T, 2> : corr_fwd_kernel<T, 0>);
  cudaError_t err = mxk::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blk = (P.d + kDxBlock - 1) / kDxBlock;
  const long long gy = static_cast<long long>(P.d) * n_blk;
  if (gy > 65535 || static_cast<long long>(tiles_x) * tiles_y > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles_x * tiles_y, static_cast<unsigned>(gy), P.batch);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      P, tiles_x, chunk, a_rows, a_cols, b_cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const float* grad, const void* a, const void* b, void* da,
               void* db, const Params& P, cudaStream_t s) {
  const int tiles_x = (P.w + kTx - 1) / kTx;
  const int tiles_y = (P.h + kTy - 1) / kTy;
  const int chunks = (P.c + kBwdChunk - 1) / kBwdChunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(tiles_x * tiles_y, chunks, 2 * P.batch);
  corr_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      grad, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(da), static_cast<T*>(db), P, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (batch, D^2, ho, wo) from data1, data2 (batch, c, h, w), all of
// dtype; the wrapper computes ho, wo and D as make_params does.
extern "C" int mx_correlation_fwd(const void* a, const void* b, void* out,
                                  int dtype, int batch, int c, int h, int w,
                                  int pad, int k, int max_disp, int s1, int s2,
                                  int multiply, void* stream) {
  Params P;
  if (!make_params(P, batch, c, h, w, pad, k, max_disp, s1, s2, multiply))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P.ho == 0 || P.wo == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxk::kFloat32) return launch_fwd<float>(a, b, out, P, s);
  if (dtype == mxk::kBFloat16)
    return launch_fwd<__nv_bfloat16>(a, b, out, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// d data1 and d data2 (batch, c, h, w) of dtype from the f32 head
// gradient (batch, D^2, ho, wo); every element is written.
extern "C" int mx_correlation_bwd(const float* grad, const void* a,
                                  const void* b, void* da, void* db, int dtype,
                                  int batch, int c, int h, int w, int pad,
                                  int k, int max_disp, int s1, int s2,
                                  int multiply, void* stream) {
  Params P;
  if (!make_params(P, batch, c, h, w, pad, k, max_disp, s1, s2, multiply))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mxk::kFloat32)
    return launch_bwd<float>(grad, a, b, da, db, P, s);
  if (dtype == mxk::kBFloat16)
    return launch_bwd<__nv_bfloat16>(grad, a, b, da, db, P, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
