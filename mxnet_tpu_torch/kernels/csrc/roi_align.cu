// ROIAlign for Hopper (sm_90a): the forward and the backward of the
// _contrib_ROIAlign op (ops/contrib.py), through kernels/roi_align.py.
//
// Replaces no Pallas site: the reference's roi_align
// (mxnet_tpu/ops/contrib.py:95-146) is a vmap over RoIs of four clipped
// gathers that XLA fuses, and its gradient is XLA's scatter-add. Written
// as PyTorch glue, one RoI head's call gathers an (R, C, ph, pw, sr, sr)
// temporary per corner (3.3 GB over the four at Faster R-CNN's 256 RoIs
// of a (2, 1024, 38, 63) map, 14 x 14 bins, sr 2), and autograd scatters
// it back. MXNet's own CUDA op is a hand-written gather kernel.
//
// The function (the reference's, step by step, in f32): RoI r = [b, x1,
// y1, x2, y2] reads image trunc(b) (negative wraps once, as a dynamic
// index does, then clamps into [0, n)); its corners are scaled by
// spatial_scale and shifted by -0.5 when aligned; its size is at least
// 1 (1e-6 when aligned); bin (py, px) averages sr x sr samples at
// y1 + (py + (iy + 0.5) / sr) * bin_h (the fraction formed in double and
// rounded to f32, as the reference's weak-typed x64 constant is), each
// the bilinear blend of its four corners, the corners clipped into the
// map BEFORE the weights are taken (wy = clip(y - clip(floor(y)), 0, 1)):
// a sample above the map reads the edge row with weight 0 and is not
// zeroed. sample_ratio <= 0 means 2 (the reference's rule, not MXNet's
// adaptive count). A bf16 map gives an f32 output (the reference's f32
// weights promote it). Products and sums are _rn intrinsics in the
// reference's order, so nvcc contracts nothing into an FMA.
//
// Layout of the work, both kernels: a CTA takes one RoI and a chunk of
// kChunk channels; a thread takes one bin (py, px), bins along the
// threads, so that a warp reads neighbouring pixels of ONE channel plane
// and writes 32 neighbouring outputs. The RoI's geometry and the bin's
// sample positions, corners and weights are the same for every channel:
// a thread forms them once, in registers (the sample ratio a template
// argument: 1-4; a runtime one above, recomputed per channel), and then
// walks its chunk of channels doing only the loads, the blend and the
// store. No integer division per element.
//
// roi_align_bwd_kernel: d data: the four corner weights of a sample are
// separable (row weight times column weight), so a thread merges its sr
// samples' rows and columns into at most 2 sr distinct rows and columns
// once per bin (clipped corners that coincide merge, which is the
// reference's scatter adding twice), then, channel by channel, adds g /
// sr^2 * row weight * column weight into each (row, column) pixel of a
// zeroed f32 buffer with atomicAdd: 4 to 9 atomics a bin at sr 2 instead
// of 16. Summation order differs from run to run, so the result is held
// to a tolerance, not bit for bit. d rois (only when rois.requires_grad,
// in the same launch): d value / d y of each sample (the clip's gradient,
// half at a bound, times the blend's difference), chained through y = y1
// + t * max(y2 - y1, min) / ph (the max's gradient halves at a tie, as
// JAX's does) into columns 1-4 of the RoI; column 0 (the batch index)
// gets none. The CTA, one RoI, sums its threads' partial gradients and
// adds them once.
//
// What bounds it on an H100: the bytes. Forward at the shape above:
// 205.5 MB of f32 output written plus 19.6 MB of map read, 0.067 ms at
// 3.35 TB/s. Backward: the head gradient read (205.5 MB) and the map's
// gradient written once (19.6 MB); its atomics (about 6 a bin) resolve in
// L2, which is where the design spends its time.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreadCap = 256;    // threads a CTA at most (bins beyond: a loop)
constexpr int kChunk = 16;         // channels a CTA takes

struct Geometry {
  int b;                           // image
  float y1, x1, bin_h, bin_w;
  float mh, mw;                    // d size / d (corner difference)
};

__device__ __forceinline__ Geometry roi_geometry(const float* __restrict__ roi,
                                                 int n, int ph, int pw,
                                                 float scale, float off,
                                                 float min_size) {
  Geometry g;
  int b = static_cast<int>(roi[0]);          // truncation, as astype(int32)
  if (b < 0) b += n;
  g.b = b < 0 ? 0 : (b >= n ? n - 1 : b);
  const float x1 = __fsub_rn(__fmul_rn(roi[1], scale), off);
  const float y1 = __fsub_rn(__fmul_rn(roi[2], scale), off);
  const float x2 = __fsub_rn(__fmul_rn(roi[3], scale), off);
  const float y2 = __fsub_rn(__fmul_rn(roi[4], scale), off);
  const float dw = __fsub_rn(x2, x1), dh = __fsub_rn(y2, y1);
  g.x1 = x1;
  g.y1 = y1;
  g.bin_w = __fdiv_rn(fmaxf(dw, min_size), static_cast<float>(pw));
  g.bin_h = __fdiv_rn(fmaxf(dh, min_size), static_cast<float>(ph));
  g.mw = dw > min_size ? 1.f : (dw == min_size ? 0.5f : 0.f);
  g.mh = dh > min_size ? 1.f : (dh == min_size ? 0.5f : 0.f);
  return g;
}

// p + (i + 0.5) / sr, formed in double and rounded once to f32
__device__ __forceinline__ float sample_t(int p, int i, int sr) {
  return static_cast<float>(static_cast<double>(p) +
                            (static_cast<double>(i) + 0.5) /
                                static_cast<double>(sr));
}

// One axis of a sample: its low and high corner (clipped into [0, size))
// and the high corner's weight, clip(v - lo, 0, 1), with that clip's
// gradient (1 inside, 1/2 on a bound, 0 outside) and the sample's t.
struct Axis {
  int lo, hi;
  float w, dw, t;
};

__device__ __forceinline__ Axis axis_of(float start, float bin, int p, int i,
                                        int sr, int size) {
  Axis a;
  a.t = sample_t(p, i, sr);
  const float v = __fadd_rn(start, __fmul_rn(a.t, bin));
  const float top = static_cast<float>(size - 1);
  const float f = fminf(fmaxf(floorf(v), 0.f), top);
  const float h = fminf(fmaxf(__fadd_rn(f, 1.f), 0.f), top);
  const float d = __fsub_rn(v, f);
  a.w = fminf(fmaxf(d, 0.f), 1.f);
  a.dw = (d > 0.f && d < 1.f) ? 1.f : ((d == 0.f || d == 1.f) ? 0.5f : 0.f);
  a.lo = static_cast<int>(f);
  a.hi = static_cast<int>(h);
  return a;
}

template <typename T>
__device__ __forceinline__ float blend(const T* __restrict__ img, int w,
                                       const Axis& ay, const Axis& ax) {
  const float wy0 = __fsub_rn(1.f, ay.w), wx0 = __fsub_rn(1.f, ax.w);
  const float v00 = mxk::to_f(img[ay.lo * w + ax.lo]);
  const float v01 = mxk::to_f(img[ay.lo * w + ax.hi]);
  const float v10 = mxk::to_f(img[ay.hi * w + ax.lo]);
  const float v11 = mxk::to_f(img[ay.hi * w + ax.hi]);
  float v = __fmul_rn(__fmul_rn(v00, wy0), wx0);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, wy0), ax.w));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, ay.w), wx0));
  return __fadd_rn(v, __fmul_rn(__fmul_rn(v11, ay.w), ax.w));
}

struct Shape {
  int n, c, h, w, ph, pw, sr, chunks;
  float scale, off, min_size;
};

// SR > 0: the sample ratio at compile time, the bin's axes in registers;
// SR == 0: s.sr at run time, the axes formed sample by sample.
template <typename T, int SR>
__global__ void __launch_bounds__(kThreadCap)
    roi_align_fwd_kernel(const T* __restrict__ data,
                         const float* __restrict__ rois,
                         float* __restrict__ out, Shape s) {
  const int r = blockIdx.x / s.chunks;
  const int c0 = (blockIdx.x - r * s.chunks) * kChunk;
  const int nc = min(kChunk, s.c - c0);
  const int sr = SR > 0 ? SR : s.sr;
  const float count = static_cast<float>(sr * sr);
  const Geometry g = roi_geometry(rois + r * 5, s.n, s.ph, s.pw, s.scale,
                                  s.off, s.min_size);
  const int bins = s.ph * s.pw;
  const long long hw = static_cast<long long>(s.h) * s.w;
  const T* img0 = data + (static_cast<long long>(g.b) * s.c + c0) * hw;
  float* o0 = out + (static_cast<long long>(r) * s.c + c0) * bins;
  for (int bin = threadIdx.x; bin < bins; bin += blockDim.x) {
    const int py = bin / s.pw, px = bin - py * s.pw;
    if constexpr (SR > 0) {
      Axis ay[SR], ax[SR];
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        ay[i] = axis_of(g.y1, g.bin_h, py, i, SR, s.h);
        ax[i] = axis_of(g.x1, g.bin_w, px, i, SR, s.w);
      }
#pragma unroll 2
      for (int cl = 0; cl < nc; ++cl) {
        const T* img = img0 + cl * hw;
        float sum = 0.f;
#pragma unroll
        for (int iy = 0; iy < SR; ++iy)
#pragma unroll
          for (int ix = 0; ix < SR; ++ix)
            sum = __fadd_rn(sum, blend(img, s.w, ay[iy], ax[ix]));
        o0[cl * bins + bin] = __fdiv_rn(sum, count);
      }
    } else {
      for (int cl = 0; cl < nc; ++cl) {
        const T* img = img0 + cl * hw;
        float sum = 0.f;
        for (int iy = 0; iy < sr; ++iy) {
          const Axis ay = axis_of(g.y1, g.bin_h, py, iy, sr, s.h);
          for (int ix = 0; ix < sr; ++ix)
            sum = __fadd_rn(sum, blend(img, s.w, ay,
                                       axis_of(g.x1, g.bin_w, px, ix, sr,
                                               s.w)));
        }
        o0[cl * bins + bin] = __fdiv_rn(sum, count);
      }
    }
  }
}

// Add weight wt to the merged list (idx, val) of n entries.
template <int N>
__device__ __forceinline__ void merge(int (&idx)[N], float (&val)[N], int& n,
                                      int at, float wt) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n && idx[i] == at) {
      val[i] += wt;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i == n) {
      idx[i] = at;
      val[i] = wt;
    }
  }
  ++n;
}

// d value / d y and d x of one sample, g-scaled, added to the RoI sums:
// (sum of d/dy, sum of d/dy * t_y, sum of d/dx, sum of d/dx * t_x)
template <typename T>
__device__ __forceinline__ void roi_terms(const T* __restrict__ img, int w,
                                          float gs, const Axis& ay,
                                          const Axis& ax, float* acc) {
  const float v00 = mxk::to_f(img[ay.lo * w + ax.lo]);
  const float v01 = mxk::to_f(img[ay.lo * w + ax.hi]);
  const float v10 = mxk::to_f(img[ay.hi * w + ax.lo]);
  const float v11 = mxk::to_f(img[ay.hi * w + ax.hi]);
  const float dy = gs * ay.dw *
                   ((1.f - ax.w) * (v10 - v00) + ax.w * (v11 - v01));
  const float dx = gs * ax.dw *
                   ((1.f - ay.w) * (v01 - v00) + ay.w * (v11 - v10));
  acc[0] += dy;
  acc[1] += dy * ay.t;
  acc[2] += dx;
  acc[3] += dx * ax.t;
}

template <typename T, int SR>
__global__ void __launch_bounds__(kThreadCap)
    roi_align_bwd_kernel(const float* __restrict__ grad,
                         const T* __restrict__ data,
                         const float* __restrict__ rois,
                         float* __restrict__ ddata, float* __restrict__ drois,
                         Shape s) {
  __shared__ float red[4][kThreadCap / 32];
  __shared__ float tot[4];
  const int r = blockIdx.x / s.chunks;
  const int c0 = (blockIdx.x - r * s.chunks) * kChunk;
  const int nc = min(kChunk, s.c - c0);
  const int sr = SR > 0 ? SR : s.sr;
  const float count = static_cast<float>(sr * sr);
  const Geometry g = roi_geometry(rois + r * 5, s.n, s.ph, s.pw, s.scale,
                                  s.off, s.min_size);
  const int bins = s.ph * s.pw;
  const long long hw = static_cast<long long>(s.h) * s.w;
  const long long plane0 = (static_cast<long long>(g.b) * s.c + c0) * hw;
  const float* g0 = grad + (static_cast<long long>(r) * s.c + c0) * bins;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int bin = threadIdx.x; bin < bins; bin += blockDim.x) {
    const int py = bin / s.pw, px = bin - py * s.pw;
    if constexpr (SR > 0) {
      Axis ay[SR], ax[SR];
      int rows[2 * SR], cols[2 * SR];
      float rw[2 * SR], cw[2 * SR];
      int nr = 0, ncol = 0;
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        ay[i] = axis_of(g.y1, g.bin_h, py, i, SR, s.h);
        ax[i] = axis_of(g.x1, g.bin_w, px, i, SR, s.w);
        merge(rows, rw, nr, ay[i].lo, 1.f - ay[i].w);
        merge(rows, rw, nr, ay[i].hi, ay[i].w);
        merge(cols, cw, ncol, ax[i].lo, 1.f - ax[i].w);
        merge(cols, cw, ncol, ax[i].hi, ax[i].w);
      }
      // no branch on the loaded gradient: the next channels' loads fly
#pragma unroll 2
      for (int cl = 0; cl < nc; ++cl) {
        const float gs = __fdiv_rn(g0[cl * bins + bin], count);
        float* dst = ddata + plane0 + cl * hw;
#pragma unroll
        for (int i = 0; i < 2 * SR; ++i) {
          if (i >= nr) break;
          const float gr = gs * rw[i];
          float* row = dst + rows[i] * s.w;
#pragma unroll
          for (int j = 0; j < 2 * SR; ++j) {
            if (j >= ncol) break;
            atomicAdd(row + cols[j], gr * cw[j]);
          }
        }
        if (drois != nullptr) {
          const T* img = data + plane0 + cl * hw;
#pragma unroll
          for (int iy = 0; iy < SR; ++iy)
#pragma unroll
            for (int ix = 0; ix < SR; ++ix)
              roi_terms(img, s.w, gs, ay[iy], ax[ix], acc);
        }
      }
    } else {
      for (int cl = 0; cl < nc; ++cl) {
        const float gs = __fdiv_rn(g0[cl * bins + bin], count);
        if (gs == 0.f) continue;
        float* dst = ddata + plane0 + cl * hw;
        const T* img = data + plane0 + cl * hw;
        for (int iy = 0; iy < sr; ++iy) {
          const Axis ay = axis_of(g.y1, g.bin_h, py, iy, sr, s.h);
          for (int ix = 0; ix < sr; ++ix) {
            const Axis ax = axis_of(g.x1, g.bin_w, px, ix, sr, s.w);
            atomicAdd(dst + ay.lo * s.w + ax.lo, gs * (1.f - ay.w) *
                                                     (1.f - ax.w));
            atomicAdd(dst + ay.lo * s.w + ax.hi, gs * (1.f - ay.w) * ax.w);
            atomicAdd(dst + ay.hi * s.w + ax.lo, gs * ay.w * (1.f - ax.w));
            atomicAdd(dst + ay.hi * s.w + ax.hi, gs * ay.w * ax.w);
            if (drois != nullptr) roi_terms(img, s.w, gs, ay, ax, acc);
          }
        }
      }
    }
  }
  if (drois == nullptr) return;
  // the CTA's one RoI: sum the threads' terms, add them once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = mxk::warp_sum(acc[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float t = 0.f;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i)
      t += red[threadIdx.x][i];
    tot[threadIdx.x] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // y = y1 + t * max(y2 - y1, min) / ph: d/dy1 = 1 - t mh / ph, d/dy2 =
    // t mh / ph; each corner is rois[k] * scale - off
    float* dr = drois + static_cast<long long>(r) * 5;
    atomicAdd(dr + 1, s.scale * (tot[2] - g.mw / s.pw * tot[3]));
    atomicAdd(dr + 2, s.scale * (tot[0] - g.mh / s.ph * tot[1]));
    atomicAdd(dr + 3, s.scale * (g.mw / s.pw * tot[3]));
    atomicAdd(dr + 4, s.scale * (g.mh / s.ph * tot[1]));
  }
}

bool make_shape(Shape& s, int dtype, int n, int c, int h, int w, int r,
                int ph, int pw, int sr, float scale, int aligned) {
  if ((dtype != mxk::kFloat32 && dtype != mxk::kBFloat16) || n < 1 ||
      c < 1 || h < 1 || w < 1 || r < 0 || ph < 1 || pw < 1 || sr < 1)
    return false;
  s.n = n;
  s.c = c;
  s.h = h;
  s.w = w;
  s.ph = ph;
  s.pw = pw;
  s.sr = sr;
  s.chunks = (c + kChunk - 1) / kChunk;
  s.scale = scale;
  s.off = aligned ? 0.5f : 0.f;
  s.min_size = aligned ? 1e-6f : 1.f;
  return static_cast<long long>(r) * s.chunks <= 0x7fffffffLL;
}

int threads_for(const Shape& s) {
  const int bins = s.ph * s.pw;
  const int t = ((bins + 31) / 32) * 32;
  return t > kThreadCap ? kThreadCap : t;
}

template <typename T, int SR>
void launch_fwd(const void* data, const float* rois, float* out, int r,
                const Shape& s, cudaStream_t st) {
  roi_align_fwd_kernel<T, SR><<<r * s.chunks, threads_for(s), 0, st>>>(
      static_cast<const T*>(data), rois, out, s);
}

template <typename T>
void dispatch_fwd(const void* data, const float* rois, float* out, int r,
                  const Shape& s, cudaStream_t st) {
  switch (s.sr) {
    case 1: launch_fwd<T, 1>(data, rois, out, r, s, st); break;
    case 2: launch_fwd<T, 2>(data, rois, out, r, s, st); break;
    case 3: launch_fwd<T, 3>(data, rois, out, r, s, st); break;
    case 4: launch_fwd<T, 4>(data, rois, out, r, s, st); break;
    default: launch_fwd<T, 0>(data, rois, out, r, s, st);
  }
}

template <typename T, int SR>
void launch_bwd(const float* grad, const void* data, const float* rois,
                float* ddata, float* drois, int r, const Shape& s,
                cudaStream_t st) {
  roi_align_bwd_kernel<T, SR><<<r * s.chunks, threads_for(s), 0, st>>>(
      grad, static_cast<const T*>(data), rois, ddata, drois, s);
}

template <typename T>
void dispatch_bwd(const float* grad, const void* data, const float* rois,
                  float* ddata, float* drois, int r, const Shape& s,
                  cudaStream_t st) {
  switch (s.sr) {
    case 1: launch_bwd<T, 1>(grad, data, rois, ddata, drois, r, s, st); break;
    case 2: launch_bwd<T, 2>(grad, data, rois, ddata, drois, r, s, st); break;
    case 3: launch_bwd<T, 3>(grad, data, rois, ddata, drois, r, s, st); break;
    case 4: launch_bwd<T, 4>(grad, data, rois, ddata, drois, r, s, st); break;
    default: launch_bwd<T, 0>(grad, data, rois, ddata, drois, r, s, st);
  }
}

}  // namespace

// out (r, c, ph, pw) f32 from data (n, c, h, w) of dtype and rois (r, 5)
// f32; sr >= 1 (the wrapper maps sample_ratio <= 0 to 2).
extern "C" int mx_roi_align_fwd(const void* data, const float* rois,
                                float* out, int dtype, int n, int c, int h,
                                int w, int r, int ph, int pw, int sr,
                                float scale, int aligned, void* stream) {
  Shape s;
  if (!make_shape(s, dtype, n, c, h, w, r, ph, pw, sr, scale, aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == mxk::kFloat32)
    dispatch_fwd<float>(data, rois, out, r, s, st);
  else
    dispatch_fwd<__nv_bfloat16>(data, rois, out, r, s, st);
  return static_cast<int>(cudaGetLastError());
}

// ddata (n, c, h, w) f32 and, when drois is not null, drois (r, 5) f32,
// both zeroed here (memsets, not kernels), from the head gradient grad
// (r, c, ph, pw) f32.
extern "C" int mx_roi_align_bwd(const float* grad, const void* data,
                                const float* rois, float* ddata, float* drois,
                                int dtype, int n, int c, int h, int w, int r,
                                int ph, int pw, int sr, float scale,
                                int aligned, void* stream) {
  Shape s;
  if (!make_shape(s, dtype, n, c, h, w, r, ph, pw, sr, scale, aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      ddata, 0, sizeof(float) * static_cast<size_t>(n) * c * h * w, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (drois != nullptr && r > 0) {
    err = cudaMemsetAsync(drois, 0, sizeof(float) * 5 * static_cast<size_t>(r),
                          st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (r == 0) return 0;
  if (dtype == mxk::kFloat32)
    dispatch_bwd<float>(grad, data, rois, ddata, drois, r, s, st);
  else
    dispatch_bwd<__nv_bfloat16>(grad, data, rois, ddata, drois, r, s, st);
  return static_cast<int>(cudaGetLastError());
}
