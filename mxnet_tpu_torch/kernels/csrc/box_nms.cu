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
// never kept and suppresses nothing), and it picks the route from m alone
// (nms_plan).
//
// The work: for each image, the suppression triangle (row i suppresses a
// later row j when their IoU exceeds overlap_thresh and they share a
// class, or always when force_suppress or id_index < 0), kept as 64 x 64
// tiles on and above the diagonal: tile (r, c), c > r, holds for each row
// of row block r one 64-bit word over the rows of block c that it
// suppresses; the diagonal tile (r, r) holds for each row of block r the
// rows of the block before it that suppress it (the tile transposed, as
// the sweep reads it). Then the greedy sweep over the triangle; then the
// output, kept rows as they are (their box converted to out_format when
// that differs), every other row -1, and -1 for rows m..n_out-1. Two
// routes:
//
//   shared (m <= 1,856: the triangle fits one CTA's 227 KB):
//     nms_cluster_kernel, ONE launch. A thread block cluster per image:
//     its CTAs compute the tiles and store them into the leader CTA's
//     shared memory through distributed shared memory, then a cluster
//     barrier, then the leader sweeps and writes the m sorted rows while
//     the other CTAs write the -1 rows m..n_out-1, which do not depend on
//     the sweep. A cluster rather than "the last CTA of the image to
//     finish sweeps": the triangle never goes through device memory, and
//     there is no scratch and no arrival counter to allocate, reset or
//     keep alive inside a CUDA graph.
//   global (m > 1,856, e.g. the op's default topk = -1 at SSD's 7,620
//     rows): TWO launches. nms_tile_kernel computes the tiles over the
//     whole grid into scratch (only the triangle: batch x T x 512 bytes
//     for T = words (words + 1) / 2 tiles) and writes the -1 rows
//     m..n_out-1; nms_sweep_kernel (one CTA per image) sweeps and writes
//     the m sorted rows.
//
// The sweep resolves one 64-row word at a time in one warp's registers,
// without a barrier or a shared-memory round trip per row. Lane l holds
// the diagonal words of rows l and l + 32 (loaded a word ahead: they do
// not depend on the decisions); the word's candidates, valid[w] &
// ~removed[w], are settled in rounds of two ballots: a candidate with no
// candidate or kept row before it among its suppressors is kept, one with
// a kept suppressor is removed. A round settles at least the first open
// candidate, and where suppressors do not chain (as in SSD's detections,
// about one round a word) it settles the whole word; rows already removed
// cost nothing. (Walking the candidates' set bits one kept row at a
// time instead costs a dependent find-first-set, shuffle and mask per
// kept row: 16 of 47.6 us at SSD detect's shape on an H100.) Then the
// kept rows' words of each tile (w, v > w) are ORed into removed[v]:
// while words <= 32 in a register of lane v, the warp reading each tile's
// words at once and reducing them; beyond, in shared memory, lane v % 32
// reading the kept rows' words of its own tiles (a word of the global
// route keeps a few rows, and a tile read whole there costs more than
// the few words).
//
// The tiles test only a row's same-class pairs (unless id_index < 0): a
// thread first masks its 32 columns by class, then steps over the set
// bits, so that a warp's steps are its lanes' same-class pairs and not
// all 32 columns.
//
// A tile whose row block or column block holds no valid row (score >
// valid_thresh) is skipped: only a valid row's words are read (a kept
// row's, a candidate's), and the bits a skipped tile would OR into a
// block with no valid row mask only rows that are never candidates.
// Exact for any input, sorted or not.
//
// The IoU follows _corner_iou (mxnet_tpu/ops/spatial.py:41) operation by
// operation, each written as an _rn intrinsic so that nvcc contracts
// nothing into an FMA (a fused area_a + area_b - inter moves decisions at
// the threshold): the plain version (kernels/box_nms.py) and the kernels
// decide alike bit for bit. max/min propagate NaN as XLA's do (max.NaN:
// the canonical NaN, and only the decision is ever read); clip(v, 0)
// gives +0 for v <= 0 and NaN for NaN. The quotient is formed only where
// the intersection is above 0: elsewhere it is +0 (or the union is not
// above 0), so the decision is 0 > overlap_thresh either way.
//
// What bounds it on an H100: at SSD detect's shapes (32 images, 7,620
// rows of 6 floats, topk 400) the bytes, 0.31 MB of sorted rows read and
// 5.85 MB of output written (0.0018 ms); at the op's default topk = -1
// (32 x 7,620 rows) the operations, 20 f32 operations for each of the
// 32 x 7,620 x 7,619 / 2 pairs (0.28 ms at 67 TFLOP/s). Neither bound
// holds the sweep's chain of dependent decisions, one image's words in
// order: the design keeps that chain to a few ballot rounds a word, with
// every load it needs issued ahead of it, and moves the rest of the work
// (the tiles, the -1 rows) off it onto the whole grid.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;                  // rows and columns per tile
constexpr int kSlots = 4;                  // tiles a CTA computes at once
constexpr int kSlotThreads = 2 * kTile;    // two a row, 32 columns each
constexpr int kThreads = kSlots * kSlotThreads;   // 512
constexpr int kMaxCluster = 8;             // the portable cluster size

struct Box {
  float x1, y1, x2, y2;
};

// a sorted row's box as corners, its area and its class
struct __align__(8) TileBox {
  float x1, y1, x2, y2, area, id;
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
// jnp.clip(v, 0): +0 at or below 0 (-0 + +0 is +0), NaN for NaN.
__device__ __forceinline__ float clip0(float v) {
  return __fadd_rn(max_nan(v, 0.f), 0.f);
}

// _to_corner: a center box (x, y, w, h) as corners.
__device__ __forceinline__ Box load_corner(const float* row, bool center) {
  const float a = row[0], b = row[1], c = row[2], d = row[3];
  if (!center) return {a, b, c, d};
  const float hw = __fdiv_rn(c, 2.f), hh = __fdiv_rn(d, 2.f);
  return {__fsub_rn(a, hw), __fsub_rn(b, hh), __fadd_rn(a, hw),
          __fadd_rn(b, hh)};
}

__device__ __forceinline__ TileBox load_box(const float* row, int cs,
                                            bool center, int id_index) {
  const Box c = load_corner(row + cs, center);
  const float area = __fmul_rn(clip0(__fsub_rn(c.x2, c.x1)),
                               clip0(__fsub_rn(c.y2, c.y1)));
  return {c.x1, c.y1, c.x2, c.y2, area, id_index >= 0 ? row[id_index] : 0.f};
}

// Whether row a suppresses the later row b by their overlap: _corner_iou
// in its order of operations above thresh (the class test is the
// caller's).
__device__ __forceinline__ bool iou_above(const TileBox& a, const TileBox& b,
                                          float thresh) {
  const float ix1 = max_nan(a.x1, b.x1), iy1 = max_nan(a.y1, b.y1);
  const float ix2 = min_nan(a.x2, b.x2), iy2 = min_nan(a.y2, b.y2);
  const float inter = __fmul_rn(clip0(__fsub_rn(ix2, ix1)),
                                clip0(__fsub_rn(iy2, iy1)));
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  if (uni > 0.f && inter > 0.f) return __fdiv_rn(inter, uni) > thresh;
  return 0.f > thresh;            // the IoU is +0
}

// Tiles of row blocks before r: tile (r, c), c >= r, is number
// first_tile(r) + c - r of the image's triangle.
__device__ __forceinline__ long long first_tile(long long r, long long words) {
  return r * words - r * (r - 1) / 2;
}

// Tile number g of the triangle as (row block, column block).
__device__ __forceinline__ void tile_rc(long long g, int words, int& r,
                                        int& c) {
  const double a = 2.0 * words + 1.0;
  long long q = static_cast<long long>((a - sqrt(a * a - 8.0 * g)) * 0.5);
  q = q < 0 ? 0 : (q > words - 1 ? words - 1 : q);
  while (q > 0 && first_tile(q, words) > g) --q;
  while (q + 1 < words && first_tile(q + 1, words) <= g) ++q;
  r = static_cast<int>(q);
  c = static_cast<int>(q + g - first_tile(q, words));
}

// One pass of a CTA's four tile slots over an image's rows ``base``:
// slot s computes tile g (none when g < 0; g is uniform over the slot),
// two neighbouring threads of the slot the word of row t of the tile's
// row block, 32 columns each. Returns whether that word is needed (the
// tile live, the row valid) in the thread that holds it, the first of
// the two, and sets *bits there. Every thread of the CTA calls it.
__device__ bool tile_pass(const float* base, int m, int k, int cs,
                          int score_index, int id_index, bool center,
                          float thresh, float valid_thresh, int words,
                          long long g, TileBox* stage, int* flags,
                          u64* bits) {
  const int tid = threadIdx.x, slot = tid / kSlotThreads;
  const int t = (tid % kSlotThreads) >> 1, h = tid & 1;
  int tr = 0, tc = 0;
  if (g >= 0) tile_rc(g, words, tr, tc);
  const int i = tr * kTile + t, j = tc * kTile + t;
  TileBox own = {};
  bool own_valid = false, col_valid = false;
  __syncthreads();                 // the last pass's reads of stage done
  if (g >= 0 && h == 0 && j < m) {
    const float* r = base + static_cast<size_t>(j) * k;
    stage[slot * kTile + t] = load_box(r, cs, center, id_index);
    col_valid = r[score_index] > valid_thresh;
  }
  if (g >= 0 && i < m) {
    const float* r = base + static_cast<size_t>(i) * k;
    own = load_box(r, cs, center, id_index);
    own_valid = r[score_index] > valid_thresh;
  }
  const unsigned ov = __ballot_sync(0xffffffffu, own_valid);
  const unsigned cv = __ballot_sync(0xffffffffu, col_valid);
  if ((tid & 31) == 0) flags[tid >> 5] = (ov != 0u) | ((cv != 0u) << 1);
  __syncthreads();
  constexpr int kSlotWarps = kSlotThreads / 32;
  int f = 0;
  for (int w = 0; w < kSlotWarps; ++w) f |= flags[slot * kSlotWarps + w];
  const bool live = f == 3 && own_valid;
  unsigned half = 0u;
  if (live) {
    const TileBox* cols = stage + slot * kTile + 32 * h;
    // the pairs to test: the half tile's columns (on the diagonal, where
    // the tile is transposed, the rows 32 h + q < t of the block that may
    // suppress row t), of row t's class unless id_index < 0, so that a
    // warp steps only over its lanes' same-class pairs
    const int n = tr == tc ? min(32, t - 32 * h)
                           : min(32, m - tc * kTile - 32 * h);
    unsigned todo = n <= 0 ? 0u : (n >= 32 ? ~0u : (1u << n) - 1u);
    if (id_index >= 0) {
      unsigned same = 0u;
#pragma unroll
      for (int q = 0; q < 32; ++q)
        same |= (cols[q].id == own.id ? 1u : 0u) << q;
      todo &= same;
    }
    for (; todo; todo &= todo - 1) {
      const int q = __ffs(todo) - 1;
      if (tr == tc ? iou_above(cols[q], own, thresh)
                   : iou_above(own, cols[q], thresh))
        half |= 1u << q;
    }
  }
  const unsigned upper = __shfl_xor_sync(0xffffffffu, half, 1);
  *bits = half | (static_cast<u64>(upper) << 32);
  return live && h == 0;
}

// The valid bits of an image's rows, ``words`` words (0 past row m): a
// warp's ballot over 32 rows at a time, two ballots to a word.
__device__ void valid_bits(const float* base, int m, int k, int score_index,
                           float valid_thresh, int words, u64* valid) {
  unsigned* half = reinterpret_cast<unsigned*>(valid);
  for (int i0 = threadIdx.x & ~31; i0 < words * kTile; i0 += blockDim.x) {
    const int i = i0 + (threadIdx.x & 31);
    const bool v = i < m && base[static_cast<size_t>(i) * k + score_index] >
                                valid_thresh;
    const unsigned bits = __ballot_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) half[i0 >> 5] = bits;   // low half first
  }
}

__device__ __forceinline__ u64 ballot64(bool lo, bool hi) {
  return static_cast<u64>(__ballot_sync(0xffffffffu, hi)) << 32 |
         __ballot_sync(0xffffffffu, lo);
}

// The greedy sweep over an image's triangle ``tiles`` (shared or device
// memory), by one warp: kept[w] for every word w. ``removed`` (shared
// memory, words entries) is read only when !kRegs.
template <bool kRegs>
__device__ void sweep(const u64* __restrict__ tiles, const u64* valid,
                      u64* kept, u64* removed, int words) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  u64 rem = 0ull;                  // kRegs: removed[lane]
  const u64* row = tiles;          // tile (w, w), then (w, w + 1), ...
  // the diagonal tile of word w: the rows before row lane (slo) and row
  // lane + 32 (shi) of the word that suppress it
  u64 slo = row[lane], shi = row[lane + 32];
  for (int w = 0; w < words; ++w) {
    // the next diagonal tile follows this row block's words - w tiles
    const u64* next = row + static_cast<size_t>(words - w) * kTile;
    u64 nlo = 0ull, nhi = 0ull;
    if (w + 1 < words) {
      nlo = next[lane];
      nhi = next[lane + 32];
    }
    u64 r;
    if constexpr (kRegs) {
      r = __shfl_sync(kAll, rem, w);
    } else {
      __syncwarp();
      r = removed[w];
    }
    // the candidates, resolved in rounds: one is kept once no candidate
    // or kept row before it suppresses it, removed once a kept row does.
    // Each round settles at least the first open candidate.
    u64 open = valid[w] & ~r, keep = 0ull;
    while (open) {
      const u64 live = open | keep;
      const u64 kb = ballot64(!(slo & live), !(shi & live)) & open;
      keep |= kb;
      open &= ~(kb | ballot64(slo & keep, shi & keep));
    }
    if (lane == 0) kept[w] = keep;
    if (keep) {
      if constexpr (kRegs) {
        // lane v takes the OR of the kept rows' words of tile (w, v): the
        // warp reads each tile's words at once and reduces them
        const bool k0 = (keep >> lane) & 1ull;
        const bool k1 = (keep >> (lane + 32)) & 1ull;
        for (int v = w + 1; v < words; ++v) {
          const u64* col = row + static_cast<size_t>(v - w) * kTile;
          const u64 a = (k0 ? col[lane] : 0ull) | (k1 ? col[lane + 32] : 0ull);
          const u64 o =
              static_cast<u64>(
                  __reduce_or_sync(kAll, static_cast<unsigned>(a >> 32)))
                  << 32 |
              __reduce_or_sync(kAll, static_cast<unsigned>(a));
          if (lane == v) rem |= o;
        }
      } else {
        // lane v % 32 owns removed[v] and reads the kept rows' words of
        // tile (w, v), eight loads in flight before their ORs
        for (int v = w + 1 + ((lane - w - 1) & 31); v < words; v += 32) {
          const u64* col = row + static_cast<size_t>(v - w) * kTile;
          u64 acc = 0ull;
          for (u64 q = keep; q;) {
            u64 a[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              a[u] = 0ull;
              if (q) {
                a[u] = col[__ffsll(static_cast<long long>(q)) - 1];
                q &= q - 1;
              }
            }
            acc |= a[0] | a[1] | a[2] | a[3] | a[4] | a[5] | a[6] | a[7];
          }
          removed[v] |= acc;
        }
      }
    }
    row = next;
    slo = nlo;
    shi = nhi;
  }
}

// Element e of an image's m sorted output rows: a kept row as it is (its
// box converted to out_format when that differs), every other row -1.
__device__ __forceinline__ float row_value(const float* base, const u64* kept,
                                           int e, int k, int cs,
                                           int in_center, int out_center) {
  const int i = e / k, c = e - i * k;
  if (!((kept[i >> 6] >> (i & 63)) & 1ull)) return -1.f;
  const float* r = base + static_cast<size_t>(i) * k;
  if (in_center == out_center || c < cs || c >= cs + 4) return r[c];
  const int q = c - cs;
  if (out_center) {
    // corner -> center: ((x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1)
    const float lo = r[cs + (q & 1)], hi = r[cs + 2 + (q & 1)];
    return q < 2 ? __fdiv_rn(__fadd_rn(lo, hi), 2.f) : __fsub_rn(hi, lo);
  }
  // center -> corner: x -+ w / 2, y -+ h / 2
  const float ctr = r[cs + (q & 1)];
  const float half = __fdiv_rn(r[cs + 2 + (q & 1)], 2.f);
  return q < 2 ? __fsub_rn(ctr, half) : __fadd_rn(ctr, half);
}

// The m sorted rows of an image's output, four elements a thread at a
// time: their loads in flight together, then their stores.
__device__ void write_rows(const float* __restrict__ base,
                           float* __restrict__ ob, const u64* kept, int m,
                           int k, int cs, int in_center, int out_center) {
  const int n = m * k, step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * step) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * step < n)
        v[u] = row_value(base, kept, e0 + u * step, k, cs, in_center,
                         out_center);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * step < n) ob[e0 + u * step] = v[u];
  }
}

// Part ``part`` of ``parts`` of n floats of -1 from p: the 16-byte
// aligned middle as float4 stores split over the parts, the unaligned
// head by the first part and the tail by the last.
__device__ void fill_neg(float* p, size_t n, int part, int parts) {
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  if (head > n) head = n;
  const size_t n4 = (n - head) / 4, rest = head + n4 * 4;
  if (part == 0)
    for (size_t e = threadIdx.x; e < head; e += blockDim.x) p[e] = -1.f;
  if (part == parts - 1)
    for (size_t e = rest + threadIdx.x; e < n; e += blockDim.x) p[e] = -1.f;
  float4* p4 = reinterpret_cast<float4*>(p + head);
  const float4 neg = make_float4(-1.f, -1.f, -1.f, -1.f);
  const size_t hi = n4 * (part + 1) / parts;
  for (size_t q = n4 * part / parts + threadIdx.x; q < hi; q += blockDim.x)
    p4[q] = neg;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {     // release
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {       // acquire
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__host__ __device__ __forceinline__ long long n_tiles_of(int words) {
  return static_cast<long long>(words) * (words + 1) / 2;
}

// The shared route's dynamic shared memory: the triangle, the valid and
// kept bits, the four slots' column boxes and the warps' flags.
__host__ __device__ __forceinline__ size_t cluster_smem(int words) {
  return static_cast<size_t>(n_tiles_of(words)) * kTile * 8 +
         2 * static_cast<size_t>(words) * 8 +
         kSlots * kTile * sizeof(TileBox) + (kThreads / 32) * sizeof(int);
}

// The global route's sweep: valid and kept bits, and removed past 32
// words.
__host__ __device__ __forceinline__ size_t sweep_smem(int words) {
  return static_cast<size_t>(words) * 8 * (words > 32 ? 3 : 2);
}

__host__ __device__ __forceinline__ int cluster_size(int words) {
  const long long c = (n_tiles_of(words) + kSlots - 1) / kSlots;
  return static_cast<int>(c < kMaxCluster ? c : kMaxCluster);
}

// The shared route: one cluster of cluster_size(words) CTAs per image
// (grid x = ranks x batch).
__global__ void __launch_bounds__(kThreads)
    nms_cluster_kernel(const float* __restrict__ rows, float* __restrict__ out,
                       int m, int n_out, int k, int cs, int score_index,
                       int id_index, int in_center, int out_center,
                       float thresh, float valid_thresh, int words) {
  extern __shared__ __align__(16) u64 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const long long n_tiles = n_tiles_of(words);
  u64* tiles = smem;
  u64* valid = tiles + n_tiles * kTile;
  u64* kept = valid + words;
  TileBox* stage = reinterpret_cast<TileBox*>(kept + words);
  int* flags = reinterpret_cast<int*>(stage + kSlots * kTile);
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / ranks;
  const int t = (threadIdx.x % kSlotThreads) >> 1;
  const float* base = rows + static_cast<size_t>(b) * m * k;
  float* ob = out + static_cast<size_t>(b) * n_out * k;
  // phase 1: every CTA of the cluster has started (its shared memory is
  // there) before the first store into the leader's
  cluster_arrive_relaxed();
  // the leader's valid bits, whose reads also bring the image's rows to
  // the cache for write_rows
  if (rank == 0)
    valid_bits(base, m, k, score_index, valid_thresh, words, valid);
  u64* dst = cluster.map_shared_rank(tiles, 0);
  const long long per_pass = static_cast<long long>(ranks) * kSlots;
  const long long passes = (n_tiles + per_pass - 1) / per_pass;
  for (long long p = 0; p < passes; ++p) {
    long long g = p * per_pass + rank * kSlots + threadIdx.x / kSlotThreads;
    if (g >= n_tiles) g = -1;
    u64 bits;
    const bool live = tile_pass(base, m, k, cs, score_index, id_index,
                                in_center != 0, thresh, valid_thresh, words,
                                g, stage, flags, &bits);
    if (p == 0) cluster_wait();
    if (live) dst[g * kTile + t] = bits;
  }
  // phase 2: the triangle and the valid bits are in the leader
  cluster_arrive();
  float* tail = ob + static_cast<size_t>(m) * k;
  const size_t n_tail = static_cast<size_t>(n_out - m) * k;
  if (rank != 0) {
    fill_neg(tail, n_tail, rank - 1, ranks - 1);
    cluster_wait();
    return;
  }
  cluster_wait();
  __syncthreads();
  if (threadIdx.x < 32) sweep<true>(tiles, valid, kept, nullptr, words);
  __syncthreads();
  write_rows(base, ob, kept, m, k, cs, in_center, out_center);
  if (ranks == 1) fill_neg(tail, n_tail, 0, 1);
}

// The global route, launch 1: grid (ceil(T / 4), batch); each CTA's four
// tiles into scratch, then its part of the image's -1 rows m..n_out-1.
__global__ void __launch_bounds__(kThreads)
    nms_tile_kernel(const float* __restrict__ rows, u64* __restrict__ scratch,
                    float* __restrict__ out, int m, int n_out, int k, int cs,
                    int score_index, int id_index, int in_center,
                    float thresh, float valid_thresh, int words) {
  __shared__ TileBox stage[kSlots * kTile];
  __shared__ int flags[kThreads / 32];
  const long long n_tiles = n_tiles_of(words);
  const int b = blockIdx.y;
  long long g = static_cast<long long>(blockIdx.x) * kSlots +
                threadIdx.x / kSlotThreads;
  if (g >= n_tiles) g = -1;
  u64 bits;
  if (tile_pass(rows + static_cast<size_t>(b) * m * k, m, k, cs, score_index,
                id_index, in_center != 0, thresh, valid_thresh, words, g,
                stage, flags, &bits))
    scratch[(static_cast<size_t>(b) * n_tiles + g) * kTile +
            (threadIdx.x % kSlotThreads >> 1)] = bits;
  float* ob = out + static_cast<size_t>(b) * n_out * k;
  fill_neg(ob + static_cast<size_t>(m) * k,
           static_cast<size_t>(n_out - m) * k, blockIdx.x, gridDim.x);
}

// The global route, launch 2: one CTA per image sweeps its triangle from
// scratch and writes its m sorted rows.
template <bool kRegs>
__global__ void __launch_bounds__(kThreads)
    nms_sweep_kernel(const float* __restrict__ rows,
                     const u64* __restrict__ scratch, float* __restrict__ out,
                     int m, int n_out, int k, int cs, int score_index,
                     int in_center, int out_center, float valid_thresh,
                     int words) {
  extern __shared__ __align__(16) u64 smem[];
  u64* valid = smem;
  u64* kept = smem + words;
  u64* removed = smem + 2 * words;
  const int b = blockIdx.x;
  const float* base = rows + static_cast<size_t>(b) * m * k;
  valid_bits(base, m, k, score_index, valid_thresh, words, valid);
  if constexpr (!kRegs)
    for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  if (threadIdx.x < 32)
    sweep<kRegs>(scratch + static_cast<size_t>(b) * n_tiles_of(words) * kTile,
                 valid, kept, removed, words);
  __syncthreads();
  write_rows(base, out + static_cast<size_t>(b) * n_out * k, kept, m, k, cs,
             in_center, out_center);
}

}  // namespace

// rows: (batch, m, k) contiguous f32, each image's rows sorted by score
// (descending, stable) and cut to its first m; out: (batch, n_out, k)
// contiguous f32, n_out >= m. cs: the first of the four box columns;
// id_index < 0: every pair is of one class. in_center / out_center: the
// box formats (0 corner, 1 center). route 0 (shared): one launch, scratch
// unused; route 1 (global): two launches, scratch holds batch * T * 64
// 64-bit words, T = words (words + 1) / 2, words = ceil(m / 64). The
// route and shared_bytes, the dynamic shared memory of the launch that
// sweeps, are the wrapper's plan (nms_plan): a plan whose bytes differ
// from this layout's (cluster_smem, sweep_smem) is refused. On `stream`;
// returns cudaGetLastError() after the launches.
extern "C" int mx_box_nms(const float* rows, void* scratch, float* out,
                          int batch, int m, int n_out, int k, int cs,
                          int score_index, int id_index, int in_center,
                          int out_center, float overlap_thresh,
                          float valid_thresh, int route,
                          long long shared_bytes, void* stream) {
  if (batch < 1 || m < 1 || n_out < m || k < 4 || cs < 0 || cs + 4 > k ||
      score_index < 0 || score_index >= k || id_index >= k ||
      (route != 0 && route != 1) || (route == 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (m + kTile - 1) / kTile;
  const size_t smem = route == 0 ? cluster_smem(words) : sweep_smem(words);
  if (shared_bytes < 0 || static_cast<size_t>(shared_bytes) != smem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (route == 0) {
    err = mxk::allow_smem(nms_cluster_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ranks = cluster_size(words);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(ranks) * batch, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, nms_cluster_kernel, rows, out, m, n_out,
                             k, cs, score_index, id_index, in_center,
                             out_center, overlap_thresh, valid_thresh, words);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const long long n_tiles = n_tiles_of(words);
  const long long n_ctas = (n_tiles + kSlots - 1) / kSlots;
  if (n_ctas > 0x7fffffffLL || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  u64* tiles = static_cast<u64*>(scratch);
  nms_tile_kernel<<<dim3(static_cast<unsigned>(n_ctas), batch), kThreads, 0,
                    s>>>(rows, tiles, out, m, n_out, k, cs, score_index,
                         id_index, in_center, overlap_thresh, valid_thresh,
                         words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (words <= 32) {
    err = mxk::allow_smem(nms_sweep_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_sweep_kernel<true><<<batch, kThreads, smem, s>>>(
        rows, tiles, out, m, n_out, k, cs, score_index, in_center,
        out_center, valid_thresh, words);
  } else {
    err = mxk::allow_smem(nms_sweep_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    nms_sweep_kernel<false><<<batch, kThreads, smem, s>>>(
        rows, tiles, out, m, n_out, k, cs, score_index, in_center,
        out_center, valid_thresh, words);
  }
  return static_cast<int>(cudaGetLastError());
}
