// Tile building blocks shared by the flash attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu); the paged
// decode (paged_attention.cu) takes its mma.sync.
//
// Every product of both kernels has the shape "a warp's 16 rows of A
// times the rows of B": bf16 on the tensor cores with mma.sync m16n8k16
// (f32 accumulate), f32 with FMA on the CUDA cores. Results live in the
// mma.sync m16n8 accumulator layout on both paths: in a warp's 16 x 8
// tile, lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 at
// columns 2t and 2t + 1, as c[0], c[1] (row g) and c[2], c[3] (row g + 8).
// Shared-memory rows are padded by 16 bytes (LD = DP + 16 / sizeof(T)) so
// that the fragment reads of neighbouring rows fall in different banks.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace mxflash {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows x DP tile from global (row stride ``stride`` elements) into shared
// memory (row stride ``ld``) by the CTA's NT threads, 16 bytes per access;
// rows >= n_valid and columns >= d are zero.
template <typename T, int DP, int NT>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int n_valid, int d) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = DP / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid && c < d)
      val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// s[nt] = A[rows r0, r0 + 8] . B[rows nt*8 .. nt*8+7]^T over the padded
// head dim DP; A and B are shared-memory tiles of row stride LD.
template <typename T, int DP, int BN, int LD>
__device__ __forceinline__ void row_products(float (&s)[BN / 8][4],
                                             const T* as, const T* bs,
                                             int r0, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int c = kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(as + r0 * LD + c),
                             ld32(as + (r0 + 8) * LD + c),
                             ld32(as + r0 * LD + c + 8),
                             ld32(as + (r0 + 8) * LD + c + 8)};
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const T* br = bs + (nt * 8 + g) * LD + c;
        const uint32_t b[2] = {ld32(br), ld32(br + 8)};
        mma_bf16(s[nt], a, b);
      }
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + r0 * LD + c);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + (r0 + 8) * LD + c);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const float* br = bs + (nt * 8 + 2 * t) * LD + c;
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + LD);
        s[nt][0] += a0.x * b0.x + a0.y * b0.y + a0.z * b0.z + a0.w * b0.w;
        s[nt][1] += a0.x * b1.x + a0.y * b1.y + a0.z * b1.z + a0.w * b1.w;
        s[nt][2] += a1.x * b0.x + a1.y * b0.y + a1.z * b0.z + a1.w * b0.w;
        s[nt][3] += a1.x * b1.x + a1.y * b1.y + a1.z * b1.z + a1.w * b1.w;
      }
    }
  }
}

// acc += P . B for this warp's 16 rows: p (16 x BN) in the accumulator
// layout, B a BN x DP shared-memory tile of row stride LD. bf16 re-packs
// p in registers as the A operand (rounding it to bf16); f32 stages it
// through the warp's PLD-strided slice ``pw`` of shared memory.
template <typename T, int DP, int BN, int LD, int PLD>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4],
                                           const float (&p)[BN / 8][4],
                                           const T* bs, float* pw, int g,
                                           int t) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t a[4] = {mxk::pack_bf16x2(p[2 * j][0], p[2 * j][1]),
                             mxk::pack_bf16x2(p[2 * j][2], p[2 * j][3]),
                             mxk::pack_bf16x2(p[2 * j + 1][0], p[2 * j + 1][1]),
                             mxk::pack_bf16x2(p[2 * j + 1][2], p[2 * j + 1][3])};
      const T* b0 = bs + (j * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const T* bp = b0 + dt * 8;
        const uint32_t b[2] = {pack_bf16(bp[0], bp[LD]),
                               pack_bf16(bp[8 * LD], bp[9 * LD])};
        mma_bf16(acc[dt], a, b);
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      pw[g * PLD + c] = p[nt][0];
      pw[g * PLD + c + 1] = p[nt][1];
      pw[(g + 8) * PLD + c] = p[nt][2];
      pw[(g + 8) * PLD + c + 1] = p[nt][3];
    }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < BN; ++kk) {
      const float p0 = pw[g * PLD + kk];
      const float p1 = pw[(g + 8) * PLD + kk];
      const float* br = bs + kk * LD + 2 * t;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const float2 b = *reinterpret_cast<const float2*>(br + dt * 8);
        acc[dt][0] += p0 * b.x;
        acc[dt][1] += p0 * b.y;
        acc[dt][2] += p1 * b.x;
        acc[dt][3] += p1 * b.y;
      }
    }
    __syncwarp();
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint32_t*>(p) = mxk::pack_bf16x2(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

// Zero a warp's DP/8 accumulator tiles.
template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// Store a warp's 16 x DP accumulator rows (r0, r0 + 8 of the tile at
// ``base``, global row stride ``sl``) as T; rows >= n_rows and columns
// >= d are skipped.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* base, long long sl,
                                           const float (&acc)[DP / 8][4],
                                           int r0, int n_rows, int d, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= n_rows) continue;
    T* row = base + r * sl;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (c < d) store2<T>(row + c, acc[dt][2 * i], acc[dt][2 * i + 1]);
    }
  }
}

}  // namespace mxflash
