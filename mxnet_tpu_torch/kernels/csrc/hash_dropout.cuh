// The stateless position-hash dropout shared by every dropout site of the
// port: the Dropout op (dropout.cu), the LayerNorm forward and backward
// (layer_norm.cu) and flash attention forward and backward
// (flash_attention.cu, flash_attention_bwd.cu).
//
// Replaces the hash of mxnet_tpu/pallas_kernels/flash_attention.py
// (`_hash_u32` :85, `_hash_u16` :96, `dropout_thresh` :101, `_drop_mask`
// :117) and fused_layers.py (`_row_keep_mask` :113), bit for bit: a
// murmur3 finalizer over an element's absolute id under a u32 seed, all
// arithmetic in uint32_t (its wrap-around is the reference's), and the
// element is kept iff the hash's low 16 bits are below the u16 keep
// threshold min(0xFFFF, round((1 - p) * 65536)). Nothing random crosses
// from a forward kernel to its backward: the backward regenerates the
// same bits from the same seed and ids.
#pragma once

#include <cstdint>

namespace mxk {

constexpr uint32_t kHashGold = 0x9E3779B9u;
constexpr uint32_t kHashMur1 = 0x85EBCA6Bu;
constexpr uint32_t kHashMur2 = 0xC2B2AE35u;

__host__ __device__ __forceinline__ uint32_t mx_hash_u32(uint32_t idx,
                                                          uint32_t seed) {
  uint32_t z = idx * kHashGold + seed;
  z ^= z >> 16;
  z *= kHashMur1;
  z ^= z >> 13;
  z *= kHashMur2;
  z ^= z >> 16;
  return z;
}

// Keep iff the low 16 bits of the hash are below ``thresh`` (a u32
// compare, as the reference compares its u16 against a u32 threshold).
__host__ __device__ __forceinline__ bool mx_keep_u16(uint32_t idx,
                                                     uint32_t seed,
                                                     uint32_t thresh) {
  return (mx_hash_u32(idx, seed) & 0xFFFFu) < thresh;
}

// Attention probabilities: a two-level id. The (batch * heads + head)
// index folds into a per-head seed first (``mx_attn_head_seed``, once per
// CTA), then the in-head id q * lk + k (true lk, no causal offset) is
// hashed under it.
__host__ __device__ __forceinline__ uint32_t mx_attn_head_seed(uint32_t head,
                                                               uint32_t seed) {
  return mx_hash_u32(head, seed);
}

__host__ __device__ __forceinline__ bool mx_attn_keep_in_head(
    uint32_t head_seed, uint32_t q, uint32_t k, uint32_t lk,
    uint32_t thresh) {
  return mx_keep_u16(q * lk + k, head_seed, thresh);
}

__host__ __device__ __forceinline__ bool mx_attn_keep(uint32_t head,
                                                      uint32_t q, uint32_t k,
                                                      uint32_t lk,
                                                      uint32_t seed,
                                                      uint32_t thresh) {
  return mx_attn_keep_in_head(mx_attn_head_seed(head, seed), q, k, lk,
                              thresh);
}

// Rows (LayerNorm, the Dropout op): the element's flat id, row * d + col
// for a row kernel, the flat index of the mask shape for the op.
__host__ __device__ __forceinline__ bool mx_row_keep(uint32_t flat,
                                                     uint32_t seed,
                                                     uint32_t thresh) {
  return mx_keep_u16(flat, seed, thresh);
}

// What a kernel needs to drop: the seed, the keep threshold and the f32
// scale of its site (1 / (1 - p) or 1 - p, see each kernel).
struct Dropout {
  uint32_t seed;
  uint32_t thresh;
  float scale;
};

}  // namespace mxk
