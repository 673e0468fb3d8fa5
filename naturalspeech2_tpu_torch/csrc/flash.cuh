// Shared pieces of the flash-attention kernels K4 (flash_fwd.cu) and K5
// (flash_bwd.cu): the masked-logit constant, the validity rule, and the
// Threefry-2x32-20 dropout mask of naturalspeech2_tpu/ops/flash_attention.py
// (`_threefry2x32`, `_dropout_keep_scaled`), bit for bit.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace ns2 {

// NEG_INF = -0.7 * FLT_MAX, rounded from double as the JAX package does:
// finite, so a fully masked row has a finite max and lse = NEG_INF.
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e+38);

// Tiles: 64 query rows by 64 key columns, 256 threads as 16 x 16; a thread
// owns rows ty + 16*i and columns tx + 16*j, i, j < 4. The 16 threads of
// one row group are the 16 lanes of a half-warp, so row reductions are
// warp shuffles with offsets below 16.
constexpr int kTQ = 64;
constexpr int kTK = 64;

struct Dropout {
  uint32_t seed0, seed1;
  float rate;          // 0: no dropout
  int stride;          // the key length the counter uses (JAX's padded n_kv)
  uint32_t threshold;  // keep when bits >= threshold
  float scale;         // 1 / (1 - rate) in f32
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// First output word of Threefry-2x32-20 with key (k0, k1) on (x0, x1).
__device__ __forceinline__ uint32_t threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                                 uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define NS2_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl32(x1, r) ^ x0;
  x0 += k0;
  x1 += k1;
  NS2_TF_ROUND(13) NS2_TF_ROUND(15) NS2_TF_ROUND(26) NS2_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  NS2_TF_ROUND(17) NS2_TF_ROUND(29) NS2_TF_ROUND(16) NS2_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  NS2_TF_ROUND(13) NS2_TF_ROUND(15) NS2_TF_ROUND(26) NS2_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  NS2_TF_ROUND(17) NS2_TF_ROUND(29) NS2_TF_ROUND(16) NS2_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  NS2_TF_ROUND(13) NS2_TF_ROUND(15) NS2_TF_ROUND(26) NS2_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef NS2_TF_ROUND
  return x0;
}

// The multiplier of probability (row, col) of batch bi, head hi: keep·scale.
__device__ __forceinline__ float keep_mult(const Dropout& dr, int bi, int hi, int row, int col) {
  const uint32_t x0 = (uint32_t)row * (uint32_t)dr.stride + (uint32_t)col;
  const uint32_t x1 = (uint32_t)bi * 65536u + (uint32_t)hi;
  return threefry2x32(dr.seed0, dr.seed1, x0, x1) >= dr.threshold ? dr.scale : 0.0f;
}

// Key col is visible from query row: inside both lengths, kept by the
// [b, n_kv] padding mask (nullptr: all kept), and not after row if causal.
__device__ __forceinline__ bool visible(const unsigned char* mask_b, int row, int col, int n_q,
                                        int n_kv, int causal) {
  return row < n_q && col < n_kv && (mask_b == nullptr || mask_b[col] != 0) &&
         (!causal || row >= col);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace ns2
