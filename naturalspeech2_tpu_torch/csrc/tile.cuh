// 64 x 64 output tiles of f32 matrix products on the CUDA cores, staged
// through shared memory in chunks of 16 along the reduction. The building
// blocks of K1 (wavenet.cu) and K1b (wavenet_lane.cu). Thread (ty, tx) of
// the 16 x 16 grid owns rows ty + 16·i and columns tx + 16·j of the tile,
// i, j < 4: 4 x 4 register tiles, so each multiply-add costs half a
// shared-memory load.
#pragma once

#include "common.cuh"

namespace ns2 {

constexpr int TM = 64;  // rows (time steps) per tile
constexpr int TN = 64;  // output columns per tile
constexpr int KC = 16;  // reduction chunk staged in shared memory

// As[kk][r] = a[(t0 + r - shift)·lda + k0 + kk], zero for rows outside
// [0, n): a causal shift by `shift` rows with zeros before t = 0.
__device__ __forceinline__ void stage_rows(const float* __restrict__ a, int lda, int n, int t0,
                                           int shift, int k0, float (*As)[TM]) {
  for (int e = threadIdx.x; e < TM * KC; e += kThreads) {
    const int r = e / KC, kk = e % KC;
    const int t = t0 + r - shift;
    As[kk][r] = (t >= 0 && t < n) ? a[(size_t)t * lda + k0 + kk] : 0.0f;
  }
}

// Ws[kk][c] = w[(k0 + kk)·ldw + n0 + c]
__device__ __forceinline__ void stage_cols(const float* __restrict__ w, int ldw, int k0, int n0,
                                           float (*Ws)[TN]) {
  for (int e = threadIdx.x; e < KC * TN; e += kThreads) {
    const int kk = e / TN, c = e % TN;
    Ws[kk][c] = w[(size_t)(k0 + kk) * ldw + n0 + c];
  }
}

// acc[i][j] += Σ_kk As[kk][ty + 16i] · Ws[kk][tx + 16j]
__device__ __forceinline__ void fma_chunk(float (&acc)[4][4], float (*As)[TM], float (*Ws)[TN]) {
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    float a[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
  }
}

// acc += A[t0 - shift + r, k] · W[k, n0 + c] over k in [0, K), with A's
// rows outside [0, n) read as zero. K must be a multiple of KC.
__device__ __forceinline__ void tile_gemm(float (&acc)[4][4], const float* __restrict__ a,
                                          int lda, int n, int t0, int shift,
                                          const float* __restrict__ w, int ldw, int n0, int K,
                                          float (*As)[TM], float (*Ws)[TN]) {
  for (int k0 = 0; k0 < K; k0 += KC) {
    stage_rows(a, lda, n, t0, shift, k0, As);
    stage_cols(w, ldw, k0, n0, Ws);
    __syncthreads();
    fma_chunk(acc, As, Ws);
    __syncthreads();
  }
}

}  // namespace ns2
