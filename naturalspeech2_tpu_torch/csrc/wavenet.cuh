// One tile of one WaveNet block, shared by K1 (wavenet.cu, all lanes of a
// stack per launch) and K1b (wavenet_lane.cu, one lane of one stack per
// launch). With dilation δ:
//   y   = [x_{t-2δ} | x_{t-δ} | x_t] · cw + cb
//   y   = y · γ + β;   g = tanh(y) · sigmoid(y)
//   out = g + x_t · rw + rb
// computed as one GEMM over K = 3d (the three taps, rows before t = 0 read
// as zero) with the residual GEMM on the x_t tap, FiLM and the gate in the
// epilogue.
#pragma once

#include "tile.cuh"

namespace ns2 {

// Rows t0..t0+TM-1, channels n0..n0+TN-1 of the block's output `o` [n, d]
// from its input `lane` [n, d]; cw [3d, d], cb [d], rw [d, d], rb [d],
// f [2d] (γ then β). Requires d % KC == 0 and n0 + TN <= d.
__device__ __forceinline__ void wavenet_block_tile(
    const float* __restrict__ lane, const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ rw, const float* __restrict__ rb, const float* __restrict__ f,
    float* __restrict__ o, int n, int d, int dil, int t0, int n0, float (*As)[TM],
    float (*Ws)[TN], float (*Rs)[TN]) {
  float acc[4][4] = {};
  float accr[4][4] = {};
  for (int tap = 0; tap < 3; ++tap) {
    const int shift = (2 - tap) * dil;  // tap 0 reads x_{t-2δ}
    for (int k0 = 0; k0 < d; k0 += KC) {
      stage_rows(lane, d, n, t0, shift, k0, As);
      stage_cols(cw + (size_t)tap * d * d, d, k0, n0, Ws);
      if (tap == 2) stage_cols(rw, d, k0, n0, Rs);
      __syncthreads();
      fma_chunk(acc, As, Ws);
      if (tap == 2) fma_chunk(accr, As, Rs);
      __syncthreads();
    }
  }

  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      float y = acc[i][j] + cb[c];
      y = y * f[c] + f[d + c];
      const float g = tanhf(y) * sigmoid(y);
      o[(size_t)t * d + c] = g + accr[i][j] + rb[c];
    }
  }
}

}  // namespace ns2
