// K1: the fused WaveNet body of the denoiser.
//
// Replaces the Pallas kernel `_wavenet_kernel` (entry `fused_wavenet_body`)
// in naturalspeech2_tpu/ops/wavenet_kernel.py. For every stack s and layer
// l, with dilation 2^l:
//   y   = [x_{t-2δ} | x_{t-δ} | x_t] · conv_w[s,l] + conv_b[s,l]
//   y   = y · film_γ[b,s,l] + film_β[b,s,l];   g = tanh(y) · sigmoid(y)
//   out = g + x · res_w[s,l] + res_b[s,l]      (lane l of the next stack)
// and the last stack's lanes give Σ_l lane_l · skip_w[l] + skip_b[l].
//
// What bounds it on the card: f32 multiply-adds on the CUDA cores and the
// shared-memory loads that feed them. At the flagship shape (b4 n1024
// d128, 4 stacks x 8 layers) one body is about 18 GFLOP against 33 lanes
// of 2 MB read and written, so HBM is not the limit; with 4x4 register
// tiles each FMA costs half a shared-memory load, which holds the kernel
// near 14 TFLOP/s of the 67 (H100 SXM, 700 W).
//
// Design: the TPU kernel keeps all 8 lanes resident in VMEM (4 MB f32),
// far beyond a block's 227 KB of shared memory, and its grid runs the
// stacks in order. Here the lanes live in device memory as f32 [L,b,n,d]
// and ping-pong between two buffers, one launch per stack: a block reads
// the causal halo (2δ rows) of the previous stack's buffer, so updating
// in place would race. A block computes a 64-row x 64-column tile of one
// lane as one GEMM over K = 3d (the three taps, rows before t = 0 read as
// zero) and fuses the residual GEMM on the x_t tap, FiLM and the gate
// into its epilogue (`wavenet_block_tile`, wavenet.cuh, shared with K1b).
// The skips are a last launch that loops over the lanes inside each
// block, so the sum is deterministic without atomics.
#include "wavenet.cuh"

namespace {

using ns2::KC;
using ns2::TM;
using ns2::TN;

// One stack: grid (ceil(n/TM), d/TN, L*b), blockIdx.z = l*b + batch.
// `in` holds the stack's input lanes with stride `in_lane_stride` between
// lanes (0 for the first stack, whose lanes all start from x).
__global__ void __launch_bounds__(ns2::kThreads)
wavenet_stack_kernel(const float* __restrict__ in, size_t in_lane_stride,
                     const float* __restrict__ conv_w,  // [L, 3d, d] of this stack
                     const float* __restrict__ conv_b,  // [L, d]
                     const float* __restrict__ res_w,   // [L, d, d]
                     const float* __restrict__ res_b,   // [L, d]
                     const float* __restrict__ film,    // [b, S, L, 2d]
                     float* __restrict__ out,           // [L, b, n, d]
                     int b, int n, int d, int S, int L, int s) {
  __shared__ float As[KC][TM];
  __shared__ float Ws[KC][TN];
  __shared__ float Rs[KC][TN];

  const int l = blockIdx.z / b, bi = blockIdx.z % b;
  ns2::wavenet_block_tile(in + l * in_lane_stride + (size_t)bi * n * d,
                          conv_w + (size_t)l * 3 * d * d, conv_b + (size_t)l * d,
                          res_w + (size_t)l * d * d, res_b + (size_t)l * d,
                          film + ((size_t)(bi * S + s) * L + l) * 2 * d,
                          out + ((size_t)l * b + bi) * n * d, n, d, 1 << l, blockIdx.x * TM,
                          blockIdx.y * TN, As, Ws, Rs);
}

// Σ_l lanes[l] · skip_w[l] + skip_b[l]: grid (ceil(n/TM), d/TN, b).
__global__ void __launch_bounds__(ns2::kThreads)
wavenet_skip_kernel(const float* __restrict__ lanes,   // [L, b, n, d]
                    const float* __restrict__ skip_w,  // [L, d, d]
                    const float* __restrict__ skip_b,  // [L, d]
                    float* __restrict__ out,           // [b, n, d]
                    int b, int n, int d, int L) {
  __shared__ float As[KC][TM];
  __shared__ float Ws[KC][TN];

  const int ty = threadIdx.x / ns2::kGrid, tx = threadIdx.x % ns2::kGrid;
  const int t0 = blockIdx.x * TM, n0 = blockIdx.y * TN, bi = blockIdx.z;

  float acc[4][4] = {};
  for (int l = 0; l < L; ++l)
    ns2::tile_gemm(acc, lanes + ((size_t)l * b + bi) * n * d, d, n, t0, 0,
                   skip_w + (size_t)l * d * d, d, n0, d, As, Ws);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      float bias = 0.0f;
      for (int l = 0; l < L; ++l) bias += skip_b[(size_t)l * d + c];
      out[((size_t)bi * n + t) * d + c] = acc[i][j] + bias;
    }
  }
}

}  // namespace

// x [b,n,d] -> out [b,n,d]; lanes_a / lanes_b are [L,b,n,d] f32 scratch.
// Requires d % 64 == 0 (checked by the Python wrapper).
NS2_API int ns2_wavenet_body(const float* x, const float* conv_w, const float* conv_b,
                             const float* res_w, const float* res_b, const float* skip_w,
                             const float* skip_b, const float* film, float* lanes_a,
                             float* lanes_b, float* out, int b, int n, int d, int S, int L,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(ns2::kThreads);
  const dim3 grid_stack((n + TM - 1) / TM, d / TN, L * b);
  const float* in = x;
  size_t in_lane_stride = 0;
  float* bufs[2] = {lanes_a, lanes_b};
  for (int s = 0; s < S; ++s) {
    float* dst = bufs[s % 2];
    wavenet_stack_kernel<<<grid_stack, block, 0, st>>>(
        in, in_lane_stride, conv_w + (size_t)s * L * 3 * d * d, conv_b + (size_t)s * L * d,
        res_w + (size_t)s * L * d * d, res_b + (size_t)s * L * d, film, dst, b, n, d, S, L, s);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    in = dst;
    in_lane_stride = (size_t)b * n * d;
  }
  const dim3 grid_skip((n + TM - 1) / TM, d / TN, b);
  wavenet_skip_kernel<<<grid_skip, block, 0, st>>>(in, skip_w, skip_b, out, b, n, d, L);
  return cudaGetLastError();
}
