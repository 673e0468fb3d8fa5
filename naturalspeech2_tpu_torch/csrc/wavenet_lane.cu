// K1b: the fused WaveNet body, one lane at a time.
//
// Replaces the Pallas kernel `_lane_kernel` (entry `_fused_forward_per_lane`,
// routed by `_forward_dispatch`) in naturalspeech2_tpu/ops/wavenet_kernel.py.
// It computes K1's function (wavenet.cu): for every stack s and layer l,
// with dilation 2^l, the gated, FiLM-conditioned causal conv block with its
// residual, lane l of stack s reading only lane l of stack s - 1; then
// Σ_l lane_l · skip_w[l] + skip_b[l].
//
// What bounds it on the card: f32 multiply-adds on the CUDA cores, as K1.
// At b1 n9000 d128 (4 stacks x 8 layers) one body is about 40 GFLOP
// against 4.6 MB of state per lane, so HBM is not the limit either.
//
// Design: lanes are independent chains, so one lane can run through all S
// stacks before the next one starts. The device state is a ping-pong pair
// of [b, n, d] f32 buffers plus the output, which accumulates the skips:
// 3·b·n·d·4 bytes (13.8 MB at b1 n9000 d128), against K1's [2, L, b, n, d]
// lanes (73.7 MB). Both kernels are bound by their multiply-adds, not by
// memory, so the smaller state buys no speed: K1b runs where the JAX
// package runs `_lane_kernel` (ops/wavenet_kernel.py:wavenet_route), and
// is slower than K1 there, as its launches are one wave and a tail at b1.
// Each (lane, stack)
// is one launch of 64-row x 64-column tiles, each one GEMM over K = 3d with
// the residual GEMM, FiLM and the gate in the epilogue
// (`wavenet_block_tile`, shared with K1). After a lane's last stack, one
// skip launch adds lane · skip_w[l] + skip_b[l] into the output; lanes go
// in order, so the sum is deterministic without atomics. L·S + L launches
// in all.
#include "wavenet.cuh"

namespace {

using ns2::KC;
using ns2::TM;
using ns2::TN;

// One block of one lane: grid (ceil(n/TM), d/TN, b). `in` / `out` are
// [b, n, d]; the weights are those of block (s, l); `film` points at
// film[0, s, l] and batch rows are `film_stride` apart.
__global__ void __launch_bounds__(ns2::kThreads)
lane_block_kernel(const float* __restrict__ in, const float* __restrict__ cw,
                  const float* __restrict__ cb, const float* __restrict__ rw,
                  const float* __restrict__ rb, const float* __restrict__ film,
                  size_t film_stride, float* __restrict__ out, int n, int d, int dil) {
  __shared__ float As[KC][TM];
  __shared__ float Ws[KC][TN];
  __shared__ float Rs[KC][TN];

  const size_t row = (size_t)blockIdx.z * n * d;
  ns2::wavenet_block_tile(in + row, cw, cb, rw, rb, film + blockIdx.z * film_stride, out + row,
                          n, d, dil, blockIdx.x * TM, blockIdx.y * TN, As, Ws, Rs);
}

// out (+)= lane · w + bias, the skip of one lane: grid (ceil(n/TM), d/TN, b).
// The first lane writes, later lanes add.
__global__ void __launch_bounds__(ns2::kThreads)
lane_skip_kernel(const float* __restrict__ lane,  // [b, n, d]
                 const float* __restrict__ w,     // [d, d]
                 const float* __restrict__ bias,  // [d]
                 float* __restrict__ out,         // [b, n, d]
                 int n, int d, int accumulate) {
  __shared__ float As[KC][TM];
  __shared__ float Ws[KC][TN];

  const int ty = threadIdx.x / ns2::kGrid, tx = threadIdx.x % ns2::kGrid;
  const int t0 = blockIdx.x * TM, n0 = blockIdx.y * TN;
  const size_t row = (size_t)blockIdx.z * n * d;

  float acc[4][4] = {};
  ns2::tile_gemm(acc, lane + row, d, n, t0, 0, w, d, n0, d, As, Ws);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      float* o = out + row + (size_t)t * d + c;
      const float skip = acc[i][j] + bias[c];
      *o = accumulate ? *o + skip : skip;
    }
  }
}

}  // namespace

// x [b,n,d] -> out [b,n,d]; lane_a / lane_b are [b,n,d] f32 scratch. The
// weights are laid out as for ns2_wavenet_body. Requires d % 64 == 0
// (checked by the Python wrapper).
NS2_API int ns2_wavenet_lanes(const float* x, const float* conv_w, const float* conv_b,
                              const float* res_w, const float* res_b, const float* skip_w,
                              const float* skip_b, const float* film, float* lane_a,
                              float* lane_b, float* out, int b, int n, int d, int S, int L,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(ns2::kThreads);
  const dim3 grid((n + TM - 1) / TM, d / TN, b);
  float* bufs[2] = {lane_a, lane_b};
  for (int l = 0; l < L; ++l) {
    const float* in = x;
    for (int s = 0; s < S; ++s) {
      const size_t sl = (size_t)s * L + l;  // block (s, l)
      float* dst = bufs[s % 2];
      lane_block_kernel<<<grid, block, 0, st>>>(
          in, conv_w + sl * 3 * d * d, conv_b + sl * d, res_w + sl * d * d, res_b + sl * d,
          film + sl * 2 * d, (size_t)S * L * 2 * d, dst, n, d, 1 << l);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      in = dst;
    }
    lane_skip_kernel<<<grid, block, 0, st>>>(in, skip_w + (size_t)l * d * d, skip_b + (size_t)l * d,
                                             out, n, d, l > 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
