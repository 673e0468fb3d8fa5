// K1b: the fused WaveNet body, one lane at a time.
//
// Replaces the Pallas kernel `_lane_kernel` (entry `_fused_forward_per_lane`,
// routed by `_forward_dispatch`) in naturalspeech2_tpu/ops/wavenet_kernel.py.
// It computes K1's function (wavenet.cu): for every stack s and layer l,
// with dilation 2^l, the gated, FiLM-conditioned causal conv block with its
// residual, lane l of stack s reading only lane l of stack s - 1; then
// Σ_l lane_l · skip_w[l] + skip_b[l].
//
// What bounds it on the card: the matrix products, as K1's. At b1 n9000
// d128 (4 stacks x 8 layers) one body is 40 GFLOP of them against 4.6 MB
// of state per lane.
//
// Design: lanes are independent chains, so one lane can run through all S
// stacks before the next one starts. The device state is a ping-pong pair
// of [b, n, d] f32 buffers plus the output, which accumulates the skips:
// 3·b·n·d·4 bytes (13.8 MB at b1 n9000 d128), against K1's [2, L, b, n, d]
// lanes (73.7 MB). K1b runs where the JAX package runs `_lane_kernel`
// (ops/wavenet_kernel.py:wavenet_route). Each (lane, stack) is one launch
// of the split-TF32 `wgmma` GEMM core (gemm_tf32x3.cuh) with K1's operands:
// the three dilated row views of the lane (`TapRows`), the packed [3d, 2d]
// block weight with interleaved conv and residual columns, and the FiLM
// gate in the `WaveGate` epilogue, two warpgroups a block sharing A's tile
// as in K1.
// After a lane's last stack, one launch of the core adds lane · skip_w[l] +
// skip_b[l] into the output through the `Store` epilogue with the output as
// its residual; lanes go in order, so the sum is deterministic without
// atomics. L·S + L launches in all.
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;

// x [b,n,d] -> out [b,n,d], d % 32 == 0; lane_a / lane_b are [b,n,d] f32
// scratch. The packed weights (ops/wavenet_kernel.py: pack_wavenet_weights):
// blocks [S, L] of Bᵀ [2d, 3d] as for ns2_wavenet_body; conv_b, res_b [S,
// L, d]; skip [L] of Bᵀ [d, d] (lane l's skip_wᵀ) in the core's format;
// skip_b [L, d].
NS2_API int ns2_wavenet_lanes(const float* x, const float* blocks, const float* conv_b,
                              const float* res_b, const float* skip, const float* skip_b,
                              const float* film, float* lane_a, float* lane_b, float* out, int b,
                              int n, int d, int S, int L, void* stream) {
  if (d % gemm::kKC != 0 || b <= 0 || n <= 0 || S <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n, chunks = 3 * d / gemm::kKC, tiles = 2 * d / gemm::kBN;
  const int skip_tiles = (d + gemm::kBN - 1) / gemm::kBN;
  const size_t b_blk = (size_t)tiles * chunks * 2 * gemm::kTile;
  const size_t b_skip = (size_t)skip_tiles * (d / gemm::kKC) * 2 * gemm::kTile;
  float* bufs[2] = {lane_a, lane_b};
  for (int l = 0; l < L; ++l) {
    const float* in = x;
    for (int s = 0; s < S; ++s) {
      const size_t sl = (size_t)s * L + l;  // block (s, l)
      float* dst = bufs[s % 2];
      cudaError_t err = gemm::launch_wn<2>(
          gemm::TapRows{in, rows, n, d, 3, 1 << l, 0, 0}, blocks + sl * b_blk, rows, chunks,
          tiles,
          gemm::WaveGate{dst, conv_b + sl * d, res_b + sl * d, film + sl * 2 * d, 0,
                         (size_t)S * L * 2 * d, rows, n, d},
          st);
      if (err != cudaSuccess) return err;
      in = dst;
    }
    cudaError_t err = gemm::launch_wn<1>(
        gemm::TapRows{in, rows, n, d, 1, 0, 0, 0}, skip + l * b_skip, rows, d / gemm::kKC,
        skip_tiles, gemm::Store{out, skip_b + (size_t)l * d, l > 0 ? out : nullptr, rows, d, d},
        st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
