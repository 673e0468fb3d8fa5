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
//
// bf16 (`ns2_wavenet_lanes_bf16`, wavenet_kernel.py:167-240 with bf16 x,
// weights and FiLM and `bf16_matmul` off): as K1's bf16 path (wavenet.cu),
// the lane state f32, the products in the core's kSplit2 mode against the
// bf16 weights held as TF32; the skips accumulate in an f32 scratch, as the
// JAX kernel's skip_scratch, and the last lane's launch rounds the sum to
// bf16 as it writes the output.
//
// `bf16_matmul` (`ns2_wavenet_lanes_bf16mm`, wavenet_kernel.py:172 and
// :208-217: the option `_fused_forward_per_lane(..., bf16_matmul=True)`
// threads through, which examples/wavenet_d512_probe.py runs at d 512): f32
// x, biases, FiLM and output, every product on bf16 operands with f32
// accumulation. The same launches run the core's kBf16 mode: its A loader
// reads the f32 lane (or x) through `TapRows` and rounds each value to bf16
// (nearest even) as it stages the chunk, so the lane is rounded at every
// product, the three conv taps and the residual alike, and the stack's
// output before the skip product, where the JAX kernel casts `a` in `dot`;
// B is the weights packed as bf16 (`pack_b(..., "bf16")`), one
// `wgmma.m64n64k16` pass a k-step. The lane state, the gate and the skips'
// sum stay f32. Bound: the products at the dense bf16 rate, 989 TFLOP/s
// (H100 SXM, 700 W), where kSplit3's three TF32 passes run at 165.
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;
using ns2::bf16;

namespace {

// T: the type of x, the biases, FiLM and the output (f32, or bf16 with the
// weights as TF32 in the kSplit2 mode); the lane state and the skips' sum
// `acc` are f32 (for f32, acc may be the output itself).
// M: the core's mode (kSplit3 for f32, kSplit2 for bf16 and mixed, kBf16 for
// `bf16_matmul`); blocks and skip are packed in its B format (Fmt<M>::T).
template <class T,
          gemm::Mode M = (sizeof(T) == 4 ? gemm::Mode::kSplit3 : gemm::Mode::kSplit2)>
int wavenet_lanes(const T* x, const typename gemm::Fmt<M>::T* blocks, const T* conv_b,
                  const T* res_b, const typename gemm::Fmt<M>::T* skip, const T* skip_b,
                  const T* film, float* lane_a,
                  float* lane_b, float* acc, T* out, int b, int n, int d, int S, int L,
                  void* stream) {
  constexpr int kB = gemm::Fmt<M>::kB;
  if (d % gemm::kKC != 0 || b <= 0 || n <= 0 || S <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n, chunks = 3 * d / gemm::kKC, tiles = 2 * d / gemm::kBN;
  const int skip_tiles = (d + gemm::kBN - 1) / gemm::kBN;
  const size_t b_blk = (size_t)tiles * chunks * kB * gemm::kTile;
  const size_t b_skip = (size_t)skip_tiles * (d / gemm::kKC) * kB * gemm::kTile;
  float* bufs[2] = {lane_a, lane_b};
  for (int l = 0; l < L; ++l) {
    const float* in = nullptr;
    for (int s = 0; s < S; ++s) {
      const size_t sl = (size_t)s * L + l;  // block (s, l)
      float* dst = bufs[s % 2];
      const gemm::WaveGate<float, T> gate{dst, conv_b + sl * d, res_b + sl * d,
                                          film + sl * 2 * d, 0, (size_t)S * L * 2 * d, rows, n,
                                          d};
      cudaError_t err =
          s == 0 ? gemm::launch_wn<2, M>(gemm::TapRows<T>{x, rows, n, d, 3, 1 << l, 0, 0},
                                         blocks + sl * b_blk, rows, chunks, tiles, gate, st)
                 : gemm::launch_wn<2, M>(gemm::TapRows<float>{in, rows, n, d, 3, 1 << l, 0, 0},
                                         blocks + sl * b_blk, rows, chunks, tiles, gate, st);
      if (err != cudaSuccess) return err;
      in = dst;
    }
    const gemm::TapRows<float> lane{in, rows, n, d, 1, 0, 0, 0};
    const float* prev = l > 0 ? acc : nullptr;
    cudaError_t err =
        l + 1 < L
            ? gemm::launch_wn<1, M>(lane, skip + l * b_skip, rows, d / gemm::kKC, skip_tiles,
                                    gemm::Store<float, T, float>{acc, skip_b + (size_t)l * d,
                                                                 prev, rows, d, d},
                                    st)
            : gemm::launch_wn<1, M>(lane, skip + l * b_skip, rows, d / gemm::kKC, skip_tiles,
                                    gemm::Store<T, T, float>{out, skip_b + (size_t)l * d, prev,
                                                             rows, d, d},
                                    st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x [b,n,d] -> out [b,n,d], d % 32 == 0; lane_a / lane_b are [b,n,d] f32
// scratch. The packed weights (ops/wavenet_kernel.py: pack_wavenet_weights):
// blocks [S, L] of Bᵀ [2d, 3d] as for ns2_wavenet_body; conv_b, res_b [S,
// L, d]; skip [L] of Bᵀ [d, d] (lane l's skip_wᵀ) in the core's format;
// skip_b [L, d]. The output accumulates the skips.
NS2_API int ns2_wavenet_lanes(const float* x, const float* blocks, const float* conv_b,
                              const float* res_b, const float* skip, const float* skip_b,
                              const float* film, float* lane_a, float* lane_b, float* out, int b,
                              int n, int d, int S, int L, void* stream) {
  return wavenet_lanes(x, blocks, conv_b, res_b, skip, skip_b, film, lane_a, lane_b, out, out,
                       b, n, d, S, L, stream);
}

// Mixed (f32 x and FiLM against bf16 weights): as ns2_wavenet_lanes with
// the biases widened and blocks and skip the bf16 weights packed as TF32
// with no lo part, the products in the kSplit2 mode.
NS2_API int ns2_wavenet_lanes_mixed(const float* x, const float* blocks, const float* conv_b,
                                    const float* res_b, const float* skip, const float* skip_b,
                                    const float* film, float* lane_a, float* lane_b, float* out,
                                    int b, int n, int d, int S, int L, void* stream) {
  return wavenet_lanes<float, gemm::Mode::kSplit2>(x, blocks, conv_b, res_b, skip, skip_b, film,
                                                   lane_a, lane_b, out, out, b, n, d, S, L,
                                                   stream);
}

// The same with x, conv_b, res_b, skip_b, film and out in bf16, blocks and
// skip the bf16 weights packed as TF32 with no lo part; acc is [b,n,d] f32
// scratch for the skips' sum.
NS2_API int ns2_wavenet_lanes_bf16(const bf16* x, const float* blocks, const bf16* conv_b,
                                   const bf16* res_b, const float* skip, const bf16* skip_b,
                                   const bf16* film, float* lane_a, float* lane_b, float* acc,
                                   bf16* out, int b, int n, int d, int S, int L, void* stream) {
  return wavenet_lanes(x, blocks, conv_b, res_b, skip, skip_b, film, lane_a, lane_b, acc, out, b,
                       n, d, S, L, stream);
}

// `bf16_matmul`: as ns2_wavenet_lanes with blocks and skip the weights
// packed as bf16, every product on bf16 operands (the lanes rounded as the
// core stages them) with f32 accumulation.
NS2_API int ns2_wavenet_lanes_bf16mm(const float* x, const bf16* blocks, const float* conv_b,
                                     const float* res_b, const bf16* skip, const float* skip_b,
                                     const float* film, float* lane_a, float* lane_b, float* out,
                                     int b, int n, int d, int S, int L, void* stream) {
  return wavenet_lanes<float, gemm::Mode::kBf16>(x, blocks, conv_b, res_b, skip, skip_b, film,
                                                 lane_a, lane_b, out, out, b, n, d, S, L,
                                                 stream);
}
