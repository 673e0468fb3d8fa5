// K1: the fused WaveNet body of the denoiser.
//
// Replaces the Pallas kernel `_wavenet_kernel` (entry `fused_wavenet_body`)
// in naturalspeech2_tpu/ops/wavenet_kernel.py. For every stack s and layer
// l, with dilation δ = 2^l:
//   y   = [x_{t-2δ} | x_{t-δ} | x_t] · conv_w[s,l] + conv_b[s,l]
//   y   = y · film_γ[b,s,l] + film_β[b,s,l];   g = tanh(y) · sigmoid(y)
//   out = g + x · res_w[s,l] + res_b[s,l]      (lane l of the next stack)
// and the last stack's lanes give Σ_l lane_l · skip_w[l] + skip_b[l].
//
// What bounds it on the card: the matrix products. At the flagship shape
// (b4 n1024 d128, 4 stacks x 8 layers) one body is 18.3 GFLOP of them
// against 33 lanes of 2 MB read and written, far past the ridge; the
// fastest f32-accurate rate the H100 has is split TF32 on the tensor cores,
// 165 TFLOP/s (H100 SXM, 700 W).
//
// Design: the TPU kernel keeps all 8 lanes resident in VMEM (4 MB f32),
// far beyond a block's 227 KB of shared memory, and its grid runs the
// stacks in order. Here the lanes live in device memory as f32 [L,b,n,d]
// and ping-pong between two buffers, one launch per stack: a block reads
// the causal halo (2δ rows) of the previous stack's buffer, so updating
// in place would race. Every product runs on the split-TF32 `wgmma` GEMM
// core (gemm_tf32x3.cuh):
//  - a stack is one launch whose grid z is the L lanes: lane l's block is
//    one GEMM over K = 3d, A the three row views of its input shifted by
//    2δ, δ and 0 (rows before t = 0 read as zero; the `TapRows` loader) and
//    B [3d, 2d], packed once per parameter version (ops/wavenet_kernel.py):
//    each 64-column tile holds 32 conv columns and the same 32 residual
//    columns, whose rows are zero on taps 0 and 1. So the residual GEMM
//    shares A's tile and its staging, at 6d² products a row for the 4d²
//    the block needs: the core is bound by staging, and running the first
//    two taps' chunks on the conv columns alone (m64n32k8) was no faster
//    (gemm_variants.py). The `WaveGate` epilogue adds the bias,
//    applies FiLM and the gate and writes the lane. A block is two
//    warpgroups sharing A's tile, two blocks an SM: at d 128 each A tile
//    is staged twice for its four column tiles, not four times (28 % less
//    time at the flagship than one warpgroup a block, gemm_variants.py);
//  - the skips are one GEMM with K = L·d over the last stack's lanes side
//    by side, B = skip_w as [L·d, d] and the bias Σ_l skip_b[l], so the sum
//    is deterministic without atomics.
// S + 1 launches in all.
//
// bf16 (`ns2_wavenet_body_bf16`, wavenet_kernel.py:80-129 with bf16 x,
// weights and FiLM): the JAX kernel keeps its lanes in f32 scratch and
// multiplies them by the bf16 weights with f32 accumulation, rounding only
// its output to bf16. So do these launches: the lanes stay f32 (the first
// stack reads x as bf16), the gate reads bf16 biases and FiLM, and the
// products run in the core's kSplit2 mode, the lanes split into TF32 hi and
// lo against the bf16 weights held as TF32 (exact), two passes where f32
// weights need three; the skips' sum is rounded to bf16 once.
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;
using ns2::bf16;

namespace {

// T: the type of x, the biases, FiLM and the output (f32, or bf16 with the
// weights as TF32 in the kSplit2 mode); the lanes are f32 either way. M:
// the core's mode, kSplit2 also for the mixed entry point (f32 x against
// bf16 weights).
template <class T,
          gemm::Mode M = (sizeof(T) == 4 ? gemm::Mode::kSplit3 : gemm::Mode::kSplit2)>
int wavenet_body(const T* x, const float* blocks, const T* conv_b, const T* res_b,
                 const float* skip, const float* skip_b, const T* film, float* lanes_a,
                 float* lanes_b, T* out, int b, int n, int d, int S, int L, void* stream) {
  constexpr int kB = gemm::Fmt<M>::kB;
  if (d % gemm::kKC != 0 || b <= 0 || n <= 0 || S <= 0 || L <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n, chunks = 3 * d / gemm::kKC, tiles = 2 * d / gemm::kBN;
  const size_t lane = (size_t)rows * d, b_blk = (size_t)tiles * chunks * kB * gemm::kTile;
  const float* in = lanes_a;
  float* bufs[2] = {lanes_a, lanes_b};
  for (int s = 0; s < S; ++s) {
    float* dst = bufs[s % 2];
    const size_t sl = (size_t)s * L;
    const gemm::Groups g{L, b_blk};
    const gemm::WaveGate<float, T> gate{dst, conv_b + sl * d, res_b + sl * d, film + sl * 2 * d,
                                        lane, (size_t)S * L * 2 * d, rows, n, d};
    // the first stack's lanes all read x
    cudaError_t err =
        s == 0 ? gemm::launch_wn<2, M>(gemm::TapRows<T>{x, rows, n, d, 3, 1, 0, 0},
                                       blocks + sl * b_blk, rows, chunks, tiles, gate, st, g)
               : gemm::launch_wn<2, M>(gemm::TapRows<float>{in, rows, n, d, 3, 1, 0, lane},
                                       blocks + sl * b_blk, rows, chunks, tiles, gate, st, g);
    if (err != cudaSuccess) return err;
    in = dst;
  }
  return gemm::launch<M>(gemm::TapRows<float>{in, rows, n, d, L, 0, lane, 0}, skip, rows,
                         L * d / gemm::kKC, (d + gemm::kBN - 1) / gemm::kBN,
                         gemm::Store<T, float, float>{out, skip_b, nullptr, rows, d, d}, st);
}

}  // namespace

// x [b,n,d] -> out [b,n,d], d % 32 == 0. The packed weights
// (ops/wavenet_kernel.py: pack_wavenet_weights): blocks [S, L] of Bᵀ [2d,
// 3d] in the core's format, b_blk floats each; conv_b, res_b [S, L, d];
// skip (Bᵀ [d, L·d]) and skip_b the sum of the lanes' biases [d]. film [b,
// S, L, 2d]. lanes_a / lanes_b are [L,b,n,d] f32 scratch.
NS2_API int ns2_wavenet_body(const float* x, const float* blocks, const float* conv_b,
                             const float* res_b, const float* skip, const float* skip_b,
                             const float* film, float* lanes_a, float* lanes_b, float* out, int b,
                             int n, int d, int S, int L, void* stream) {
  return wavenet_body(x, blocks, conv_b, res_b, skip, skip_b, film, lanes_a, lanes_b, out, b, n,
                      d, S, L, stream);
}

// Mixed (AMP training's denoiser, wavenet_kernel.py:80-129 with f32 x and
// FiLM against bf16 weights): every pointer f32, the biases widened, blocks
// and skip the bf16 weights packed as TF32 with no lo part, the products in
// the kSplit2 mode; the JAX kernel's products promote the weights to f32.
NS2_API int ns2_wavenet_body_mixed(const float* x, const float* blocks, const float* conv_b,
                                   const float* res_b, const float* skip, const float* skip_b,
                                   const float* film, float* lanes_a, float* lanes_b, float* out,
                                   int b, int n, int d, int S, int L, void* stream) {
  return wavenet_body<float, gemm::Mode::kSplit2>(x, blocks, conv_b, res_b, skip, skip_b, film,
                                                  lanes_a, lanes_b, out, b, n, d, S, L, stream);
}

// The same with x, conv_b, res_b, film and out in bf16, blocks and skip the
// bf16 weights packed as TF32 with no lo part, skip_b their f32 sum.
NS2_API int ns2_wavenet_body_bf16(const bf16* x, const float* blocks, const bf16* conv_b,
                                  const bf16* res_b, const float* skip, const float* skip_b,
                                  const bf16* film, float* lanes_a, float* lanes_b, bf16* out,
                                  int b, int n, int d, int S, int L, void* stream) {
  return wavenet_body(x, blocks, conv_b, res_b, skip, skip_b, film, lanes_a, lanes_b, out, b, n,
                      d, S, L, stream);
}
