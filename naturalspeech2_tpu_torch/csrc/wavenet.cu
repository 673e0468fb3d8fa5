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
// Mixed (`ns2_wavenet_body_mixed`, AMP training's denoiser: f32 x, biases
// and FiLM against bf16 weights, the JAX kernel's products promoting the
// weights to f32): the bf16 path below with x split into three planes too
// by a pre-pass (`split3_kernel`), the gate on the f32 biases and FiLM and
// the skips' sum stored in f32; the weights packed "bf16_sw128", exact for
// bf16 weights. S + 2 launches.
//
// bf16 (`ns2_wavenet_body_bf16`, wavenet_kernel.py:80-129 with bf16 x,
// weights and FiLM): the JAX kernel keeps its lanes in f32 scratch and
// multiplies them by the bf16 weights with f32 products, rounding only its
// output to bf16. Here the same S + 1 launches run on the bf16 GEMM core
// (gemm_bf16.cuh: TMA copies of A and B, a 4-stage ring, bf16 `wgmma` with
// f32 accumulation) with each f32 lane carried as three bf16 planes, hi,
// mid and lo, which sum to it exactly (lanes [L·b, 3, n, d], d padded to
// 64, ping-ponged): each part times a bf16 weight is exact in f32, so a
// block is three bf16 passes over one B (K = 3 parts · 3 taps · d, the
// parts lo first; the first stack reads x as one part). A stack's L lanes
// are one launch, folded into the grid's rows (`SplitTaps`: the lane of a
// row tile sets its dilation and its block); `WaveGateSplit` computes the
// gate in f32 and writes the three planes. The skips are one launch with K
// = 3 parts · L · d against skip_w [L·d, d] (`SplitLanes`), the bias Σ_l
// skip_b[l] in f32, the output rounded to bf16 once. Each distinct tensor
// map (x, the two plane buffers, every block's B, the skips' A and B) is
// encoded once a call. What bounds these blocks on the card is their
// epilogue, one block an SM: a gate of two transcendentals a value and
// three planes to store (staged in shared memory, stored by TMA). Taken
// out, the gate's math alone cut K1 at b4 n1024 d128 by about a quarter
// (gemm_variants.py's k1_bf16_no_gate); 64 x 128 tiles two an SM, to run
// one block's epilogue beside the other's products, were slower
// (k1_bf16_tile_64x128; PERF.md).
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;
namespace bgemm = ns2::bgemm;
using ns2::bf16;

namespace {

// The f32 body on the split-TF32 core; the lanes f32 [L, b, n, d].
int wavenet_body(const float* x, const float* blocks, const float* conv_b, const float* res_b,
                 const float* skip, const float* skip_b, const float* film, float* lanes_a,
                 float* lanes_b, float* out, int b, int n, int d, int S, int L, void* stream) {
  constexpr int kB = gemm::kBParts;
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
    const gemm::WaveGate gate{dst, conv_b + sl * d, res_b + sl * d, film + sl * 2 * d,
                              lane, (size_t)S * L * 2 * d, rows, n, d};
    // the first stack's lanes all read x
    const gemm::TapRows taps = s == 0 ? gemm::TapRows{x, rows, n, d, 3, 1, 0, 0}
                                      : gemm::TapRows{in, rows, n, d, 3, 1, 0, lane};
    cudaError_t err =
        gemm::launch_wn<2>(taps, blocks + sl * b_blk, rows, chunks, tiles, gate, st, g);
    if (err != cudaSuccess) return err;
    in = dst;
  }
  return gemm::launch(gemm::TapRows{in, rows, n, d, L, 0, lane, 0}, skip, rows,
                      L * d / gemm::kKC, (d + gemm::kBN - 1) / gemm::kBN,
                      gemm::Store{out, skip_b, nullptr, rows, d, d}, st);
}

// The body on the bf16 core: x16 the planes [b, x_parts, n, d] the first
// stack reads (bf16 x as one part; the mixed entry's f32 x as three), the
// biases and FiLM of P (bf16, or f32 for the mixed entry), the output of P.
template <class P>
int body_on_bf16_core(const bf16* x16, int x_parts, const bf16* blocks, const P* conv_b,
                      const P* res_b, const bf16* skip, const float* skip_b, const P* film,
                      bf16* planes_a, bf16* planes_b, P* out, int b, int n, int d, int S, int L,
                      cudaStream_t st) {
  const int per_part = 3 * d / bgemm::kKC;  // chunks of one part of a block
  const bgemm::Shape sh = bgemm::choose(L * b, n, 2 * d, true);
  CUtensorMap map_x, map_planes[2], map_out[2], map_blocks;
  bf16* planes[2] = {planes_a, planes_b};
  cudaError_t err = bgemm::rows_map(&map_x, x16, b, x_parts, n, d, d, sh.bm);
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = bgemm::rows_map(&map_planes[i], planes[i], L * b, 3, n, d, d, sh.bm);
    if (err == cudaSuccess) err = bgemm::planes_map(&map_out[i], planes[i], L * b, 3, n, d);
  }
  if (err == cudaSuccess) err = bgemm::b_map(&map_blocks, blocks, 2 * d, S * L * per_part, sh.bn);
  for (int s = 0; s < S && err == cudaSuccess; ++s) {
    const size_t sl = (size_t)s * L;
    const bgemm::WaveGateSplit<3, P> gate{map_out[s % 2], conv_b + sl * d, res_b + sl * d,
                                          film + sl * 2 * d, (size_t)S * L * 2 * d, b, n, d};
    const bgemm::SplitTaps taps{L * b, n, d, b, 0, s == 0 ? x_parts : 3, s == 0,
                                (int)sl * per_part};
    err = bgemm::launch_at(sh, s == 0 ? map_x : map_planes[(s - 1) % 2], map_blocks, taps,
                           2 * d, taps.parts * per_part, gate, st);
  }
  if (err != cudaSuccess) return err;
  // the skips: the last stack's planes, every lane side by side
  const bgemm::Shape sk = bgemm::choose(b, n, d);
  CUtensorMap map_lanes, map_skip;
  err = bgemm::rows_map(&map_lanes, planes[(S - 1) % 2], L * b, 3, n, d, d, sk.bm);
  if (err == cudaSuccess) err = bgemm::b_map(&map_skip, skip, d, L * d / bgemm::kKC, sk.bn);
  if (err != cudaSuccess) return err;
  return bgemm::launch_at(sk, map_lanes, map_skip, bgemm::SplitLanes{b, n, d, L, 3, 0, 0}, d,
                          3 * L * d / bgemm::kKC,
                          bgemm::Store<P, float>{out, skip_b, nullptr, d, d}, st);
}

bool body_ok(int b, int n, int d, int S, int L) {
  return d % bgemm::kKC == 0 && b > 0 && n > 0 && S > 0 && L > 0;
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
// FiLM against bf16 weights, whose products the JAX kernel promotes to f32)
// on the bf16 core: x, conv_b, res_b, skip_b, film and out f32, d % 64 ==
// 0; blocks and skip the bf16 weights packed "bf16_sw128" as for
// ns2_wavenet_body_bf16; x_planes [b, 3, n, d] bf16 scratch for x's three
// planes, planes_a / planes_b [L·b, 3, n, d] bf16 scratch. A pre-pass splits
// x into its planes, then the bf16 entry's launches run with three parts of
// x and the gate on the f32 biases and FiLM (staged in shared memory), the
// skips' sum stored in f32: S + 2 launches.
NS2_API int ns2_wavenet_body_mixed(const float* x, const bf16* blocks, const float* conv_b,
                                   const float* res_b, const bf16* skip, const float* skip_b,
                                   const float* film, bf16* x_planes, bf16* planes_a,
                                   bf16* planes_b, float* out, int b, int n, int d, int S, int L,
                                   void* stream) {
  if (!body_ok(b, n, d, S, L)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bgemm::split_planes(x, x_planes, b, n, d, d, st);
  if (err != cudaSuccess) return err;
  return body_on_bf16_core(x_planes, 3, blocks, conv_b, res_b, skip, skip_b, film, planes_a,
                           planes_b, out, b, n, d, S, L, st);
}

// bf16 on the bf16 core: x [b,n,d], conv_b, res_b, film and out bf16, d %
// 64 == 0; blocks the [S, L] Bᵀ [2d, 3d] packed "bf16_sw128" (one run of
// S·L·3d/64 chunks), skip Bᵀ [d, L·d] packed so, skip_b the f32 sum of the
// lanes' biases [d]; planes_a / planes_b [L·b, 3, n, d] bf16 scratch.
NS2_API int ns2_wavenet_body_bf16(const bf16* x, const bf16* blocks, const bf16* conv_b,
                                  const bf16* res_b, const bf16* skip, const float* skip_b,
                                  const bf16* film, bf16* planes_a, bf16* planes_b, bf16* out,
                                  int b, int n, int d, int S, int L, void* stream) {
  if (!body_ok(b, n, d, S, L)) return cudaErrorInvalidValue;
  return body_on_bf16_core(x, 1, blocks, conv_b, res_b, skip, skip_b, film, planes_a, planes_b,
                           out, b, n, d, S, L, static_cast<cudaStream_t>(stream));
}
