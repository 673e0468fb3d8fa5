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
// weights and FiLM and `bf16_matmul` off): the JAX kernel's lane state is
// f32, its products f32 against the bf16 weights, its skips summed in f32
// and the output rounded once. As K1's bf16 path (wavenet.cu), the
// launches run on the bf16 GEMM core (gemm_bf16.cuh) with the lane carried
// as three bf16 planes [b, 3, n, d] (d padded to 64), ping-ponged, each
// block three bf16 passes over its B (`SplitTaps`, `WaveGateSplit`). A
// launch takes kLaneGroup lanes (their planes [kLaneGroup·b, 3, n, d], the
// lanes folded into the grid's rows as K1 folds a stack's); the skips stay
// one launch a lane, in lane order, each adding lane · skip_w[l] +
// skip_b[l] into the f32 scratch `acc` (`Store` with acc as its residual),
// the last lane's rounding the sum to bf16 as it writes the output. Every
// tensor map (x, the two plane buffers, all S·L blocks' B as one run, the
// skips' A and B) is encoded once a call, for its L·S / kLaneGroup + L
// launches.
//
// `bf16_matmul` (`ns2_wavenet_lanes_bf16mm`, wavenet_kernel.py:172 and
// :208-217: the option `_fused_forward_per_lane(..., bf16_matmul=True)`
// threads through, which examples/wavenet_d512_probe.py runs at d 512): f32
// x, biases, FiLM and output, both operands of every product cast to bf16
// (nearest even), f32 accumulation. The lane (or x) enters a stack only
// through its products (the three conv taps, the residual, the skip), so
// one bf16 plane a lane, bf16(v), is every operand the JAX kernel
// multiplies, bit for bit. So the bf16 path's launches with one part: a
// rounding pre-pass writes x as bf16 [b, n, d], the blocks run one bf16
// pass each (`SplitTaps` with parts 1) against the f32 weights rounded to
// bf16 as they are packed ("bf16_sw128"), kLaneGroup lanes a launch,
// `WaveGateSplit<1, float>` computing the gate in f32 on the f32 biases and
// FiLM (the tile's columns staged in shared memory first) and storing
// bf16(v) into planes [kLaneGroup·b, 1, n, d] by TMA; the skips one
// launch a lane, in lane order, adding lane · skip_w[l] + skip_b[l] into the
// f32 output, its own residual from the second lane on. S·L / kLaneGroup +
// L + 1 launches. Bound: the products at the dense bf16 rate, 989 TFLOP/s
// (H100 SXM, 700 W), a third of the bf16 path's, whose lanes take three
// passes.
//
// Mixed (`ns2_wavenet_lanes_mixed`, wavenet_kernel.py:167-240 with f32 x and
// FiLM against bf16 weights, whose products the JAX kernel promotes to
// f32): the bf16 path's launches with the f32 parameters, as K1's mixed
// entry (wavenet.cu): a pre-pass splits x into its three planes [b, 3, n,
// d] (`split_planes`), the first stack reads three parts of x, the gate
// runs on the f32 biases and FiLM (`WaveGateSplit<3, float>`, the tile's
// columns staged in shared memory first), and the skips are summed into the
// f32 output, its own residual from the second lane on, as `bf16_matmul`
// sums them. 1 + S·L / kLaneGroup + L launches.
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;
namespace bgemm = ns2::bgemm;
using ns2::bf16;

namespace {

// Lanes a launch of the bf16 path's blocks: one lane at b1 n9000 d128 is
// 71 row tiles of 128, a wave at half the 132 SMs; four fill the card
// better, at four lanes' planes (55 MB at n9000): gemm_variants.py's
// k1b_bf16_one_lane and k1b_bf16_two_lanes were slower (PERF.md).
constexpr int kLaneGroup = 4;

// The lanes on the split-TF32 core, f32 in and out; blocks and skip packed
// in its B format. The lane state and the skips' sum are f32, the sum in
// the output.
int wavenet_lanes(const float* x, const float* blocks, const float* conv_b, const float* res_b,
                  const float* skip, const float* skip_b, const float* film, float* lane_a,
                  float* lane_b, float* out, int b, int n, int d, int S, int L, void* stream) {
  constexpr int kB = gemm::kBParts;
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
      const gemm::WaveGate gate{dst, conv_b + sl * d, res_b + sl * d, film + sl * 2 * d, 0,
                                (size_t)S * L * 2 * d, rows, n, d};
      const gemm::TapRows taps{s == 0 ? x : in, rows, n, d, 3, 1 << l, 0, 0};
      cudaError_t err =
          gemm::launch_wn<2>(taps, blocks + sl * b_blk, rows, chunks, tiles, gate, st);
      if (err != cudaSuccess) return err;
      in = dst;
    }
    const gemm::TapRows lane{in, rows, n, d, 1, 0, 0, 0};
    const cudaError_t err = gemm::launch_wn<1>(
        lane, skip + l * b_skip, rows, d / gemm::kKC, skip_tiles,
        gemm::Store{out, skip_b + (size_t)l * d, l > 0 ? out : nullptr, rows, d, d}, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The lanes on the bf16 core, Parts planes a lane (3: K1b in bf16 and
// mixed, hi, mid and lo of the f32 lane; 1: `bf16_matmul`, bf16(v)): x16 the
// planes [b, x_parts, n, d] the first stack reads (bf16 x, or `bf16_matmul`'s
// rounded x, as one part; the mixed entry's f32 x as three); planes_a /
// planes_b [kLaneGroup·b, Parts, n, d] bf16; the biases, FiLM and skip_b of
// P (bf16, or f32 for `bf16_matmul` and the mixed entry); the skips summed
// in f32 into acc [b, n, d], the last lane's sum stored to out (bf16, or the
// f32 acc itself).
template <int Parts, class P, class Out>
int lanes_on_bf16_core(const bf16* x16, int x_parts, const bf16* blocks, const P* conv_b,
                       const P* res_b, const bf16* skip, const P* skip_b, const P* film,
                       bf16* planes_a, bf16* planes_b, float* acc, Out* out, int b, int n, int d,
                       int S, int L, cudaStream_t st) {
  const int per_part = 3 * d / bgemm::kKC, skip_chunks = d / bgemm::kKC;
  const bgemm::Shape sh = bgemm::choose(kLaneGroup * b, n, 2 * d, true);
  const bgemm::Shape sk = bgemm::choose(b, n, d);
  bf16* planes[2] = {planes_a, planes_b};
  CUtensorMap map_x, map_planes[2], map_out[2], map_blocks, map_lane, map_skip;
  cudaError_t err = bgemm::rows_map(&map_x, x16, b, x_parts, n, d, d, sh.bm);
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    err = bgemm::rows_map(&map_planes[i], planes[i], kLaneGroup * b, Parts, n, d, d, sh.bm);
    if (err == cudaSuccess)
      err = bgemm::planes_map(&map_out[i], planes[i], kLaneGroup * b, Parts, n, d);
  }
  if (err == cudaSuccess) err = bgemm::b_map(&map_blocks, blocks, 2 * d, S * L * per_part, sh.bn);
  // the skips read the last stack's planes
  if (err == cudaSuccess)
    err = bgemm::rows_map(&map_lane, planes[(S - 1) % 2], kLaneGroup * b, Parts, n, d, d, sk.bm);
  if (err == cudaSuccess) err = bgemm::b_map(&map_skip, skip, d, L * skip_chunks, sk.bn);
  for (int l0 = 0; l0 < L && err == cudaSuccess; l0 += kLaneGroup) {
    const int lanes = L - l0 < kLaneGroup ? L - l0 : kLaneGroup;
    for (int s = 0; s < S && err == cudaSuccess; ++s) {
      const size_t sl = (size_t)s * L + l0;  // block (s, l0)
      const bgemm::WaveGateSplit<Parts, P> gate{map_out[s % 2], conv_b + sl * d, res_b + sl * d,
                                                film + sl * 2 * d, (size_t)S * L * 2 * d, b, n, d};
      const bgemm::SplitTaps taps{lanes * b, n, d, b, l0, s == 0 ? x_parts : Parts, s == 0,
                                  (int)sl * per_part};
      err = bgemm::launch_at(sh, s == 0 ? map_x : map_planes[(s - 1) % 2], map_blocks, taps,
                             2 * d, taps.parts * per_part, gate, st);
    }
    for (int g = 0; g < lanes && err == cudaSuccess; ++g) {
      const int l = l0 + g;
      const bgemm::SplitLanes lane{b, n, d, 1, Parts, g, l * skip_chunks};
      const float* prev = l > 0 ? acc : nullptr;
      err = l + 1 < L
                ? bgemm::launch_at(sk, map_lane, map_skip, lane, d, Parts * skip_chunks,
                                   bgemm::Store<float, P, float>{acc, skip_b + (size_t)l * d,
                                                                 prev, d, d},
                                   st)
                : bgemm::launch_at(sk, map_lane, map_skip, lane, d, Parts * skip_chunks,
                                   bgemm::Store<Out, P, float>{out, skip_b + (size_t)l * d, prev,
                                                               d, d},
                                   st);
    }
  }
  return err;
}

bool lanes_ok(int b, int n, int d, int S, int L) {
  return d % bgemm::kKC == 0 && b > 0 && n > 0 && S > 0 && L > 0;
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
  return wavenet_lanes(x, blocks, conv_b, res_b, skip, skip_b, film, lane_a, lane_b, out, b, n, d,
                       S, L, stream);
}

// Mixed (see the top of this file): x, conv_b, res_b, skip_b, film and out
// f32, d % 64 == 0; blocks and skip the bf16 weights packed "bf16_sw128" as
// for ns2_wavenet_lanes_bf16; x_planes [b, 3, n, d] bf16 scratch for x's
// three planes, planes_a / planes_b [kLaneGroup·b, 3, n, d] bf16 scratch.
// 1 + S·L / kLaneGroup + L launches.
NS2_API int ns2_wavenet_lanes_mixed(const float* x, const bf16* blocks, const float* conv_b,
                                    const float* res_b, const bf16* skip, const float* skip_b,
                                    const float* film, bf16* x_planes, bf16* planes_a,
                                    bf16* planes_b, float* out, int b, int n, int d, int S,
                                    int L, void* stream) {
  if (!lanes_ok(b, n, d, S, L)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bgemm::split_planes(x, x_planes, b, n, d, d, st);
  if (err != cudaSuccess) return err;
  return lanes_on_bf16_core<3>(x_planes, 3, blocks, conv_b, res_b, skip, skip_b, film, planes_a,
                               planes_b, out, out, b, n, d, S, L, st);
}

// bf16 on the bf16 core: x, conv_b, res_b, skip_b, film and out bf16, d %
// 64 == 0; blocks the [S, L] Bᵀ [2d, 3d] packed "bf16_sw128" (one run of
// S·L·3d/64 chunks), skip the [L] Bᵀ [d, d] packed so; planes_a / planes_b
// [kLaneGroup·b, 3, n, d] bf16 scratch, acc [b,n,d] f32 scratch for the
// skips' sum.
NS2_API int ns2_wavenet_lanes_bf16(const bf16* x, const bf16* blocks, const bf16* conv_b,
                                   const bf16* res_b, const bf16* skip, const bf16* skip_b,
                                   const bf16* film, bf16* planes_a, bf16* planes_b, float* acc,
                                   bf16* out, int b, int n, int d, int S, int L, void* stream) {
  if (!lanes_ok(b, n, d, S, L)) return cudaErrorInvalidValue;
  return lanes_on_bf16_core<3>(x, 1, blocks, conv_b, res_b, skip, skip_b, film, planes_a,
                               planes_b, acc, out, b, n, d, S, L,
                               static_cast<cudaStream_t>(stream));
}

// `bf16_matmul` on the bf16 core: x, conv_b, res_b, skip_b, film and out
// f32, d % 64 == 0; blocks and skip the f32 weights rounded to bf16 and
// packed "bf16_sw128" as for ns2_wavenet_lanes_bf16; x16 [b, n, d] bf16
// scratch for the rounded x, planes_a / planes_b [kLaneGroup·b, 1, n, d]
// bf16 scratch. S·L / kLaneGroup + L + 1 launches.
NS2_API int ns2_wavenet_lanes_bf16mm(const float* x, const bf16* blocks, const float* conv_b,
                                     const float* res_b, const bf16* skip, const float* skip_b,
                                     const float* film, bf16* x16, bf16* planes_a,
                                     bf16* planes_b, float* out, int b, int n, int d, int S,
                                     int L, void* stream) {
  if (!lanes_ok(b, n, d, S, L)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bgemm::round_bf16(x, x16, (size_t)b * n * d, st);
  if (err != cudaSuccess) return err;
  return lanes_on_bf16_core<1>(x16, 1, blocks, conv_b, res_b, skip, skip_b, film, planes_a,
                               planes_b, out, out, b, n, d, S, L, st);
}
