// K3: the fused pre-norm feed-forward block of the denoiser transformer.
//
// Replaces the Pallas kernel `_ff_block_kernel` (entry `fused_ff_block`)
// in naturalspeech2_tpu/ops/ff_block_kernel.py:
//   y = x + W₂ · conv₃(gelu_tanh(n(x)·W_g + b_g) ∘ (n(x)·W_v + b_v)) + b₂
// with n(x) the adaptive RMSNorm and conv₃ the causal k=3 conv
// a_{t-2}·Wc₀ + a_{t-1}·Wc₁ + a_t·Wc₂ + b_c.
//
// What bounds it on the card: the three matrix products, 2·b·n·(2·dm·ip +
// 3·ip² + ip·dm) FLOP (ip the inner width 8dm/3, padded), three quarters
// of them in the conv, against b·n·dm floats in and out and the weights:
// far past the ridge at every shape the model runs (b4 n1024 dm128: 4.2
// GFLOP; b16 n1024 dm512: 252 GFLOP).
//
// Design: the TPU kernel holds a whole sequence's [n, inner] activations
// in VMEM. Here the block is three launches of the split-TF32 GEMM core
// (gemm_tf32x3.cuh) through two f32 scratches [b·n, ip] (5.8 MB at the
// flagship, resident in L2):
//  1. GEGLU: a = gelu_tanh(n(x)·W_g + b_g) ∘ (n(x)·W_v + b_v), the norm as
//     the loader of A; each tile holds 32 value and the same 32 gate
//     columns, so both products share the A tile and one epilogue;
//  2. the causal conv as one GEMM with K = 3·ip over the three shifted row
//     views of a (rows before t = 0 read as zero), + b_c;
//  3. y = x + c·W₂ + b₂.
// The wrapper pads ip to a multiple of 32 and dm to the chunk of 32 with
// exact zeros in the packed weights, which change no sum; the norm takes
// √dm from the real width.
//
// bf16 (`ns2_ff_block_bf16`, ff_block_kernel.py:102-130): the bf16 GEMM
// core (gemm_bf16.cuh), bf16 `wgmma` with f32 accumulation, in four
// launches: the norm pre-pass writes n(x), rounded to bf16, into the c
// scratch (dm padded with zeros to 64 columns, so c holds max(ip, dm_pad)
// a row: dm_pad passes ip where ff_mult is small, 512 against 384); the
// GEGLU reads it as plain rows, its biases and gate in f32 and `a` rounded
// once where the epilogue stores it (the JAX kernel's one downcast shared
// by the three conv taps); the conv reads the three taps as row-shifted
// views of `a`; c = conv + b_c rounded before W₂; y + b₂ + x in f32, rounded
// once. The weights are packed "bf16_sw128" and ip is a multiple of 64.
//
// Mixed (`ns2_ff_block_mixed`: f32 x, γ, β and biases against bf16 weights,
// AMP training's denoiser; the JAX kernel with `mm = float32`: the norm,
// every activation and every product in f32, the bf16 weights widened
// exactly): the bf16 core with each f32 operand carried as three bf16
// planes (hi, mid, lo: `split3`, an exact sum), each part's product with a
// bf16 weight exact in f32, so a product is three bf16 passes over the same
// chunks of B, lo first. Four launches, every GEMM a programmatic dependent
// of the kernel before it:
//  1. the norm pre-pass writes n(x)'s three planes [b, 3, n, dm_pad] into
//     the c scratch (the norm, γ and β in f32);
//  2. the GEGLU over those parts (`SplitLanes`, one lane) against [W_v |
//     W_g]; its epilogue adds the f32 biases, computes gelu_tanh(gate)·val
//     in f32 and writes a's three planes [b, 3, n, ip], staged in shared
//     memory for TMA stores (`GegluSplit`);
//  3. the conv as one GEMM over the 3 parts × 3 taps of a (`SplitTaps`,
//     dilation 1: the rows before t = 0 of the sequence TMA's zeros); its
//     epilogue adds b_c in f32 and writes c's three planes (`StoreSplit`);
//  4. y = x + c·W₂ + b₂ over c's three parts, stored in f32.
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;
namespace bgemm = ns2::bgemm;
using ns2::bf16;

namespace {

// The block on the split-TF32 core (f32).
int ff_block(const float* x, const float* gamma, const float* beta, const float* bt_geglu,
             const float* b_val, const float* b_gate, const float* bt_conv, const float* bc,
             const float* bt_out, const float* b2, float* a_buf, float* c_buf, float* out, int b,
             int n, int dm, int ip, void* stream) {
  if (ip % gemm::kKC != 0 || dm <= 0 || n <= 0 || b <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n;
  const int dm_chunks = (dm + gemm::kKC - 1) / gemm::kKC;
  cudaError_t err = gemm::launch(
      gemm::NormRows{x, gamma, beta, rows, n, dm, sqrtf((float)dm)}, bt_geglu, rows,
      dm_chunks, ip / gemm::kKC, gemm::Geglu{a_buf, b_val, b_gate, rows, ip}, st);
  if (err != cudaSuccess) return err;
  err = gemm::launch(gemm::TapRows{a_buf, rows, n, ip, 3, 1}, bt_conv, rows,
                        3 * ip / gemm::kKC, (ip + gemm::kBN - 1) / gemm::kBN,
                        gemm::Store{c_buf, bc, nullptr, rows, ip, ip}, st);
  if (err != cudaSuccess) return err;
  return gemm::launch(gemm::TapRows{c_buf, rows, n, ip, 1, 0}, bt_out, rows, ip / gemm::kKC,
                      (dm + gemm::kBN - 1) / gemm::kBN, gemm::Store{out, b2, x, rows, dm, dm},
                      st);
}

// The block on the bf16 core (gemm_bf16.cuh).
int ff_block_bf16(const bf16* x, const bf16* gamma, const bf16* beta, const bf16* bt_geglu,
                  const bf16* b_val, const bf16* b_gate, const bf16* bt_conv, const bf16* bc,
                  const bf16* bt_out, const bf16* b2, bf16* a_buf, bf16* c_buf, bf16* out, int b,
                  int n, int dm, int ip, void* stream) {
  const int dm_pad = bgemm::round_up(dm, bgemm::kPad);
  if (ip % bgemm::kKC != 0 || dm <= 0 || n <= 0 || b <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = bgemm::launch_normed(x, gamma, beta, c_buf, b, n, dm, bt_geglu, 2 * ip,
                                         bgemm::Geglu{a_buf, b_val, b_gate, ip}, st);
  if (err != cudaSuccess) return err;
  err = bgemm::launch(bgemm::TapRows{a_buf, b, n, ip}, bt_conv, ip, 3 * ip / bgemm::kKC,
                      bgemm::Store<>{c_buf, bc, nullptr, ip, ip}, st);
  if (err != cudaSuccess) return err;
  return bgemm::launch(bgemm::Rows{c_buf, b, n, ip, ip}, bt_out, dm_pad, ip / bgemm::kKC,
                       bgemm::Store<>{out, b2, x, dm, dm}, st);
}

// The mixed block on the bf16 core: a_planes [b, 3, n, ip], c_planes [b, 3,
// n, max(ip, dm_pad)] bf16 scratch (c first holds n(x)'s planes).
int ff_block_mixed(const float* x, const float* gamma, const float* beta, const bf16* bt_geglu,
                   const float* b_val, const float* b_gate, const bf16* bt_conv, const float* bc,
                   const bf16* bt_out, const float* b2, bf16* a_planes, bf16* c_planes,
                   float* out, int b, int n, int dm, int ip, void* stream) {
  if (ip % bgemm::kKC != 0 || dm <= 0 || n <= 0 || b <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap a_out, c_out;
  cudaError_t err = bgemm::planes_map(&a_out, a_planes, b, 3, n, ip);
  if (err == cudaSuccess) err = bgemm::planes_map(&c_out, c_planes, b, 3, n, ip);
  if (err == cudaSuccess)
    err = bgemm::launch_normed_split(x, gamma, beta, c_planes, b, n, dm, bt_geglu, 2 * ip,
                                     bgemm::GegluSplit{a_out, b_val, b_gate, n, ip}, st);
  if (err != cudaSuccess) return err;
  const int taps = 3 * ip / bgemm::kKC;  // chunks of one part of the conv's K
  err = bgemm::launch_planes(a_planes, 3, ip, bgemm::SplitTaps{b, n, ip, b, 0, 3, false, 0},
                             bt_conv, ip, taps, 3 * taps, bgemm::StoreSplit{c_out, bc, n, ip}, st);
  if (err != cudaSuccess) return err;
  return bgemm::launch_planes(c_planes, 3, ip, bgemm::SplitLanes{b, n, ip, 1, 3, 0, 0}, bt_out,
                              bgemm::round_up(dm, bgemm::kPad), ip / bgemm::kKC,
                              3 * ip / bgemm::kKC,
                              bgemm::Store<float>{out, b2, x, dm, dm}, st);
}

}  // namespace

// x [b,n,dm] -> out [b,n,dm]. The packed weights (ops/gemm_cache.py):
// bt_geglu (ip/32 tiles of 32 value and 32 gate columns over K = dm padded
// to 32), bt_conv (N = ip, K = 3·ip), bt_out (N = dm, K = ip); biases b_val,
// b_gate, bc [ip] and b2 [dm]. a_buf and c_buf are [b·n, ip] scratch of the
// block's type. Three launches; ip % 32 != 0 returns cudaErrorInvalidValue.
NS2_API int ns2_ff_block(const float* x, const float* gamma, const float* beta,
                         const float* bt_geglu, const float* b_val, const float* b_gate,
                         const float* bt_conv, const float* bc, const float* bt_out,
                         const float* b2, float* a_buf, float* c_buf, float* out, int b, int n,
                         int dm, int ip, void* stream) {
  return ff_block(x, gamma, beta, bt_geglu, b_val, b_gate, bt_conv, bc, bt_out, b2, a_buf,
                  c_buf, out, b, n, dm, ip, stream);
}

// Mixed (`ns2_ff_block_mixed`, see the top of this file): x, γ, β, the
// biases and out f32; the weights bf16 packed "bf16_sw128" as for
// ns2_ff_block_bf16, ip a multiple of 64; a_planes [b, 3, n, ip] and
// c_planes [b, 3, n, max(ip, dm padded to 64)] bf16 scratch. Four launches:
// the norm pre-pass and the three GEMMs.
NS2_API int ns2_ff_block_mixed(const float* x, const float* gamma, const float* beta,
                               const bf16* bt_geglu, const float* b_val, const float* b_gate,
                               const bf16* bt_conv, const float* bc, const bf16* bt_out,
                               const float* b2, bf16* a_planes, bf16* c_planes, float* out, int b,
                               int n, int dm, int ip, void* stream) {
  return ff_block_mixed(x, gamma, beta, bt_geglu, b_val, b_gate, bt_conv, bc, bt_out, b2,
                        a_planes, c_planes, out, b, n, dm, ip, stream);
}

// The same in bf16 on the bf16 core: every pointer bf16, the weights
// packed "bf16_sw128" (bt_geglu: N = 2·ip, K = dm padded to 64; bt_conv: N
// = ip, K = 3·ip; bt_out: N = dm padded to 64, K = ip), ip a multiple of 64;
// c_buf holds b·n rows of max(ip, dm padded to 64). Four launches: the norm
// pre-pass and the three GEMMs.
NS2_API int ns2_ff_block_bf16(const bf16* x, const bf16* gamma, const bf16* beta,
                              const bf16* bt_geglu, const bf16* b_val, const bf16* b_gate,
                              const bf16* bt_conv, const bf16* bc, const bf16* bt_out,
                              const bf16* b2, bf16* a_buf, bf16* c_buf, bf16* out, int b, int n,
                              int dm, int ip, void* stream) {
  return ff_block_bf16(x, gamma, beta, bt_geglu, b_val, b_gate, bt_conv, bc, bt_out, b2, a_buf,
                       c_buf, out, b, n, dm, ip, stream);
}
