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
// bf16 (`ns2_ff_block_bf16`, ff_block_kernel.py:102-130): the same three
// launches on bf16 operands, bf16 `wgmma` with f32 accumulation: n(x)
// rounded to bf16 as it is staged; the GEGLU and its biases in f32 and `a`
// rounded once where the epilogue stores it (the JAX kernel's one downcast
// shared by the three conv taps), so the scratches are bf16; c = conv + b_c
// rounded before W₂; y + b₂ + x in f32, rounded once.
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;
using ns2::bf16;

namespace {

// T: the activations' and biases' type; M: the core's mode (kSplit2 for
// the mixed entry point).
template <class T, gemm::Mode M = gemm::kModeOf<T>>
int ff_block(const T* x, const T* gamma, const T* beta, const T* bt_geglu, const T* b_val,
             const T* b_gate, const T* bt_conv, const T* bc, const T* bt_out, const T* b2,
             T* a_buf, T* c_buf, T* out, int b, int n, int dm, int ip, void* stream) {
  if (ip % gemm::kKC != 0 || dm <= 0 || n <= 0 || b <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n;
  const int dm_chunks = (dm + gemm::kKC - 1) / gemm::kKC;
  cudaError_t err = gemm::launch<M>(
      gemm::NormRows<T>{x, gamma, beta, rows, n, dm, sqrtf((float)dm)}, bt_geglu, rows,
      dm_chunks, ip / gemm::kKC, gemm::Geglu<T>{a_buf, b_val, b_gate, rows, ip}, st);
  if (err != cudaSuccess) return err;
  err = gemm::launch<M>(gemm::TapRows<T>{a_buf, rows, n, ip, 3, 1}, bt_conv, rows,
                        3 * ip / gemm::kKC, (ip + gemm::kBN - 1) / gemm::kBN,
                        gemm::Store<T>{c_buf, bc, nullptr, rows, ip, ip}, st);
  if (err != cudaSuccess) return err;
  return gemm::launch<M>(gemm::TapRows<T>{c_buf, rows, n, ip, 1, 0}, bt_out, rows,
                         ip / gemm::kKC, (dm + gemm::kBN - 1) / gemm::kBN,
                         gemm::Store<T>{out, b2, x, rows, dm, dm}, st);
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

// Mixed (`ns2_ff_block_mixed`: f32 activations, γ, β and biases against
// bf16 weights packed as TF32 with no lo part, AMP training's denoiser):
// the f32 block, the GEMM core in its two-pass kSplit2 mode (the f32 rows
// split into hi and lo against the weights' exact TF32 values). The JAX
// kernel computes the same, its products promoting the bf16 weights to f32
// (`mm = float32`).
NS2_API int ns2_ff_block_mixed(const float* x, const float* gamma, const float* beta,
                               const float* bt_geglu, const float* b_val, const float* b_gate,
                               const float* bt_conv, const float* bc, const float* bt_out,
                               const float* b2, float* a_buf, float* c_buf, float* out, int b,
                               int n, int dm, int ip, void* stream) {
  return ff_block<float, gemm::Mode::kSplit2>(x, gamma, beta, bt_geglu, b_val, b_gate, bt_conv,
                                              bc, bt_out, b2, a_buf, c_buf, out, b, n, dm, ip,
                                              stream);
}

// The same in bf16: every pointer bf16, the weights packed as bf16.
NS2_API int ns2_ff_block_bf16(const bf16* x, const bf16* gamma, const bf16* beta,
                              const bf16* bt_geglu, const bf16* b_val, const bf16* b_gate,
                              const bf16* bt_conv, const bf16* bc, const bf16* bt_out,
                              const bf16* b2, bf16* a_buf, bf16* c_buf, bf16* out, int b, int n,
                              int dm, int ip, void* stream) {
  return ff_block(x, gamma, beta, bt_geglu, b_val, b_gate, bt_conv, bc, bt_out, b2, a_buf,
                  c_buf, out, b, n, dm, ip, stream);
}
