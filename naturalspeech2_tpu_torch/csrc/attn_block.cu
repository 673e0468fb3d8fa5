// K2: the fused pre-norm self-attention block of the denoiser transformer.
//
// Replaces the Pallas kernel `_attn_block_kernel` (entry `fused_attn_block`)
// in naturalspeech2_tpu/ops/attn_block_kernel.py:
//   y = x + Σ_h softmax(q_h k_hᵀ · scale) v_h · W_o,h,
//   q, k, v = n(x) · W_{q,k,v},  n(x) = x / max(‖x‖, 1e-12) · √d · γ_b + β_b
// with no mask, no causal masking and no dropout.
//
// What bounds it on the card: the products. At the flagship shape (b4
// n1024 dm128, 8 heads of 64) the logits and P·V are 8.6 GFLOP and the
// projections 2.1, against 2 MB of x in and out.
//
// Design: the TPU kernel holds one head's whole [n, n] logits tile in VMEM
// and sums the heads' W_o products in a scratch accumulator. Here three
// launches, all on the TF32 tensor cores in split TF32:
//  1. q/k/v = n(x) · [W_q | W_k | W_v] on the GEMM core (gemm_tf32x3.cuh),
//     the norm as the loader of A, each 64-column tile part of one head of
//     one projection, scattered into K4's layout [3, b, H, n, dh];
//  2. the attention core: K4's `wgmma` kernel (flash_fwd.cu), unmasked,
//     without dropout and without its lse store;
//  3. y = x + Σ_h o_h · W_o,h on the GEMM core: the reduction runs over the
//     heads' concatenation, each head's [n, dh] output tile dh / 32
//     contiguous chunks of K, so the head sum is the f32 sum of the core's chunks in
//     one block, as the TPU kernel's scratch accumulation is, with no
//     cross-block sum.
// The wrapper pads each head to K4's width (64, or a multiple of 128: wider
// heads run K4's chunked kernel) and dm to the chunk of 32 with
// exact zeros in the packed weights (zero q and k columns change no logit,
// zero v columns give zero output columns, which meet zero W_o rows); the
// norm takes √dm from the real width, and the caller's scale is unchanged.
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;

extern "C" int ns2_flash_fwd(const float* q, const float* k, const float* v,
                             const unsigned char* mask, float* o, float* lse, int b, int h,
                             int n_q, int n_kv, int d, int causal, float scale, unsigned seed0,
                             unsigned seed1, float rate, int stride, unsigned threshold,
                             float keep_scale, void* stream);

// x [b,n,dm] -> out [b,n,dm], heads of dh = 64 or a multiple of 128 (K4's
// head widths). The packed weights
// (ops/gemm_cache.py): bt_qkv (N = 3·H·dh, column which·H·dh + h·dh + e;
// K = dm padded to 32) and bt_out (N = dm, K = H·dh). qkv [3, b, H, n, dh]
// and o [b, H, n, dh] are f32 scratch. Three launches.
NS2_API int ns2_attn_block(const float* x, const float* gamma, const float* beta,
                           const float* bt_qkv, const float* bt_out, float* qkv, float* o,
                           float* out, int b, int n, int dm, int heads, int dh, float scale,
                           void* stream) {
  if (dm <= 0 || n <= 0 || b <= 0 || heads <= 0 || (dh != 64 && (dh <= 0 || dh % 128 != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n;
  cudaError_t err = gemm::launch(
      gemm::NormRows{x, gamma, beta, rows, n, dm, sqrtf((float)dm)}, bt_qkv, rows,
      (dm + gemm::kKC - 1) / gemm::kKC, 3 * heads * dh / gemm::kBN,
      gemm::QkvScatter{qkv, rows, n, heads, b, dh}, st);
  if (err != cudaSuccess) return err;
  const size_t plane = (size_t)rows * heads * dh;
  err = (cudaError_t)ns2_flash_fwd(qkv, qkv + plane, qkv + 2 * plane, nullptr, o, nullptr, b,
                                   heads, n, n, dh, 0, scale, 0u, 0u, 0.0f, 0, 0u, 1.0f, stream);
  if (err != cudaSuccess) return err;
  return gemm::launch(gemm::HeadRows{o, rows, n, heads, dh}, bt_out, rows,
                      heads * dh / gemm::kKC, (dm + gemm::kBN - 1) / gemm::kBN,
                      gemm::Store{out, nullptr, x, rows, dm, dm}, st);
}
