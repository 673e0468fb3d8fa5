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
//  3. y = x + Σ_h o_h · W_o,h on the GEMM core (without x when the
//     residual is off): the reduction runs over the
//     heads' concatenation, each head's [n, dh] output tile dh / 32
//     contiguous chunks of K, so the head sum is the f32 sum of the core's chunks in
//     one block, as the TPU kernel's scratch accumulation is, with no
//     cross-block sum.
// The wrapper pads each head to K4's width (64, or a multiple of 128: wider
// heads run K4's chunked kernel) and dm to the chunk of 32 with
// exact zeros in the packed weights (zero q and k columns change no logit,
// zero v columns give zero output columns, which meet zero W_o rows); the
// norm takes √dm from the real width, and the caller's scale is unchanged.
//
// bf16 (`ns2_attn_block_bf16`, the JAX kernel's `mm = bfloat16` path,
// attn_block_kernel.py:100-154): the projections on the bf16 GEMM core
// (gemm_bf16.cuh), bf16 `wgmma` with f32 accumulation, in four launches.
// The norm pre-pass writes n(x) in f32, rounded to bf16, into the o scratch
// (dm padded with zeros to 64 columns: o holds max(H·dh, dm_pad) a row);
// the q/k/v GEMM reads it as plain rows and rounds q, k and v to bf16 where
// its epilogue stores them; K4's bf16 kernel (flash_fwd_bf16.cu) rounds P
// before P·V and writes o in bf16 over n(x); the W_o GEMM reads o in K4's
// layout, sums the heads and the residual in f32 and rounds y once. One
// difference from the TPU kernel: K4 rescales its online softmax per key
// tile, so P is rounded against the running row max, not the final one (one
// bf16 ulp on some probabilities; chip_smoke.py holds the block to its
// plain version).
//
// Mixed (`ns2_attn_block_mixed`: f32 x, γ and β against bf16 weights, AMP
// training's denoiser; the JAX kernel with `mm = float32`: the norm, q, k,
// v, the attention and every product in f32, the bf16 weights widened
// exactly): the projections on the bf16 core with each f32 operand carried
// as three bf16 planes (hi, mid, lo: `split3`, an exact sum), each part's
// product with a bf16 weight exact in f32, so a product is three bf16
// passes over the same chunks of B, lo first. Five launches, every GEMM a
// programmatic dependent of the kernel before it:
//  1. the norm pre-pass writes n(x)'s three planes [b, 3, n, dm_pad] into
//     the planes scratch (the norm, γ and β in f32);
//  2. q/k/v over those parts (`SplitLanes`, one lane), stored in f32 into
//     K4's layout (`QkvScatterT<float>`), as the JAX kernel keeps them;
//  3. the attention core on K4's f32 kernel (flash_fwd.cu, split TF32), as
//     the JAX kernel runs it in f32;
//  4. o split into its three planes (`split_planes` of o as [b, H·n, dh]:
//     [b, 3·H, n, dh]), over n(x)'s planes, which are dead by then;
//  5. y = (x +) Σ_h o_h · W_o,h over o's three parts (`SplitHeadRows`),
//     stored in f32, x added only when the residual is on.
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace gemm = ns2::gemm;
namespace bgemm = ns2::bgemm;
using ns2::bf16;

extern "C" int ns2_flash_fwd(const float* q, const float* k, const float* v,
                             const unsigned char* mask, float* o, float* lse, int b, int h,
                             int n_q, int n_kv, int d, int causal, float scale, unsigned seed0,
                             unsigned seed1, float rate, int stride, unsigned threshold,
                             float keep_scale, int b_offset, int h_offset,
                             void* stream);
extern "C" int ns2_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                  const unsigned char* mask, bf16* o, float* lse, int b, int h,
                                  int n_q, int n_kv, int d, int causal, float scale,
                                  unsigned seed0, unsigned seed1, float rate, int stride,
                                  unsigned threshold, float keep_scale, int b_offset,
                                  int h_offset, void* stream);

namespace {

// K4 without mask, causal masking, dropout or lse, at the block's type.
int attention_core(const float* q, const float* k, const float* v, float* o, int b, int heads,
                   int n_q, int n_kv, int dh, float scale, void* stream) {
  return ns2_flash_fwd(q, k, v, nullptr, o, nullptr, b, heads, n_q, n_kv, dh, 0, scale, 0u, 0u,
                       0.0f, 0, 0u, 1.0f, 0, 0, stream);
}

int attention_core(const bf16* q, const bf16* k, const bf16* v, bf16* o, int b, int heads,
                   int n_q, int n_kv, int dh, float scale, void* stream) {
  return ns2_flash_fwd_bf16(q, k, v, nullptr, o, nullptr, b, heads, n_q, n_kv, dh, 0, scale, 0u,
                            0u, 0.0f, 0, 0u, 1.0f, 0, 0, stream);
}

// The block on the split-TF32 core (f32).
int attn_block(const float* x, const float* gamma, const float* beta, const float* bt_qkv,
               const float* bt_out, float* qkv, float* o, float* out, int b, int n, int dm,
               int heads, int dh, float scale, int residual, void* stream) {
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
  err = (cudaError_t)attention_core(qkv, qkv + plane, qkv + 2 * plane, o, b, heads, n, n, dh,
                                    scale, stream);
  if (err != cudaSuccess) return err;
  return gemm::launch(gemm::HeadRows{o, rows, n, heads, dh}, bt_out, rows,
                      heads * dh / gemm::kKC, (dm + gemm::kBN - 1) / gemm::kBN,
                      gemm::Store{out, nullptr, residual ? x : nullptr, rows, dm, dm}, st);
}

// The block on the bf16 core (gemm_bf16.cuh); o holds max(H·dh, dm_pad)
// values a row.
int attn_block_bf16(const bf16* x, const bf16* gamma, const bf16* beta, const bf16* bt_qkv,
                    const bf16* bt_out, bf16* qkv, bf16* o, bf16* out, int b, int n, int dm,
                    int heads, int dh, float scale, int residual, void* stream) {
  if (dm <= 0 || n <= 0 || b <= 0 || heads <= 0 || (dh != 64 && (dh <= 0 || dh % 128 != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n, hd = heads * dh, dm_pad = bgemm::round_up(dm, bgemm::kPad);
  cudaError_t err = bgemm::launch_normed(x, gamma, beta, o, b, n, dm, bt_qkv, 3 * hd,
                                         bgemm::QkvScatter{qkv, n, heads, b, dh}, st);
  if (err != cudaSuccess) return err;
  const size_t plane = (size_t)rows * hd;
  err = (cudaError_t)attention_core(qkv, qkv + plane, qkv + 2 * plane, o, b, heads, n, n, dh,
                                    scale, stream);
  if (err != cudaSuccess) return err;
  return bgemm::launch(bgemm::HeadRows{o, b, heads, n, dh}, bt_out, dm_pad, hd / bgemm::kKC,
                       bgemm::Store<>{out, nullptr, residual ? x : nullptr, dm, dm}, st);
}

// The mixed block on the bf16 core: qkv [3, b, H, n, dh] and o [b, H, n, dh]
// f32 scratch, planes [b, 3, ·] bf16 scratch of 3·max(H·dh, dm_pad) values a
// row (n(x)'s planes, then o's).
int attn_block_mixed(const float* x, const float* gamma, const float* beta, const bf16* bt_qkv,
                     const bf16* bt_out, float* qkv, float* o, bf16* planes, float* out, int b,
                     int n, int dm, int heads, int dh, float scale, int residual, void* stream) {
  if (dm <= 0 || n <= 0 || b <= 0 || heads <= 0 || (dh != 64 && (dh <= 0 || dh % 128 != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = heads * dh;
  cudaError_t err = bgemm::launch_normed_split(x, gamma, beta, planes, b, n, dm, bt_qkv, 3 * hd,
                                               bgemm::QkvScatterT<float>{qkv, n, heads, b, dh},
                                               st);
  if (err != cudaSuccess) return err;
  const size_t plane = (size_t)b * n * hd;
  err = (cudaError_t)attention_core(qkv, qkv + plane, qkv + 2 * plane, o, b, heads, n, n, dh,
                                    scale, stream);
  if (err == cudaSuccess) err = bgemm::split_planes(o, planes, b, heads * n, dh, dh, st);
  if (err != cudaSuccess) return err;
  return bgemm::launch_planes(planes, 3 * heads, dh, bgemm::SplitHeadRows{b, heads, n, dh},
                              bt_out, bgemm::round_up(dm, bgemm::kPad), hd / bgemm::kKC,
                              3 * hd / bgemm::kKC,
                              bgemm::Store<float>{out, nullptr, residual ? x : nullptr, dm, dm},
                              st);
}

}  // namespace

// x [b,n,dm] -> out [b,n,dm], heads of dh = 64 or a multiple of 128 (K4's
// head widths). The packed weights
// (ops/gemm_cache.py): bt_qkv (N = 3·H·dh, column which·H·dh + h·dh + e;
// K = dm padded to 32) and bt_out (N = dm, K = H·dh). qkv [3, b, H, n, dh]
// and o [b, H, n, dh] are scratch of the block's type. Three launches.
// residual 0 leaves x out of y: y = Σ_h o_h · W_o,h, the partial sum of a
// rank that holds some of the heads (tensor parallelism).
NS2_API int ns2_attn_block(const float* x, const float* gamma, const float* beta,
                           const float* bt_qkv, const float* bt_out, float* qkv, float* o,
                           float* out, int b, int n, int dm, int heads, int dh, float scale,
                           int residual, void* stream) {
  return attn_block(x, gamma, beta, bt_qkv, bt_out, qkv, o, out, b, n, dm, heads, dh, scale,
                    residual, stream);
}

// Mixed (`ns2_attn_block_mixed`, see the top of this file): x, γ, β and out
// f32; the weights bf16 packed "bf16_sw128" as for ns2_attn_block_bf16;
// qkv [3, b, H, n, dh] and o [b, H, n, dh] f32 scratch, planes bf16 scratch
// of 3·max(H·dh, dm padded to 64) values for each of the b·n rows. Five
// launches: the norm pre-pass, the q/k/v GEMM, K4 f32, the split of o and
// the W_o GEMM. residual 0 as for ns2_attn_block.
NS2_API int ns2_attn_block_mixed(const float* x, const float* gamma, const float* beta,
                                 const bf16* bt_qkv, const bf16* bt_out, float* qkv, float* o,
                                 bf16* planes, float* out, int b, int n, int dm, int heads, int dh,
                                 float scale, int residual, void* stream) {
  return attn_block_mixed(x, gamma, beta, bt_qkv, bt_out, qkv, o, planes, out, b, n, dm, heads,
                          dh, scale, residual, stream);
}

// The same in bf16 on the bf16 core: every pointer bf16, the weights packed
// "bf16_sw128" (bt_qkv: N = 3·H·dh, K = dm padded to 64; bt_out: N = dm
// padded to 64, K = H·dh); o holds max(H·dh, dm padded to 64) values for
// each of the b·n rows. Four launches: the norm pre-pass, the q/k/v GEMM,
// K4 bf16 and the W_o GEMM.
NS2_API int ns2_attn_block_bf16(const bf16* x, const bf16* gamma, const bf16* beta,
                                const bf16* bt_qkv, const bf16* bt_out, bf16* qkv, bf16* o,
                                bf16* out, int b, int n, int dm, int heads, int dh, float scale,
                                int residual, void* stream) {
  return attn_block_bf16(x, gamma, beta, bt_qkv, bt_out, qkv, o, out, b, n, dm, heads, dh, scale,
                         residual, stream);
}
