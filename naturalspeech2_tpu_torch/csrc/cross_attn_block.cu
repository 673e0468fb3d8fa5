// K2b: the fused pre-norm cross-attention block of the conditional
// denoiser transformer.
//
// Replaces the Pallas kernel `_cross_attn_block_kernel` (entry
// `fused_cross_attn_block`) in naturalspeech2_tpu/ops/attn_block_kernel.py:
//   y = x + Σ_h softmax(q_h k_hᵀ · scale) v_h · W_o,h,
//   q = n(x) · W_q,  n(x) = x / max(‖x‖, 1e-12) · √dm · γ_b + β_b,
//   k, v = ctx · W_{k,v}  (the context is not normalised)
// with no mask, no causal masking and no dropout. The context is the 32
// resampled speech-prompt latents, so m is small and n is long.
//
// What bounds it on the card: the products. At the conditional sampling
// shape (x [8, 512, 128], ctx [8, 32, 128], 8 heads of 64) the q and out
// projections are 0.54 GFLOP each, the logits and P·V 0.13 each and k/v
// 0.07, against 5.4 MB of inputs and outputs.
//
// Design: the TPU kernel holds one head's whole [n, m] logits tile and its
// q/k/v in VMEM, one head per grid step. Here four launches, all on the
// TF32 tensor cores in split TF32, as K2 (attn_block.cu) is built:
//  1. q = n(x) · W_q on the GEMM core (gemm_tf32x3.cuh), the norm as the
//     loader of A, each 64-column tile part of one head, scattered into
//     K4's layout [b, H, n, dh];
//  2. k, v = ctx · [W_k | W_v] on the GEMM core, A the context's rows as
//     they are, scattered into [2, b, H, m, dh]; once per batch row, not in
//     every query tile;
//  3. the attention core: K4's kernel (flash_fwd.cu) with n_q = n, n_kv =
//     m, unmasked, without dropout and without its lse store;
//  4. y = x + Σ_h o_h · W_o,h on the GEMM core: the reduction runs over the
//     heads' concatenation, so the head sum is the f32 sum of the core's
//     chunks in one block, as the TPU kernel's scratch accumulation is,
//     and the epilogue adds the residual (unless it is off).
// The packed weights (ops/attn_block_kernel.py `pack_cross_weights`, once
// per parameter version) pad each head to K4's width with exact zeros
// (zero q and k columns change no logit, zero v columns give zero output
// columns, which meet zero W_o rows) and dm and dc to the core's chunk of
// 32; x and ctx are read as they are (the loaders give zeros past dm and
// dc), and the norm takes √dm from the real width.
//
// bf16 (`ns2_cross_attn_block_bf16`, the JAX kernel's `mm = bfloat16`
// path, attn_block_kernel.py:237-292): the projections on the bf16 GEMM
// core (gemm_bf16.cuh: TMA copies into a 4-stage ring, bf16 `wgmma` with
// f32 accumulation, tiles by waves of the SMs), as K2's bf16 block
// (attn_block.cu), in five launches, the three GEMMs each a programmatic
// dependent of the kernel before it:
//  1. the norm pre-pass writes n(x) in f32, rounded to bf16, into the o
//     scratch at dm padded to 64 (o holds max(H·dh, dm_pad) a row);
//  2. q = n(x) · W_q, rounded to bf16 where `QkvScatter` stores it in K4's
//     layout [b, H, n, dh];
//  3. k, v = ctx · [W_k | W_v], A the context's rows by TMA (`Rows`; m = 32
//     rows fill half a 64-row box, the rest TMA's zeros, so each batch row
//     is one row tile), scattered into [2, b, H, m, dh]. TMA takes rows 16
//     bytes apart: where dc % 8 != 0 (the JAX gate admits any dc) or ctx is
//     not 16-byte aligned, a copy kernel first writes ctx at a row of dc
//     rounded up to 8 into the kv scratch's tail (one launch more);
//  4. K4's bf16 kernel (flash_fwd_bf16.cu) over q and kv, n_kv = m,
//     rounding P before P·V, o in bf16 over n(x);
//  5. y = x + Σ_h o_h · W_o,h: the heads' concatenation (`HeadRows`) times
//     W_o, the heads and the residual (unless it is off) summed in f32,
//     rounded once.
// What bounds it at the served shapes (x [2|8, 512, 128], ctx [·, 32, 128])
// is latency: 0.4–1.4 µs of work at the card's rates against five launches,
// so the GEMMs start their blocks during their predecessors' tails.
//
// Mixed (`ns2_cross_attn_block_mixed`: f32 x, ctx, γ and β against bf16
// weights, AMP training's denoiser; the JAX kernel with `mm = float32`,
// attn_block_kernel.py:244: the norm, q, k, v, the attention and every
// product in f32, the bf16 weights widened exactly): the projections on the
// bf16 core with each f32 operand carried as three bf16 planes (`split3`,
// an exact sum), each part's product with a bf16 weight exact in f32, so a
// product is three bf16 passes over the same chunks of B, lo first, as K2's
// mixed entry (attn_block.cu). Six launches, every GEMM a programmatic
// dependent of the kernel before it:
//  1. the norm pre-pass writes n(x)'s three planes [b, 3, n, dm_pad] and,
//     in the same launch, the context's [b, 3, m, dc_pad] into the planes
//     scratch's tail (`SplitTail`: dc padded to 64 with zeros, so the copy
//     that TMA needs where dc % 8 != 0 comes with it);
//  2. q over n(x)'s parts (`SplitLanes`, one lane), stored in f32 into
//     K4's layout [b, H, n, dh] (`QkvScatterT<float>`);
//  3. k, v over the context's parts (`SplitLanes` of m-row sequences: m =
//     32 rows fill half a 64-row box, the rest TMA's zeros), stored in f32
//     into [2, b, H, m, dh];
//  4. the attention core on K4's f32 kernel (flash_fwd.cu, split TF32);
//  5. o split into its three planes (`split_planes` of o as [b, H·n, dh]:
//     [b, 3·H, n, dh]), over n(x)'s planes, which are dead by then;
//  6. y = (x +) Σ_h o_h · W_o,h over o's three parts (`SplitHeadRows`),
//     stored in f32, x added only when the residual is on.
// What bounds it at AMP's shape (x [16, 160, 128], ctx [16, 32, 128]) is
// latency too: some 3.5 µs of work at the card's rates (the projections'
// three bf16 passes at 989 TFLOP/s, the core's three TF32 ones at 495)
// against six launches, K4 f32 the longest of them.
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
int cross_attn_block(const float* x, const float* ctx, const float* gamma, const float* beta,
                     const float* bt_q, const float* bt_kv, const float* bt_out, float* q,
                     float* kv, float* o, float* out, int b, int n, int m, int dm, int dc,
                     int heads, int dh, float scale, int residual, void* stream) {
  if (dm <= 0 || dc <= 0 || n <= 0 || m <= 0 || b <= 0 || heads <= 0 ||
      (dh != 64 && (dh <= 0 || dh % 128 != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n, ctx_rows = b * m;
  cudaError_t err = gemm::launch(
      gemm::NormRows{x, gamma, beta, rows, n, dm, sqrtf((float)dm)}, bt_q, rows,
      (dm + gemm::kKC - 1) / gemm::kKC, heads * dh / gemm::kBN,
      gemm::QkvScatter{q, rows, n, heads, b, dh}, st);
  if (err != cudaSuccess) return err;
  err = gemm::launch(gemm::Rows{ctx, ctx_rows, dc}, bt_kv, ctx_rows,
                     (dc + gemm::kKC - 1) / gemm::kKC, 2 * heads * dh / gemm::kBN,
                     gemm::QkvScatter{kv, ctx_rows, m, heads, b, dh}, st);
  if (err != cudaSuccess) return err;
  const size_t plane = (size_t)ctx_rows * heads * dh;
  err = (cudaError_t)attention_core(q, kv, kv + plane, o, b, heads, n, m, dh, scale, stream);
  if (err != cudaSuccess) return err;
  return gemm::launch(gemm::HeadRows{o, rows, n, heads, dh}, bt_out, rows,
                      heads * dh / gemm::kKC, (dm + gemm::kBN - 1) / gemm::kBN,
                      gemm::Store{out, nullptr, residual ? x : nullptr, rows, dm, dm}, st);
}

// The block on the bf16 core (gemm_bf16.cuh); o holds max(H·dh, dm_pad)
// values a row, kv [2, b, H, m, dh] and then b·m rows of dc rounded up to 8.
int cross_attn_block_bf16(const bf16* x, const bf16* ctx, const bf16* gamma, const bf16* beta,
                          const bf16* bt_q, const bf16* bt_kv, const bf16* bt_out, bf16* q,
                          bf16* kv, bf16* o, bf16* out, int b, int n, int m, int dm, int dc,
                          int heads, int dh, float scale, int residual, void* stream) {
  if (dm <= 0 || dc <= 0 || n <= 0 || m <= 0 || b <= 0 || heads <= 0 ||
      (dh != 64 && (dh <= 0 || dh % 128 != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = heads * dh, dm_pad = bgemm::round_up(dm, bgemm::kPad);
  cudaError_t err = bgemm::launch_normed(x, gamma, beta, o, b, n, dm, bt_q, hd,
                                         bgemm::QkvScatter{q, n, heads, b, dh, 1}, st);
  if (err != cudaSuccess) return err;
  const size_t plane = (size_t)b * m * hd;
  const bf16* rows = ctx;
  int ld = dc;
  if (dc % 8 != 0 || reinterpret_cast<uintptr_t>(ctx) % 16 != 0) {  // rows TMA cannot read
    ld = bgemm::round_up(dc, 8);
    err = bgemm::copy_rows(ctx, kv + 2 * plane, b * m, dc, ld, st);
    if (err != cudaSuccess) return err;
    rows = kv + 2 * plane;
  }
  err = bgemm::launch(bgemm::Rows{rows, b, m, ld, dc}, bt_kv, 2 * hd,
                      bgemm::round_up(dc, bgemm::kPad) / bgemm::kKC,
                      bgemm::QkvScatter{kv, m, heads, b, dh, 2}, st);
  if (err != cudaSuccess) return err;
  err = (cudaError_t)attention_core(q, kv, kv + plane, o, b, heads, n, m, dh, scale, stream);
  if (err != cudaSuccess) return err;
  return bgemm::launch(bgemm::HeadRows{o, b, heads, n, dh}, bt_out, dm_pad, hd / bgemm::kKC,
                       bgemm::Store<>{out, nullptr, residual ? x : nullptr, dm, dm}, st);
}

// The mixed block on the bf16 core: q [b, H, n, dh], kv [2, b, H, m, dh] and
// o [b, H, n, dh] f32 scratch; planes bf16 scratch of b·n rows of
// 3·max(H·dh, dm_pad) values (n(x)'s planes, then o's), then the context's
// planes [b, 3, m, dc_pad].
int cross_attn_block_mixed(const float* x, const float* ctx, const float* gamma,
                           const float* beta, const bf16* bt_q, const bf16* bt_kv,
                           const bf16* bt_out, float* q, float* kv, float* o, bf16* planes,
                           float* out, int b, int n, int m, int dm, int dc, int heads, int dh,
                           float scale, int residual, void* stream) {
  if (dm <= 0 || dc <= 0 || n <= 0 || m <= 0 || b <= 0 || heads <= 0 ||
      (dh != 64 && (dh <= 0 || dh % 128 != 0)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = heads * dh, dm_pad = bgemm::round_up(dm, bgemm::kPad);
  const int dc_pad = bgemm::round_up(dc, bgemm::kPad), per_part = dc_pad / bgemm::kKC;
  bf16* ctx_planes = planes + (size_t)b * n * 3 * (hd > dm_pad ? hd : dm_pad);
  cudaError_t err = bgemm::launch_normed_split(
      x, gamma, beta, planes, b, n, dm, bt_q, hd, bgemm::QkvScatterT<float>{q, n, heads, b, dh, 1},
      st, bgemm::SplitTail{ctx, ctx_planes, b * m, m, dc, dc_pad});
  if (err == cudaSuccess)
    err = bgemm::launch_planes(ctx_planes, 3, dc_pad, bgemm::SplitLanes{b, m, dc_pad, 1, 3, 0, 0},
                               bt_kv, 2 * hd, per_part, 3 * per_part,
                               bgemm::QkvScatterT<float>{kv, m, heads, b, dh, 2}, st);
  if (err != cudaSuccess) return err;
  const size_t plane = (size_t)b * m * hd;
  err = (cudaError_t)attention_core(q, kv, kv + plane, o, b, heads, n, m, dh, scale, stream);
  if (err == cudaSuccess) err = bgemm::split_planes(o, planes, b, heads * n, dh, dh, st);
  if (err != cudaSuccess) return err;
  return bgemm::launch_planes(planes, 3 * heads, dh, bgemm::SplitHeadRows{b, heads, n, dh},
                              bt_out, dm_pad, hd / bgemm::kKC, 3 * hd / bgemm::kKC,
                              bgemm::Store<float>{out, nullptr, residual ? x : nullptr, dm, dm},
                              st);
}

}  // namespace

// x [b,n,dm], ctx [b,m,dc] -> out [b,n,dm], heads of dh = 64 or a multiple of
// 128 (K4's head widths). The packed weights: bt_q (N = H·dh, column h·dh +
// e; K = dm), bt_kv (N = 2·H·dh, k's heads then v's; K = dc) and bt_out (N =
// dm, K = H·dh). q [b, H, n, dh], kv [2, b, H, m, dh] and o [b, H, n, dh] are
// f32 scratch. Four launches. residual 0 leaves x out of y (a rank's partial
// sum over its heads, as for ns2_attn_block).
NS2_API int ns2_cross_attn_block(const float* x, const float* ctx, const float* gamma,
                                 const float* beta, const float* bt_q, const float* bt_kv,
                                 const float* bt_out, float* q, float* kv, float* o, float* out,
                                 int b, int n, int m, int dm, int dc, int heads, int dh,
                                 float scale, int residual, void* stream) {
  return cross_attn_block(x, ctx, gamma, beta, bt_q, bt_kv, bt_out, q, kv, o, out, b, n, m, dm,
                          dc, heads, dh, scale, residual, stream);
}

// Mixed (`ns2_cross_attn_block_mixed`, see the top of this file): x, ctx, γ,
// β and out f32; the weights bf16 packed "bf16_sw128" as for
// ns2_cross_attn_block_bf16; q [b, H, n, dh], kv [2, b, H, m, dh] and o [b,
// H, n, dh] f32 scratch; planes bf16 scratch of 3·max(H·dh, dm padded to
// 64) values for each of the b·n rows, then 3·(dc padded to 64) for each of
// the b·m rows of the context. Six launches: the norm pre-pass (with the
// context's split), the q GEMM, the k/v GEMM, K4 f32, the split of o and
// the W_o GEMM. residual 0 as for ns2_cross_attn_block.
NS2_API int ns2_cross_attn_block_mixed(const float* x, const float* ctx, const float* gamma,
                                       const float* beta, const bf16* bt_q, const bf16* bt_kv,
                                       const bf16* bt_out, float* q, float* kv, float* o,
                                       bf16* planes, float* out, int b, int n, int m, int dm,
                                       int dc, int heads, int dh, float scale, int residual,
                                       void* stream) {
  return cross_attn_block_mixed(x, ctx, gamma, beta, bt_q, bt_kv, bt_out, q, kv, o, planes, out,
                                b, n, m, dm, dc, heads, dh, scale, residual, stream);
}

// The same in bf16 on the bf16 core: every pointer bf16, the weights
// packed "bf16_sw128" (bt_q: N = H·dh, K = dm padded to 64; bt_kv: N =
// 2·H·dh, K = dc padded to 64; bt_out: N = dm padded to 64, K = H·dh); o
// holds max(H·dh, dm padded to 64) values for each of the b·n rows, kv [2,
// b, H, m, dh] and then b·m rows of dc rounded up to 8 (the context's copy
// where TMA cannot read it as it is). Five launches (six with that copy):
// the norm pre-pass, the q GEMM, the k/v GEMM, K4 bf16 and the W_o GEMM.
NS2_API int ns2_cross_attn_block_bf16(const bf16* x, const bf16* ctx, const bf16* gamma,
                                      const bf16* beta, const bf16* bt_q, const bf16* bt_kv,
                                      const bf16* bt_out, bf16* q, bf16* kv, bf16* o, bf16* out,
                                      int b, int n, int m, int dm, int dc, int heads, int dh,
                                      float scale, int residual, void* stream) {
  return cross_attn_block_bf16(x, ctx, gamma, beta, bt_q, bt_kv, bt_out, q, kv, o, out, b, n, m,
                               dm, dc, heads, dh, scale, residual, stream);
}
