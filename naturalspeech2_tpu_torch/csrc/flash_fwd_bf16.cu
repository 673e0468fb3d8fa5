// K4 in bf16: flash attention forward on Hopper's bf16 tensor cores.
//
// Replaces, at a bf16 input dtype, the Pallas kernels `_flash_kernel` and
// `_flash_oneshot_kernel` in naturalspeech2_tpu/ops/flash_attention.py
// (the function is flash_fwd.cu's; `flash_forward_bf16_torch` in
// ops/flash_attention.py is the plain version): the logits summed in f32
// from the bf16 operands; m, l and lse in f32 over the undropped
// probabilities; P times the dropout keep multiplier in f32, rounded to
// bf16 before P·V; o rounded once. P is rounded against the running row max
// of its 128-key tile, where the plain version uses the final max: one bf16
// ulp on some probabilities.
//
// What bounds it on the card: the two products, 4·n_q·n_kv·D FLOP per
// (batch, head) at the bf16 rate (989 TFLOP/s) against 2·(2·n_q + 2·n_kv)·D
// bytes: past the ridge from n ≈ 300 on, so the tensor cores have to be
// kept busy, and the softmax between the two products (an e^x, a max and a
// sum per logit on the CUDA cores) is what stands in their way.
//
// Design: a block owns 64·C query rows of one (batch, head): C consumer
// warpgroups of 64 rows each (C = 3 on long non-causal runs at D = 64, else
// 2; see Layout)
// and a producer warpgroup, which hands its registers to them
// (`setmaxnreg`); one block an SM. The producer copies Q once and K and V
// tiles of 128 keys into a ring of stages with 16-byte `cp.async` straight
// into the 128-byte swizzled layout (flash_bf16.cuh), each stage's copies
// completing on an `mbarrier`, and waits for the consumers to free a stage;
// no thread stages data through registers and no block-wide barrier runs
// per tile. S = Q·Kᵀ is `wgmma.m64n128k16` with both operands K-major in
// shared memory; O += P·V takes P from registers (the accumulator of S,
// rounded to bf16) and V as it was copied, read MN-major through the
// transpose bit, one `wgmma.m64n64k16` per 64 columns of O. In each turn a
// warpgroup issues the next tile's S and the last tile's P·V together;
// while both run it does the softmax of S as soon as S is done, then
// rescales O and rounds the new P. The warpgroups take turns at the tensor
// cores in a round (named barriers), so one's softmax runs while another's
// products do.
// The softmax works in log2 units: e^(scale·s − m) = 2^(s·c − m·c), c =
// scale·log2 e, one FMA and one ex2 on the special-function unit a logit
// (so scale must be positive); masked logits are −∞ and a row whose keys
// are all masked so far takes 0 for its max. Only a tile that the padding
// mask, the key length or the causal diagonal cuts runs the per-element
// test. Causal blocks stop at the diagonal; the ragged tail of the keys is
// zero-filled by the copies and masked. Heads wider than 128 run
// flash_fwd.cu's chunked kernel at bf16.
#include "flash_bf16.cuh"

namespace {

using ns2::bf16;
using ns2::sm90::pin;
namespace sm90 = ns2::sm90;

constexpr int kKeys = 128;       // keys a tile
constexpr int kProducers = 128;  // the warpgroup that copies
constexpr int kTurnBar = 1;      // named barriers 1, 2, 3: the consumers' turns
constexpr int kTurnThreads = 256;  // a turn's barrier: its warpgroup and the one before

constexpr uint32_t kPanelKV = kKeys * sm90::kPanelRowBytes;

// The block's shape, G consumer warpgroups of 64 query rows, and its shared
// memory, bytes from a 1024-byte aligned base: Q, the K ring, the V ring,
// then the barriers (Q's, and each stage's full and empty). Three
// warpgroups (192 rows, 160 registers a thread, D = 64 only) make each K and
// V tile serve 1.5 times the rows of two and fill the card in fewer waves
// on long query runs; two (232 registers) waste fewer rows on short or
// causal ones (see ns2_flash_fwd_bf16). The copies' latency is what a
// shallow ring exposes: 4 stages at D = 64, where 5 and 6 gained nothing
// more (flash_variants.py times 2 and 3 stages, and each block shape).
template <int D, int G>
struct Layout {
  static constexpr int kRows = 64 * G;
  static constexpr int kConsumers = 128 * G;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr uint32_t kPanelQ = kRows * sm90::kPanelRowBytes;
  static constexpr uint32_t kTileKV = kPanelKV * (D / 64);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kPanelQ * (D / 64);
  static constexpr uint32_t kV = kK + kStages * kTileKV;
  static constexpr uint32_t kBars = kV + kStages * kTileKV;
  static constexpr int kBytes = (int)kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment
};

// One tile's softmax on S (s[j][i]: row ra + 8·(i / 2), key k0 + 8j + 2t + (i
// & 1)), in place: s becomes P·keep, m (raw logit units) and l advance,
// corr rescales what O held.
struct Rows {
  const unsigned char* mask_b;
  int bi, hi, ra, row0, n_q, n_kv, causal, t;
  float c;  // scale·log2 e
};

template <bool kDropout>
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 8][4], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], const Rows& rw,
                                             int k0, const ns2::Dropout& dr) {
  const bool whole = rw.mask_b == nullptr && k0 + kKeys <= rw.n_kv &&
                     (!rw.causal || k0 + kKeys - 1 <= rw.row0);
  if (!whole) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * rw.t + e;
        const bool col_ok = col < rw.n_kv && (rw.mask_b == nullptr || rw.mask_b[col] != 0);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = rw.ra + 8 * r;
          if (!(col_ok && row < rw.n_q && (!rw.causal || row >= col)))
            s[j][2 * r + e] = -INFINITY;
        }
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], ns2::quad_max(mx[r]));
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;  // every key so far masked
    corr[r] = sm90::ex2((m[r] - m_use) * rw.c);             // 0 while m was −∞
    m[r] = m_new;
    mc[r] = m_use * rw.c;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float p = sm90::ex2(fmaf(s[j][i], rw.c, -mc[i / 2]));
      sum[i / 2] += p;
      if (kDropout && p != 0.0f)
        p *= ns2::keep_mult(dr, rw.bi, rw.hi, rw.ra + 8 * (i / 2),
                            k0 + 8 * j + 2 * rw.t + (i & 1));
      s[j][i] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ns2::quad_sum(sum[r]);
}

// S = Q·Kᵀ over the head width for one warpgroup's 64 rows: Q at q_at
// (panels panel_q apart), K at k_at (panels kPanelKV apart), both K-major.
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[kKeys / 8][4], uint32_t q_at,
                                        uint32_t panel_q, uint32_t k_at) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (uint32_t)(ks % 4) * 32u;  // k-step within its panel
    sm90::wgmma_ss_n128(s, sm90::desc(q_at + (ks / 4) * panel_q + off),
                        sm90::desc(k_at + (ks / 4) * kPanelKV + off), ks > 0);
  }
}

// acc += P·V: P in registers, V at v_at read MN-major, 64 columns of O a
// product.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 64][8][4],
                                         const uint32_t (&pa)[kKeys / 16][4], uint32_t v_at) {
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks)
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      sm90::wgmma_rs_n64_mn(acc[p], pa[ks],
                            sm90::desc(v_at + p * kPanelKV + ks * 2048u));
}

// O's rows rescaled by corr, and P (s) rounded to bf16 as the next P·V's
// register operand.
template <int D>
__device__ __forceinline__ void rescale_pack(float (&acc)[D / 64][8][4], const float (&corr)[2],
                                             const float (&s)[kKeys / 8][4],
                                             uint32_t (&pa)[kKeys / 16][4]) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[p][j][0] *= corr[0];
      acc[p][j][1] *= corr[0];
      acc[p][j][2] *= corr[1];
      acc[p][j][3] *= corr[1];
    }
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks) sm90::pack_a(s[2 * ks], s[2 * ks + 1], pa[ks]);
}

// grid (ceil(n_q / kRows), b·h), kThreads threads, Layout<D, G>::kBytes of
// dynamic shared memory. kLse: store lse (K2's attention core skips it);
// kDropout: apply the keep mask (its Threefry code stays out of the other
// instantiations, whose softmax loop it would otherwise bloat).
template <int D, int G, bool kLse, bool kDropout>
__global__ void __launch_bounds__(Layout<D, G>::kThreads, 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                      bf16* __restrict__ o, float* __restrict__ lse, int heads, int n_q, int n_kv,
                      int causal, float scale, ns2::Dropout dr) {
  using L = Layout<D, G>;
  constexpr int S = L::kStages, kRows = L::kRows, kConsumers = L::kConsumers;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + (base - raw) + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kRows, bh = blockIdx.y;
  const int k_end = causal ? min(n_kv, q0 + kRows) : n_kv;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  if (tid == 0) {
    sm90::mbar_init(q_full, kProducers);
    for (int st = 0; st < S; ++st) {
      sm90::mbar_init(&full[st], kProducers);         // every producer thread's copies
      sm90::mbar_init(&empty[st], kConsumers / 32);  // every consumer warp done with it
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup
    sm90::producer_regs<G>();
    const int ptid = tid - kConsumers;
    const bf16* kh = k + (size_t)bh * n_kv * D;
    const bf16* vh = v + (size_t)bh * n_kv * D;
    sm90::load_tile<kRows, D>(base + L::kQ, q + (size_t)bh * n_q * D, q0, n_q, ptid, kProducers);
    sm90::mbar_arrive_copies(q_full);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % S;
      sm90::mbar_wait(&empty[st], ((kt / S) & 1) ^ 1);  // the first round passes
      sm90::load_tile<kKeys, D>(base + L::kK + st * L::kTileKV, kh, kt * kKeys, n_kv, ptid,
                                kProducers);
      sm90::load_tile<kKeys, D>(base + L::kV + st * L::kTileKV, vh, kt * kKeys, n_kv, ptid,
                                kProducers);
      sm90::mbar_arrive_copies(&full[st]);
    }
    sm90::cp_async_drain();
    return;
  }
  sm90::consumer_regs<G>();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp;
  const Rows rw{mask ? mask + (size_t)(bh / heads) * n_kv : nullptr,
                bh / heads, bh % heads, row0 + lane / 4, row0, n_q, n_kv, causal, lane % 4,
                scale * 1.4426950408889634f};
  const uint32_t q_at = base + L::kQ + 64 * wg * sm90::kPanelRowBytes;
  auto k_at = [&](int st) { return base + L::kK + st * L::kTileKV; };
  auto v_at = [&](int st) { return base + L::kV + st * L::kTileKV; };

  float acc[D / 64][8][4];
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[p][j][i] = 0.0f;
  float s[kKeys / 8][4];
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
  uint32_t pa[kKeys / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, corr[2];

  // Turns at the tensor cores: warpgroup 0 first, then round the
  // warpgroups; turn kt issues S of tile kt and P·V of tile kt - 1 (the
  // first S alone, the last P·V alone), n_tiles + 1 turns a warpgroup.
  const int next = (wg + 1) % G;
  if (wg == G - 1) sm90::bar_arrive(kTurnBar, kTurnThreads);
  sm90::mbar_wait(q_full, 0);
  sm90::mbar_wait(&full[0], 0);
  ns2::fence_proxy_async();  // the copies, made visible to wgmma
  sm90::bar_sync(kTurnBar + wg, kTurnThreads);
  pin(s);
  ns2::wg_fence();
  issue_s<D>(s, q_at, L::kPanelQ, k_at(0));
  ns2::wg_commit();
  sm90::bar_arrive(kTurnBar + next, kTurnThreads);
  sm90::wg_wait<0>();
  pin(s);
  softmax_tile<kDropout>(s, m, l, corr, rw, 0, dr);
  rescale_pack<D>(acc, corr, s, pa);
  for (int kt = 1; kt < n_tiles; ++kt) {
    const int st = kt % S, st_prev = (kt - 1) % S;
    sm90::mbar_wait(&full[st], (kt / S) & 1);
    ns2::fence_proxy_async();
    sm90::bar_sync(kTurnBar + wg, kTurnThreads);
    pin(s);
    pin(pa);
    pin(acc);
    ns2::wg_fence();
    issue_s<D>(s, q_at, L::kPanelQ, k_at(st));
    ns2::wg_commit();
    issue_pv<D>(acc, pa, v_at(st_prev));
    ns2::wg_commit();
    sm90::bar_arrive(kTurnBar + next, kTurnThreads);
    sm90::wg_wait<1>();  // S done, P·V may still run
    pin(s);
    softmax_tile<kDropout>(s, m, l, corr, rw, kt * kKeys, dr);
    sm90::wg_wait<0>();
    pin(acc);
    pin(pa);
    if (lane == 0) sm90::mbar_arrive(&empty[st_prev]);
    rescale_pack<D>(acc, corr, s, pa);
  }
  sm90::bar_sync(kTurnBar + wg, kTurnThreads);
  pin(pa);
  pin(acc);
  ns2::wg_fence();
  issue_pv<D>(acc, pa, v_at((n_tiles - 1) % S));
  ns2::wg_commit();
  // the last warpgroup's last turn hands none on: every bar_sync has its
  // arrivals
  if (wg != G - 1) sm90::bar_arrive(kTurnBar + next, kTurnThreads);
  sm90::wg_wait<0>();
  pin(acc);

  // o = acc / l rounded to bf16; lse = m·scale + log l (NEG_INF where every
  // key was masked, and o = 0 there)
  bf16* oh = o + (size_t)bh * n_q * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw.ra + 8 * r;
    if (row >= n_q) continue;
    const float inv_l = l[r] == 0.0f ? 1.0f : 1.0f / l[r];
    if (kLse && rw.t == 0)
      lse[(size_t)bh * n_q + row] = l[r] == 0.0f ? ns2::kNegInf : m[r] * scale + logf(l[r]);
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ns2::store2(oh + (size_t)row * D + 64 * p + 8 * j + 2 * rw.t, acc[p][j][2 * r] * inv_l,
                    acc[p][j][2 * r + 1] * inv_l);
  }
}

template <int D, int G>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
                   bf16* o, float* lse, int b, int h, int n_q, int n_kv, int causal, float scale,
                   const ns2::Dropout& dr, cudaStream_t stream) {
  using L = Layout<D, G>;
  const bool drop = dr.rate > 0.0f;
  auto kernel = lse ? (drop ? flash_fwd_bf16_kernel<D, G, true, true>
                            : flash_fwd_bf16_kernel<D, G, true, false>)
                    : (drop ? flash_fwd_bf16_kernel<D, G, false, true>
                            : flash_fwd_bf16_kernel<D, G, false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + L::kRows - 1) / L::kRows, b * h);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(q, k, v, mask, o, lse, h, n_q, n_kv, causal,
                                                   scale, dr);
  return cudaGetLastError();
}

}  // namespace

// q [b,h,n_q,d], k/v [b,h,n_kv,d] bf16, 16-byte aligned, mask [b,n_kv] uint8
// or null -> o [b,h,n_q,d] bf16, lse [b,h,n_q] f32 (not written when lse is
// null). Dropout as for ns2_flash_fwd (flash_fwd.cu): the keep multiplier is
// applied to P in f32, m, l and lse stay over the undropped P, and P·keep is
// rounded to bf16 as P·V's operand. d is 64 or a multiple of 128 and scale
// positive; anything else returns cudaErrorInvalidValue.
NS2_API int ns2_flash_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                               const unsigned char* mask, bf16* o, float* lse, int b, int h,
                               int n_q, int n_kv, int d, int causal, float scale, unsigned seed0,
                               unsigned seed1, float rate, int stride, unsigned threshold,
                               float keep_scale, int b_offset, int h_offset, void* stream) {
  if ((d != 64 && (d <= 0 || d % 128 != 0)) || n_q <= 0 || n_kv <= 0 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  const ns2::Dropout dr{seed0, seed1, rate, stride, threshold, keep_scale, b_offset, h_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // three consumer warpgroups on long, non-causal query runs (the long-form
  // shapes), two on short or causal ones, whose third would mostly idle.
  // flash_variants.py at b·h = 8 on an H100: two are faster up to 2,048
  // queries, three from 2,560 (two's grid passes one wave of the SMs). At
  // other b·h the crossover moves with the waves, which this rule ignores.
  const bool three = !causal && n_q > 2048;
  if (d == 64)
    return three ? launch<64, 3>(q, k, v, mask, o, lse, b, h, n_q, n_kv, causal, scale, dr, st)
                 : launch<64, 2>(q, k, v, mask, o, lse, b, h, n_q, n_kv, causal, scale, dr, st);
  if (d == 128)
    return launch<128, 2>(q, k, v, mask, o, lse, b, h, n_q, n_kv, causal, scale, dr, st);
  return ns2::flash_fwd_wide_bf16(q, k, v, mask, o, lse, b, h, n_q, n_kv, d, causal, scale, dr,
                                  st);
}
