// K5 in bf16: flash attention backward, dq and dk/dv, on Hopper's bf16
// tensor cores.
//
// Replaces, at a bf16 input dtype, the Pallas kernels `_flash_bwd_dq_kernel`
// and `_flash_bwd_dkv_kernel` in naturalspeech2_tpu/ops/flash_attention.py
// (the function is flash_bwd.cu's; `flash_backward_bf16_torch` in
// ops/flash_attention.py is the plain version), at the JAX kernels'
// rounding points: S = Q·Kᵀ and dP = dO·Vᵀ summed in f32 from the bf16
// values; dS = P∘(dP∘keep − delta)·scale rounded to bf16 before dQ = dS·K
// and dK = dSᵀ·Q; dV = Aᵀ·dO with A = P∘keep NOT rounded; dq, dk and dv
// rounded once.
//
// What bounds it on the card: the matrix products, five n_q·n_kv·D
// products (S, dP, dV, dQ, dK) of bf16 values; this kernel runs seven (each
// owner kernel recomputes S and dP), dV in two bf16 passes (below).
//
// Design: two owner kernels, as flash_bwd.cu's: flash_bwd_dq_bf16_kernel
// owns 128 query rows of one (batch, head) and walks the keys in tiles of
// 64; flash_bwd_dkv_bf16_kernel owns 128 keys and walks the queries in
// tiles of 64 (32 at D = 128, where dK and dV take 128 registers a thread).
// Each block is two consumer warpgroups of 64 owned rows and a producer
// warpgroup that hands them its registers (`setmaxnreg`: 40 a thread, the
// consumers 232), and each owned row's sums stay in one warpgroup's
// accumulators: no atomics, and the same inputs give the same bits. The
// producer copies the owned tiles once and the walked tiles (with their lse
// and delta rows) into a ring of four stages, raw bf16, with `cp.async`
// straight into the 128-byte swizzled layout (flash_bf16.cuh), completing
// on `mbarrier`s; nothing is widened or staged through registers. Every
// product is `wgmma` with the owner's 64 rows as M: S (Sᵀ) and dP (dPᵀ)
// from shared memory, both operands K-major; dQ, dK and dV with dS, dSᵀ
// or Aᵀ from the accumulators in registers and the walked (or, for dQ,
// the key) tile read MN-major from the same staged copy (the transpose
// bit). Each tile's S and dP are issued together with the last tile's
// gradient products, and the next operands (dS, A) are formed while those
// run. A is f32: it runs as two bf16 parts, hi = bf16(A) and lo = bf16(A
// − hi), each part's product summed in f32; what the two leave out is at
// most 2⁻¹⁶ of each entry of A (the bf16 rounding of lo), below dv's own
// bf16 rounding (2⁻⁹). A tile that no rule cuts skips the per-element test;
// causal blocks skip the tiles past the diagonal. Heads wider than 128 run
// flash_bwd.cu's chunked kernels at bf16.
#include "flash_bf16.cuh"

namespace {

using ns2::bf16;
using ns2::sm90::pin;
namespace sm90 = ns2::sm90;

constexpr int kOwn = 128;                  // rows a block owns
constexpr int kConsumers = 256;                    // two warpgroups of 64
constexpr int kProducers = 128;                    // and one that copies
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 4;  // the rings' depth (flash_variants.py times 3)
constexpr float kLog2e = 1.4426950408889634f;

// dq: the owned Q and dO, then rings of K and V tiles, then the barriers.
template <int D>
struct DqLayout {
  static constexpr int kWalk = 64;
  static constexpr uint32_t kPanelOwn = kOwn * sm90::kPanelRowBytes;
  static constexpr uint32_t kPanelWalk = kWalk * sm90::kPanelRowBytes;
  static constexpr uint32_t kTileWalk = kPanelWalk * (D / 64);
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDo = kQ + kPanelOwn * (D / 64);
  static constexpr uint32_t kK = kDo + kPanelOwn * (D / 64);
  static constexpr uint32_t kV = kK + kStages * kTileWalk;
  static constexpr uint32_t kBars = kV + kStages * kTileWalk;
  static constexpr int kBytes = (int)kBars + 8 * (1 + 2 * kStages) + 1024;
};

// dk/dv: the owned K and V, rings of Q and dO tiles and of their lse and
// delta rows, then the barriers.
template <int D>
struct DkvLayout {
  static constexpr int kWalk = D == 64 ? 64 : 32;
  static constexpr uint32_t kPanelOwn = kOwn * sm90::kPanelRowBytes;
  static constexpr uint32_t kPanelWalk = kWalk * sm90::kPanelRowBytes;
  static constexpr uint32_t kTileWalk = kPanelWalk * (D / 64);
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = kK + kPanelOwn * (D / 64);
  static constexpr uint32_t kQ = kV + kPanelOwn * (D / 64);
  static constexpr uint32_t kDo = kQ + kStages * kTileWalk;
  static constexpr uint32_t kLse = kDo + kStages * kTileWalk;
  static constexpr uint32_t kDelta = kLse + kStages * kWalk * 4;
  static constexpr uint32_t kBars = kDelta + kStages * kWalk * 4;
  static constexpr int kBytes = (int)kBars + 8 * (1 + 2 * kStages) + 1024;
};

// The barriers: the owned tiles' (`own`), and each stage's full and empty.
struct Bars {
  uint64_t *own, *full, *empty;
};

__device__ __forceinline__ Bars init_bars(unsigned char* at, int tid) {
  uint64_t* b = reinterpret_cast<uint64_t*>(at);
  if (tid == 0) {
    sm90::mbar_init(b, kProducers);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(b + 1 + st, kProducers);
      sm90::mbar_init(b + 1 + kStages + st, kConsumers / 32);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  return Bars{b, b + 1, b + 1 + kStages};
}

// s (+)= X·Yᵀ over the head width: X the warpgroup's 64 owned rows (panel
// stride own), Y a walked tile of 8·NJ rows (panel stride walk), both
// K-major.
template <int D, int NJ>
__device__ __forceinline__ void product_xyt(float (&s)[NJ][4], uint32_t x, uint32_t own,
                                            uint32_t y, uint32_t walk) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (uint32_t)(ks % 4) * 32u;  // k-step within its panel
    const uint64_t a = sm90::desc(x + (ks / 4) * own + off);
    const uint64_t b = sm90::desc(y + (ks / 4) * walk + off);
    if constexpr (NJ == 8)
      sm90::wgmma_ss_n64(s, a, b, ks > 0);
    else
      sm90::wgmma_ss_n32(s, a, b, ks > 0);
  }
}

// acc += A·T: A in registers (k-steps of 16 walked rows), T the walked
// tile (panel stride walk) read MN-major, each 64-column panel of acc apart.
template <int D, int KS>
__device__ __forceinline__ void add_product(float (&acc)[D / 64][8][4], const uint32_t (&a)[KS][4],
                                            uint32_t tile, uint32_t walk) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      sm90::wgmma_rs_n64_mn(acc[p], a[ks], sm90::desc(tile + p * walk + ks * 2048u));
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 64][8][4]) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[p][j][i] = 0.0f;
}

// Rows ra and ra + 8 of a warpgroup's accumulator (columns 64p + 8j + 2t +
// {0, 1}) to a bf16 [n_rows, D] matrix.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 64][8][4], int ra,
                                           int n_rows, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ns2::store2(dst + (size_t)row * D + 64 * p + 8 * j + 2 * t, acc[p][j][2 * r],
                    acc[p][j][2 * r + 1]);
  }
}

// dS (f32) in place of S for one warp's rows of the dq kernel: element (j,
// i) is query ra + 8·(i / 2), key k0 + 8j + 2t + (i & 1); row0 is the
// warp's first query.
struct DqRows {
  const unsigned char* mask_b;
  int bi, hi, row0, ra, t, n_q, n_kv, causal;
  float c, scale, lse2[2], delta[2];  // lse2: lse·log2 e of rows ra, ra + 8
};

template <int W, bool kDropout>
__device__ __forceinline__ void dq_ds(float (&s)[W / 8][4], const float (&dp)[W / 8][4],
                                      const DqRows& rw, int k0, const ns2::Dropout& dr) {
  const bool whole = rw.mask_b == nullptr && rw.row0 + 16 <= rw.n_q && k0 + W <= rw.n_kv &&
                     (!rw.causal || k0 + W - 1 <= rw.row0);
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rw.ra + 8 * (i / 2), col = k0 + 8 * j + 2 * rw.t + (i & 1);
      float ds = 0.0f;
      if (whole || ns2::visible(rw.mask_b, row, col, rw.n_q, rw.n_kv, rw.causal)) {
        const float p = sm90::ex2(fmaf(s[j][i], rw.c, -rw.lse2[i / 2]));
        float d = dp[j][i];
        if (kDropout) d *= ns2::keep_mult(dr, rw.bi, rw.hi, row, col);
        ds = p * (d - rw.delta[i / 2]) * rw.scale;
      }
      s[j][i] = ds;
    }
}

// grid (ceil(n_q / 128), b·h), kThreads threads, DqLayout<D>::kBytes. Each
// tile's S and dP are issued together with the last tile's dQ += dS·K, and
// dS is formed while that product runs. kDropout: apply the keep mask (its
// Threefry code stays out of the other instantiation).
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const bf16* __restrict__ dout, bf16* __restrict__ dq, int heads, int n_q,
                         int n_kv, int causal, float scale, ns2::Dropout dr) {
  using L = DqLayout<D>;
  constexpr int W = L::kWalk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const Bars bars = init_bars(smem_raw + (base - raw) + L::kBars, tid);

  const int q0 = blockIdx.x * kOwn, bh = blockIdx.y;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  const int k_end = causal ? min(n_kv, q0 + kOwn) : n_kv;
  const int n_tiles = (k_end + W - 1) / W;

  if (tid >= kConsumers) {  // the producer warpgroup
    sm90::producer_regs<2>();
    const int ptid = tid - kConsumers;
    sm90::load_tile<kOwn, D>(base + L::kQ, q + qbase * D, q0, n_q, ptid, kProducers);
    sm90::load_tile<kOwn, D>(base + L::kDo, dout + qbase * D, q0, n_q, ptid, kProducers);
    sm90::mbar_arrive_copies(bars.own);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages;
      sm90::mbar_wait(&bars.empty[st], ((kt / kStages) & 1) ^ 1);
      sm90::load_tile<W, D>(base + L::kK + st * L::kTileWalk, k + kbase * D, kt * W, n_kv, ptid,
                            kProducers);
      sm90::load_tile<W, D>(base + L::kV + st * L::kTileWalk, v + kbase * D, kt * W, n_kv, ptid,
                            kProducers);
      sm90::mbar_arrive_copies(&bars.full[st]);
    }
    sm90::cp_async_drain();
    return;
  }
  sm90::consumer_regs<2>();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp;
  DqRows rw{mask ? mask + (size_t)(bh / heads) * n_kv : nullptr,
            bh / heads, bh % heads, row0, row0 + lane / 4, lane % 4, n_q, n_kv, causal,
            scale * kLog2e, scale, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw.ra + 8 * r;
    rw.lse2[r] = row < n_q ? lse[qbase + row] * kLog2e : 0.0f;
    rw.delta[r] = row < n_q ? delta[qbase + row] : 0.0f;
  }
  const uint32_t q_at = base + L::kQ + 64 * wg * sm90::kPanelRowBytes;
  const uint32_t do_at = base + L::kDo + 64 * wg * sm90::kPanelRowBytes;
  auto k_at = [&](int st) { return base + L::kK + st * L::kTileWalk; };
  auto v_at = [&](int st) { return base + L::kV + st * L::kTileWalk; };

  float acc[D / 64][8][4];
  zero<D>(acc);
  float s[W / 8][4], dp[W / 8][4];
  uint32_t da[W / 16][4];
  auto pack = [&]() {
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks) sm90::pack_a(s[2 * ks], s[2 * ks + 1], da[ks]);
  };
  sm90::mbar_wait(bars.own, 0);
  sm90::mbar_wait(&bars.full[0], 0);
  ns2::fence_proxy_async();
  pin(s);
  pin(dp);
  ns2::wg_fence();
  product_xyt<D>(s, q_at, L::kPanelOwn, k_at(0), L::kPanelWalk);    // S = Q Kᵀ
  product_xyt<D>(dp, do_at, L::kPanelOwn, v_at(0), L::kPanelWalk);  // dP = dO Vᵀ
  ns2::wg_commit();
  sm90::wg_wait<0>();
  pin(s);
  pin(dp);
  dq_ds<W, kDropout>(s, dp, rw, 0, dr);
  pack();
  for (int kt = 1; kt < n_tiles; ++kt) {
    const int st = kt % kStages, st_prev = (kt - 1) % kStages;
    sm90::mbar_wait(&bars.full[st], (kt / kStages) & 1);
    ns2::fence_proxy_async();
    pin(s);
    pin(dp);
    pin(da);
    pin(acc);
    ns2::wg_fence();
    product_xyt<D>(s, q_at, L::kPanelOwn, k_at(st), L::kPanelWalk);
    product_xyt<D>(dp, do_at, L::kPanelOwn, v_at(st), L::kPanelWalk);
    ns2::wg_commit();
    add_product<D>(acc, da, k_at(st_prev), L::kPanelWalk);  // dQ += dS K, the last tile's
    ns2::wg_commit();
    sm90::wg_wait<1>();
    pin(s);
    pin(dp);
    dq_ds<W, kDropout>(s, dp, rw, kt * W, dr);
    sm90::wg_wait<0>();
    pin(acc);
    pin(da);
    if (lane == 0) sm90::mbar_arrive(&bars.empty[st_prev]);
    pack();
  }
  pin(da);
  pin(acc);
  ns2::wg_fence();
  add_product<D>(acc, da, k_at((n_tiles - 1) % kStages), L::kPanelWalk);
  ns2::wg_commit();
  sm90::wg_wait<0>();
  pin(acc);
  store_rows<D>(dq + qbase * D, acc, rw.ra, n_q, rw.t);
}

// A in place of Sᵀ and dS in place of dPᵀ for one warp's keys of the dk/dv
// kernel: element (j, i) is key ka + 8·(i / 2), query qs + 8j + 2t + (i &
// 1), with the tile's lse and delta rows from shared memory; row0 is the
// warp's first key.
struct DkvRows {
  const unsigned char* mask_b;
  int bi, hi, row0, ka, t, n_q, n_kv, causal;
  float c, scale;
};

template <int W, bool kDropout>
__device__ __forceinline__ void dkv_ads(float (&s)[W / 8][4], float (&dp)[W / 8][4],
                                        const DkvRows& rw, int qs, const float* lse_s,
                                        const float* delta_s, const ns2::Dropout& dr) {
  const bool whole = rw.mask_b == nullptr && qs + W <= rw.n_q && rw.row0 + 16 <= rw.n_kv &&
                     (!rw.causal || rw.row0 + 15 <= qs);
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * rw.t);
    const float2 dl2 = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * rw.t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i & 1, qc = qs + 8 * j + 2 * rw.t + e, key = rw.ka + 8 * (i / 2);
      float a = 0.0f, ds = 0.0f;
      if (whole || ns2::visible(rw.mask_b, qc, key, rw.n_q, rw.n_kv, rw.causal)) {
        const float p = sm90::ex2(fmaf(s[j][i], rw.c, -(e ? lse2.y : lse2.x) * kLog2e));
        float d = dp[j][i];
        a = p;
        if (kDropout) {
          const float keep = ns2::keep_mult(dr, rw.bi, rw.hi, qc, key);
          a = p * keep;
          d *= keep;
        }
        ds = p * (d - (e ? dl2.y : dl2.x)) * rw.scale;
      }
      s[j][i] = a;
      dp[j][i] = ds;
    }
  }
}

// grid (ceil(n_kv / 128), b·h), kThreads threads, DkvLayout<D>::kBytes.
// Each tile's Sᵀ and dPᵀ are issued together with the last tile's dV and
// dK products, and A and dS are formed while those run. kDropout as for the
// dq kernel.
template <int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const bf16* __restrict__ dout, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int heads, int n_q, int n_kv, int causal,
                          float scale, ns2::Dropout dr) {
  using L = DkvLayout<D>;
  constexpr int W = L::kWalk;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  const Bars bars = init_bars(gbase + L::kBars, tid);

  const int kv0 = blockIdx.x * kOwn, bh = blockIdx.y;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  // causal: query tiles that end before this key block starts see none of it
  const int q_begin = causal ? kv0 : 0;
  const int n_tiles = q_begin < n_q ? (n_q - q_begin + W - 1) / W : 0;

  if (tid >= kConsumers) {  // the producer warpgroup
    sm90::producer_regs<2>();
    const int ptid = tid - kConsumers;
    if (n_tiles == 0) return;
    sm90::load_tile<kOwn, D>(base + L::kK, k + kbase * D, kv0, n_kv, ptid, kProducers);
    sm90::load_tile<kOwn, D>(base + L::kV, v + kbase * D, kv0, n_kv, ptid, kProducers);
    sm90::mbar_arrive_copies(bars.own);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % kStages, qs = q_begin + kt * W;
      sm90::mbar_wait(&bars.empty[st], ((kt / kStages) & 1) ^ 1);
      sm90::load_tile<W, D>(base + L::kQ + st * L::kTileWalk, q + qbase * D, qs, n_q, ptid,
                            kProducers);
      sm90::load_tile<W, D>(base + L::kDo + st * L::kTileWalk, dout + qbase * D, qs, n_q, ptid,
                            kProducers);
      sm90::load_row_f32(base + L::kLse + st * W * 4, lse + qbase, qs, n_q, W, ptid,
                         kProducers);
      sm90::load_row_f32(base + L::kDelta + st * W * 4, delta + qbase, qs, n_q, W, ptid,
                         kProducers);
      sm90::mbar_arrive_copies(&bars.full[st]);
    }
    sm90::cp_async_drain();
    return;
  }
  sm90::consumer_regs<2>();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = kv0 + 64 * wg + 16 * warp;
  const DkvRows rw{mask ? mask + (size_t)(bh / heads) * n_kv : nullptr,
                   bh / heads, bh % heads, row0, row0 + lane / 4, lane % 4, n_q, n_kv, causal,
                   scale * kLog2e, scale};
  const uint32_t k_at = base + L::kK + 64 * wg * sm90::kPanelRowBytes;
  const uint32_t v_at = base + L::kV + 64 * wg * sm90::kPanelRowBytes;
  auto q_at = [&](int st) { return base + L::kQ + st * L::kTileWalk; };
  auto do_at = [&](int st) { return base + L::kDo + st * L::kTileWalk; };
  auto rows_at = [&](uint32_t at, int st) {
    return reinterpret_cast<const float*>(gbase + at + st * W * 4);
  };

  float acc_k[D / 64][8][4], acc_v[D / 64][8][4];
  zero<D>(acc_k);
  zero<D>(acc_v);
  float s[W / 8][4], dp[W / 8][4];
  uint32_t a_hi[W / 16][4], a_lo[W / 16][4], da[W / 16][4];
  // A as two bf16 parts (hi, and the rounding of A − hi), dS rounded
  auto pack = [&]() {
#pragma unroll
    for (int ks = 0; ks < W / 16; ++ks) {
      sm90::pack_a(s[2 * ks], s[2 * ks + 1], a_hi[ks]);
      float lo0[4], lo1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo0[i] = s[2 * ks][i] - __bfloat162float(__float2bfloat16_rn(s[2 * ks][i]));
        lo1[i] = s[2 * ks + 1][i] - __bfloat162float(__float2bfloat16_rn(s[2 * ks + 1][i]));
      }
      sm90::pack_a(lo0, lo1, a_lo[ks]);
      sm90::pack_a(dp[2 * ks], dp[2 * ks + 1], da[ks]);
    }
  };
  // dV += Aᵀ dO (the small part, then the large) and dK += dSᵀ Q on stage st
  auto issue_grads = [&](int st) {
    add_product<D>(acc_v, a_lo, do_at(st), L::kPanelWalk);
    add_product<D>(acc_v, a_hi, do_at(st), L::kPanelWalk);
    add_product<D>(acc_k, da, q_at(st), L::kPanelWalk);
  };
  if (n_tiles > 0) {
    sm90::mbar_wait(bars.own, 0);
    sm90::mbar_wait(&bars.full[0], 0);
    ns2::fence_proxy_async();
    pin(s);
    pin(dp);
    ns2::wg_fence();
    product_xyt<D>(s, k_at, L::kPanelOwn, q_at(0), L::kPanelWalk);    // Sᵀ = K Qᵀ
    product_xyt<D>(dp, v_at, L::kPanelOwn, do_at(0), L::kPanelWalk);  // dPᵀ = V dOᵀ
    ns2::wg_commit();
    sm90::wg_wait<0>();
    pin(s);
    pin(dp);
    dkv_ads<W, kDropout>(s, dp, rw, q_begin, rows_at(L::kLse, 0), rows_at(L::kDelta, 0), dr);
    pack();
    for (int kt = 1; kt < n_tiles; ++kt) {
      const int st = kt % kStages, st_prev = (kt - 1) % kStages;
      sm90::mbar_wait(&bars.full[st], (kt / kStages) & 1);
      ns2::fence_proxy_async();
      pin(s);
      pin(dp);
      pin(a_hi);
      pin(a_lo);
      pin(da);
      pin(acc_k);
      pin(acc_v);
      ns2::wg_fence();
      product_xyt<D>(s, k_at, L::kPanelOwn, q_at(st), L::kPanelWalk);
      product_xyt<D>(dp, v_at, L::kPanelOwn, do_at(st), L::kPanelWalk);
      ns2::wg_commit();
      issue_grads(st_prev);
      ns2::wg_commit();
      sm90::wg_wait<1>();
      pin(s);
      pin(dp);
      dkv_ads<W, kDropout>(s, dp, rw, q_begin + kt * W, rows_at(L::kLse, st),
                           rows_at(L::kDelta, st), dr);
      sm90::wg_wait<0>();
      pin(acc_k);
      pin(acc_v);
      pin(a_hi);
      pin(a_lo);
      pin(da);
      if (lane == 0) sm90::mbar_arrive(&bars.empty[st_prev]);
      pack();
    }
    pin(a_hi);
    pin(a_lo);
    pin(da);
    pin(acc_k);
    pin(acc_v);
    ns2::wg_fence();
    issue_grads((n_tiles - 1) % kStages);
    ns2::wg_commit();
    sm90::wg_wait<0>();
    pin(acc_k);
    pin(acc_v);
  }
  store_rows<D>(dk + kbase * D, acc_k, rw.ka, n_kv, rw.t);
  store_rows<D>(dv + kbase * D, acc_v, rw.ka, n_kv, rw.t);
}

template <int D, bool kDropout>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
                   const float* lse, const float* delta, const bf16* dout, bf16* dq, bf16* dk,
                   bf16* dv, int b, int h, int n_q, int n_kv, int causal, float scale,
                   const ns2::Dropout& dr, cudaStream_t st) {
  constexpr int dq_bytes = DqLayout<D>::kBytes, dkv_bytes = DkvLayout<D>::kBytes;
  auto dq_kernel = flash_bwd_dq_bf16_kernel<D, kDropout>;
  auto dkv_kernel = flash_bwd_dkv_bf16_kernel<D, kDropout>;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((n_q + kOwn - 1) / kOwn, b * h);
  dq_kernel<<<grid_q, kThreads, dq_bytes, st>>>(q, k, v, mask, lse, delta, dout, dq, h, n_q, n_kv,
                                                causal, scale, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((n_kv + kOwn - 1) / kOwn, b * h);
  dkv_kernel<<<grid_kv, kThreads, dkv_bytes, st>>>(q, k, v, mask, lse, delta, dout, dk, dv, h,
                                                   n_q, n_kv, causal, scale, dr);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
                   const float* lse, const float* delta, const bf16* dout, bf16* dq, bf16* dk,
                   bf16* dv, int b, int h, int n_q, int n_kv, int causal, float scale,
                   const ns2::Dropout& dr, cudaStream_t st) {
  return dr.rate > 0.0f ? launch<D, true>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q,
                                          n_kv, causal, scale, dr, st)
                        : launch<D, false>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h,
                                           n_q, n_kv, causal, scale, dr, st);
}

}  // namespace

// q/dout [b,h,n_q,d], k/v [b,h,n_kv,d] bf16, 16-byte aligned, mask [b,n_kv]
// uint8 or null, lse and delta [b,h,n_q] f32 -> dq [b,h,n_q,d], dk/dv
// [b,h,n_kv,d] bf16. Dropout arguments as for ns2_flash_fwd. d is 64 or a
// multiple of 128 and scale positive; anything else returns
// cudaErrorInvalidValue.
NS2_API int ns2_flash_bwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                               const unsigned char* mask, const float* lse, const float* delta,
                               const bf16* dout, bf16* dq, bf16* dk, bf16* dv, int b, int h,
                               int n_q, int n_kv, int d, int causal, float scale, unsigned seed0,
                               unsigned seed1, float rate, int stride, unsigned threshold,
                               float keep_scale, int b_offset, int h_offset, void* stream) {
  if ((d != 64 && (d <= 0 || d % 128 != 0)) || n_q <= 0 || n_kv <= 0 || !(scale > 0.0f))
    return cudaErrorInvalidValue;
  const ns2::Dropout dr{seed0, seed1, rate, stride, threshold, keep_scale, b_offset, h_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv, causal,
                      scale, dr, st);
  if (d == 128)
    return launch<128>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv, causal,
                       scale, dr, st);
  return ns2::flash_bwd_wide_bf16(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv,
                                  d, causal, scale, dr, st);
}
