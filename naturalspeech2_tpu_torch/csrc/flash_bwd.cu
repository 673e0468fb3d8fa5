// K5: flash attention backward, dq and dk/dv, on the tensor cores in split
// TF32.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` in naturalspeech2_tpu/ops/flash_attention.py. With
// the forward's per-row lse and delta = Σ_d dO·O (a plain reduction before
// the launch, as XLA computes it outside the TPU kernels):
//   P  = valid ? exp(q kᵀ · scale − lse) : 0      (masked P exactly 0)
//   A  = P ∘ keep,  dP = (dO vᵀ) ∘ keep            (keep: the forward's
//                                                    Threefry dropout mask)
//   dS = P ∘ (dP − delta) · scale
//   dq = dS k,  dk = dSᵀ q,  dv = Aᵀ dO.
//
// What bounds it on the card: the matrix products. The bound counts five
// n_q·n_kv·D products (S, dP, dV, dQ, dK); this kernel executes seven,
// since each owner kernel recomputes S and dP for itself, and each product
// takes three TF32 passes (split TF32, flash.cuh) on the tensor cores.
//
// Design: each output has one owner block that loops inside itself, as
// the TPU grid accumulates across a sequential axis: flash_bwd_dq_kernel
// owns (batch·head, 64 query rows) and walks the keys in tiles of 32;
// flash_bwd_dkv_kernel owns (batch·head, 64 keys) and walks the queries in
// tiles of 32. Every sum stays in one warp's accumulators, so there are no
// atomics and the result is deterministic. Four warps per block, each
// owning 16 of the block's 64 rows (queries, or keys), run every product on
// `mma.sync.m16n8k8` TF32 tiles in split TF32. The backward needs P and dS
// in both orientations; `mma.sync` fragments are loaded from shared memory
// by arbitrary index, so the transposed products read the same padded tiles
// (flash.cuh's direct and paired patterns, both free of bank conflicts) and
// the accumulators of S and dP become the A operands of dV, dK and dQ in
// registers. `wgmma`'s TF32 operands would have to be K-major copies in
// shared memory, one per orientation. The owner's own tiles (Q and dO, or
// K and V) are staged once; the walked tiles arrive by `cp.async` in a
// two-stage ring, the next one in flight while this one's products run.
// Operands are split into hi and lo once per fragment read, never per
// product; S and dP keep their small terms apart, and each tile's dQ, dK
// and dV are summed apart and added in f32, as in K4, against the tensor
// cores' truncating adds. A tile that no rule cuts skips the per-element
// test. Causal blocks skip the tiles past the diagonal. With 32-row walked
// tiles three blocks share an SM; at the training shape [16,8,150,64] that
// took 0.11 ms on the card against 0.18 with 64-row tiles (two blocks), at
// [4,8,1024,64] 0.81 against 0.77. The head width D is 64 or 128 (a
// template parameter; the wrapper pads narrower heads with zeros, wider ones
// to a multiple of 128, which the wide kernels below walk in 128-wide
// chunks). At 128
// the staged tiles take 135 KB, one block an SM, and each product's
// 64-column groups are summed in turn in one partial accumulator
// (flash.cuh add_product), which keeps the owner's two 64-register sums
// within the thread's registers.
//
// bf16 at heads 64 and 128 wide is flash_bwd_bf16.cu's pair of kernels.
// Wider bf16 heads (`ns2::flash_bwd_wide_bf16`) run the chunked kernels
// below at the JAX kernels' rounding points at a bf16 input dtype: dO
// widened to f32, S = Q·Kᵀ and dP = dO·Vᵀ summed in f32 from the bf16
// values, dS rounded to bf16 before dQ = dS·K and dK = dSᵀ·Q, and dV = Aᵀ·dO
// with A = P∘keep NOT rounded (`a.astype(do.dtype)` with dO already f32).
// Their tiles are widened to f32 as they are staged (bf16 is exact in f32
// and in TF32), so every fragment pattern and rule above is unchanged; where
// both operands are bf16 values (S, dP, dQ, dK) one TF32 pass is the exact
// product, and dV runs A split into TF32 hi and lo against dO as it is, two
// passes. The widening loads go through registers, not overlapped with the
// products.
#include "flash.cuh"

namespace {

using ns2::bf16;
using ns2::kFlashThreads;
using ns2::kLdOf;
using ns2::kTile;

// Rows per walked tile, and with them the blocks an SM holds: at 32 rows
// three (about 70 KB of shared memory and at most 168 registers a thread
// each), 12 warps to hide the latency of the fragment loads, splits and
// mmas; at 64 two.
constexpr int kDqWalk = 32;
constexpr int kDkvWalk = 32;

template <int kWalk, int D>
struct DqSmem {
  float q[kTile][kLdOf<D>];      // the block's query rows
  float dout[kTile][kLdOf<D>];   // and their dO
  float k[2][kWalk][kLdOf<D>];   // key tiles, a two-stage ring
  float v[2][kWalk][kLdOf<D>];   // value tiles
};

template <int kWalk, int D>
struct DkvSmem {
  float k[kTile][kLdOf<D>];       // the block's keys
  float v[kTile][kLdOf<D>];       // and their values
  float q[2][kWalk][kLdOf<D>];    // query tiles, a two-stage ring
  float dout[2][kWalk][kLdOf<D>]; // dO tiles
  float lse[2][kWalk];
  float delta[2][kWalk];
};

// Blocks an SM: at D = 64 three with 32-row walked tiles, two with 64; at
// D = 128 one.
template <int kWalk, int D>
constexpr int kBwdBlocks = D == 128 ? 1 : (kWalk == 32 ? 3 : 2);

// dS in place of S for one warp's 16 query rows and a walked tile of keys
// from k0 (dq's orientation): element (j, i) is query ra + 8·(i / 2), key k0
// + 8j + 2t + (i & 1); w0 is the warp's first query. A tile that no rule
// cuts skips the per-element test.
// dS as the next products take it: rounded to bf16 where they run on bf16
// operands (the JAX kernels' `ds.astype(k.dtype)`), else as it is.
template <bool kRound>
__device__ __forceinline__ float ds_operand(float ds) {
  return kRound ? __bfloat162float(__float2bfloat16_rn(ds)) : ds;
}

template <int kWalk, bool kRound>
__device__ __forceinline__ void dq_ds(float (&s)[kWalk / 8][4], const float (&dp)[kWalk / 8][4],
                                      const unsigned char* mask_b, int bi, int hi, int w0, int ra,
                                      int k0, int n_q, int n_kv, int causal, float scale,
                                      const float (&row_lse)[2], const float (&row_delta)[2],
                                      int t, const ns2::Dropout& dr) {
  const bool whole = mask_b == nullptr && w0 + 16 <= n_q && k0 + kWalk <= n_kv &&
                     (!causal || k0 + kWalk - 1 <= w0);
#pragma unroll
  for (int j = 0; j < kWalk / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ra + 8 * (i / 2), col = k0 + 8 * j + 2 * t + (i & 1);
      float ds = 0.0f;
      if (whole || ns2::visible(mask_b, row, col, n_q, n_kv, causal)) {
        const float p = ns2::exp_sfu(s[j][i] * scale - row_lse[i / 2]);
        float d = dp[j][i];
        if (dr.rate > 0.0f) d *= ns2::keep_mult(dr, bi, hi, row, col);
        ds = ds_operand<kRound>(p * (d - row_delta[i / 2]) * scale);
      }
      s[j][i] = ds;
    }
}

// A = P ∘ keep in place of Sᵀ and dS in place of dPᵀ for one warp's 16 keys
// and a walked tile of queries from qs (dk/dv's orientation): element (j, i)
// is key ka + 8·(i / 2), query qs + 8j + 2t + (i & 1); w0 is the warp's first
// key, lse and delta the tile's rows.
template <int kWalk, bool kRound>
__device__ __forceinline__ void dkv_ads(float (&s)[kWalk / 8][4], float (&dp)[kWalk / 8][4],
                                        const unsigned char* mask_b, int bi, int hi, int w0,
                                        int ka, int qs, int n_q, int n_kv, int causal,
                                        float scale, const float* lse, const float* delta, int t,
                                        const ns2::Dropout& dr) {
  const bool whole = mask_b == nullptr && qs + kWalk <= n_q && w0 + 16 <= n_kv &&
                     (!causal || w0 + 15 <= qs);
#pragma unroll
  for (int j = 0; j < kWalk / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qc = 8 * j + 2 * t + (i & 1), row = qs + qc, col = ka + 8 * (i / 2);
      float a = 0.0f, ds = 0.0f;
      if (whole || ns2::visible(mask_b, row, col, n_q, n_kv, causal)) {
        const float p = ns2::exp_sfu(s[j][i] * scale - lse[qc]);
        float d = dp[j][i];
        a = p;
        if (dr.rate > 0.0f) {
          const float keep = ns2::keep_mult(dr, bi, hi, row, col);
          a = p * keep;
          d *= keep;
        }
        ds = ds_operand<kRound>(p * (d - delta[qc]) * scale);
      }
      s[j][i] = a;
      dp[j][i] = ds;
    }
}

// grid (ceil(n_q / 64), b·h), 128 threads; dynamic shared memory
// sizeof(DqSmem<kWalk, D>). T: the element type of q, k, v, dO and dq (f32,
// or bf16 with the rounding points in the header).
template <class T, int kWalk, int D>
__global__ void __launch_bounds__(kFlashThreads, (kBwdBlocks<kWalk, D>))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                    const float* __restrict__ delta, const T* __restrict__ dout,
                    T* __restrict__ dq, int heads, int n_q, int n_kv, int causal, float scale,
                    ns2::Dropout dr) {
  constexpr bool kSplit = sizeof(T) == 4;  // f32 operands: split TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<kWalk, D>& sm = *reinterpret_cast<DqSmem<kWalk, D>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  const T* kh = k + kbase * D;
  const T* vh = v + kbase * D;
  const unsigned char* mask_b = mask ? mask + (size_t)bi * n_kv : nullptr;

  const int k_end = causal ? min(n_kv, q0 + kTile) : n_kv;
  const int n_tiles = (k_end + kWalk - 1) / kWalk;
  ns2::load_tile_async<kTile, D>(sm.q, q + qbase * D, q0, n_q, tid, kFlashThreads);
  ns2::load_tile_async<kTile, D>(sm.dout, dout + qbase * D, q0, n_q, tid, kFlashThreads);
  ns2::load_tile_async<kWalk, D>(sm.k[0], kh, 0, n_kv, tid, kFlashThreads);
  ns2::load_tile_async<kWalk, D>(sm.v[0], vh, 0, n_kv, tid, kFlashThreads);
  ns2::cp_async_commit();

  const int w0 = 16 * warp, ra = q0 + w0 + g;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    row_lse[r] = row < n_q ? lse[qbase + row] : 0.0f;
    row_delta[r] = row < n_q ? delta[qbase + row] : 0.0f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * kWalk;
    if (kt + 1 < n_tiles) {
      ns2::load_tile_async<kWalk, D>(sm.k[st ^ 1], kh, k0 + kWalk, n_kv, tid, kFlashThreads);
      ns2::load_tile_async<kWalk, D>(sm.v[st ^ 1], vh, k0 + kWalk, n_kv, tid, kFlashThreads);
      ns2::cp_async_commit();
      ns2::cp_async_wait<1>();
    } else {
      ns2::cp_async_wait<0>();
    }
    __syncthreads();

    float s[kWalk / 8][4], dp[kWalk / 8][4];
    ns2::product_xyt<kWalk / 8, D, kSplit>(sm.q, sm.k[st], w0, lane, s);      // S = Q Kᵀ
    ns2::product_xyt<kWalk / 8, D, kSplit>(sm.dout, sm.v[st], w0, lane, dp);  // dP = dO Vᵀ
    dq_ds<kWalk, !kSplit>(s, dp, mask_b, bi, hi, q0 + w0, ra, k0, n_q, n_kv, causal, scale,
                          row_lse, row_delta, t, dr);
    ns2::add_product<kWalk / 8, D, kSplit, kSplit>(acc, s, sm.k[st], g, t);  // dQ += dS K
    __syncthreads();
  }
  const float one[2] = {1.0f, 1.0f};
  ns2::store_rows<D>(dq + qbase * D, acc, ra, n_q, t, one);
}

// grid (ceil(n_kv / 64), b·h), 128 threads; dynamic shared memory
// sizeof(DkvSmem<kWalk, D>). T as for the dq kernel.
template <class T, int kWalk, int D>
__global__ void __launch_bounds__(kFlashThreads, (kBwdBlocks<kWalk, D>))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const unsigned char* __restrict__ mask, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int heads, int n_q, int n_kv,
                     int causal, float scale, ns2::Dropout dr) {
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<kWalk, D>& sm = *reinterpret_cast<DkvSmem<kWalk, D>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int kv0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  const T* qh = q + qbase * D;
  const T* dh = dout + qbase * D;
  const unsigned char* mask_b = mask ? mask + (size_t)bi * n_kv : nullptr;

  // causal: query tiles that end before this key tile starts see none of it
  const int q_begin = causal ? kv0 : 0;
  const int n_tiles = q_begin < n_q ? (n_q - q_begin + kWalk - 1) / kWalk : 0;
  auto load_query_tile = [&](int stage, int qs) {
    ns2::load_tile_async<kWalk, D>(sm.q[stage], qh, qs, n_q, tid, kFlashThreads);
    ns2::load_tile_async<kWalk, D>(sm.dout[stage], dh, qs, n_q, tid, kFlashThreads);
    if (tid < kWalk) {
      const bool ok = qs + tid < n_q;
      sm.lse[stage][tid] = ok ? lse[qbase + qs + tid] : 0.0f;
      sm.delta[stage][tid] = ok ? delta[qbase + qs + tid] : 0.0f;
    }
  };
  ns2::load_tile_async<kTile, D>(sm.k, k + kbase * D, kv0, n_kv, tid, kFlashThreads);
  ns2::load_tile_async<kTile, D>(sm.v, v + kbase * D, kv0, n_kv, tid, kFlashThreads);
  if (n_tiles > 0) load_query_tile(0, q_begin);
  ns2::cp_async_commit();

  const int w0 = 16 * warp, ka = kv0 + w0 + g;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.0f;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int st = qt & 1, qs = q_begin + qt * kWalk;
    if (qt + 1 < n_tiles) {
      load_query_tile(st ^ 1, qs + kWalk);
      ns2::cp_async_commit();
      ns2::cp_async_wait<1>();
    } else {
      ns2::cp_async_wait<0>();
    }
    __syncthreads();

    // transposed: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, element (j, i) is key
    // ka + 8·(i / 2), query qs + 8j + 2t + (i & 1)
    float s[kWalk / 8][4], dp[kWalk / 8][4];
    ns2::product_xyt<kWalk / 8, D, kSplit>(sm.k, sm.q[st], w0, lane, s);      // Sᵀ = K Qᵀ
    ns2::product_xyt<kWalk / 8, D, kSplit>(sm.v, sm.dout[st], w0, lane, dp);  // dPᵀ = V dOᵀ
    dkv_ads<kWalk, !kSplit>(s, dp, mask_b, bi, hi, kv0 + w0, ka, qs, n_q, n_kv, causal, scale,
                            sm.lse[st], sm.delta[st], t, dr);
    // dV += Aᵀ dO: A = P∘keep stays f32 (split) in both dtypes
    ns2::add_product<kWalk / 8, D, true, kSplit>(acc_v, s, sm.dout[st], g, t);
    ns2::add_product<kWalk / 8, D, kSplit, kSplit>(acc_k, dp, sm.q[st], g, t);  // dK += dSᵀ Q
    __syncthreads();
  }
  ns2::cp_async_wait<0>();  // with no query tile (causal, n_kv > n_q) K, V may be in flight
  const float one[2] = {1.0f, 1.0f};
  ns2::store_rows<D>(dk + kbase * D, acc_k, ka, n_kv, t, one);
  ns2::store_rows<D>(dv + kbase * D, acc_v, ka, n_kv, t, one);
}

// Heads wider than 128 (d a multiple of 128, as the JAX kernel pads d): the
// owner kernels above at D = 128 with grid z over the d / 128 chunks of the
// output, block z writing columns 128·z.. of dq (or dk and dv). For each
// walked tile, S and dP are summed over the head dim chunk by chunk, each
// chunk's owner and walked tiles staged through the same D = 128 buffers
// (stage 0 of the ring) and its products summed in fresh accumulators added
// in f32; the chunks run so that the block's own comes last, and its staged
// tiles then serve dQ += dS K (or dV += Aᵀ dO, dK += dSᵀ Q). Each block
// recomputes S and dP (d / 128 times in all) and restages its owner rows
// per chunk, with no copy in flight during the products: a first kernel
// for widths no config of the repo uses.
constexpr int kWideD = 128;

// grid (ceil(n_q / 64), b·h, d / 128), 128 threads; dynamic shared memory
// sizeof(DqSmem<kDqWalk, 128>)
template <class T>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const unsigned char* __restrict__ mask,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const T* __restrict__ dout, T* __restrict__ dq, int heads, int n_q,
                         int n_kv, int d, int causal, float scale, ns2::Dropout dr) {
  constexpr int D = kWideD, kWalk = kDqWalk;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<kWalk, D>& sm = *reinterpret_cast<DqSmem<kWalk, D>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y, oc = blockIdx.z, nc = d / D;
  const int bi = bh / heads, hi = bh % heads;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  const unsigned char* mask_b = mask ? mask + (size_t)bi * n_kv : nullptr;
  const int k_end = causal ? min(n_kv, q0 + kTile) : n_kv;
  const int n_tiles = (k_end + kWalk - 1) / kWalk;

  const int w0 = 16 * warp, ra = q0 + w0 + g;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    row_lse[r] = row < n_q ? lse[qbase + row] : 0.0f;
    row_delta[r] = row < n_q ? delta[qbase + row] : 0.0f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kWalk;
    float s[kWalk / 8][4], dp[kWalk / 8][4];
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.0f;
    for (int i = 1; i <= nc; ++i) {
      const int c = (oc + i) % nc;  // the block's own chunk last
      __syncthreads();  // the last products are done with the staged tiles
      ns2::load_tile_async<kTile, D>(sm.q, q + qbase * d + c * D, q0, n_q, tid, kFlashThreads, d);
      ns2::load_tile_async<kTile, D>(sm.dout, dout + qbase * d + c * D, q0, n_q, tid,
                                     kFlashThreads, d);
      ns2::load_tile_async<kWalk, D>(sm.k[0], k + kbase * d + c * D, k0, n_kv, tid,
                                     kFlashThreads, d);
      ns2::load_tile_async<kWalk, D>(sm.v[0], v + kbase * d + c * D, k0, n_kv, tid,
                                     kFlashThreads, d);
      ns2::cp_async_commit();
      ns2::cp_async_wait<0>();
      __syncthreads();
      float sc[kWalk / 8][4], dpc[kWalk / 8][4];
      ns2::product_xyt<kWalk / 8, D, kSplit>(sm.q, sm.k[0], w0, lane, sc);  // S_c = Q_c K_cᵀ
      ns2::product_xyt<kWalk / 8, D, kSplit>(sm.dout, sm.v[0], w0, lane, dpc);  // dP_c
#pragma unroll
      for (int j = 0; j < kWalk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += sc[j][e];
          dp[j][e] += dpc[j][e];
        }
    }
    dq_ds<kWalk, !kSplit>(s, dp, mask_b, bi, hi, q0 + w0, ra, k0, n_q, n_kv, causal, scale,
                          row_lse, row_delta, t, dr);
    ns2::add_product<kWalk / 8, D, kSplit, kSplit>(acc, s, sm.k[0], g, t);  // dQ_oc += dS K_oc
  }
  const float one[2] = {1.0f, 1.0f};
  ns2::store_rows<D>(dq + qbase * d + oc * D, acc, ra, n_q, t, one, d);
}

// grid (ceil(n_kv / 64), b·h, d / 128), 128 threads; dynamic shared memory
// sizeof(DkvSmem<kDkvWalk, 128>)
template <class T>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const unsigned char* __restrict__ mask,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                          int heads, int n_q, int n_kv, int d, int causal, float scale,
                          ns2::Dropout dr) {
  constexpr int D = kWideD, kWalk = kDkvWalk;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<kWalk, D>& sm = *reinterpret_cast<DkvSmem<kWalk, D>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int kv0 = blockIdx.x * kTile, bh = blockIdx.y, oc = blockIdx.z, nc = d / D;
  const int bi = bh / heads, hi = bh % heads;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  const unsigned char* mask_b = mask ? mask + (size_t)bi * n_kv : nullptr;
  const int q_begin = causal ? kv0 : 0;
  const int n_tiles = q_begin < n_q ? (n_q - q_begin + kWalk - 1) / kWalk : 0;

  const int w0 = 16 * warp, ka = kv0 + w0 + g;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.0f;

  for (int qt = 0; qt < n_tiles; ++qt) {
    const int qs = q_begin + qt * kWalk;
    float s[kWalk / 8][4], dp[kWalk / 8][4];
#pragma unroll
    for (int j = 0; j < kWalk / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.0f;
    for (int i = 1; i <= nc; ++i) {
      const int c = (oc + i) % nc;  // the block's own chunk last
      __syncthreads();  // the last products are done with the staged tiles
      ns2::load_tile_async<kTile, D>(sm.k, k + kbase * d + c * D, kv0, n_kv, tid, kFlashThreads,
                                     d);
      ns2::load_tile_async<kTile, D>(sm.v, v + kbase * d + c * D, kv0, n_kv, tid, kFlashThreads,
                                     d);
      ns2::load_tile_async<kWalk, D>(sm.q[0], q + qbase * d + c * D, qs, n_q, tid,
                                     kFlashThreads, d);
      ns2::load_tile_async<kWalk, D>(sm.dout[0], dout + qbase * d + c * D, qs, n_q, tid,
                                     kFlashThreads, d);
      if (i == 1 && tid < kWalk) {
        const bool ok = qs + tid < n_q;
        sm.lse[0][tid] = ok ? lse[qbase + qs + tid] : 0.0f;
        sm.delta[0][tid] = ok ? delta[qbase + qs + tid] : 0.0f;
      }
      ns2::cp_async_commit();
      ns2::cp_async_wait<0>();
      __syncthreads();
      float sc[kWalk / 8][4], dpc[kWalk / 8][4];
      ns2::product_xyt<kWalk / 8, D, kSplit>(sm.k, sm.q[0], w0, lane, sc);  // Sᵀ_c = K_c Q_cᵀ
      ns2::product_xyt<kWalk / 8, D, kSplit>(sm.v, sm.dout[0], w0, lane, dpc);  // dPᵀ_c
#pragma unroll
      for (int j = 0; j < kWalk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += sc[j][e];
          dp[j][e] += dpc[j][e];
        }
    }
    dkv_ads<kWalk, !kSplit>(s, dp, mask_b, bi, hi, kv0 + w0, ka, qs, n_q, n_kv, causal, scale,
                            sm.lse[0], sm.delta[0], t, dr);
    ns2::add_product<kWalk / 8, D, true, kSplit>(acc_v, s, sm.dout[0], g, t);  // dV_oc += Aᵀ dO_oc
    ns2::add_product<kWalk / 8, D, kSplit, kSplit>(acc_k, dp, sm.q[0], g, t);  // dK_oc += dSᵀ Q_oc
  }
  const float one[2] = {1.0f, 1.0f};
  ns2::store_rows<D>(dk + kbase * d + oc * D, acc_k, ka, n_kv, t, one, d);
  ns2::store_rows<D>(dv + kbase * d + oc * D, acc_v, ka, n_kv, t, one, d);
}

template <class T>
cudaError_t launch_bwd_wide(const T* q, const T* k, const T* v, const unsigned char* mask,
                            const float* lse, const float* delta, const T* dout, T* dq, T* dk,
                            T* dv, int b, int h, int n_q, int n_kv, int d, int causal,
                            float scale, const ns2::Dropout& dr, cudaStream_t st) {
  const int dq_bytes = (int)sizeof(DqSmem<kDqWalk, kWideD>);
  const int dkv_bytes = (int)sizeof(DkvSmem<kDkvWalk, kWideD>);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wide_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_wide_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((n_q + kTile - 1) / kTile, b * h, d / kWideD);
  flash_bwd_dq_wide_kernel<T><<<grid_q, kFlashThreads, dq_bytes, st>>>(
      q, k, v, mask, lse, delta, dout, dq, h, n_q, n_kv, d, causal, scale, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((n_kv + kTile - 1) / kTile, b * h, d / kWideD);
  flash_bwd_dkv_wide_kernel<T><<<grid_kv, kFlashThreads, dkv_bytes, st>>>(
      q, k, v, mask, lse, delta, dout, dk, dv, h, n_q, n_kv, d, causal, scale, dr);
  return cudaGetLastError();
}

template <class T, int D>
cudaError_t launch_bwd(const T* q, const T* k, const T* v, const unsigned char* mask,
                       const float* lse, const float* delta, const T* dout, T* dq, T* dk, T* dv,
                       int b, int h, int n_q, int n_kv, int causal, float scale,
                       const ns2::Dropout& dr, cudaStream_t st) {
  const int dq_bytes = (int)sizeof(DqSmem<kDqWalk, D>);
  const int dkv_bytes = (int)sizeof(DkvSmem<kDkvWalk, D>);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, kDqWalk, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, kDkvWalk, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((n_q + kTile - 1) / kTile, b * h);
  flash_bwd_dq_kernel<T, kDqWalk, D><<<grid_q, kFlashThreads, dq_bytes, st>>>(
      q, k, v, mask, lse, delta, dout, dq, h, n_q, n_kv, causal, scale, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((n_kv + kTile - 1) / kTile, b * h);
  flash_bwd_dkv_kernel<T, kDkvWalk, D><<<grid_kv, kFlashThreads, dkv_bytes, st>>>(
      q, k, v, mask, lse, delta, dout, dk, dv, h, n_q, n_kv, causal, scale, dr);
  return cudaGetLastError();
}

template <class T>
int flash_bwd(const T* q, const T* k, const T* v, const unsigned char* mask, const float* lse,
              const float* delta, const T* dout, T* dq, T* dk, T* dv, int b, int h, int n_q,
              int n_kv, int d, int causal, float scale, const ns2::Dropout& dr, void* stream) {
  if ((d != 64 && (d <= 0 || d % kWideD != 0)) || n_q <= 0 || n_kv <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_bwd<T, 64>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv,
                             causal, scale, dr, st);
  if (d == 128)
    return launch_bwd<T, 128>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv,
                              causal, scale, dr, st);
  return launch_bwd_wide<T>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv, d,
                            causal, scale, dr, st);
}

}  // namespace

// Heads wider than 128 at bf16 (flash_bwd_bf16.cu's entry point sends them
// here): the chunked kernels at bf16's rounding points (see the header).
int ns2::flash_bwd_wide_bf16(const bf16* q, const bf16* k, const bf16* v,
                             const unsigned char* mask, const float* lse, const float* delta,
                             const bf16* dout, bf16* dq, bf16* dk, bf16* dv, int b, int h,
                             int n_q, int n_kv, int d, int causal, float scale, const Dropout& dr,
                             cudaStream_t stream) {
  return launch_bwd_wide<bf16>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv, d,
                               causal, scale, dr, stream);
}

// q/dout [b,h,n_q,d], k/v [b,h,n_kv,d], 16-byte aligned, mask [b,n_kv]
// uint8 or null, lse and delta [b,h,n_q] -> dq [b,h,n_q,d], dk/dv
// [b,h,n_kv,d], d 64 or a multiple of 128. Dropout arguments as for
// ns2_flash_fwd; other head widths return cudaErrorInvalidValue.
NS2_API int ns2_flash_bwd(const float* q, const float* k, const float* v,
                          const unsigned char* mask, const float* lse, const float* delta,
                          const float* dout, float* dq, float* dk, float* dv, int b, int h,
                          int n_q, int n_kv, int d, int causal, float scale, unsigned seed0,
                          unsigned seed1, float rate, int stride, unsigned threshold,
                          float keep_scale, int b_offset, int h_offset,
                          void* stream) {
  return flash_bwd(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv, d, causal,
                   scale, ns2::Dropout{seed0, seed1, rate, stride, threshold, keep_scale, b_offset,
                                h_offset},
                   stream);
}
