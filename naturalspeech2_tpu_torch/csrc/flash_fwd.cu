// K4: flash attention forward, on the tensor cores in split TF32.
//
// (bf16 at heads 64 and 128 wide is flash_fwd_bf16.cu's kernel; this file
// keeps the chunked kernel for wider heads at both types.)
//
// Replaces the Pallas kernels `_flash_kernel` (online softmax over kv
// blocks) and `_flash_oneshot_kernel` (one kv block) in
// naturalspeech2_tpu/ops/flash_attention.py, which compute one function:
//   o = softmax(q kᵀ · scale) v,  lse = m + log l  per query row,
// with a [b, n_kv] key-padding mask, causal masking (row >= col) and
// Threefry dropout on the probabilities (the normaliser l uses the undropped
// ones). Masked logits are NEG_INF (finite) and masked probabilities exactly
// 0, so a fully masked row gives o = 0 and lse = NEG_INF.
//
// What bounds it on the card: the matrix products, 4·n_q·n_kv·D FLOP per
// (batch, head) against 16·(n_q + n_kv)·D bytes of q, k, v and o, far past
// the ridge at the training shape (b16 h8 n150) and beyond. The fastest
// f32-accurate way the H100 has is split TF32 on the tensor cores: three
// TF32 products per f32 product, 495 / 3 = 165 TFLOP/s, where f32 FMAs on
// the CUDA cores peak at 67.
//
// Design: one block, one warpgroup of four warps, owns (batch·head, 64
// query rows), each warp 16 rows, and walks the keys in tiles of 32. The
// head width D is 64 or 128 (a template parameter; the wrapper pads
// narrower heads with zeros, wider ones to a multiple of 128, which
// flash_fwd_wide_kernel walks in 128-wide chunks). Both
// products run on `wgmma` TF32 tiles in split TF32 (flash.cuh: hi·hi +
// hi·lo + lo·hi, f32 accumulation); one TF32 pass alone would change the
// function at the 1e-4 level. Every operand is split into hi and lo once:
// Q, K and V as they are staged in shared memory, P as it leaves the
// softmax. S = Q·Kᵀ is `wgmma.m64n32k8` with both operands K-major in
// shared memory (Q and K are row-major in device memory, so their rows go
// straight into 8-row core matrices). For O += P·V, `wgmma.m64n64k8` takes P
// from registers and V transposed, one 64-column group of O at a time (two
// at D = 128, each the 64-row half of Vᵀ, summed in turn in one partial
// accumulator): V is staged as Vᵀ, each head dim a row
// of keys, the keys of each 8 in the paired order (flash.cuh), so that the
// accumulator of S is, element for element, P's register operand. The
// tensor cores truncate where they add, so S keeps its large and small terms
// in separate accumulators and each tile's P·V is summed apart and added to
// O in f32: no accumulator runs through more than 24 products. The online
// softmax runs on the accumulator in registers: row max and sum across the
// four lanes of a row, e^x on the special-function unit, the mask, causal
// and dropout rules by global (row, col), so the tiles need not match the
// TPU's; a tile that no rule cuts skips the per-element test. Causal blocks
// stop at the diagonal.
//
// Loads: the split and the transpose pass every element through registers
// anyway, so the next tile's K and V are loaded into registers right after
// this tile is stored, and their loads are in flight while this tile's
// products run; a `cp.async` or TMA ring would add a raw copy in shared
// memory and a second pass over it. At D = 64 the block takes 64 KB of
// shared memory and 210 registers a thread, two blocks an SM, so that one
// block's softmax and staging run while the other's products do; at D = 128
// 128 KB, one block an SM. Registers that wgmma reads
// or writes are pinned around its fence and wait, or the compiler waits for
// the products at every access.
#include "wgmma.cuh"

namespace {

using ns2::kFlashThreads;
using ns2::kTile;

// Keys per tile: 32, so that two blocks (64 KB of shared memory, at most
// 255 registers a thread) share an SM and one's softmax runs while the
// other's products do.
constexpr int kKeys = 32;

using ns2::bf16;
using ns2::fence_proxy_async;
using ns2::kmajor;
using ns2::kmajor_bf16;
using ns2::kmajor_desc;
using ns2::pin;
using ns2::store_split1;
using ns2::store_split4;
using ns2::wg_commit_wait;
using ns2::wg_fence;
using ns2::wgmma_rs_n64;
using ns2::wgmma_ss_n32;

template <class T, int D>
struct FwdSmem;

template <int D>
struct FwdSmem<float, D> {
  float q_hi[kTile * D], q_lo[kTile * D];  // Q, K-major (64 rows, k = head dims)
  float k_hi[kKeys * D], k_lo[kKeys * D];  // K, K-major (32 keys, k = head dims)
  float v_hi[D * kKeys], v_lo[D * kKeys];  // Vᵀ, K-major (D dims, k = keys paired)
};

template <int D>
struct FwdSmem<bf16, D> {
  bf16 q[kTile * D];  // Q, bf16 K-major (64 rows, k = head dims)
  bf16 k[kKeys * D];  // K, bf16 K-major (32 keys, k = head dims)
  bf16 v[D * kKeys];  // Vᵀ, bf16 K-major (D dims, k = keys in order)
};

// A tile's K and V in registers, loaded ahead of their turn: K as float4s of
// row e % 32, columns 4·(e / 32) (e = tid + 128·i), so that eight lanes
// store one 128-byte run of a core matrix; V as keys 8·warp + 2·(lane / 8) +
// p, head dims lane % 8 + 8q, so that the transposed stores, by head dim
// % 8 and key position % 4, hit 32 distinct banks. Rows are ld floats apart
// (D, or the full head width when a wide head is walked in D-wide chunks).
// bf16: K and V alike as 16-byte runs of 8 head dims of key e % 32, columns
// 8·(e / 32).
template <class T, int D>
struct KvRegs;

template <int D>
struct KvRegs<float, D> {
  float4 k[kKeys * D / 4 / kFlashThreads];
  float v[2][D / 8];
};

template <int D>
struct KvRegs<bf16, D> {
  uint4 k[kKeys * D / 8 / kFlashThreads];
  uint4 v[kKeys * D / 8 / kFlashThreads];
};

template <int D>
__device__ __forceinline__ void load_k(KvRegs<float, D>& r, const float* kh, int k0, int n_kv,
                                       int tid, int ld) {
#pragma unroll
  for (int i = 0; i < kKeys * D / 4 / kFlashThreads; ++i) {
    const int e = tid + kFlashThreads * i, row = k0 + e % kKeys, c4 = 4 * (e / kKeys);
    r.k[i] = row < n_kv ? *reinterpret_cast<const float4*>(kh + (size_t)row * ld + c4)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <int D>
__device__ __forceinline__ void load_v(KvRegs<float, D>& r, const float* vh, int k0, int n_kv,
                                       int tid, int ld) {
  const int lane = tid % 32;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int row = k0 + 8 * (tid / 32) + 2 * (lane / 8) + p;
#pragma unroll
    for (int q = 0; q < D / 8; ++q)
      r.v[p][q] = row < n_kv ? vh[(size_t)row * ld + lane % 8 + 8 * q] : 0.0f;
  }
}

// K stays in key order; Vᵀ takes its keys in the paired order (flash.cuh),
// key 2t of each 8 at k position t and key 2t + 1 at t + 4, so that P's
// accumulator is the A operand of P·V as it stands.
template <int D>
__device__ __forceinline__ void store_k(FwdSmem<float, D>& sm, const KvRegs<float, D>& r,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < kKeys * D / 4 / kFlashThreads; ++i) {
    const int e = tid + kFlashThreads * i;
    store_split4(sm.k_hi, sm.k_lo, kmajor<kKeys>(e % kKeys, 4 * (e / kKeys)), r.k[i]);
  }
}

template <int D>
__device__ __forceinline__ void store_v(FwdSmem<float, D>& sm, const KvRegs<float, D>& r,
                                        int tid) {
  const int lane = tid % 32;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int key = 8 * (tid / 32) + 2 * (lane / 8) + p;
    const int pos = key / 8 * 8 + key % 8 / 2 + 4 * (key % 2);
#pragma unroll
    for (int q = 0; q < D / 8; ++q)
      store_split1(sm.v_hi, sm.v_lo, kmajor<D>(lane % 8 + 8 * q, pos), r.v[p][q]);
  }
}

// 16-byte runs of a bf16 [rows, ld] matrix: run e of R rows is row e % R,
// columns 8·(e / R); zeros past n_rows.
template <int R, int D>
__device__ __forceinline__ uint4 load_run(const bf16* src, int row0, int n_rows, int e, int ld) {
  const int row = row0 + e % R;
  return row < n_rows ? *reinterpret_cast<const uint4*>(src + (size_t)row * ld + 8 * (e / R))
                      : make_uint4(0u, 0u, 0u, 0u);
}

template <int D>
__device__ __forceinline__ void load_k(KvRegs<bf16, D>& r, const bf16* kh, int k0, int n_kv,
                                       int tid, int ld) {
#pragma unroll
  for (int i = 0; i < kKeys * D / 8 / kFlashThreads; ++i)
    r.k[i] = load_run<kKeys, D>(kh, k0, n_kv, tid + kFlashThreads * i, ld);
}

template <int D>
__device__ __forceinline__ void load_v(KvRegs<bf16, D>& r, const bf16* vh, int k0, int n_kv,
                                       int tid, int ld) {
#pragma unroll
  for (int i = 0; i < kKeys * D / 8 / kFlashThreads; ++i)
    r.v[i] = load_run<kKeys, D>(vh, k0, n_kv, tid + kFlashThreads * i, ld);
}

// K: each run is 16 contiguous bytes of its core matrix. Vᵀ: each run's 8
// head dims go to 8 rows of Vᵀ at the key's position, in key order.
template <int D>
__device__ __forceinline__ void store_k(FwdSmem<bf16, D>& sm, const KvRegs<bf16, D>& r,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < kKeys * D / 8 / kFlashThreads; ++i) {
    const int e = tid + kFlashThreads * i;
    *reinterpret_cast<uint4*>(sm.k + kmajor_bf16<kKeys>(e % kKeys, 8 * (e / kKeys))) = r.k[i];
  }
}

template <int D>
__device__ __forceinline__ void store_v(FwdSmem<bf16, D>& sm, const KvRegs<bf16, D>& r,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < kKeys * D / 8 / kFlashThreads; ++i) {
    const int e = tid + kFlashThreads * i, key = e % kKeys, c8 = 8 * (e / kKeys);
    const bf16* vals = reinterpret_cast<const bf16*>(&r.v[i]);
#pragma unroll
    for (int u = 0; u < 8; ++u) sm.v[kmajor_bf16<D>(c8 + u, key)] = vals[u];
  }
}

// The block's 64 query rows (columns of Q ld elements apart), K-major:
// split into hi and lo (f32) or as they are (bf16).
template <int D>
__device__ __forceinline__ void stage_q(FwdSmem<float, D>& sm, const float* qh, int q0, int n_q,
                                        int tid, int ld) {
#pragma unroll
  for (int i = 0; i < kTile * D / 4 / kFlashThreads; ++i) {
    const int e = tid + kFlashThreads * i, row = q0 + e % kTile, c4 = 4 * (e / kTile);
    const float4 x = row < n_q ? *reinterpret_cast<const float4*>(qh + (size_t)row * ld + c4)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    store_split4(sm.q_hi, sm.q_lo, kmajor<kTile>(e % kTile, c4), x);
  }
}

template <int D>
__device__ __forceinline__ void stage_q(FwdSmem<bf16, D>& sm, const bf16* qh, int q0, int n_q,
                                        int tid, int ld) {
#pragma unroll
  for (int i = 0; i < kTile * D / 8 / kFlashThreads; ++i) {
    const int e = tid + kFlashThreads * i;
    *reinterpret_cast<uint4*>(sm.q + kmajor_bf16<kTile>(e % kTile, 8 * (e / kTile))) =
        load_run<kTile, D>(qh, q0, n_q, e, ld);
  }
}

// s = Q Kᵀ over the D staged head dims: element (j, i) is row ra + 8·(i / 2),
// key k0 + 8j + 2t + (i & 1); the large terms and the small ones summed in
// separate accumulators and added at the end.
template <int D>
__device__ __forceinline__ void qk_product(const FwdSmem<float, D>& sm,
                                           float (&s)[kKeys / 8][4]) {
  float small[kKeys / 8][4];
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = small[j][i] = 0.0f;
  pin(s);
  pin(small);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const uint64_t qa_hi = kmajor_desc<kTile>(sm.q_hi, ks);
    const uint64_t qa_lo = kmajor_desc<kTile>(sm.q_lo, ks);
    const uint64_t kb_hi = kmajor_desc<kKeys>(sm.k_hi, ks);
    const uint64_t kb_lo = kmajor_desc<kKeys>(sm.k_lo, ks);
    wgmma_ss_n32(small, qa_hi, kb_lo);
    wgmma_ss_n32(small, qa_lo, kb_hi);
    wgmma_ss_n32(s, qa_hi, kb_hi);
  }
  wg_commit_wait();
  pin(s);
  pin(small);
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] += small[j][i];
}

// bf16: one pass, exact products summed in f32.
template <int D>
__device__ __forceinline__ void qk_product(const FwdSmem<bf16, D>& sm,
                                           float (&s)[kKeys / 8][4]) {
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
  pin(s);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ns2::wgmma_bf16_ss_n32(s, kmajor_desc<kTile>(sm.q, ks), kmajor_desc<kKeys>(sm.k, ks));
  wg_commit_wait();
  pin(s);
}

// Where a block's rows and keys are, and the rules that hide a key.
struct TileRules {
  const unsigned char* mask_b;
  int bi, hi, ra, q0w0, n_q, n_kv, causal, t;
  float scale;
};

// The online softmax of one key tile on S's accumulator, in place: s
// becomes P (times the dropout keep multiplier), m and l advance, corr is
// the factor that rescales what O held. A tile that no rule cuts (all keys
// inside n_kv, no padding mask, causal only below the diagonal) skips the
// per-element test.
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 8][4], float (&m)[2],
                                             float (&l)[2], float (&corr)[2], const TileRules& rw,
                                             int k0, const ns2::Dropout& dr) {
  const bool whole = rw.mask_b == nullptr && k0 + kKeys <= rw.n_kv &&
                     (!rw.causal || k0 + kKeys - 1 <= rw.q0w0);
  float row_max[2] = {ns2::kNegInf, ns2::kNegInf};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = whole || ns2::visible(rw.mask_b, rw.ra + 8 * (i / 2),
                                            k0 + 8 * j + 2 * rw.t + (i & 1), rw.n_q, rw.n_kv,
                                            rw.causal);
      s[j][i] = ok ? s[j][i] * rw.scale : ns2::kNegInf;
      row_max[i / 2] = fmaxf(row_max[i / 2], s[j][i]);
    }
  float row_sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], ns2::quad_max(row_max[r]));
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a masked logit is NEG_INF: exactly 0 once the row has a visible key
      // (m finite), and tested for while every key so far was masked
      float p = s[j][i] == ns2::kNegInf ? 0.0f : ns2::exp_sfu(s[j][i] - m[i / 2]);
      row_sum[i / 2] += p;
      if (dr.rate > 0.0f && p != 0.0f)
        p *= ns2::keep_mult(dr, rw.bi, rw.hi, rw.ra + 8 * (i / 2),
                            k0 + 8 * j + 2 * rw.t + (i & 1));
      s[j][i] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ns2::quad_sum(row_sum[r]);
}

// acc = acc·corr + P V: P from the accumulator in registers; each 64-column
// group of O (rows 64·h.. of Vᵀ, 256·h floats into each k-step) summed
// apart and added in f32.
template <int D>
__device__ __forceinline__ void add_pv(float (&acc)[D / 8][4], const float (&s)[kKeys / 8][4],
                                       const float (&corr)[2], const FwdSmem<float, D>& sm) {
  uint32_t pa_hi[kKeys / 8][4], pa_lo[kKeys / 8][4];
#pragma unroll
  for (int ks = 0; ks < kKeys / 8; ++ks) ns2::a_from_acc(s[ks], pa_hi[ks], pa_lo[ks]);
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.0f;
    pin(part);
    pin(pa_hi);
    pin(pa_lo);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKeys / 8; ++ks) {
      const uint64_t vb_hi = kmajor_desc<D>(sm.v_hi + 256 * h, ks);
      const uint64_t vb_lo = kmajor_desc<D>(sm.v_lo + 256 * h, ks);
      wgmma_rs_n64(part, pa_hi[ks], vb_lo);
      wgmma_rs_n64(part, pa_lo[ks], vb_hi);
      wgmma_rs_n64(part, pa_hi[ks], vb_hi);
    }
    wg_commit_wait();
    pin(part);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* a = acc[8 * h + j];
      a[0] = a[0] * corr[0] + part[j][0];
      a[1] = a[1] * corr[0] + part[j][1];
      a[2] = a[2] * corr[1] + part[j][2];
      a[3] = a[3] * corr[1] + part[j][3];
    }
  }
}

// bf16: P rounded to bf16 as the register operand (keys 16ks .. 16ks + 15
// of the accumulator, pair for pair), Vᵀ's rows 64·h.. 512·h elements into
// each k-step.
template <int D>
__device__ __forceinline__ void add_pv(float (&acc)[D / 8][4], const float (&s)[kKeys / 8][4],
                                       const float (&corr)[2], const FwdSmem<bf16, D>& sm) {
  uint32_t pa[kKeys / 16][4];
#pragma unroll
  for (int ks = 0; ks < kKeys / 16; ++ks) {
    pa[ks][0] = ns2::pack_bf16x2(s[2 * ks][0], s[2 * ks][1]);
    pa[ks][1] = ns2::pack_bf16x2(s[2 * ks][2], s[2 * ks][3]);
    pa[ks][2] = ns2::pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]);
    pa[ks][3] = ns2::pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3]);
  }
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.0f;
    pin(part);
    pin(pa);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks)
      ns2::wgmma_bf16_rs_n64(part, pa[ks], kmajor_desc<D>(sm.v + 512 * h, ks));
    wg_commit_wait();
    pin(part);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* a = acc[8 * h + j];
      a[0] = a[0] * corr[0] + part[j][0];
      a[1] = a[1] * corr[0] + part[j][1];
      a[2] = a[2] * corr[1] + part[j][2];
      a[3] = a[3] * corr[1] + part[j][3];
    }
  }
}

// o = acc / l for the block's rows (row stride ld; rounded to T) and, if
// lse, lse = m + log l in f32.
template <int D, class T>
__device__ __forceinline__ void finish(T* oh, float* lse_h, const float (&acc)[D / 8][4],
                                       const float (&m)[2], const float (&l)[2], const TileRules& rw,
                                       int ld) {
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float safe_l = l[r] == 0.0f ? 1.0f : l[r];
    inv_l[r] = 1.0f / safe_l;
    const int row = rw.ra + 8 * r;
    if (lse_h && rw.t == 0 && row < rw.n_q) lse_h[row] = m[r] + logf(safe_l);
  }
  ns2::store_rows<D>(oh, acc, rw.ra, rw.n_q, rw.t, inv_l, ld);
}

// grid (ceil(n_q / 64), b·h), 128 threads (one warpgroup); dynamic shared
// memory sizeof(FwdSmem<T, D>) = 65,536 or 131,072 bytes (f32), 16,384 or
// 32,768 (bf16). kLse: store lse (K2's attention core, which needs no
// backward state, skips it). T: the element type of q, k, v and o.
template <class T, int D, bool kLse>
__global__ void __launch_bounds__(kFlashThreads, D == 64 ? 2 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const unsigned char* __restrict__ mask, T* __restrict__ o,
                 float* __restrict__ lse, int heads, int n_q, int n_kv, int causal, float scale,
                 ns2::Dropout dr) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<T, D>& sm = *reinterpret_cast<FwdSmem<T, D>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const T* kh = k + (size_t)bh * n_kv * D;
  const T* vh = v + (size_t)bh * n_kv * D;
  // this lane's rows of the warp's 16: ra = q0 + 16·warp + g (index 0) and
  // ra + 8 (index 1); acc[j] holds columns 8j + 2t, 8j + 2t + 1 of both
  const TileRules rw{mask ? mask + (size_t)(bh / heads) * n_kv : nullptr,
                     bh / heads, bh % heads, q0 + 16 * warp + lane / 4, q0 + 16 * warp,
                     n_q, n_kv, causal, lane % 4, scale};

  const int k_end = causal ? min(n_kv, q0 + kTile) : n_kv;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  KvRegs<T, D> regs;
  load_k(regs, kh, 0, n_kv, tid, D);
  load_v(regs, vh, 0, n_kv, tid, D);
  stage_q(sm, q + (size_t)bh * n_q * D, q0, n_q, tid, D);

  float m[2] = {ns2::kNegInf, ns2::kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the last tile's products are done with sm.k / sm.v
    store_k(sm, regs, tid);
    store_v(sm, regs, tid);
    fence_proxy_async();
    __syncthreads();  // tile kt is in shared memory, for wgmma too
    if (kt + 1 < n_tiles) {  // the next tile's loads overlap this tile's products
      load_k(regs, kh, k0 + kKeys, n_kv, tid, D);
      load_v(regs, vh, k0 + kKeys, n_kv, tid, D);
    }
    float s[kKeys / 8][4], corr[2];
    qk_product(sm, s);
    softmax_tile(s, m, l, corr, rw, k0, dr);
    add_pv(acc, s, corr, sm);
  }
  finish<D>(o + (size_t)bh * n_q * D, kLse ? lse + (size_t)bh * n_q : nullptr, acc, m, l, rw, D);
}

// Heads wider than 128 (d a multiple of 128, as the JAX kernel pads d): grid
// (ceil(n_q / 64), b·h, d / 128), block z owning the 128 columns of O from
// 128·z. The logits run over the full width in 128-wide chunks through the
// D = 128 buffers: for each key tile, each chunk c of Q and K is staged and
// its product summed in fresh accumulators added in f32 (so no accumulator
// runs through more products than at D = 128), then the
// softmax as above and P times the block's own 128 columns of V. Each block
// recomputes the logits (d / 128 times in all) and restages Q per chunk:
// simple, and a first kernel for widths no config of the repo uses. lse
// is written by block z = 0 alone. Loads are not overlapped with products.
template <class T, bool kLse>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const unsigned char* __restrict__ mask, T* __restrict__ o,
                      float* __restrict__ lse, int heads, int n_q, int n_kv, int d, int causal,
                      float scale, ns2::Dropout dr) {
  constexpr int D = 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  FwdSmem<T, D>& sm = *reinterpret_cast<FwdSmem<T, D>*>(smem_raw);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y, oc = blockIdx.z, nc = d / D;
  const T* qh = q + (size_t)bh * n_q * d;
  const T* kh = k + (size_t)bh * n_kv * d;
  const T* vh = v + (size_t)bh * n_kv * d;
  const TileRules rw{mask ? mask + (size_t)(bh / heads) * n_kv : nullptr,
                     bh / heads, bh % heads, q0 + 16 * warp + lane / 4, q0 + 16 * warp,
                     n_q, n_kv, causal, lane % 4, scale};

  const int k_end = causal ? min(n_kv, q0 + kTile) : n_kv;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  float m[2] = {ns2::kNegInf, ns2::kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  KvRegs<T, D> regs;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    float s[kKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
    for (int c = 0; c < nc; ++c) {
      __syncthreads();  // the last products are done with sm.q, sm.k (and sm.v)
      stage_q(sm, qh + c * D, q0, n_q, tid, d);
      load_k(regs, kh + c * D, k0, n_kv, tid, d);
      store_k(sm, regs, tid);
      if (c == 0) {
        load_v(regs, vh + oc * D, k0, n_kv, tid, d);
        store_v(sm, regs, tid);
      }
      fence_proxy_async();
      __syncthreads();  // chunk c of the tile is in shared memory, for wgmma too
      float part[kKeys / 8][4];
      qk_product(sm, part);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] += part[j][i];
    }
    float corr[2];
    softmax_tile(s, m, l, corr, rw, k0, dr);
    add_pv(acc, s, corr, sm);
  }
  finish<D>(o + (size_t)bh * n_q * d + oc * D,
            kLse && oc == 0 ? lse + (size_t)bh * n_q : nullptr, acc, m, l, rw, d);
}

template <class T, int D>
cudaError_t launch_fwd(const T* q, const T* k, const T* v, const unsigned char* mask, T* o,
                       float* lse, int b, int h, int n_q, int n_kv, int causal, float scale,
                       const ns2::Dropout& dr, cudaStream_t stream) {
  const int bytes = (int)sizeof(FwdSmem<T, D>);
  auto kernel = lse ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kTile - 1) / kTile, b * h);
  kernel<<<grid, kFlashThreads, bytes, stream>>>(q, k, v, mask, o, lse, h, n_q, n_kv, causal,
                                                 scale, dr);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_fwd_wide(const T* q, const T* k, const T* v, const unsigned char* mask, T* o,
                            float* lse, int b, int h, int n_q, int n_kv, int d, int causal,
                            float scale, const ns2::Dropout& dr, cudaStream_t stream) {
  const int bytes = (int)sizeof(FwdSmem<T, 128>);
  auto kernel = lse ? flash_fwd_wide_kernel<T, true> : flash_fwd_wide_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kTile - 1) / kTile, b * h, d / 128);
  kernel<<<grid, kFlashThreads, bytes, stream>>>(q, k, v, mask, o, lse, h, n_q, n_kv, d, causal,
                                                 scale, dr);
  return cudaGetLastError();
}

template <class T>
int flash_fwd(const T* q, const T* k, const T* v, const unsigned char* mask, T* o, float* lse,
              int b, int h, int n_q, int n_kv, int d, int causal, float scale,
              const ns2::Dropout& dr, void* stream) {
  if ((d != 64 && (d <= 0 || d % 128 != 0)) || n_q <= 0 || n_kv <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_fwd<T, 64>(q, k, v, mask, o, lse, b, h, n_q, n_kv, causal, scale, dr, st);
  if (d == 128)
    return launch_fwd<T, 128>(q, k, v, mask, o, lse, b, h, n_q, n_kv, causal, scale, dr, st);
  return launch_fwd_wide<T>(q, k, v, mask, o, lse, b, h, n_q, n_kv, d, causal, scale, dr, st);
}

}  // namespace

// Heads wider than 128 at bf16 (flash_fwd_bf16.cu's entry point sends them
// here): the chunked kernel, q, k, v and o in bf16, lse f32. With dropout
// the keep multiplier is applied to P in f32, m, l and lse stay over the
// undropped P, and P·keep is rounded to bf16 as P·V's register operand (the
// JAX kernels' `(p * keep).astype(v.dtype)`).
int ns2::flash_fwd_wide_bf16(const bf16* q, const bf16* k, const bf16* v,
                             const unsigned char* mask, bf16* o, float* lse, int b, int h,
                             int n_q, int n_kv, int d, int causal, float scale, const Dropout& dr,
                             cudaStream_t stream) {
  return launch_fwd_wide<bf16>(q, k, v, mask, o, lse, b, h, n_q, n_kv, d, causal, scale, dr,
                               stream);
}

// q [b,h,n_q,d], k/v [b,h,n_kv,d], 16-byte aligned, mask [b,n_kv] uint8
// or null -> o [b,h,n_q,d], lse [b,h,n_q] (not written when lse is null).
// Dropout is on when rate > 0: seed, counter stride, keep threshold and keep
// scale come from the Python wrapper, as the JAX package derives them;
// b_offset and h_offset are the global batch row and head of this call's
// row 0 and head 0 (0 for a whole array), which the mask is keyed on. d is
// 64 or a multiple of 128; other head widths return cudaErrorInvalidValue
// (the wrapper pads every other width to the next of these).
NS2_API int ns2_flash_fwd(const float* q, const float* k, const float* v,
                          const unsigned char* mask, float* o, float* lse, int b, int h, int n_q,
                          int n_kv, int d, int causal, float scale, unsigned seed0,
                          unsigned seed1, float rate, int stride, unsigned threshold,
                          float keep_scale, int b_offset, int h_offset,
                          void* stream) {
  return flash_fwd(q, k, v, mask, o, lse, b, h, n_q, n_kv, d, causal, scale,
                   ns2::Dropout{seed0, seed1, rate, stride, threshold, keep_scale, b_offset,
                                h_offset}, stream);
}
