// Shared pieces of the flash-attention kernels K4 (flash_fwd.cu) and K5
// (flash_bwd.cu): the masked-logit constant, the validity rule, the
// Threefry-2x32-20 dropout mask of naturalspeech2_tpu/ops/flash_attention.py
// (`_threefry2x32`, `_dropout_keep_scaled`), bit for bit, the split of an
// operand into TF32 hi and lo and the accumulator layout both kernels use,
// and K5's `mma.sync` products over staged tiles and asynchronous copies.
// K5's chunked bf16 kernels (heads wider than 128) stage their bf16 tiles
// widened to f32 (exact) and run one TF32 pass where both operands are bf16
// values, which TF32 holds exactly (the `kSplit` flags below). The bf16
// kernels at heads 64 and 128 wide are flash_fwd_bf16.cu's and
// flash_bwd_bf16.cu's (flash_bf16.cuh).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace ns2 {

// NEG_INF = -0.7 * FLT_MAX, rounded from double as the JAX package does:
// finite, so a fully masked row has a finite max and lse = NEG_INF.
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e+38);

// The tiles: 64 rows (queries, or keys) per block, four warps of 32 lanes,
// each warp owning 16 rows of its block's 64; the walked tiles hold kTile
// rows (K4 walks 32 keys at a time). The head width D is a template
// parameter of the kernels, 64 or 128 (the wrappers pad narrower heads with
// zeros). Staged [rows][D] tiles keep a row stride of D + 4 floats (68 or
// 132, both 4 mod 32): the two fragment patterns below then touch 32
// distinct banks per load.
constexpr int kTile = 64;
constexpr int kWarps = 4;
constexpr int kFlashThreads = 32 * kWarps;
template <int D>
constexpr int kLdOf = D + 4;

struct Dropout {
  uint32_t seed0, seed1;
  float rate;          // 0: no dropout
  int stride;          // the key length the counter uses (JAX's padded n_kv)
  uint32_t threshold;  // keep when bits >= threshold
  float scale;         // 1 / (1 - rate) in f32
  // the global batch row and head of this launch's row 0 and head 0: a
  // rank that holds rows or heads of a larger array draws their masks
  int b_offset, h_offset;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// First output word of Threefry-2x32-20 with key (k0, k1) on (x0, x1).
__device__ __forceinline__ uint32_t threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                                 uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define NS2_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl32(x1, r) ^ x0;
  x0 += k0;
  x1 += k1;
  NS2_TF_ROUND(13) NS2_TF_ROUND(15) NS2_TF_ROUND(26) NS2_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  NS2_TF_ROUND(17) NS2_TF_ROUND(29) NS2_TF_ROUND(16) NS2_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  NS2_TF_ROUND(13) NS2_TF_ROUND(15) NS2_TF_ROUND(26) NS2_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  NS2_TF_ROUND(17) NS2_TF_ROUND(29) NS2_TF_ROUND(16) NS2_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  NS2_TF_ROUND(13) NS2_TF_ROUND(15) NS2_TF_ROUND(26) NS2_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef NS2_TF_ROUND
  return x0;
}

// The multiplier of probability (row, col) of batch bi, head hi: keep·scale,
// keyed on the global batch row and head (the offsets added).
__device__ __forceinline__ float keep_mult(const Dropout& dr, int bi, int hi, int row, int col) {
  const uint32_t x0 = (uint32_t)row * (uint32_t)dr.stride + (uint32_t)col;
  const uint32_t x1 = (uint32_t)(bi + dr.b_offset) * 65536u + (uint32_t)(hi + dr.h_offset);
  return threefry2x32(dr.seed0, dr.seed1, x0, x1) >= dr.threshold ? dr.scale : 0.0f;
}

// e^x on the special-function unit, as 2^(x·log2 e): ex2's error and the
// rounding of x·log2 e stay near 1e-7 relative for the |x| < 30 that give a
// probability above 1e-13.
__device__ __forceinline__ float exp_sfu(float x) { return exp2f(x * 1.4426950408889634f); }

// Key col is visible from query row: inside both lengths, kept by the
// [b, n_kv] padding mask (nullptr: all kept), and not after row if causal.
__device__ __forceinline__ bool visible(const unsigned char* mask_b, int row, int col, int n_q,
                                        int n_kv, int causal) {
  return row < n_q && col < n_kv && (mask_b == nullptr || mask_b[col] != 0) &&
         (!causal || row >= col);
}

// The chunked kernels for heads wider than 128 at bf16 (flash_fwd.cu,
// flash_bwd.cu), where the bf16 entry points send such heads.
int flash_fwd_wide_bf16(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
                        bf16* o, float* lse, int b, int h, int n_q, int n_kv, int d, int causal,
                        float scale, const Dropout& dr, cudaStream_t stream);
int flash_bwd_wide_bf16(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
                        const float* lse, const float* delta, const bf16* dout, bf16* dq,
                        bf16* dk, bf16* dv, int b, int h, int n_q, int n_kv, int d, int causal,
                        float scale, const Dropout& dr, cudaStream_t stream);

// ---- split TF32 --------------------------------------------------------
//
// An f32 operand x becomes hi = tf32(x), rounded half away from zero as
// cvt.rna.tf32.f32 does but in two integer operations, and lo = x - hi
// (exact in f32), whose low 13 bits the tensor core drops. A product a·b
// becomes a_hi·b_hi + (a_hi·b_lo + a_lo·b_hi) on the TF32 tensor cores
// with f32 accumulation: the dropped a_lo·b_lo and the truncated lo leave a
// relative error near 2^-21 per product, where one TF32 pass (hi·hi alone)
// errs near 2^-11. The tensor cores truncate where they add, so a long sum
// loses a little at every mma: the kernels keep the large term apart from
// the two small ones where a product starts from zero (product_xyt here,
// K4's wgmma loop likewise), and sum a tile's product in a fresh accumulator
// that is then added in f32 (add_product), so that no accumulator runs
// through more than 24 mmas.

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a·b on one m16n8k8 TF32 tensor-core tile. Lane l holds, with
// g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k8"):
//   a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]   (16 x 8, rows x k)
//   b[0..1] = B[t][g], B[t+4][g]                            (8 x 8, k x cols)
//   d[0..3] = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in split TF32: the two small cross terms first, then the large one.
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[2],
                                          const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_hi);
}

// ---- fragments from staged tiles ----------------------------------------
//
// A tile is staged as float[rows][D + 4]. Two ways to read a k-step of 8:
// "direct", the tile's rows along the fragment's rows (A) or columns (B)
// and its columns along k, as S = Q·Kᵀ reads Q and K (by ldmatrix, four
// 8 x 4 blocks a lane-wide instruction); and "paired", the tile's rows
// along k, as dQ = dS·K reads K. In the paired order k = t is tile row
// 2t and k = t + 4 row 2t + 1, which is the order in which a product's
// accumulator d holds its columns: d of one product is the A operand of the
// next without a shuffle (see a_from_acc). At a row stride of 68 floats the
// direct reads (8 rows of 16 bytes a block) hit 8 distinct 4-bank groups and
// the paired ones banks 8t + g: no conflicts.

// Four 8-row x 4-float blocks of a staged tile in one instruction: lane l
// gives the address of row l % 8 of block l / 8 and receives element
// (l / 4, l % 4) of each block, the direct pattern (ldmatrix moves 16-bit
// pairs, so a float arrives whole).
__device__ __forceinline__ void ldsm_x4(const float* row, uint32_t (&r)[4]) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void split_bits(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// A[m][k] = tile[r0 + m][c0 + k], m < 16, k < 8, split; lane l = 4g + t.
template <int LD>
__device__ __forceinline__ void a_direct(const float (*tile)[LD], int r0, int c0, int lane,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int b = lane / 8;
  uint32_t x[4];
  ldsm_x4(&tile[r0 + lane % 8 + 8 * (b & 1)][c0 + 4 * (b >> 1)], x);
  split_bits(x, hi, lo);
}

// B[k][n] = tile[r0 + 8i + n][c0 + k] for two adjacent 8-column tiles i = 0,
// 1 (n < 8, k < 8), split: hi[2i], hi[2i + 1] are tile i's b[0], b[1].
template <int LD>
__device__ __forceinline__ void b_direct2(const float (*tile)[LD], int r0, int c0, int lane,
                                          uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int b = lane / 8;
  uint32_t x[4];
  ldsm_x4(&tile[r0 + 8 * (b >> 1) + lane % 8][c0 + 4 * (b & 1)], x);
  split_bits(x, hi, lo);
}

// B[k][n] = tile[r0 + pair(k)][c0 + n] with pair(t) = 2t, pair(t + 4) = 2t + 1.
template <int LD>
__device__ __forceinline__ void b_paired(const float (*tile)[LD], int r0, int c0, int g, int t,
                                         uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(tile[r0 + 2 * t][c0 + g], hi[0], lo[0]);
  split_tf32(tile[r0 + 2 * t + 1][c0 + g], hi[1], lo[1]);
}

// The accumulator of an 8-column product tile as the A operand of a k-step
// in the paired order: A[g][t] = d[0], A[g+8][t] = d[2], A[g][t+4] = d[1],
// A[g+8][t+4] = d[3].
__device__ __forceinline__ void a_from_acc(const float (&d)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(d[0], hi[0], lo[0]);
  split_tf32(d[2], hi[1], lo[1]);
  split_tf32(d[1], hi[2], lo[2]);
  split_tf32(d[3], hi[3], lo[3]);
}

// ---- warp products over staged tiles -------------------------------------

// d = X·Yᵀ for one warp's 16 rows of X (rows r0 .. r0 + 15 of a staged
// tile) against the 8·NJ rows of the staged tile Y, over the head width D:
// d[j] holds Y's rows 8j .. 8j + 7 in the accumulator layout. The large
// terms and the small ones run in separate accumulators, summed at the end.
// kSplit false: both tiles hold bf16 values (exact in TF32), and one TF32
// pass, hi·hi, is the exact product.
template <int NJ, int D, bool kSplit = true>
__device__ __forceinline__ void product_xyt(const float (*x)[kLdOf<D>],
                                            const float (*y)[kLdOf<D>], int r0, int lane,
                                            float (&d)[NJ][4]) {
  static_assert(NJ % 2 == 0, "column tiles go in pairs");
  float small[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = small[j][i] = 0.0f;
#pragma unroll 2
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t a_hi[4], a_lo[4];
    a_direct(x, r0, 8 * ks, lane, a_hi, a_lo);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b_hi[4], b_lo[4];
      b_direct2(y, 8 * j, 8 * ks, lane, b_hi, b_lo);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t bh[2] = {b_hi[2 * i], b_hi[2 * i + 1]};
        const uint32_t bl[2] = {b_lo[2 * i], b_lo[2 * i + 1]};
        if (kSplit) {
          mma_tf32(small[j + i], a_hi, bl);
          mma_tf32(small[j + i], a_lo, bh);
        }
        mma_tf32(d[j + i], a_hi, bh);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] += small[j][i];
}

// acc += A·T for one warp, with A the 16 x 8·KS accumulator tiles a[ks]
// (k-step ks covering T's rows 8ks .. 8ks + 7 in the paired order) and T a
// staged tile [rows][D] read paired. Each 64-column group of the product is
// summed in a fresh accumulator and added in f32: at D = 128 two groups in
// turn, so that one 32-register partial sum serves both. kSplitA / kSplitB
// false: A / T holds bf16 values, exact in TF32, and its lo part is zero:
// hi·hi + lo·hi is two passes (f32 A against bf16 T), hi·hi one.
template <int KS, int D, bool kSplitA = true, bool kSplitB = true>
__device__ __forceinline__ void add_product(float (&acc)[D / 8][4], const float (&a)[KS][4],
                                            const float (*tile)[kLdOf<D>], int g, int t) {
#pragma unroll
  for (int c0 = 0; c0 < D / 8; c0 += 8) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a_hi[4], a_lo[4];
      a_from_acc(a[ks], a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b_hi[2], b_lo[2];
        b_paired(tile, 8 * ks, 8 * (c0 + j), g, t, b_hi, b_lo);
        if (kSplitA && kSplitB) {
          mma_split(part[j], a_hi, a_lo, b_hi, b_lo);
        } else {
          if (kSplitA) mma_tf32(part[j], a_lo, b_hi);
          if (kSplitB) mma_tf32(part[j], a_hi, b_lo);
          mma_tf32(part[j], a_hi, b_hi);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c0 + j][i] += part[j][i];
  }
}

// Rows ra and ra + 8 of a warp's accumulator, columns 8j + 2t + {0, 1}, to
// D columns of a matrix (f32 or bf16, rounded) of n_rows rows ld elements
// apart, each times its row's factor.
template <int D, class T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], int ra,
                                           int n_rows, int t, const float (&factor)[2],
                                           int ld = D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + (size_t)row * ld + 8 * j + 2 * t, acc[j][2 * r] * factor[r],
             acc[j][2 * r + 1] * factor[r]);
  }
}

// ---- asynchronous tile copies -------------------------------------------

// 16 bytes from global to shared memory without passing through registers;
// zeros where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Start copying rows row0 .. row0 + R - 1 of a [rows, D] f32 matrix (rows
// ld floats apart) into a staged tile; rows at or past `rows` become zeros.
// Called by all `nthreads` threads of the block; the caller commits the
// group.
template <int R, int D>
__device__ __forceinline__ void load_tile_async(float (*tile)[kLdOf<D>], const float* src,
                                                int row0, int rows, int tid, int nthreads,
                                                int ld = D) {
  for (int c = tid; c < R * (D / 4); c += nthreads) {
    const int r = c / (D / 4), c4 = (c % (D / 4)) * 4;
    const bool ok = row0 + r < rows;
    cp_async16(&tile[r][c4], src + (size_t)(ok ? row0 + r : 0) * ld + c4, ok);
  }
}

// The same from a [rows, D] bf16 matrix, widened to f32 as it is staged
// (exact): 16-byte loads of 8 values through registers, stored as two
// 16-byte runs of f32, so the copy is done when the call returns (the
// caller's commit and wait then have nothing of it in flight).
template <int R, int D>
__device__ __forceinline__ void load_tile_async(float (*tile)[kLdOf<D>], const bf16* src,
                                                int row0, int rows, int tid, int nthreads,
                                                int ld = D) {
  for (int c = tid; c < R * (D / 8); c += nthreads) {
    const int r = c / (D / 8), c8 = (c % (D / 8)) * 8;
    float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
    if (row0 + r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c8);
      lo = unpack_bf16x4(make_uint2(raw.x, raw.y));
      hi = unpack_bf16x4(make_uint2(raw.z, raw.w));
    }
    *reinterpret_cast<float4*>(&tile[r][c8]) = lo;
    *reinterpret_cast<float4*>(&tile[r][c8 + 4]) = hi;
  }
}

// Max and sum over the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace ns2
