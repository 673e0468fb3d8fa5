// The split-TF32 GEMM core of K1 (wavenet.cu), K1b (wavenet_lane.cu), K2
// (attn_block.cu), K2b (cross_attn_block.cu), K3 (ff_block.cu) and K6
// (rvq.cu):
//
//   C[M x N] = epilogue(prologue(A)[M x K] · B[K x N])   in f32,
//
// on the TF32 tensor cores in three passes, a_hi·b_hi + (a_hi·b_lo +
// a_lo·b_hi) (flash.cuh), which keeps f32 accuracy where one TF32 pass
// would not.
//
// What bounds it on the card: the products. The fastest f32-accurate rate
// the H100 has is split TF32, 495 / 3 = 165 TFLOP/s (H100 SXM, 700 W),
// where f32 FMAs on the CUDA cores peak at 67; the blocks' GEMMs reach the
// ridge at a few hundred rows.
//
// Design: a block is WN warpgroups of 128 threads that share one 64-row
// tile of A, each owning a 64 x 64 tile of C (so a block covers 64 WN
// columns), `wgmma.m64n64k8` with both operands K-major in shared memory.
// (K2, K2b, K3 and K6 take WN 1 or 3 by the grid's size, `launch`; K1 and
// K1b 2.)
// The reduction walks K in chunks of 32 (four k-steps) through a
// two-stage ring:
//  - B is a weight. The Python wrapper's cache holds Bᵀ once per
//    parameter, padded with zeros, already split into hi and lo and laid
//    out tile by tile in the K-major core-matrix order (`pack_b` in
//    ops/gemm_cache.py), so a chunk of B is one contiguous 16 KB run that
//    `cp.async` copies into the ring as it stands, two chunks ahead, each
//    warpgroup its own column tile;
//  - A is an activation. Its staging threads (one warpgroup, or the first
//    two of a larger block: two or four threads a row) load their float4s
//    of the next chunk into registers while the products of this chunk
//    run, and the loader applies the prologue on the way (the adaptive
//    RMSNorm; causal, dilated row shifts; the head layout of K4's output;
//    the WaveNet's lanes side by side). They
//    split them into hi and lo and store them K-major into the other stage
//    of the ring, also while this chunk's products run: wgmma is
//    asynchronous, and the block waits for it only after.
// What limits it is staging, not the products (`gemm_variants.py` times
// the core with each part of the work taken out): every block reloads,
// splits and stores all of A for its columns. So three warpgroups share
// each A tile, a third of that work per column, where the grid still gives
// every SM such a block (`launch`; one fits, as three one-warpgroup blocks
// do, at ~155 registers a thread); blocks sharing B instead were no faster.
// Rounding discipline (flash.cuh): the tensor cores truncate where they add.
// Each chunk is summed in fresh accumulators, the large terms hi·hi (4 mmas)
// apart from the small cross terms (8 mmas), and added to the f32 result
// afterwards, so no accumulator runs through more than 8 mmas, however long
// K is (K3's conv has K = 3 · 1376 at dim 512).
// Groups: grid z runs `groups` GEMMs of one shape in one launch (K1: the L
// lanes of a stack); the loader and the epilogue take the group's operands
// in `group(z)`, and group z's B lies z · b_group elements on.
//
// Every bf16 block (K1, K1b and its `bf16_matmul`, K2, K2b, K3), the mixed
// entry points of K1, K1b, K2, K2b and K3 (f32 activations against bf16
// weights) and K6 in bf16 run the bf16 core instead (gemm_bf16.cuh): this
// one multiplies f32 by f32 alone. Loaders read f32 activations and hand
// f32 values to the staging; epilogues take the types of their outputs,
// biases and residuals as template parameters and round once, where they
// store.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace ns2 {
namespace gemm {

constexpr int kBM = 64;                 // rows of C per block: wgmma's m
constexpr int kBN = 64;                 // columns of C per warpgroup
constexpr int kKC = 32;                 // k per staged chunk
constexpr int kThreads = 128;           // one warpgroup
constexpr int kTile = kBM * kKC;        // elements of one operand tile (kBN == kBM)
static_assert(kBN == kBM, "A and B tiles share the K-major layout");

constexpr int kBParts = 2;              // parts of a packed B element: hi, lo

// Threads that stage A: one warpgroup, or the first two of a larger block.
template <int WN>
constexpr int kStagers = (WN == 1 ? 1 : 2) * kThreads;

template <int WN>
struct Smem {
  float a[2][2][kTile];                 // [stage][hi, lo], K-major, shared by the warpgroups
  float b[2][WN][kBParts][kTile];       // [stage][warpgroup][hi, lo], K-major, as cached
  float part[kStagers<WN> / kBM][kBM];  // the norm prologue's partial sums of squares
};

// Four consecutive values p[k .. k+3] as f32, zero at and past n; one
// vector load where `vec` (n % 4 == 0 and p aligned to four elements).
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int k, int n, bool vec) {
  if (vec && k + 4 <= n) return *reinterpret_cast<const float4*>(p + k);
  return make_float4(k < n ? p[k] : 0.0f, k + 1 < n ? p[k + 1] : 0.0f,
                     k + 2 < n ? p[k + 2] : 0.0f, k + 3 < n ? p[k + 3] : 0.0f);
}

// p aligned to four elements of T.
template <class T>
__device__ __forceinline__ bool aligned4(const T* p) {
  return ((uintptr_t)p & (4 * sizeof(T) - 1)) == 0;
}

// ---- A loaders: init(row, part, tid, lanes) once per thread, `lanes`
// threads to a row; chunk(c) once per chunk of 32 k, then get(j) for its
// columns j = 0, 4, .., 28 ---------------------------------------------------

// A = n(x), the adaptive RMSNorm x / max(‖x‖, 1e-12) · √dm · γ_b + β_b of
// x [rows, dm] with γ, β [b, dm] and row = b·n + t; zero past dm. The norm
// uses the real width dm, whatever K is padded to.
struct NormRows {
  const float* x;
  const float* gamma;
  const float* beta;
  int rows, n, dm;
  float sqrt_dm;
  const float *p, *g, *be;
  const float *pc, *gc, *bc;  // the chunk's x, γ, β
  int left;                   // dm - the chunk's first k
  float scale;
  bool ok, vec;

  __device__ void group(int) {}

  // Called by all threads of the block, with part[lanes][64] and the
  // thread's index: the `lanes` threads of a row (t, t + 64, ..) each sum
  // every lanes-th float4 of it; threads past lanes·64 sum nothing.
  __device__ void init(int row, float* part, int tid, int lanes) {
    ok = row < rows;
    const int r = ok ? row : 0, bi = r / n;
    p = x + (size_t)r * dm;
    g = gamma + (size_t)bi * dm;
    be = beta + (size_t)bi * dm;
    vec = dm % 4 == 0 && aligned4(x) && aligned4(gamma) && aligned4(beta);
    if (tid < lanes * kBM) {
      float ss = 0.0f;
      for (int k = 4 * (tid / kBM); k < dm; k += 4 * lanes) {
        const float4 v = load4(p, k, dm, vec);
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
      part[tid] = ss;
    }
    __syncthreads();
    float total = 0.0f;
    for (int i = 0; i < lanes; ++i) total += part[i * kBM + tid % kBM];
    scale = sqrt_dm / fmaxf(sqrtf(total), 1e-12f);
  }

  __device__ void chunk(int c) {
    const int k0 = c * kKC;
    pc = p + k0;
    gc = g + k0;
    bc = be + k0;
    left = dm - k0;
  }

  __device__ float4 get(int j) const {
    if (!ok) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 v = load4(pc, j, left, vec), gg = load4(gc, j, left, vec);
    const float4 bb = load4(bc, j, left, vec);
    return make_float4(v.x * scale * gg.x + bb.x, v.y * scale * gg.y + bb.y,
                       v.z * scale * gg.z + bb.z, v.w * scale * gg.w + bb.w);
  }
};

// A = a [rows, w] as it stands, zero past w (any w): K2b's context and
// K6's input and residual.
struct Rows {
  const float* a;
  int rows, w;
  const float *p, *pc;  // the row, and the chunk's
  int left;             // w - the chunk's first k
  bool ok, vec;

  __device__ void group(int) {}

  __device__ void init(int row, float*, int, int) {
    ok = row < rows;
    p = a + (size_t)(ok ? row : 0) * w;
    vec = w % 4 == 0 && aligned4(a);
  }

  __device__ void chunk(int c) {
    pc = p + c * kKC;
    left = w - c * kKC;
  }

  __device__ float4 get(int j) const {
    return ok ? load4(pc, j, left, vec) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};

// A[row, tap·w + c] = a_tap[row - (taps - 1 - tap)·dil, c] within row's
// sequence (row = b·n + t), zero before t = 0, where a_tap = a + tap ·
// tap_stride: with taps 3 and dil δ the causal k=3 conv's three shifted row
// views at dilation δ; with taps 1 the rows of a as they are; with taps L,
// dil 0 and tap_stride one lane, L lanes side by side. Group z reads a + z ·
// group_stride at dilation dil · 2^z (K1: lane l at δ = 2^l). Each a_tap is
// [rows, w] of f32, w % 32 == 0, aligned to four elements.
struct TapRows {
  const float* a;
  int rows, n, w, taps, dil;
  size_t tap_stride, group_stride;
  const float *p, *pc;  // the row, and the chunk's shifted row
  int t;
  bool ok, live;         // live: the chunk's source row exists

  __device__ void group(int z) {
    a += (size_t)z * group_stride;
    dil <<= z;
  }

  __device__ void init(int row, float*, int, int) {
    ok = row < rows;
    t = ok ? row % n : 0;
    p = a + (size_t)(ok ? row : 0) * w;
  }

  __device__ void chunk(int c) {
    const int k0 = c * kKC, tap = k0 / w, shift = (taps - 1 - tap) * dil;
    live = ok && t >= shift;
    pc = live ? p + tap * tap_stride - (size_t)shift * w + (k0 - tap * w) : p;
  }

  __device__ float4 get(int j) const {
    return live ? load4v(pc + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};

// A[row, h·dh + e] = o[b, h, t, e] (row = b·n + t): K4's output [b, H, n,
// dh] as the rows of the heads' concatenation, each head one contiguous
// [n, dh] tile; dh % 32 == 0.
struct HeadRows {
  const float* o;
  int rows, n, heads, dh;
  const float *p, *pc;  // the row of head 0, and the chunk's
  size_t head_stride;
  bool ok;

  __device__ void group(int) {}

  __device__ void init(int row, float*, int, int) {
    ok = row < rows;
    const int r = ok ? row : 0, bi = r / n, t = r % n;
    head_stride = (size_t)n * dh;
    p = o + ((size_t)bi * heads * n + t) * dh;
  }

  __device__ void chunk(int c) {
    const int k0 = c * kKC;
    pc = p + (size_t)(k0 / dh) * head_stride + k0 % dh;
  }

  __device__ float4 get(int j) const {
    return ok ? load4v(pc + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
};

// ---- epilogues, on the accumulator of a 64 x 64 tile ----------------------
//
// Lane l = 4g + t of warp w holds rows 16w + g + 8r (r = 0, 1) and columns
// 8j + 2t + e (e = 0, 1) as acc[j][2r + e].

// out[row, col] = acc + bias[col] (+ res[row, col]) for col < ncols, both
// [rows, ld]; bias and res may be null.
struct Store {
  float* out;
  const float* bias;
  const float* res;
  int rows, ncols, ld;

  __device__ void group(int) {}

  __device__ void operator()(const float (&acc)[8][4], int m0, int n0, int warp,
                             int lane) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * (lane % 4) + e;
          if (col >= ncols) continue;
          const size_t at = (size_t)row * ld + col;
          out[at] = acc[j][2 * r + e] + (bias ? bias[col] : 0.0f) + (res ? res[at] : 0.0f);
        }
    }
  }
};

// K3's GEGLU: tile j holds value columns 32j .. 32j + 31 in its first 32
// columns and the same gate columns in its last 32 (the weight cache
// interleaves them so), and writes
//   a[row, c] = gelu_tanh(gate + b_gate[c]) · (val + b_val[c]),  a [rows, w].
struct Geglu {
  float* a;
  const float* b_val;
  const float* b_gate;
  int rows, w;

  __device__ void group(int) {}

  __device__ void operator()(const float (&acc)[8][4], int m0, int n0, int warp,
                             int lane) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 / 2 + 8 * j + 2 * (lane % 4) + e;
          a[(size_t)row * w + c] =
              gelu_tanh(acc[j + 4][2 * r + e] + b_gate[c]) * (acc[j][2 * r + e] + b_val[c]);
        }
    }
  }
};

// K2's q/k/v: column which·H·dh + h·dh + e (which: q, k, v) is column e
// of head h of that projection, scattered into K4's layout qkv [3, b, H, n,
// dh]; dh % 64 == 0, so a 64-column tile lies within one head.
struct QkvScatter {
  float* qkv;
  int rows, n, heads, batch, dh;

  __device__ void group(int) {}

  __device__ void operator()(const float (&acc)[8][4], int m0, int n0, int warp,
                             int lane) const {
    const int hd = heads * dh, which = n0 / hd, h = n0 % hd / dh, e0 = n0 % dh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= rows) continue;
      const int bi = row / n, t = row % n;
      float* dst = qkv + ((((size_t)which * batch + bi) * heads + h) * n + t) * dh + e0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        store2(dst + 8 * jj + 2 * (lane % 4), acc[jj][2 * r], acc[jj][2 * r + 1]);
    }
  }
};

// K6's nearest code: C = r·Cbᵀ, so code col is d² = −2·acc + norms[col]
// from the row's residual r (‖r‖², the same for every code, dropped); each
// row's first minimal (d², col) over the tile's columns < ncols goes into
// best[row]
// by a 64-bit atomicMin on (order-preserving bits of d², col): across tiles
// the least d² wins and, on equal d², the lower col, the first minimal index
// overall. best starts at all ones.
struct ArgMin {
  const float* norms;
  unsigned long long* best;
  int rows, ncols;

  __device__ void group(int) {}

  __device__ void operator()(const float (&acc)[8][4], int m0, int n0, int warp,
                             int lane) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      float bd = INFINITY;
      int bc = -1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // ascending columns: a strict < keeps the first
          const int col = n0 + 8 * j + 2 * (lane % 4) + e;
          if (col >= ncols) continue;
          const float d2 = -2.0f * acc[j][2 * r + e] + norms[col];
          if (bc < 0 || d2 < bd) {
            bd = d2;
            bc = col;
          }
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the four lanes of the row
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (oc >= 0 && (bc < 0 || od < bd || (od == bd && oc < bc))) {
          bd = od;
          bc = oc;
        }
      }
      if (lane % 4 == 0 && row < rows && bc >= 0) {
        uint32_t u = __float_as_uint(bd + 0.0f);  // -0 as +0
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        atomicMin(best + row, (unsigned long long)u << 32 | (uint32_t)bc);
      }
    }
  }
};

// K1's gated block: tile j holds the conv's columns 32j .. 32j + 31 in its
// first 32 columns and the residual's same columns in its last 32 (the
// weight cache interleaves them so), and writes lane l of the next stack:
//   y = conv + cb[c],  y = y·γ + β,  out[row, c] = tanh(y)·σ(y) + res + rb[c]
// with γ = film[b][c], β = film[b][w + c] (row = b·n + t; batch rows
// film_b elements apart). Group z (lane z) writes out + z · out_group and
// reads its biases and FiLM z·w and z·2w elements on. out is [rows, w] (the
// lanes, f32 as the JAX kernel keeps them), the biases and FiLM f32 (the
// mixed entry points widen theirs).
struct WaveGate {
  float* out;
  const float* cb;
  const float* rb;
  const float* film;
  size_t out_group, film_b;
  int rows, n, w;

  __device__ void group(int z) {
    out += (size_t)z * out_group;
    cb += (size_t)z * w;
    rb += (size_t)z * w;
    film += (size_t)z * 2 * w;
  }

  __device__ void operator()(const float (&acc)[8][4], int m0, int n0, int warp,
                             int lane) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= rows) continue;
      const float* f = film + (size_t)(row / n) * film_b;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 / 2 + 8 * j + 2 * (lane % 4) + e;
          const float y = (acc[j][2 * r + e] + cb[c]) * f[c] + f[w + c];
          out[(size_t)row * w + c] = tanhf(y) * sigmoid(y) + acc[j + 4][2 * r + e] + rb[c];
        }
    }
  }
};

// ---- the kernel -----------------------------------------------------------

// grid (ceil(M / 64), ceil(n_tiles / WN), groups), 128·WN threads, dynamic
// shared memory sizeof(Smem<WN>). bt: the packed Bᵀ of group 0, tile
// (j, c) at (j·chunks + c)·kBParts·kTile elements, hi then lo; group z's at
// bt + z·b_group. A warpgroup past the last column tile runs its products
// on whatever its B stage holds and stores nothing.
// Blocks an SM: three of one warpgroup, two of two (at most 128 registers a
// thread: K1's and K1b's blocks), one of three.
template <int WN>
constexpr int kBlocksPerSm = WN == 1 ? 3 : (WN == 2 ? 2 : 1);

template <int WN, class Loader, class Epilogue>
__global__ void __launch_bounds__(WN * kThreads, kBlocksPerSm<WN>)
gemm_kernel(Loader loader, const float* __restrict__ bt, size_t b_group,
            int chunks, int n_tiles, Epilogue epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<WN>& sm = *reinterpret_cast<Smem<WN>*>(smem_raw);

  const int tid = threadIdx.x, wg = tid / kThreads, t = tid % kThreads;
  const int warp = t / 32, lane = t % 32;
  const int m0 = blockIdx.x * kBM, tile = blockIdx.y * WN + wg, n0 = tile * kBN;
  const bool live = tile < n_tiles;  // the same for the whole warpgroup
  const float* bj = bt + blockIdx.z * b_group + (size_t)tile * chunks * kBParts * kTile;
  // a staging thread's row and its float4 columns 4·(cq + lanes·i) of a
  // chunk: a warp stores 32 rows' 16 bytes, one contiguous run per k-half
  constexpr int kLanes = kStagers<WN> / kBM;      // staging threads per row of A
  constexpr int kA4 = kTile / 4 / kStagers<WN>;   // float4s per staging thread
  static_assert(kA4 * kStagers<WN> * 4 == kTile, "A's chunk divides over its stagers");
  const bool stager = tid < kStagers<WN>;         // the same for the whole warp
  const int sr = tid % kBM, cq = tid / kBM;
  Loader ld = loader;
  ld.group(blockIdx.z);
  ld.init(m0 + sr, &sm.part[0][0], tid, kLanes);

  auto load_b = [&](int c, int s) {
    if (!live) return;
    const char* src = reinterpret_cast<const char*>(bj + (size_t)c * kBParts * kTile);
    char* dst = reinterpret_cast<char*>(&sm.b[s][wg][0][0]);
    constexpr int kBytes = kBParts * kTile * (int)sizeof(float);
    for (int e = 16 * t; e < kBytes; e += 16 * kThreads) cp_async16(dst + e, src + e, true);
  };
  float4 areg[kA4];
  auto load_a = [&](int c) {
    if (!stager) return;
    ld.chunk(c);
#pragma unroll
    for (int i = 0; i < kA4; ++i) areg[i] = ld.get(4 * (cq + kLanes * i));
  };
  auto store_a = [&](int s) {
    if (!stager) return;
#pragma unroll
    for (int i = 0; i < kA4; ++i) {
      const int k = 4 * (cq + kLanes * i);
      store_split4(sm.a[s][0], sm.a[s][1], kmajor<kBM>(sr, k), areg[i]);
    }
  };

  load_b(0, 0);
  cp_async_commit();
  if (chunks > 1) load_b(1, 1);
  cp_async_commit();
  load_a(0);
  store_a(0);
  if (chunks > 1) load_a(1);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    cp_async_wait<1>();  // chunk c of B has landed (c + 1 may be in flight)
    fence_proxy_async();
    __syncthreads();     // chunk c of A and B is in shared memory, for wgmma too

    // the chunk's large terms and small ones, each summed in fresh
    // accumulators
    float big[8][4], small[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) big[j][i] = small[j][i] = 0.0f;
    pin(big);
    pin(small);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const uint64_t a_hi = kmajor_desc<kBM>(sm.a[s][0], ks);
      const uint64_t a_lo = kmajor_desc<kBM>(sm.a[s][1], ks);
      const uint64_t b_hi = kmajor_desc<kBN>(sm.b[s][wg][0], ks);
      wgmma_ss_n64(small, a_hi, kmajor_desc<kBN>(sm.b[s][wg][1], ks));
      wgmma_ss_n64(small, a_lo, b_hi);
      wgmma_ss_n64(big, a_hi, b_hi);
    }
    wg_commit();
    // while the products run: split and stage chunk c + 1 of A (stage s ^ 1
    // was last read by chunk c - 1's products, waited for), load c + 2
    if (c + 1 < chunks) {
      store_a(s ^ 1);
      if (c + 2 < chunks) load_a(c + 2);
    }
    wg_wait0();
    pin(big);
    pin(small);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += big[j][i] + small[j][i];
    __syncthreads();  // every warp's products are done with stage s
    if (c + 2 < chunks) load_b(c + 2, s);
    cp_async_commit();  // possibly empty: one group per chunk keeps the count
  }
  if (live) {
    Epilogue e = epi;
    e.group(blockIdx.z);
    e(acc, m0, n0, warp, lane);
  }
}

// The number of SMs of the current device.
inline int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count;
}

// `groups` GEMMs in grid z, group z's B b_group elements after group 0's.
struct Groups {
  int groups = 1;
  size_t b_group = 0;
};

template <int WN, class Loader, class Epilogue>
cudaError_t launch_wn(const Loader& loader, const float* bt, int rows, int chunks,
                      int n_tiles, const Epilogue& epi, cudaStream_t stream,
                      Groups g = Groups()) {
  if (rows <= 0 || chunks <= 0 || n_tiles <= 0 || g.groups <= 0) return cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem<WN>);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<WN, Loader, Epilogue>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kBM - 1) / kBM, (n_tiles + WN - 1) / WN, g.groups);
  gemm_kernel<WN, Loader, Epilogue><<<grid, WN * kThreads, bytes, stream>>>(
      loader, bt, g.b_group, chunks, n_tiles, epi);
  return cudaGetLastError();
}

constexpr int kSharedWN = 3;  // warpgroups sharing an A tile where the grid is large

// C = epilogue(A · B) over `rows` rows and n_tiles · 64 columns, K =
// chunks · 32 (for each of g.groups groups), launched on
// `stream` without synchronising. Three warpgroups share each A tile where
// that still gives every SM such a block (one fits), else a block is one
// warpgroup (three an SM).
template <class Loader, class Epilogue>
cudaError_t launch(const Loader& loader, const float* bt, int rows, int chunks,
                   int n_tiles, const Epilogue& epi, cudaStream_t stream, Groups g = Groups()) {
  if (rows <= 0 || chunks <= 0 || n_tiles <= 0) return cudaErrorInvalidValue;
  const long shared = (long)((rows + kBM - 1) / kBM) * ((n_tiles + kSharedWN - 1) / kSharedWN) *
                      g.groups;
  if (shared >= sm_count())
    return launch_wn<kSharedWN>(loader, bt, rows, chunks, n_tiles, epi, stream, g);
  return launch_wn<1>(loader, bt, rows, chunks, n_tiles, epi, stream, g);
}

}  // namespace gemm
}  // namespace ns2
