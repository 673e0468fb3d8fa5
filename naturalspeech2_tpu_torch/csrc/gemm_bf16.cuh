// The bf16 GEMM core of K1 (wavenet.cu), K1b (wavenet_lane.cu, its
// `bf16_matmul` option too), K2 (attn_block.cu), K2b (cross_attn_block.cu)
// and K3 (ff_block.cu) in bf16, of the mixed entry points of K1, K1b, K2,
// K2b and K3 (f32 activations against bf16 weights) and of K6 in bf16
// (rvq.cu):
//
//   C[M x N] = epilogue(A[M x K] · B[K x N]),   A and B bf16, summed in f32,
//
// on Hopper's bf16 tensor cores (989 TFLOP/s dense, H100 SXM at 700 W).
//
// What bounds it on the card: the products. K3's three GEMMs at the scaled
// model's b16 × n1024 × d512 are 266 GFLOP against some 120 MB of operands
// and outputs, far past the ridge (≈ 295 FLOP a byte); the served b2 ×
// n512 × d128 ones fill less than one wave of the 132 SMs.
//
// Design (the shape of K4's and K5's bf16 kernels, flash_bf16.cuh, with
// the copies on the Tensor Memory Accelerator): a block owns a BM × BN tile
// of C, BM = 64·G rows for G consumer warpgroups of 64 rows each, and one
// producer warpgroup.
//  - K runs in chunks of 64, one 128-byte row of bf16 per row of an
//    operand: a chunk of A is one [BM, 64] panel and of B one [BN, 64]
//    panel, both in the 128-byte swizzled layout that `wgmma` reads
//    K-major (flash_bf16.cuh), so a chunk's four k-steps are
//    `wgmma.m64nBNk16` on descriptors 32 bytes apart.
//  - One producer thread keeps a ring of 4 chunks in flight: per chunk one
//    TMA box of A (the hardware writes the 128-byte swizzle) and one of B,
//    both completing on the stage's `full` mbarrier with their byte count.
//    The producer warpgroup hands its registers to the consumers
//    (`setmaxnreg`, two consumer warpgroups). No thread stages an operand
//    through registers: copies by `cp.async` from a producer warpgroup
//    reached some 14 GB/s an SM, a sixth of what the products need at 128 ×
//    256, whatever the ring's depth (gemm_variants.py).
//  - The f32 accumulator stays in registers across the whole of K. Each
//    consumer warp releases a stage on its `empty` mbarrier as soon as its
//    warpgroup's products on it are done (`wgmma.wait_group 1` after the
//    next chunk's products are issued), with no block-wide barrier.
//  - A is plain bf16 rows, [b, H, n, w] as a 4-dim tensor map, and a tile's
//    rows lie in one sequence (batch · ceil(n / BM) row tiles), so a box
//    that runs past the sequence's ends reads TMA's out-of-bounds zeros:
//    `Rows` (rows of a buffer: n(x) written by the pre-pass `norm_rows`,
//    K3's c), `TapRows` (K3's conv: the three taps are boxes of one [b, n,
//    w] buffer shifted back by 2, 1 and 0 rows, the rows before t = 0 of
//    the sequence zeros), `HeadRows` (K4's output [b, H, n, dh] as the
//    heads' concatenation; a chunk of 64 lies in one head), and the
//    WaveNet's `SplitTaps` and `SplitLanes` (below). K2b's context is
//    `Rows` of ctx [b, m, dc] itself (its mixed entry: `SplitLanes` of the
//    context's planes): m = 32 rows fill half a 64-row box, the rest TMA's
//    zeros. A loader also names each chunk's B chunk (`at`
//    returns it), so that chunks of A may share one chunk of B.
//  - B is a weight, packed once by the Python wrapper (`pack_b(bt,
//    "bf16_sw128")` in ops/gemm_cache.py): Bᵀ [N, K] padded with zeros to
//    64-row and 64-column multiples and laid out chunk by chunk, [K / 64,
//    N, 64], each 128-byte row already swizzled. The rows n0 .. n0 + BN - 1
//    of a chunk are then one contiguous run, a TMA box copied as it lies,
//    whatever BN is (rows past N read as zeros).
//  - The tile shape is chosen by waves of the SMs (`choose`): 128 × 256
//    where the grid is large, 128 × 128, or 64 × 64 (two blocks an SM)
//    where a grid of larger tiles would leave most SMs idle (the served
//    shapes).
// Epilogues: `Geglu` (each 64 columns of B hold 32 value and the same 32
// gate columns, so both products share A), `Store` (bias and an optional
// residual, summed in f32, rounded once), `QkvScatter` (into K4's [3, b,
// H, n, dh]), `WaveGateSplit` (K1's gate, into three bf16 planes, or
// one for `bf16_matmul`), `GegluSplit` and `StoreSplit` (K3 mixed: a's and
// c's three planes) and `ArgMin` (K6's distances and each row's first
// minimum). Every rounding point of the JAX kernels stays where the
// callers put it: the core only sums A·B in f32 and hands the sum to the
// epilogue.
//
// f32 operands against bf16 values (K1 and K1b in bf16, whose JAX kernels
// keep their lanes in f32 and multiply them by the bf16 weights with f32
// products; the mixed entries of K1, K1b, K2, K2b and K3, whose
// activations are f32 too: n(x) by `norm_planes`, K3's a and c by their
// epilogues, x, K2's and K2b's o and K2b's context by `split_planes`; K6 in
// bf16, whose f32 residual meets bf16 codebooks): an
// f32 value v is carried as three bf16
// planes, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), which
// sum to v exactly (8 + 8 + 8 of f32's 24 significant bits), and each part
// times a bf16 value is exact in f32. So the product is three bf16 passes
// over the same B chunks, issued lo first: the tensor cores truncate where
// they add (gemm_tf32x3.cuh), so the small terms go in before the
// accumulator holds the large ones. K1b's `bf16_matmul` rounds both
// operands of every product to bf16, so there a lane is one plane, bf16(v):
// the same loaders and epilogue with one part.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

#include "flash_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace ns2 {
namespace bgemm {

constexpr int kKC = 64;          // k per chunk: one 128-byte panel row of bf16
constexpr int kStages = 4;       // chunks in the ring (4 to 7 fit; deeper gained nothing)
constexpr int kProducers = 128;  // the warpgroup that copies
constexpr int kPad = 64;         // what pack_b pads N and K to

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// A block of BM rows (BM / 64 consumer warpgroups) by BN columns, and its
// shared memory from a 1024-byte aligned base: kStages stages of an A panel
// and a B panel, then each stage's full and empty barriers (at 128 x 256,
// 193 KB of the SM's 227). Blocks of 128 rows run one an SM (168 registers
// a thread at launch, then 40 for the producer and 232 for the consumers);
// blocks of 64 rows two (128 each).
template <int BM, int BN>
struct Tile {
  static constexpr int kGroups = BM / 64;
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + kProducers;
  static constexpr int kBlocksPerSm = BM == 128 ? 1 : 2;
  static constexpr uint32_t kPanelA = BM * sm90::kPanelRowBytes;
  static constexpr uint32_t kPanelB = BN * sm90::kPanelRowBytes;
  static constexpr uint32_t kStage = kPanelA + kPanelB;
  static constexpr uint32_t kBars = kStages * kStage;
  static constexpr int kBytes = (int)kBars + 16 * kStages + 1024;  // + alignment
};

// d[64 x 256] += A·Bᵀ over one k-step of 16: bf16 A and B in shared memory,
// both K-major and 128-byte swizzled (descriptors a, b), f32 accumulation;
// scale_d 0 overwrites d. The accumulator layout as sm90::wgmma_ss_n64's, j < 32.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[32][4], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// One k-step of 16 for a warpgroup's 64 x BN accumulator.
template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 8][4], uint64_t a, uint64_t b) {
  if constexpr (BN == 256)
    wgmma_ss_n256(d, a, b, 1);
  else if constexpr (BN == 128)
    sm90::wgmma_ss_n128(d, a, b, 1);
  else
    sm90::wgmma_ss_n64(d, a, b, 1);
}

// ---- TMA ----------------------------------------------------------------

// cuTensorMapEncodeTiled, the driver's, through the runtime's entry point
// (no link to the driver library); null where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of a bf16 tensor of `rank` dims (dims[0] innermost, strides
// in bytes of dims 1 .. rank - 1), read in boxes of box[] elements; reads out
// of bounds (negative coordinates too) give zeros. swizzle: the 128-byte
// swizzle `wgmma` reads (A), or none (B, packed already swizzled).
inline cudaError_t make_map(CUtensorMap* map, const bf16* base, int rank, const uint64_t* dims,
                            const uint64_t* strides, const uint32_t* box, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], one[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    if (i + 1 < rank) st[i] = strides[i];
  }
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                            const_cast<bf16*>(base), d, st, bx, one,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Arrive on `bar` expecting `bytes` more from the copies that complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   sm90::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One box of a 4-dim (A) or 3-dim (B) map at coordinates c.. into shared
// memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(sm90::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(sm90::smem_u32(bar))
      : "memory");
}

// ---- A: a 4-dim map [b, H, n, w] of the operand (w innermost) and the
// coordinates (c, t, h, b) of chunk kc's box for the tile of rows t0 ..
// t0 + BM - 1 of sequence bi: A[bi·n + t, 64·kc + j] is element (c + j, t,
// h, bi) of the map. A tile's rows lie in one sequence, so a box past the
// sequence's ends (t < 0, t >= n) reads zeros. `at` returns the chunk of
// the packed B that chunk kc of A multiplies (kc but for the WaveNet's). --

inline cudaError_t rows_map(CUtensorMap* map, const bf16* a, int batch, int heads, int n, int w,
                            int ld, int bm) {
  const uint64_t dims[4] = {(uint64_t)w, (uint64_t)n, (uint64_t)heads, (uint64_t)batch};
  const uint64_t row = 2ull * ld, strides[3] = {row, row * n, row * n * heads};
  const uint32_t box[4] = {(uint32_t)kKC, (uint32_t)bm, 1, 1};
  return make_map(map, a, 4, dims, strides, box, true);
}

// A[b·n + t, k] = a[(b·n + t)·ld + k] for k < w; ld a multiple of 8.
struct Rows {
  const bf16* a;
  int batch, n, ld, w;

  cudaError_t map(CUtensorMap* m, int bm) const { return rows_map(m, a, batch, 1, n, w, ld, bm); }
  __device__ int at(int kc, int t0, int bi, int (&c)[4]) const {
    c[0] = kc * kKC;
    c[1] = t0;
    c[2] = 0;
    c[3] = bi;
    return kc;
  }
};

// K3's causal conv: A[b·n + t, tap·w + c] = a[b·n + t - (2 - tap), c], zero
// where t < 2 - tap (the box starts before its sequence); a [b, n, w], w a
// multiple of 64, so each chunk lies in one tap.
struct TapRows {
  const bf16* a;
  int batch, n, w;

  cudaError_t map(CUtensorMap* m, int bm) const { return rows_map(m, a, batch, 1, n, w, w, bm); }
  __device__ int at(int kc, int t0, int bi, int (&c)[4]) const {
    const int k = kc * kKC, tap = k / w;
    c[0] = k - tap * w;
    c[1] = t0 - (2 - tap);
    c[2] = 0;
    c[3] = bi;
    return kc;
  }
};

// A[b·n + t, h·dh + e] = o[b, h, t, e]: K4's output [b, H, n, dh] as the rows
// of the heads' concatenation; dh a multiple of 64, so each chunk lies in
// one head.
struct HeadRows {
  const bf16* o;
  int batch, heads, n, dh;

  cudaError_t map(CUtensorMap* m, int bm) const {
    return rows_map(m, o, batch, heads, n, dh, dh, bm);
  }
  __device__ int at(int kc, int t0, int bi, int (&c)[4]) const {
    const int k = kc * kKC, h = k / dh;
    c[0] = k - h * dh;
    c[1] = t0;
    c[2] = h;
    c[3] = bi;
    return kc;
  }
};

// K1's and K1b's block products on the bf16 core. The lanes of a stack are
// bf16 planes [G·b, P, n, w] (lane g of the launch, sequence bi of the
// batch at g·b + bi; P = 3: plane 0 hi, 1 mid, 2 lo, see the top of this
// file; P = 1: `bf16_matmul`'s bf16(v)), w = d padded to 64, written by the
// previous stack's `WaveGateSplit`; the first stack reads x [b, n, w] as
// one part, the same b sequences for every lane (`shared`). The grid's
// sequences are the G·b of the launch (`batch`: K1 folds a stack's L lanes
// into the rows of one launch), so the lane of sequence bi is lane0 + bi /
// per_lane, with dilation δ = 2^lane. Chunk kc of K = parts · 3w is (part,
// tap, c): the box of rows t0 - (2 - tap)·δ onward of plane part, the rows
// before t = 0 TMA's zeros (δ up to 128: up to 256 rows before the tile).
// The parts run lo, mid, hi, and each multiplies the same chunks of the
// lane's block: the packed blocks are one run of [S·L, 3w / 64] chunks of
// Bᵀ [2w, 3w], and the lane's block starts at chunk b_block0 + lane·3w/64.
struct SplitTaps {
  int batch, n, w;
  int per_lane;  // sequences a lane: b
  int lane0;     // the launch's first lane
  int parts;     // planes of A: 3, or 1 (x, `bf16_matmul`'s lanes)
  bool shared;   // A is x [b, n, w], read by every lane
  int b_block0;  // the chunk of lane lane0's block in the packed blocks

  __device__ int at(int kc, int t0, int bi, int (&c)[4]) const {
    const int per_part = 3 * w / kKC, p = kc / per_part, kb = kc - p * per_part;
    const int k = kb * kKC, tap = k / w, lane = bi / per_lane;
    c[0] = k - tap * w;
    c[1] = t0 - ((2 - tap) << (lane0 + lane));
    c[2] = parts - 1 - p;  // lo first
    c[3] = shared ? bi - lane * per_lane : bi;
    return b_block0 + lane * per_part + kb;
  }
};

// The skips' product: A[bi·n + t, (part, lane, c)] = plane part of lane
// slot0 + lane of planes [·, parts, n, w] (sequence (slot0 + lane)·batch +
// bi), K = parts · lanes · w, the parts lo first; chunk kc multiplies chunk
// b_chunk0 + (kc mod lanes·w/64) of the packed skips (K1: the L lanes side
// by side against skip_w [L·w, w]; K1b: one lane a launch).
struct SplitLanes {
  int batch, n, w, lanes, parts;
  int slot0;     // the first lane's place in the planes
  int b_chunk0;

  __device__ int at(int kc, int t0, int bi, int (&c)[4]) const {
    const int per_part = lanes * w / kKC, p = kc / per_part, kb = kc - p * per_part;
    const int k = kb * kKC, lane = k / w;
    c[0] = k - lane * w;
    c[1] = t0;
    c[2] = parts - 1 - p;
    c[3] = (slot0 + lane) * batch + bi;
    return b_chunk0 + kb;
  }
};

// K2's W_o product in its mixed entry: A[bi·n + t, (part, h, e)] = part
// `part` of K4's f32 output o[bi, h, t, e], from the planes [b, 3·H, n, dh]
// that `split_planes` writes of o read as [b, H·n, dh] (part q of head h at
// slice q·H + h); K = 3·H·dh, the parts lo first, each against the same
// chunks of W_o. dh a multiple of 64, so each chunk lies in one head.
struct SplitHeadRows {
  int batch, heads, n, dh;

  __device__ int at(int kc, int t0, int bi, int (&c)[4]) const {
    const int per_part = heads * dh / kKC, p = kc / per_part, kb = kc - p * per_part;
    const int k = kb * kKC, h = k / dh;
    c[0] = k - h * dh;
    c[1] = t0;
    c[2] = (2 - p) * heads + h;
    c[3] = bi;
    return kb;
  }
};

// B: the packed Bᵀ [chunks, b_rows, 64] as a 3-dim map, boxes of BN rows of
// one chunk, copied as they lie (already swizzled); rows past b_rows read
// as zeros. `chunks` may cover several packed B's one after another (K1's
// blocks: every block of the body).
inline cudaError_t b_map(CUtensorMap* map, const bf16* bt, int b_rows, int chunks, int bn) {
  const uint64_t dims[3] = {(uint64_t)kKC, (uint64_t)b_rows, (uint64_t)chunks};
  const uint64_t strides[2] = {2ull * kKC, 2ull * kKC * b_rows};
  const uint32_t box[3] = {(uint32_t)kKC, (uint32_t)bn, 1};
  return make_map(map, bt, 3, dims, strides, box, false);
}

// ---- epilogues, on a warpgroup's 64 x BN accumulator ----------------------
//
// Lane l = 4g + t of warp w holds rows m0 + 16w + g + 8r (r = 0, 1) and
// columns n0 + 8j + 2t + e (e = 0, 1) as acc[j][2r + e], j < BN / 8; rows at
// or past row_end (the end of the tile's sequence) are not stored.

// out[row, col] = acc + bias[col] (+ res[row, col]) for col < ncols, out
// and res [rows, ld]; bias and res may be null. Summed in f32, rounded once
// to Out (bf16, or f32: K1b's sum of the skips).
template <class Out = bf16, class Bias = Out, class Res = Out>
struct Store {
  Out* out;
  const Bias* bias;
  const Res* res;
  int ncols, ld;

  template <int NJ>
  __device__ void operator()(const float (&acc)[NJ][4], int m0, int row_end, int n0, int warp,
                             int lane) const {
    const bool pairs = ld % 2 == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= row_end) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= ncols) continue;
        const size_t at = (size_t)row * ld + col;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = acc[j][2 * r + e] + (bias && col + e < ncols ? to_f32(bias[col + e]) : 0.0f) +
                 (res && col + e < ncols ? to_f32(res[at + e]) : 0.0f);
        if (pairs && col + 1 < ncols) {
          store2(out + at, v[0], v[1]);
        } else {
          out[at] = from_f32<Out>(v[0]);
          if (col + 1 < ncols) out[at + 1] = from_f32<Out>(v[1]);
        }
      }
    }
  }
};

// K3's GEGLU: each 64 columns of B hold 32 value columns in their first half
// and the same 32 gate columns in their second (ops/ff_block_kernel.py
// interleaves them so), and write
//   a[row, c] = gelu_tanh(gate + b_gate[c]) · (val + b_val[c])
// for c < w, a [rows, w] (w even), in f32, rounded once.
struct Geglu {
  bf16* a;
  const bf16* b_val;
  const bf16* b_gate;
  int w;

  template <int NJ>
  __device__ void operator()(const float (&acc)[NJ][4], int m0, int row_end, int n0, int warp,
                             int lane) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= row_end) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j % 8 >= 4) continue;  // a gate tile: read with its value tile
        const int c = n0 / 2 + 32 * (j / 8) + 8 * (j % 8) + 2 * (lane % 4);
        if (c >= w) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = gelu_tanh(acc[j + 4][2 * r + e] + to_f32(b_gate[c + e])) *
                 (acc[j][2 * r + e] + to_f32(b_val[c + e]));
        store2(a + (size_t)row * w + c, v[0], v[1]);
      }
    }
  }
};

// K2's q/k/v: column which·H·dh + h·dh + e (which: q, k, v) is column e of
// head h of that projection, scattered into K4's layout qkv [parts, b, H,
// n, dh] of Out (bf16, rounded once; f32 for the mixed entries, whose K4 is
// f32); dh % 64 == 0, so each 64 columns lie within one head. K2b's q
// (parts 1) and k/v (parts 2) take it too; a tile's columns past the
// parts' are not stored.
template <class Out>
struct QkvScatterT {
  Out* qkv;
  int n, heads, batch, dh;
  int parts = 3;

  template <int NJ>
  __device__ void operator()(const float (&acc)[NJ][4], int m0, int row_end, int n0, int warp,
                             int lane) const {
    const int hd = heads * dh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (row >= row_end) continue;
      const int bi = row / n, t = row % n;
#pragma unroll
      for (int p = 0; p < NJ / 8; ++p) {
        const int col = n0 + 64 * p, which = col / hd;
        if (which >= parts) continue;
        const int h = col % hd / dh, e0 = col % dh;
        Out* dst = qkv + ((((size_t)which * batch + bi) * heads + h) * n + t) * dh + e0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          store2(dst + 8 * jj + 2 * (lane % 4), acc[8 * p + jj][2 * r],
                 acc[8 * p + jj][2 * r + 1]);
      }
    }
  }
};
using QkvScatter = QkvScatterT<bf16>;

// The parts of an f32 value: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v
// - hi - mid), each rounded to nearest even; lo + mid + hi == v exactly
// (the differences are exact in f32, and what hi and mid leave is at most
// 8 significant bits).
__device__ __forceinline__ void split3(float v, float (&p)[3]) {
  p[0] = __bfloat162float(__float2bfloat16_rn(v));
  p[1] = __bfloat162float(__float2bfloat16_rn(v - p[0]));
  p[2] = v - p[0] - p[1];
}

// The planes [seqs, parts, n, w] as a 4-dim map that `WaveGateSplit` stores
// through: boxes of 64 columns, 64 rows and the parts' planes of one
// sequence, 128-byte swizzled in shared memory; rows past n are not written.
inline cudaError_t planes_map(CUtensorMap* map, const bf16* planes, int seqs, int parts, int n,
                              int w) {
  const uint64_t dims[4] = {(uint64_t)w, (uint64_t)n, (uint64_t)parts, (uint64_t)seqs};
  const uint64_t row = 2ull * w, strides[3] = {row, row * n, row * n * parts};
  const uint32_t box[4] = {(uint32_t)kKC, 64, (uint32_t)parts, 1};
  return make_map(map, planes, 4, dims, strides, box, true);
}

// f32 values written as bf16 planes by an epilogue (`WaveGateSplit`,
// `GegluSplit`, `StoreSplit`): a warpgroup stages its 64 rows of them in
// shared memory (the ring, free once both warpgroups' products are done),
// box by box in the layout `planes_map`'s boxes take ([Parts][64 rows][64
// columns], each 128-byte row swizzled), and one thread stores the boxes by
// TMA. Parts: three (`split3`) or one, bf16(v) rounded to nearest even.
// Stored by each thread in 4-byte pieces, three planes to a value, they
// took about a fifth of K1's time at b4 n1024 d128 (PERF.md).
template <int Parts>
struct StagedPlanes {
  static_assert(Parts == 3 || Parts == 1, "three parts of an f32 value, or its bf16 value");
  static constexpr uint32_t kBox = Parts * 64 * sm90::kPanelRowBytes;

  // values v0, v1 of columns cc, cc + 1 (cc even) of the staged tile, row
  // `row` of the warpgroup's 64, into the boxes from shared address `stage`
  __device__ static void put(uint32_t stage, int row, int cc, float v0, float v1) {
    float p[2][Parts];
    if constexpr (Parts == 3) {
      split3(v0, p[0]);
      split3(v1, p[1]);
    } else {  // pack_bf16x2 rounds them to nearest even
      p[0][0] = v0;
      p[1][0] = v1;
    }
    const uint32_t box = stage + cc / 64 * kBox;
#pragma unroll
    for (int q = 0; q < Parts; ++q) {
      const uint32_t at = box + sm90::swizzled(64 * q + row, cc % 64 / 8) + 2 * (cc % 8);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(pack_bf16x2(p[0][q], p[1][q]))
                   : "memory");
    }
  }

  // once the warpgroup has put its values: up to `boxes` boxes, those of
  // columns c0 + 64·i < w, stored through `map` (planes_map) at row t of
  // sequence seq; rows past n are not written
  __device__ static void store(const CUtensorMap* map, uint32_t stage, int boxes, int c0, int w,
                               int t, int seq, int warp, int lane, int wg) {
    fence_proxy_async();          // the stores, made visible to the TMA unit
    sm90::bar_sync(3 + wg, 128);  // the warpgroup's planes are staged
    if (warp == 0 && lane == 0) {
      for (int b = 0; b < boxes && c0 + 64 * b < w; ++b)
        asm volatile(
            "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], "
            "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
            "r"(stage + b * kBox), "r"(c0 + 64 * b), "r"(t), "r"(0), "r"(seq)
            : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before the block exits
    }
  }
};

// K1's gated block on the bf16 core: each 64 columns of B hold 32 conv
// columns and the same 32 residual columns (ops/wavenet_kernel.py's
// `block_weights`), so conv column c sits at j in [8g, 8g + 4) of group g
// and its residual at j + 4, and writes lane v of the next stack:
//   y = (conv + cb[c])·γ + β,  v = tanh(y)·σ(y) + res + rb[c]
// in f32 (γ = film[c], β = film[w + c] of the row's batch and lane), as
// Parts bf16 planes of the planes at the row's sequence: three (`split3`,
// K1 and K1b in bf16) or one, bf16(v) rounded to nearest even (K1b's
// `bf16_matmul`, whose products read the lane so). The grid's sequence s
// is lane s / per_lane of the launch and batch s % per_lane. cb, rb:
// [lanes, w] of P (bf16, or f32 for `bf16_matmul` and K1's mixed entry)
// from the launch's first lane; film: [b, ·, 2w] of P from it, batch rows
// film_b apart, lanes 2w apart. A warpgroup stages its 64 rows' planes
// (`StagedPlanes`, `kStaging` bytes each). With f32 parameters the
// warpgroup first copies the tile's cb,
// rb, γ and β (one column a thread) into shared memory past its planes, and
// the gate reads them there: read from device memory in the gate's loop,
// they took 10–16 % of `bf16_matmul`'s time (gemm_variants.py's
// bf16_gate_no_loads).
template <int Parts = 3, class P = bf16>
struct WaveGateSplit {
  static_assert(Parts == 3 || Parts == 1, "three parts of an f32 lane, or its bf16 value");
  static constexpr bool kStaged = std::is_same<P, float>::value;  // the parameters staged
  CUtensorMap out;  // planes_map of the planes written
  const P* cb;
  const P* rb;
  const P* film;
  size_t film_b;
  int per_lane, n, w;

  // shared memory of a warpgroup's planes: BN / 128 boxes of [Parts][64][64]
  template <int BN>
  static constexpr uint32_t kPlanes = BN / 128 * StagedPlanes<Parts>::kBox;
  // and of what it stages in all: with f32 parameters, then the tile's cb,
  // rb, γ, β [4][BN / 2] f32, the next warpgroup's planes 1024-byte aligned
  template <int BN>
  static constexpr uint32_t kStaging =
      kPlanes<BN> + (kStaged ? (uint32_t)round_up(4 * BN / 2 * 4, 1024) : 0u);

  template <int NJ>
  __device__ void operator()(const float (&acc)[NJ][4], int m0, int row_end, int n0, int warp,
                             int lane, uint32_t stage, int wg) const {
    static_assert(NJ >= 16, "a tile of 128 columns or more: 64 conv columns a box");
    constexpr int kCols = 4 * NJ;  // the tile's conv columns: BN / 2
    if (m0 >= row_end) return;  // the warpgroup's rows all past its sequence
    // a tile's rows lie in one sequence: one lane, one batch row
    const int seq = m0 / n, ln = seq / per_lane, bi = seq - ln * per_lane;
    const P* f = film + (size_t)bi * film_b + (size_t)ln * 2 * w;
    const P* cbl = cb + (size_t)ln * w;
    const P* rbl = rb + (size_t)ln * w;
    const int r0 = 16 * warp + lane / 4;  // this thread's first row of the 64
    // with f32 parameters: [4][kCols] f32, the tile's cb, rb, γ, β
    [[maybe_unused]] const uint32_t params = stage + kPlanes<8 * NJ>;
    if constexpr (kStaged) {
      for (int t = 32 * warp + lane; t < kCols; t += 128) {
        const int c = n0 / 2 + t;
        const bool in = c < w;
        st_shared(params + 4 * t, in ? to_f32(cbl[c]) : 0.0f);
        st_shared(params + 4 * (kCols + t), in ? to_f32(rbl[c]) : 0.0f);
        st_shared(params + 4 * (2 * kCols + t), in ? to_f32(f[c]) : 0.0f);
        st_shared(params + 4 * (3 * kCols + t), in ? to_f32(f[w + c]) : 0.0f);
      }
      sm90::bar_sync(3 + wg, 128);  // the tile's parameters are staged
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j % 8 >= 4) continue;  // a residual tile: read with its conv tile
      const int cc = 32 * (j / 8) + 8 * (j % 8) + 2 * (lane % 4);  // conv column in the tile
      const int c = n0 / 2 + cc;
      if (c >= w) continue;
      float2 cbc, rbc, gamma, beta;
      if constexpr (kStaged) {
        cbc = ld_shared2(params + 4 * cc);
        rbc = ld_shared2(params + 4 * (kCols + cc));
        gamma = ld_shared2(params + 4 * (2 * kCols + cc));
        beta = ld_shared2(params + 4 * (3 * kCols + cc));
      } else {
        cbc = load2(cbl + c);
        rbc = load2(rbl + c);
        gamma = load2(f + c);
        beta = load2(f + w + c);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float y0 = (acc[j][2 * r] + cbc.x) * gamma.x + beta.x;
        const float y1 = (acc[j][2 * r + 1] + cbc.y) * gamma.y + beta.y;
        const float v0 = tanhf(y0) * sigmoid(y0) + acc[j + 4][2 * r] + rbc.x;
        const float v1 = tanhf(y1) * sigmoid(y1) + acc[j + 4][2 * r + 1] + rbc.y;
        StagedPlanes<Parts>::put(stage, r0 + 8 * r, cc, v0, v1);
      }
    }
    StagedPlanes<Parts>::store(&out, stage, 8 * NJ / 128, n0 / 2, w, m0 - seq * n, seq, warp,
                               lane, wg);
  }

  // two adjacent bf16 (p 4-byte aligned) as f32
  __device__ static float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void st_shared(uint32_t at, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at), "f"(v) : "memory");
  }
  __device__ static float2 ld_shared2(uint32_t at) {  // at 8-byte aligned
    float2 v;
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(at) : "memory");
    return v;
  }
};

// K3's GEGLU in its mixed entry (f32 x against bf16 weights): as `Geglu`
// (each 64 columns of B hold 32 value and the same 32 gate columns), with
// f32 biases, a = gelu_tanh(gate + b_gate[c]) · (val + b_val[c]) in f32,
// written as the three bf16 planes of a [b, 3, n, w] (`StagedPlanes`, the
// tile's BN / 2 columns of a), which the conv reads as its A.
struct GegluSplit {
  CUtensorMap out;  // planes_map of a's planes
  const float* b_val;
  const float* b_gate;
  int n, w;

  template <int BN>
  static constexpr uint32_t kStaging = BN / 128 * StagedPlanes<3>::kBox;

  template <int NJ>
  __device__ void operator()(const float (&acc)[NJ][4], int m0, int row_end, int n0, int warp,
                             int lane, uint32_t stage, int wg) const {
    static_assert(NJ >= 16, "a tile of 128 columns or more: 64 columns of a a box");
    if (m0 >= row_end) return;  // the warpgroup's rows all past its sequence
    const int seq = m0 / n, r0 = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j % 8 >= 4) continue;  // a gate tile: read with its value tile
      const int cc = 32 * (j / 8) + 8 * (j % 8) + 2 * (lane % 4);  // column of a in the tile
      const int c = n0 / 2 + cc;
      if (c >= w) continue;
      const float bv0 = b_val[c], bv1 = b_val[c + 1], bg0 = b_gate[c], bg1 = b_gate[c + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        StagedPlanes<3>::put(stage, r0 + 8 * r, cc,
                             gelu_tanh(acc[j + 4][2 * r] + bg0) * (acc[j][2 * r] + bv0),
                             gelu_tanh(acc[j + 4][2 * r + 1] + bg1) * (acc[j][2 * r + 1] + bv1));
    }
    StagedPlanes<3>::store(&out, stage, 8 * NJ / 128, n0 / 2, w, m0 - seq * n, seq, warp, lane,
                           wg);
  }
};

// K3's conv in its mixed entry: c[row, col] = acc + bias[col] in f32 for
// col < w (bias f32), written as the three bf16 planes of c [b, 3, n, w]
// (`StagedPlanes`, the tile's BN columns), which W₂'s product reads.
struct StoreSplit {
  CUtensorMap out;  // planes_map of c's planes
  const float* bias;
  int n, w;

  template <int BN>
  static constexpr uint32_t kStaging = BN / 64 * StagedPlanes<3>::kBox;

  template <int NJ>
  __device__ void operator()(const float (&acc)[NJ][4], int m0, int row_end, int n0, int warp,
                             int lane, uint32_t stage, int wg) const {
    if (m0 >= row_end) return;
    const int seq = m0 / n, r0 = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int cc = 8 * j + 2 * (lane % 4), c = n0 + cc;
      if (c >= w) continue;
      const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        StagedPlanes<3>::put(stage, r0 + 8 * r, cc, acc[j][2 * r] + b0, acc[j][2 * r + 1] + b1);
    }
    StagedPlanes<3>::store(&out, stage, 8 * NJ / 64, n0, w, m0 - seq * n, seq, warp, lane, wg);
  }
};

// K6's distances (rvq.cu): B holds a stage's codebook C [K, w] as Bᵀ, so
// column c of the tile is code c, and
//   d²[row, c] = ‖C_c‖² − 2·acc   (‖r‖² is the same for every code: dropped)
// for the codes c < ncols. Each row's first minimum in the tile (columns
// ascending within a thread, then the four threads of the row by code) is
// merged into best[row] by a 64-bit atomicMin on (d²'s bits made to order
// as unsigned, code): the least d² wins and, among equal ones, the least
// code, so the first minimal index of the whole row survives every merge, as
// the JAX kernel's argmin keeps it. best holds all ones before the first
// merge. The split-TF32 core's gemm::ArgMin on this core's layout.
struct ArgMin {
  const float* norms;  // [ncols] f32
  unsigned long long* best;
  int ncols;

  template <int NJ>
  __device__ void operator()(const float (&acc)[NJ][4], int m0, int row_end, int n0, int warp,
                             int lane) const {
    float bd[2] = {INFINITY, INFINITY};  // the thread's two rows, 8 apart
    int bc[2] = {-1, -1};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // ascending columns: a strict < keeps the first
        const int col = n0 + 8 * j + 2 * (lane % 4) + e;
        if (col >= ncols) continue;
        const float norm = norms[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float d2 = -2.0f * acc[j][2 * r + e] + norm;
          if (bc[r] < 0 || d2 < bd[r]) {
            bd[r] = d2;
            bc[r] = col;
          }
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the four threads of the row
        const float od = __shfl_xor_sync(0xffffffffu, bd[r], off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc[r], off);
        if (oc >= 0 && (bc[r] < 0 || od < bd[r] || (od == bd[r] && oc < bc[r]))) {
          bd[r] = od;
          bc[r] = oc;
        }
      }
      const int row = m0 + 16 * warp + lane / 4 + 8 * r;
      if (lane % 4 == 0 && row < row_end && bc[r] >= 0) {
        uint32_t u = __float_as_uint(bd[r] + 0.0f);  // -0 as +0
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        atomicMin(best + row, (unsigned long long)u << 32 | (uint32_t)bc[r]);
      }
    }
  }
};

// Epilogues that stage their output in the ring (called with its address).
template <class E>
constexpr bool kStagesOut = false;
template <int Parts, class P>
constexpr bool kStagesOut<WaveGateSplit<Parts, P>> = true;
template <>
constexpr bool kStagesOut<GegluSplit> = true;
template <>
constexpr bool kStagesOut<StoreSplit> = true;

// ---- the kernel -----------------------------------------------------------

// grid (ceil(b_rows / BN), batch · ceil(n / BM)), Tile<BM, BN>::kThreads
// threads, Tile<BM, BN>::kBytes of dynamic shared memory: block (x, y) owns
// columns x·BN .. x·BN + BN - 1 and rows t0 .. t0 + BM - 1 (t0 = (y %
// tiles)·BM, tiles = ceil(n / BM)) of sequence y / tiles. map_a: the
// Loader's map of A; map_b: the packed Bᵀ's (b_map); chunks · 64 = K,
// chunk kc of A against chunk ld.at(kc, ...) of B.
template <int BM, int BN, class Loader, class Epilogue>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads, Tile<BM, BN>::kBlocksPerSm)
bf16_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, Loader ld, int chunks,
                 const __grid_constant__ Epilogue epi) {
  using T = Tile<BM, BN>;
  extern __shared__ __align__(1024) unsigned char bgemm_smem[];
  const uint32_t raw = sm90::smem_u32(bgemm_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bgemm_smem + (base - raw) + T::kBars);
  uint64_t* full = bars;
  uint64_t* empty = bars + kStages;

  const int tid = threadIdx.x;
  const int seq_tiles = (ld.n + BM - 1) / BM;
  const int bi = blockIdx.y / seq_tiles, t0 = blockIdx.y % seq_tiles * BM;
  const int n0 = blockIdx.x * BN;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(&full[st], 1);  // the producer's arrival and its bytes
      sm90::mbar_init(&empty[st], T::kConsumers / 32);  // every consumer warp done with it
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
  // the next kernel on the stream may start its blocks now (they wait below)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (tid >= T::kConsumers) {  // the producer warpgroup: one thread issues the copies
    if constexpr (T::kGroups == 2) sm90::producer_regs<2>();
    // The previous kernel's writes are visible past this point. Every read
    // of A and every store of the epilogue comes after a copy issued here,
    // so none can race that kernel's reads or writes.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (tid == T::kConsumers) {
      for (int kc = 0; kc < chunks; ++kc) {
        const int st = kc % kStages;
        sm90::mbar_wait(&empty[st], ((kc / kStages) & 1) ^ 1);  // the first round passes
        const uint32_t a_at = base + st * T::kStage;
        int c[4];
        const int kb = ld.at(kc, t0, bi, c);
        mbar_expect_tx(&full[st], T::kStage);
        tma_load_4d(a_at, &map_a, &full[st], c[0], c[1], c[2], c[3]);
        tma_load_3d(a_at + T::kPanelA, &map_b, &full[st], 0, n0, kb);
      }
    }
    return;
  }
  if constexpr (T::kGroups == 2) sm90::consumer_regs<2>();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  for (int kc = 0; kc < chunks; ++kc) {
    const int st = kc % kStages;
    sm90::mbar_wait(&full[st], (kc / kStages) & 1);  // the chunk's bytes have landed
    const uint32_t a_at = base + st * T::kStage + wg * 64 * sm90::kPanelRowBytes;
    const uint32_t b_at = base + st * T::kStage + T::kPanelA;
    sm90::pin(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks)
      mma<BN>(acc, sm90::desc(a_at + 32 * ks), sm90::desc(b_at + 32 * ks));
    wg_commit();
    sm90::wg_wait<1>();  // chunk kc - 1's products are done, kc's may run
    sm90::pin(acc);
    if (kc > 0 && lane == 0) sm90::mbar_arrive(&empty[(kc - 1) % kStages]);
  }
  sm90::wg_wait<0>();
  sm90::pin(acc);
  const int seq0 = bi * ld.n;
  if constexpr (kStagesOut<Epilogue>) {
    sm90::bar_sync(2, T::kConsumers);  // every warpgroup is done with the ring
    epi(acc, seq0 + t0 + 64 * wg, seq0 + ld.n, n0, warp, lane,
        base + wg * Epilogue::template kStaging<BN>, wg);
  } else {
    epi(acc, seq0 + t0 + 64 * wg, seq0 + ld.n, n0, warp, lane);
  }
}

// The tile shapes, with the blocks an SM and a relative rate of products
// each sustains an SM (a smaller tile reads more bytes a product).
struct Shape {
  int bm, bn, per_sm;
  float rate;
};
constexpr Shape kShapes[] = {{128, 256, 1, 1.0f}, {128, 128, 1, 0.85f}, {64, 64, 2, 0.6f}};

// The shape that finishes a GEMM of `cols` columns over batch sequences of
// n rows soonest by waves of the SMs (`wide`: of 128 columns or more, as
// `WaveGateSplit` stages them): tiles = batch · ceil(n / bm) ·
// ceil(cols / bn), ceil(tiles / (SMs · blocks an SM)) waves, each as long
// as one SM's share of products, blocks an SM · bm · bn / rate.
inline Shape choose(int batch, int n, int cols, bool wide = false) {
  const int sms = gemm::sm_count();
  Shape best = kShapes[0];
  float best_cost = 0.0f;
  for (const Shape& s : kShapes) {
    if (wide && s.bn < 128) continue;
    const long tiles = (long)batch * ((n + s.bm - 1) / s.bm) * ((cols + s.bn - 1) / s.bn);
    const long waves = (tiles + (long)sms * s.per_sm - 1) / ((long)sms * s.per_sm);
    const float cost = (float)waves * s.per_sm * s.bm * s.bn / s.rate;
    if (&s == kShapes || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device,
// once per kernel and device, not once a launch. Keyed by the kernel's
// address: a process may load several builds of these sources (the
// variants of gemm_variants.py), whose template statics it would share.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;  // (kernel, device)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& e : done)
    if (e.first == kernel && e.second == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.emplace_back(kernel, dev);
  return err;
}

// One launch on maps encoded by the caller: map_a the loader's at box rows
// BM, map_b the packed Bᵀ's at box rows BN (b_map); grid (ceil(b_rows / BN),
// ld.batch · ceil(ld.n / BM)), K = chunks · 64. Launched as a programmatic
// dependent of the stream's previous kernel: its blocks may start, set up
// their barriers and wait (`griddepcontrol.wait` in the producer) while
// that kernel's last blocks run.
template <int BM, int BN, class Loader, class Epilogue>
cudaError_t launch_mapped(const CUtensorMap& map_a, const CUtensorMap& map_b, const Loader& ld,
                          int b_rows, int chunks, const Epilogue& epi, cudaStream_t stream) {
  using T = Tile<BM, BN>;
  auto kernel = bf16_gemm_kernel<BM, BN, Loader, Epilogue>;
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), T::kBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((b_rows + BN - 1) / BN, ld.batch * ((ld.n + BM - 1) / BM));
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, ld, chunks, epi);
}

template <int V>
using Int = std::integral_constant<int, V>;

// launch_mapped at the tile shape s, chosen at run time; the maps encoded
// at s's box rows (s.bm for A, s.bn for B).
template <class Loader, class Epilogue>
cudaError_t launch_at(const Shape& s, const CUtensorMap& map_a, const CUtensorMap& map_b,
                      const Loader& ld, int b_rows, int chunks, const Epilogue& epi,
                      cudaStream_t stream) {
  auto go = [&](auto bm, auto bn) {
    return launch_mapped<decltype(bm)::value, decltype(bn)::value>(map_a, map_b, ld, b_rows,
                                                                   chunks, epi, stream);
  };
  if (s.bm == 128 && s.bn == 256) return go(Int<128>{}, Int<256>{});
  if (s.bm == 128) return go(Int<128>{}, Int<128>{});
  if constexpr (kStagesOut<Epilogue>)
    return cudaErrorInvalidValue;  // stages 128 columns or more: choose(..., wide)
  else
    return go(Int<64>{}, Int<64>{});
}

// C = epilogue(A · B) over the loader's batch · n rows and the b_rows
// columns of the packed Bᵀ (a multiple of 64; pack_b's padding of N), K =
// chunks · 64, launched on `stream` without synchronising; both maps
// encoded for this launch.
template <class Loader, class Epilogue>
cudaError_t launch(const Loader& ld, const bf16* bt, int b_rows, int chunks, const Epilogue& epi,
                   cudaStream_t stream) {
  if (ld.batch <= 0 || ld.n <= 0 || chunks <= 0 || b_rows <= 0 || b_rows % kPad != 0)
    return cudaErrorInvalidValue;
  const Shape s = choose(ld.batch, ld.n, b_rows);
  CUtensorMap map_a, map_b;
  cudaError_t err = ld.map(&map_a, s.bm);
  if (err != cudaSuccess) return err;
  err = b_map(&map_b, bt, b_rows, chunks, s.bn);
  if (err != cudaSuccess) return err;
  return launch_at(s, map_a, map_b, ld, b_rows, chunks, epi, stream);
}

// ---- the norm pre-pass ----------------------------------------------------

constexpr int kNormRowsPerBlock = 8;  // one warp a row

// f32 rows split into their three planes in the norm pre-pass's launch,
// after n(x)'s rows (K2b mixed's context): a [rows, w] into planes
// [rows / n, 3, n, ld] (ld even), columns past w zeros, as `split_planes`
// writes them; none where rows is 0. One launch fewer than a split of its
// own: K2b mixed at x [16, 160, 128] took 0.064 ms against 0.068–0.069 with
// the split launched alone, on an H100 (gemm_variants.py, PERF.md).
struct SplitTail {
  const float* a = nullptr;
  bf16* planes = nullptr;
  int rows = 0, n = 1, w = 0, ld = 0;
};

// out[row, k] = n(x)[row, k] rounded to bf16 for k < dm, 0 for dm <= k < ld:
// the adaptive RMSNorm x / max(‖x‖, 1e-12) · √dm · γ_b + β_b of x [rows,
// dm] (row = b·n + t, γ, β [b, dm]) in f32, as the split-TF32 core's
// NormRows loader computes it; ld even. Parts 3 (the mixed entries' f32
// x): its three parts (`split3`) into the planes [b, 3, n, ld] instead,
// and the rows after x's split as `tail` says.
template <class In, int Parts = 1>
__global__ void __launch_bounds__(32 * kNormRowsPerBlock)
norm_rows_kernel(const In* __restrict__ x, const In* __restrict__ gamma,
                 const In* __restrict__ beta, bf16* __restrict__ out, int rows, int n, int dm,
                 int ld, float sqrt_dm, const SplitTail tail) {
  const int row = blockIdx.x * kNormRowsPerBlock + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) {
    const int r = row - rows;
    if constexpr (Parts == 3) {
      if (r >= tail.rows) return;
      const float* p = tail.a + (size_t)r * tail.w;
      const size_t plane = (size_t)tail.n * tail.ld;
      bf16* o = tail.planes + (size_t)(r / tail.n) * 2 * plane + (size_t)r * tail.ld;
      for (int k = 2 * lane; k < tail.ld; k += 64) {
        float q[2][3];
        split3(k < tail.w ? p[k] : 0.0f, q[0]);
        split3(k + 1 < tail.w ? p[k + 1] : 0.0f, q[1]);
#pragma unroll
        for (int i = 0; i < 3; ++i) store2(o + i * plane + k, q[0][i], q[1][i]);
      }
    }
    return;
  }
  const In* p = x + (size_t)row * dm;
  const size_t bd = (size_t)(row / n) * dm;
  float ss = 0.0f;
  for (int k = lane; k < dm; k += 32) {
    const float v = to_f32(p[k]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float scale = sqrt_dm / fmaxf(sqrtf(ss), 1e-12f);
  const size_t plane = (size_t)n * ld;  // row t of sequence bi, plane q: (bi·Parts + q)·n + t
  bf16* o = out + (size_t)(row / n) * (Parts - 1) * plane + (size_t)row * ld;
  for (int k = 2 * lane; k < ld; k += 64) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[e] = k + e < dm
                 ? to_f32(p[k + e]) * scale * to_f32(gamma[bd + k + e]) + to_f32(beta[bd + k + e])
                 : 0.0f;
    if constexpr (Parts == 1) {
      store2(o + k, v[0], v[1]);
    } else {
      float q[2][3];
      split3(v[0], q[0]);
      split3(v[1], q[1]);
#pragma unroll
      for (int i = 0; i < 3; ++i) store2(o + i * plane + k, q[0][i], q[1][i]);
    }
  }
}

// n(x) of x [b·n, dm] into out [b·n, ld] (ld >= dm, even), launched on
// `stream` without synchronising.
inline cudaError_t norm_rows(const bf16* x, const bf16* gamma, const bf16* beta, bf16* out,
                             int rows, int n, int dm, int ld, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || dm <= 0 || ld < dm || ld % 2 != 0) return cudaErrorInvalidValue;
  norm_rows_kernel<bf16><<<(rows + kNormRowsPerBlock - 1) / kNormRowsPerBlock,
                           32 * kNormRowsPerBlock, 0, stream>>>(x, gamma, beta, out, rows, n, dm,
                                                                ld, sqrtf((float)dm), SplitTail{});
  return cudaGetLastError();
}

// The three parts of n(x) of f32 x [b·n, dm] into the planes [b, 3, n, ld]
// (ld >= dm, even), and the `tail` rows' parts, launched on `stream`
// without synchronising.
inline cudaError_t norm_planes(const float* x, const float* gamma, const float* beta,
                               bf16* planes, int rows, int n, int dm, int ld,
                               cudaStream_t stream, const SplitTail& tail = SplitTail{}) {
  if (rows <= 0 || n <= 0 || dm <= 0 || ld < dm || ld % 2 != 0 || tail.rows < 0 ||
      (tail.rows > 0 && (tail.n <= 0 || tail.w <= 0 || tail.ld < tail.w || tail.ld % 2 != 0)))
    return cudaErrorInvalidValue;
  const int all = rows + tail.rows;
  norm_rows_kernel<float, 3><<<(all + kNormRowsPerBlock - 1) / kNormRowsPerBlock,
                               32 * kNormRowsPerBlock, 0, stream>>>(
      x, gamma, beta, planes, rows, n, dm, ld, sqrtf((float)dm), tail);
  return cudaGetLastError();
}

// ---- the copies of A that TMA cannot read as they are --------------------

constexpr int kCopyThreads = 256;

// out[i] = bf16(x[i]), rounded to nearest even, for i < count (even): two a
// thread. (Templates, as every kernel of this header: the sources that
// include it are linked into one library.)
template <class In>
__global__ void __launch_bounds__(kCopyThreads)
round_bf16_kernel(const In* __restrict__ x, bf16* __restrict__ out, size_t count) {
  const size_t i = 2 * ((size_t)blockIdx.x * kCopyThreads + threadIdx.x);
  if (i < count) store2(out + i, x[i], x[i + 1]);
}

// x (f32, count values, count even) rounded to bf16 into out, launched on
// `stream` without synchronising: K1b's `bf16_matmul` reads x so.
inline cudaError_t round_bf16(const float* x, bf16* out, size_t count, cudaStream_t stream) {
  if (count == 0 || count % 2 != 0) return cudaErrorInvalidValue;
  const size_t blocks = (count / 2 + kCopyThreads - 1) / kCopyThreads;
  round_bf16_kernel<float><<<(unsigned)blocks, kCopyThreads, 0, stream>>>(x, out, count);
  return cudaGetLastError();
}

// planes[bi, q, t, c] = part q (0 hi, 1 mid, 2 lo: `split3`) of x[bi, t, c]
// for x [b, n, w] f32 and c < w, 0 for w <= c < ld (ld even): the f32 x of
// K1's and K1b's mixed entries, K2's and K2b's o, and K2b's context (dc
// padded to 64) are carried so. count = b·n·ld; two values a thread.
template <class In>
__global__ void __launch_bounds__(kCopyThreads)
split3_kernel(const In* __restrict__ x, bf16* __restrict__ planes, size_t count, int n, int w,
              int ld) {
  const size_t i = 2 * ((size_t)blockIdx.x * kCopyThreads + threadIdx.x);
  if (i >= count) return;
  const size_t r = i / ld, bi = r / n;
  const int c = (int)(i - r * ld);
  const In* src = x + r * w + c;
  float p[2][3];
  split3(c < w ? to_f32(src[0]) : 0.0f, p[0]);
  split3(c + 1 < w ? to_f32(src[1]) : 0.0f, p[1]);
  const size_t plane = (size_t)n * ld;
  bf16* dst = planes + bi * 2 * plane + i;  // plane 0 of sequence bi at bi·3·n·ld
#pragma unroll
  for (int q = 0; q < 3; ++q) store2(dst + q * plane, p[0][q], p[1][q]);
}

// x [b, n, w] (f32) as three bf16 planes [b, 3, n, ld] (ld >= w, even;
// columns past w zeros), launched on `stream` without synchronising.
inline cudaError_t split_planes(const float* x, bf16* planes, int b, int n, int w, int ld,
                                cudaStream_t stream) {
  const size_t count = (size_t)b * n * ld;
  if (count == 0 || w <= 0 || ld < w || ld % 2 != 0) return cudaErrorInvalidValue;
  const size_t blocks = (count / 2 + kCopyThreads - 1) / kCopyThreads;
  split3_kernel<float><<<(unsigned)blocks, kCopyThreads, 0, stream>>>(x, planes, count, n, w, ld);
  return cudaGetLastError();
}

// out[r, c] = a[r, c] for c < w, out [rows, ld]: rows of a at a row stride
// that TMA takes (16-byte aligned, ld a multiple of 8), columns w .. ld - 1
// left as they are (a map of width w never reads them).
template <class T>
__global__ void __launch_bounds__(kCopyThreads)
copy_rows_kernel(const T* __restrict__ a, T* __restrict__ out, int rows, int w, int ld) {
  const size_t i = (size_t)blockIdx.x * kCopyThreads + threadIdx.x;
  if (i >= (size_t)rows * w) return;
  const size_t r = i / w;
  out[r * ld + (i - r * w)] = a[i];
}

inline cudaError_t copy_rows(const bf16* a, bf16* out, int rows, int w, int ld,
                             cudaStream_t stream) {
  if (rows <= 0 || w <= 0 || ld < w) return cudaErrorInvalidValue;
  const size_t count = (size_t)rows * w;
  copy_rows_kernel<bf16><<<(unsigned)((count + kCopyThreads - 1) / kCopyThreads), kCopyThreads,
                           0, stream>>>(a, out, rows, w, ld);
  return cudaGetLastError();
}

// C = epilogue(n(x) · B), n(x) the adaptive RMSNorm of x [b, n, dm]: the
// pre-pass into `scratch` (b·n rows of dm padded to 64), then a GEMM on its
// rows; K = dm padded to 64. (n(x) staged through registers by the GEMM's
// producer warpgroup instead, the pre-pass saved, was slower at every shape
// of the bf16 paths but the served K3's, where it was level:
// gemm_variants.py's bf16_norm_loader.)
template <class Epilogue>
cudaError_t launch_normed(const bf16* x, const bf16* gamma, const bf16* beta, bf16* scratch,
                          int b, int n, int dm, const bf16* bt, int b_rows, const Epilogue& epi,
                          cudaStream_t stream) {
  const int dm_pad = round_up(dm, kPad), chunks = dm_pad / kKC;
  const cudaError_t err = norm_rows(x, gamma, beta, scratch, b * n, n, dm, dm_pad, stream);
  if (err != cudaSuccess) return err;
  return launch(Rows{scratch, b, n, dm_pad, dm_pad}, bt, b_rows, chunks, epi, stream);
}

// C = epilogue(A · B) with A read from bf16 planes [batch, slices, n, w]
// (ld.batch, ld.n; a loader over parts: `SplitLanes`, `SplitTaps`,
// `SplitHeadRows`) and B the packed Bᵀ of b_rows rows and b_chunks chunks;
// chunks · 64 = K (each part's chunks against the same B chunks). The tile
// shape by waves (of 128 columns or more for an epilogue that stages its
// output), both maps encoded for this launch.
template <class Loader, class Epilogue>
cudaError_t launch_planes(const bf16* planes, int slices, int w, const Loader& ld, const bf16* bt,
                          int b_rows, int b_chunks, int chunks, const Epilogue& epi,
                          cudaStream_t stream) {
  if (ld.batch <= 0 || ld.n <= 0 || chunks <= 0 || b_rows <= 0 || b_rows % kPad != 0 ||
      w % kKC != 0)
    return cudaErrorInvalidValue;
  const Shape s = choose(ld.batch, ld.n, b_rows, kStagesOut<Epilogue>);
  CUtensorMap map_a, map_b;
  cudaError_t err = rows_map(&map_a, planes, ld.batch, slices, ld.n, w, w, s.bm);
  if (err != cudaSuccess) return err;
  err = b_map(&map_b, bt, b_rows, b_chunks, s.bn);
  if (err != cudaSuccess) return err;
  return launch_at(s, map_a, map_b, ld, b_rows, chunks, epi, stream);
}

// `launch_normed` for f32 x against bf16 B (the mixed entries of K2, K2b and
// K3): the pre-pass writes the three parts of n(x) into `planes` [b, 3, n,
// dm padded to 64] (and splits the `tail` rows, K2b's context), then one
// GEMM over them, K = 3 · dm padded, the parts lo first (`SplitLanes` with
// one lane).
template <class Epilogue>
cudaError_t launch_normed_split(const float* x, const float* gamma, const float* beta,
                                bf16* planes, int b, int n, int dm, const bf16* bt, int b_rows,
                                const Epilogue& epi, cudaStream_t stream,
                                const SplitTail& tail = SplitTail{}) {
  const int dm_pad = round_up(dm, kPad), per_part = dm_pad / kKC;
  const cudaError_t err =
      norm_planes(x, gamma, beta, planes, b * n, n, dm, dm_pad, stream, tail);
  if (err != cudaSuccess) return err;
  return launch_planes(planes, 3, dm_pad, SplitLanes{b, n, dm_pad, 1, 3, 0, 0}, bt, b_rows,
                       per_part, 3 * per_part, epi, stream);
}

}  // namespace bgemm
}  // namespace ns2
