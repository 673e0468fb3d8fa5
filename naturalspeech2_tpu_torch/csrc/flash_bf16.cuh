// The pieces that K4's and K5's bf16 kernels (flash_fwd_bf16.cu,
// flash_bwd_bf16.cu) build on: tiles in shared memory in the 128-byte
// swizzled layout that `wgmma` reads, filled by `cp.async` 16-byte copies
// that complete on `mbarrier`s, their descriptors read K-major or MN-major
// (the transpose bit of 16-bit `wgmma`), the bf16 products, and named
// barriers.
//
// A panel is R rows of 64 bf16 (128 bytes), row r at byte 128·r, its
// 16-byte chunk c stored at chunk c ^ (r % 8) (the 128-byte swizzle: byte
// address bits 4-6 xor bits 7-9), the panel 1024-byte aligned. A [R, D]
// tile is D / 64 panels, R·128 bytes apart. One layout serves every
// operand: a row-major [rows, 64] panel is K-major when the product sums
// over its columns (Q, K in S = Q·Kᵀ) and MN-major when it sums over its
// rows (V in O = P·V, K in dQ = dS·K). Either way the descriptor holds the
// address, 1024 bytes between 8-row groups (SBO) and the swizzle mode; a
// product N = 64 wide never needs a second 64-column block, so the leading
// offset (LBO) is set to the same 1024 bytes, and whichever of the two
// strides the hardware takes for the 8-row step of an MN-major operand,
// the answer is the same. K-major: a k-step of 16 (32 bytes) starts 32
// bytes further into the panel; MN-major: a k-step of 16 rows starts 2048
// bytes further.
#pragma once

#include <stdint.h>

#include "wgmma.cuh"

namespace ns2 {
namespace sm90 {

constexpr uint32_t kPanelRowBytes = 128;
constexpr uint32_t kGroupBytes = 1024;  // 8 rows of a panel: one swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c (c < 8) of row r in a panel.
__device__ __forceinline__ uint32_t swizzled(uint32_t r, uint32_t c) {
  return r * kPanelRowBytes + ((c ^ (r & 7u)) << 4);
}

// The descriptor of a swizzled operand at shared address `addr`.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFFu) | (uint64_t)(kGroupBytes >> 4) << 16 |
         (uint64_t)(kGroupBytes >> 4) << 32 | 1ull << 62;
}

// Start copying rows row0 .. row0 + R - 1 of a [rows, D] bf16 matrix (rows
// ld elements apart) into a swizzled [R, D] tile at shared address `tile`;
// rows at or past `rows` become zeros. Run by the `nthreads` threads from
// `tid`; consecutive threads copy consecutive 16 bytes of a row.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src, int row0, int rows,
                                          int tid, int nthreads, int ld = D) {
  constexpr int kChunks = D / 8;
#pragma unroll 1  // rolled: the producer runs on few registers
  for (int e = tid; e < R * kChunks; e += nthreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < rows;
    const bf16* from = src + (size_t)(ok ? row0 + r : 0) * ld + 8 * c;
    const uint32_t to = tile + (uint32_t)(c / 8) * R * kPanelRowBytes + swizzled(r, c % 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to), "l"(from),
                 "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// src[i0 .. i0 + n - 1] (f32) into shared memory at dst, zeros at or past
// `count`: one 4-byte copy an element, by thread `tid` of `nthreads`.
__device__ __forceinline__ void load_row_f32(uint32_t dst, const float* src, int i0, int count,
                                             int n, int tid, int nthreads) {
  for (int e = tid; e < n; e += nthreads) {
    const bool ok = i0 + e < count;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + 4u * e),
                 "l"(src + (ok ? i0 + e : 0)), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

// ---- mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the other threads (and the
// async proxy); the caller then syncs the block once.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have
// landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Every cp.async of this thread landed (a producer before it exits).
__device__ __forceinline__ void cp_async_drain() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- registers between warpgroups ---------------------------------------
//
// A block of one producer warpgroup and C consumer warpgroups launches with
// 65,536 / (128·(C + 1)) registers a thread; the producer gives registers
// back and the consumers take them: with two consumers 168 → 40 and 232
// (128·128 = 256·64), with three 128 → 32 and 160 (128·96 = 384·32).
template <int kConsumerGroups>
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kConsumerGroups == 2 ? 40 : 32));
}

template <int kConsumerGroups>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerGroups == 2 ? 232 : 160));
}

// ---- named barriers (0 is __syncthreads') ------------------------------

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x in one special-function instruction (ex2.approx, subnormal results
// flushed to 0: a probability below 2^-126 of its row's largest).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- products ----------------------------------------------------------

// Pins registers that wgmma reads or writes at this point of the program
// (before its fence, after its wait), so that the compiler moves no access
// to them across either. Float accumulators are bound as "f": an "r" binding
// would make the compiler copy them into integer registers right after the
// product is issued, a read of the accumulator while it is in flight, which
// ptxas answers by serializing every wgmma of the kernel.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(r[j][i])::"memory");
}

// An accumulator of P 64-column panels.
template <int P>
__device__ __forceinline__ void pin(float (&r)[P][8][4]) {
#pragma unroll
  for (int p = 0; p < P; ++p) pin(r[p]);
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// Wait until at most n of this thread's committed wgmma groups are pending.
template <int n>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Columns 16ks .. 16ks + 15 of a 64-row accumulator (its tiles 2ks and
// 2ks + 1) rounded to bf16 as the register A operand of a k-step: a[0] =
// row g, columns 2t, 2t+1; a[1] = row g + 8; a[2], a[3] the same 8 columns
// on (mma.m16n8k16's A layout), the lower column in the low half.
__device__ __forceinline__ void pack_a(const float (&d0)[4], const float (&d1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16x2(d0[0], d0[1]);
  a[1] = pack_bf16x2(d0[2], d0[3]);
  a[2] = pack_bf16x2(d1[0], d1[1]);
  a[3] = pack_bf16x2(d1[2], d1[3]);
}

// d[64 x 32] (+)= A·Bᵀ over one k-step of 16: bf16 A and B in shared memory,
// both K-major (descriptors a, b), f32 accumulation; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 64] (+)= A·Bᵀ over one k-step of 16: bf16 A and B in shared memory,
// both K-major (descriptors a, b), f32 accumulation; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] (+)= A·Bᵀ over one k-step of 16: bf16 A and B in shared memory,
// both K-major (descriptors a, b), f32 accumulation; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 64] += A·B over one k-step of 16: bf16 A in registers (the layout
// of `pack_a`), bf16 B MN-major in shared memory (the transpose bit), f32
// accumulation.
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

}  // namespace sm90
}  // namespace ns2
