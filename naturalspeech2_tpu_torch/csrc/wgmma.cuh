// Hopper warpgroup matrix products (`wgmma`) on TF32 and bf16 operands, as
// K4 (flash_fwd.cu) and the GEMM core (gemm_tf32x3.cuh) use them: the
// K-major no-swizzle shared-memory layout and its descriptors, the fences,
// and the products m64n32k8 / m64n64k8 (TF32) with both operands in shared
// memory or A in registers, and K4's bf16 ones (f32 accumulation):
// m64n32k16 from shared memory, m64n64k16 with A in registers. The TF32
// semantics were pinned down on the card by a one-kernel probe
// (descriptors, register A, the accumulator layout) before K4 used them;
// the bf16 layout is the same in bytes (a core matrix is 8 rows of 16
// bytes, 8 bf16 where it was 4 floats), and its k-step twice as deep.
#pragma once

#include <stdint.h>

#include "flash.cuh"

namespace ns2 {

// ---- wgmma on K-major operands without swizzle ---------------------------
//
// A K-major operand tile of R rows by K k is stored in k-steps of 8 (8·R
// floats each); a k-step is two halves of 4 k, each R/8 core matrices of 8
// rows by 16 bytes, rows 16 bytes apart. The descriptor holds the k-step's
// address, the bytes between its two halves (LBO) and between 8-row groups
// (SBO): PTX ISA "Matrix Descriptor Format", CUTLASS's canonical
// INTERLEAVE K-major layout ((8,n),2):((1,SBO),LBO) in 16-byte units.
template <int R>
__device__ __forceinline__ int kmajor(int r, int k) {
  return (k / 8) * 8 * R + ((k % 8) / 4 * (R / 8) + r / 8) * 32 + (r % 8) * 4 + k % 4;
}

template <int R>
__device__ __forceinline__ uint64_t kmajor_desc_at(const void* kstep) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(kstep);
  constexpr uint32_t lbo = R / 8 * 128, sbo = 128;
  return (uint64_t)((a >> 4) & 0x3FFF) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(const float* tile, int ks) {
  return kmajor_desc_at<R>(tile + ks * 8 * R);
}

// The bf16 K-major layout: k-steps of 16 (16·R values, the same 32·R bytes
// as a TF32 k-step of 8), each two halves of 8 k, each R/8 core matrices of
// 8 rows by 16 bytes.
template <int R>
__device__ __forceinline__ int kmajor_bf16(int r, int k) {
  return (k / 16) * 16 * R + ((k % 16) / 8 * (R / 8) + r / 8) * 64 + (r % 8) * 8 + k % 8;
}

template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* tile, int ks) {
  return kmajor_desc_at<R>(tile + ks * 16 * R);
}

// Shared memory written by ordinary stores, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Pins registers that wgmma reads or writes at this point of the program,
// so that the compiler moves no access to them across the fence or the wait
// (it would otherwise wait for the products before each such access).
template <int N, class T>
__device__ __forceinline__ void pin(T (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" : "+r"(*reinterpret_cast<uint32_t*>(&r[j][i]))::"memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  wg_commit();
  wg_wait0();
}

// d[64 x 32] += A·Bᵀ over one k-step of 8, both operands K-major in shared
// memory. Each warp holds its 16 rows in mma.m16n8k8's accumulator layout:
// d[j][i] is row g + 8·(i / 2), column 8j + 2t + (i % 2).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, "
      "p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A·Bᵀ over one k-step of 8, both operands K-major in shared
// memory; the accumulator layout as wgmma_ss_n32's, j < 8.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A·B over one k-step of 8, A in registers (mma.m16n8k8's A
// layout on each warp's 16 rows), B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 32] += A·Bᵀ over one k-step of 16, bf16 operands K-major in shared
// memory, f32 accumulation; the accumulator layout as wgmma_ss_n32's.
__device__ __forceinline__ void wgmma_bf16_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, "
      "p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A·B over one k-step of 16, bf16 A in registers (mma.m16n8k16's
// A layout on each warp's 16 rows: a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t,
// 2t+1], a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9], the lower k in
// the low half), B K-major in shared memory, f32 accumulation. An
// accumulator's columns 16ks .. 16ks + 15 are, pair for pair, that layout
// (pack_bf16x2 of d[2ks][0, 1], d[2ks][2, 3], d[2ks+1][0, 1], d[2ks+1][2, 3]).
__device__ __forceinline__ void wgmma_bf16_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Split f32 values into K-major hi and lo tiles.
__device__ __forceinline__ void store_split4(float* hi, float* lo, int at, float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void store_split1(float* hi, float* lo, int at, float x) {
  uint32_t h, l;
  split_tf32(x, h, l);
  hi[at] = __uint_as_float(h);
  lo[at] = __uint_as_float(l);
}

}  // namespace ns2
