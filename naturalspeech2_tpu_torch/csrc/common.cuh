// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel runs its products on the tensor cores (flash.cuh, wgmma.cuh,
// flash_bf16.cuh, gemm_tf32x3.cuh): f32 operands in split TF32, bf16 operands in bf16 with
// f32 accumulation. Each host entry point is a
// plain C function (bound with ctypes): it takes device pointers, sizes and
// the caller's stream, launches without synchronising, and returns
// cudaGetLastError() so the Python wrapper can raise on a launch that was
// refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ns2 {

using bf16 = __nv_bfloat16;

// Threads a block of the elementwise kernels (K6's update).
constexpr int kThreads = 256;

// 1 / (1 + e^-x), the reciprocal correctly rounded (as 1.0f / (...) is, in
// one instruction where the division takes several).
__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + expf(-x)); }

// tanh-approximate GELU, the formula of jax.nn.gelu(approximate=True)
// and torch's F.gelu(approximate="tanh").
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// Element conversions of the kernels' two activation types: loads widen to
// f32, stores round to nearest even.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Two adjacent elements p[0], p[1] (p 4- or 8-byte aligned) from f32 values.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Two f32 values rounded to bf16 in one 32-bit register, a in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four f32 values from four consecutive bf16 in two 32-bit words.
__device__ __forceinline__ float4 unpack_bf16x4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// p[0..3], p aligned to four elements.
__device__ __forceinline__ float4 load4v(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace ns2

// Every kernel translation unit defines its entry points with C linkage.
#define NS2_API extern "C" __attribute__((visibility("default")))
