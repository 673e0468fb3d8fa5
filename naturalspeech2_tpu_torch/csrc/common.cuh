// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel runs its products in split TF32 on the tensor cores
// (flash.cuh, wgmma.cuh, gemm_tf32x3.cuh). Each host entry point is a
// plain C function (bound with ctypes): it takes device pointers, sizes and
// the caller's stream, launches without synchronising, and returns
// cudaGetLastError() so the Python wrapper can raise on a launch that was
// refused.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ns2 {

// Threads a block of the elementwise kernels (K6's update).
constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// tanh-approximate GELU, the formula of jax.nn.gelu(approximate=True)
// and torch's F.gelu(approximate="tanh").
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

}  // namespace ns2

// Every kernel translation unit defines its entry points with C linkage.
#define NS2_API extern "C" __attribute__((visibility("default")))
