// K6: residual vector quantization.
//
// Replaces the Pallas kernel `_rvq_kernel` (entry `rvq_quantize`) in
// naturalspeech2_tpu/ops/rvq.py. For each of the Q stages, in order:
//   d²[c] = −2·r·C[c] + ‖C[c]‖²   (‖r‖² is the same for every c: dropped)
//   idx   = the first c of minimal d²
//   r    −= C[idx],  total += C[idx]
// writing the quantized sum [m, d] and the codes [m, Q] (int32).
//
// What bounds it on the card: the distance products, 2·m·K·d·Q f32
// multiply-adds (5.0 GFLOP at m 2400, K 1024, d 128, Q 8), fed from shared
// memory; the codebooks (4 MiB) are read once per row block and stay in L2.
//
// Design: the TPU kernel keeps all codebooks in VMEM and gathers C[idx] as
// onehot·C on the matrix unit. A Hopper block cannot hold 4 MiB, so each
// block owns 32 rows and streams each stage's codebook through shared
// memory in tiles of 64 codes and 128 dims: the distance products run over
// the codebook dim in chunks of 128 (any d, a multiple of 128: the wrapper
// pads with zero columns, which change no distance), with the rows'
// residual chunk staged beside the code chunk, once per stage when d is
// 128. A running (min, first index) per row stays in registers; ties keep
// the lower index, within a thread by a strict < over ascending codes and
// across the 16 threads of a row by the index. The residual and the
// quantized sum live in device memory ([m, d] each; the block's rows are
// its own), updated after each stage with C[idx] gathered from device
// memory. The stages stay sequential inside the block.
#include "common.cuh"

namespace {

constexpr int RM = 32;   // rows per block
constexpr int RK = 64;   // codes per tile
constexpr int RC = 128;  // codebook dims per chunk

struct RvqSmem {
  float r[RM][RC + 1];  // the rows' residual chunk, padded
  float c[RK][RC + 1];  // codebook tile chunk, padded
  float cn[RK];         // the tile's squared norms
  int idx[RM];          // this stage's codes
};

// grid ceil(m / RM), 256 threads; dynamic shared memory sizeof(RvqSmem).
// residual and quantized are [m, d] (the residual starts as x).
__global__ void __launch_bounds__(ns2::kThreads)
rvq_kernel(const float* __restrict__ x, const float* __restrict__ cb,
           const float* __restrict__ norms, float* __restrict__ residual,
           float* __restrict__ quantized, int* __restrict__ codes, int m, int d, int num_q,
           int size) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RvqSmem& sm = *reinterpret_cast<RvqSmem*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int m0 = blockIdx.x * RM;
  const int rows = min(RM, m - m0);
  float* res = residual + (size_t)m0 * d;
  float* total = quantized + (size_t)m0 * d;

  for (int e = tid; e < rows * d; e += ns2::kThreads) {
    res[e] = x[(size_t)m0 * d + e];
    total[e] = 0.0f;
  }

  for (int qi = 0; qi < num_q; ++qi) {
    const float* cbq = cb + (size_t)qi * size * d;
    float best[2] = {INFINITY, INFINITY};
    int best_idx[2] = {0, 0};
    for (int k0 = 0; k0 < size; k0 += RK) {
      float acc[2][4] = {};
      for (int c0 = 0; c0 < d; c0 += RC) {
        __syncthreads();  // the previous chunk (or tile, or stage update) is done
        if (d > RC || k0 == 0)
          for (int e = tid; e < RM * RC; e += ns2::kThreads) {
            const int r = e / RC, c = e % RC;
            sm.r[r][c] = r < rows ? res[(size_t)r * d + c0 + c] : 0.0f;
          }
        for (int e = tid; e < RK * RC; e += ns2::kThreads) {
          const int r = e / RC, c = e % RC;
          sm.c[r][c] = (k0 + r < size) ? cbq[(size_t)(k0 + r) * d + c0 + c] : 0.0f;
        }
        if (c0 == 0 && tid < RK)
          sm.cn[tid] = (k0 + tid < size) ? norms[(size_t)qi * size + k0 + tid] : 0.0f;
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < RC; ++c) {
          const float a0 = sm.r[ty][c], a1 = sm.r[ty + 16][c];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float b = sm.c[tx + 16 * j][c];
            acc[0][j] += a0 * b;
            acc[1][j] += a1 * b;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // ascending codes: strict < keeps the first
        const int code = k0 + tx + 16 * j;
        if (code >= size) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d2 = -2.0f * acc[i][j] + sm.cn[tx + 16 * j];
          if (d2 < best[i]) {
            best[i] = d2;
            best_idx[i] = code;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_idx[i], off);
        if (ov < best[i] || (ov == best[i] && oi < best_idx[i])) {
          best[i] = ov;
          best_idx[i] = oi;
        }
      }
      if (tx == 0) {
        const int row = ty + 16 * i;
        sm.idx[row] = best_idx[i];
        if (row < rows) codes[(size_t)(m0 + row) * num_q + qi] = best_idx[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * d; e += ns2::kThreads) {
      const float q = cbq[(size_t)sm.idx[e / d] * d + e % d];
      res[e] -= q;
      total[e] += q;
    }
    // the block's own writes to res are visible to it after the next barrier
  }
}

}  // namespace

// x [m, d], cb [Q, K, d], norms [Q, K] (Σ_d C², computed by the wrapper) ->
// quantized [m, d], codes [m, Q] int32; residual is [m, d] f32 scratch.
// Takes d % 128 == 0 (the wrapper pads; other widths return
// cudaErrorInvalidValue).
NS2_API int ns2_rvq(const float* x, const float* cb, const float* norms, float* residual,
                    float* quantized, int* codes, int m, int d, int num_q, int size,
                    void* stream) {
  if (d <= 0 || d % RC != 0 || m <= 0 || size <= 0) return cudaErrorInvalidValue;
  const int bytes = (int)sizeof(RvqSmem);
  cudaError_t err =
      cudaFuncSetAttribute(rvq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  rvq_kernel<<<(m + RM - 1) / RM, ns2::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, cb, norms, residual, quantized, codes, m, d, num_q, size);
  return cudaGetLastError();
}
