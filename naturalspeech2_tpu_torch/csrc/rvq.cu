// K6: residual vector quantization, its distances on the tensor cores in
// split TF32.
//
// Replaces the Pallas kernel `_rvq_kernel` (entry `rvq_quantize`) in
// naturalspeech2_tpu/ops/rvq.py. For each of the Q stages, in order:
//   d²[c] = −2·r·C[c] + ‖C[c]‖²   (‖r‖² is the same for every c: dropped)
//   idx   = the first c of minimal d²
//   r    −= C[idx],  total += C[idx]
// writing the quantized sum [m, d] and the codes [m, Q] (int32).
//
// What bounds it on the card: the distance products, 2·m·K·d·Q FLOP (5.0
// GFLOP at m 2400, K 1024, d 128, Q 8); the fastest f32-accurate way the
// H100 has is split TF32 on the tensor cores (three TF32 products per f32
// product, flash.cuh).
//
// Design: the TPU kernel keeps all codebooks in VMEM, runs the stages in one
// grid step per row block and gathers C[idx] as onehot·C on the matrix
// unit. Here each stage is two launches, the stages in order on the stream:
//  1. r · C_qᵀ on the split-TF32 GEMM core (gemm_tf32x3.cuh), A the
//     residual's rows (x at stage 0), B the stage's codebook packed once per
//     parameter version (ops/rvq.py), 64 codes a tile: at the training
//     shape 38 x 16 tiles, which fill the card. The `ArgMin` epilogue turns
//     each row's 64 products into d² and merges the row's first minimum into
//     a 64-bit word per row by atomicMin on (order-preserving d² bits, code),
//     which keeps the first minimal index across tiles as the JAX kernel's
//     argmin does;
//  2. rvq_update_kernel: one thread per element gathers C_q[idx], subtracts
//     it from the residual, adds it to the quantized sum and writes the code.
// The quantized sum is a sum of codebook rows in stage order, so it equals
// the plain version's bit for bit wherever the codes do; a code can differ
// only where two candidates' d² are within the products' rounding.
#include "gemm_tf32x3.cuh"

namespace {

namespace gemm = ns2::gemm;

// grid ceil(m·d / 256), 256 threads. r_in is x at stage 0 and the residual
// after (updated in place, so r_in and r_out may alias, as total_in and
// total do); total_in is null at stage 0.
__global__ void __launch_bounds__(ns2::kThreads)
rvq_update_kernel(const float* r_in, float* r_out, const float* total_in, float* total,
                  const float* __restrict__ cbq, const unsigned long long* __restrict__ best,
                  int* __restrict__ codes, int m, int d, int num_q, int qi) {
  const size_t e = (size_t)blockIdx.x * ns2::kThreads + threadIdx.x;
  if (e >= (size_t)m * d) return;
  const int row = (int)(e / d), col = (int)(e % d);
  const int idx = (int)(uint32_t)(best[row] & 0xffffffffull);
  const float c = cbq[(size_t)idx * d + col];
  r_out[e] = r_in[e] - c;
  total[e] = (total_in ? total_in[e] : 0.0f) + c;
  if (col == 0) codes[(size_t)row * num_q + qi] = idx;
}

}  // namespace

// x [m, d], cb [Q, K, d] and its packed form cb_packed (ops/gemm_cache.py
// pack_b of each C_q, Q blocks of ceil(K / 64) · ceil(d / 32) · 4096
// floats), norms [Q, K] (Σ_d C²) -> quantized [m, d], codes [m, Q] int32.
// residual [m, d] f32 and best [Q, m] (all ones on entry) are scratch. Any
// d ≥ 1 and K ≥ 1. 2·Q launches.
NS2_API int ns2_rvq(const float* x, const float* cb, const float* cb_packed, const float* norms,
                    unsigned long long* best, float* residual, float* quantized, int* codes,
                    int m, int d, int num_q, int size, void* stream) {
  if (d <= 0 || m <= 0 || size <= 0 || num_q <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (d + gemm::kKC - 1) / gemm::kKC;
  const int n_tiles = (size + gemm::kBN - 1) / gemm::kBN;
  const size_t packed_stage = (size_t)n_tiles * chunks * 2 * gemm::kTile;
  const unsigned update_blocks = (unsigned)(((size_t)m * d + ns2::kThreads - 1) / ns2::kThreads);
  for (int qi = 0; qi < num_q; ++qi) {
    const float* r = qi == 0 ? x : residual;
    cudaError_t err = gemm::launch(
        gemm::Rows<float>{r, m, d}, cb_packed + qi * packed_stage, m, chunks, n_tiles,
        gemm::ArgMin{norms + (size_t)qi * size, best + (size_t)qi * m, m, size}, st);
    if (err != cudaSuccess) return err;
    rvq_update_kernel<<<update_blocks, ns2::kThreads, 0, st>>>(
        r, residual, qi == 0 ? nullptr : quantized, quantized, cb + (size_t)qi * size * d,
        best + (size_t)qi * m, codes, m, d, num_q, qi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
