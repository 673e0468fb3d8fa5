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
//
// bf16 (`ns2_rvq_bf16`: x and the codebooks bf16, AMP training's codec):
// the TPU kernel upcasts x and its dots promote the bf16 codebooks, so the
// function is the f32 one on the bf16 values, `quantized` cast back to
// bf16. Here the first stage's rows are read as bf16 and widened, the
// codebooks are packed as TF32 with no lo part (exact) and the distances run
// in the core's two-pass kSplit2 mode (the f32 residual split into hi and
// lo); the residual and the sum stay f32 (the sum in a scratch of its own),
// and the last stage rounds the sum to bf16 once.
#include "gemm_tf32x3.cuh"

namespace {

namespace gemm = ns2::gemm;

// grid ceil(m·d / 256), 256 threads. r_in is x at stage 0 and the residual
// after (updated in place, so r_in and r_out may alias, as total_in and
// total do); total_in is null at stage 0. R: r_in's type (x's at stage 0,
// f32 after); C: the codebooks'. out, if not null, takes the sum rounded to
// its type (bf16 at the last stage).
template <class R, class C>
__global__ void __launch_bounds__(ns2::kThreads)
rvq_update_kernel(const R* r_in, float* r_out, const float* total_in, float* total,
                  ns2::bf16* out, const C* __restrict__ cbq,
                  const unsigned long long* __restrict__ best, int* __restrict__ codes, int m,
                  int d, int num_q, int qi) {
  const size_t e = (size_t)blockIdx.x * ns2::kThreads + threadIdx.x;
  if (e >= (size_t)m * d) return;
  const int row = (int)(e / d), col = (int)(e % d);
  const int idx = (int)(uint32_t)(best[row] & 0xffffffffull);
  const float c = ns2::to_f32(cbq[(size_t)idx * d + col]);
  r_out[e] = ns2::to_f32(r_in[e]) - c;
  const float sum = (total_in ? total_in[e] : 0.0f) + c;
  total[e] = sum;
  if (out) out[e] = ns2::from_f32<ns2::bf16>(sum);
  if (col == 0) codes[(size_t)row * num_q + qi] = idx;
}

// T: the type of x and the codebooks (f32: cb_packed split, three passes,
// total the output; bf16: cb_packed TF32, two passes, total an f32 scratch
// and out the bf16 output).
template <class T>
int rvq(const T* x, const T* cb, const float* cb_packed, const float* norms,
        unsigned long long* best, float* residual, float* total, ns2::bf16* out, int* codes,
        int m, int d, int num_q, int size, void* stream) {
  constexpr gemm::Mode M = sizeof(T) == 4 ? gemm::Mode::kSplit3 : gemm::Mode::kSplit2;
  if (d <= 0 || m <= 0 || size <= 0 || num_q <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (d + gemm::kKC - 1) / gemm::kKC;
  const int n_tiles = (size + gemm::kBN - 1) / gemm::kBN;
  const size_t packed_stage = (size_t)n_tiles * chunks * gemm::Fmt<M>::kB * gemm::kTile;
  const unsigned update_blocks = (unsigned)(((size_t)m * d + ns2::kThreads - 1) / ns2::kThreads);
  for (int qi = 0; qi < num_q; ++qi) {
    const gemm::ArgMin argmin{norms + (size_t)qi * size, best + (size_t)qi * m, m, size};
    const float* cbp = cb_packed + qi * packed_stage;
    cudaError_t err = qi == 0 ? gemm::launch<M>(gemm::Rows<T>{x, m, d}, cbp, m, chunks, n_tiles,
                                                argmin, st)
                              : gemm::launch<M>(gemm::Rows<float>{residual, m, d}, cbp, m, chunks,
                                                n_tiles, argmin, st);
    if (err != cudaSuccess) return err;
    ns2::bf16* last = qi == num_q - 1 ? out : nullptr;
    const T* cbq = cb + (size_t)qi * size * d;
    const float* prev = qi == 0 ? nullptr : total;
    if (qi == 0)
      rvq_update_kernel<<<update_blocks, ns2::kThreads, 0, st>>>(
          x, residual, prev, total, last, cbq, best + (size_t)qi * m, codes, m, d, num_q, qi);
    else
      rvq_update_kernel<<<update_blocks, ns2::kThreads, 0, st>>>(
          (const float*)residual, residual, prev, total, last, cbq, best + (size_t)qi * m, codes,
          m, d, num_q, qi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  return rvq(x, cb, cb_packed, norms, best, residual, quantized, nullptr, codes, m, d, num_q,
             size, stream);
}

// The same with x, cb and quantized in bf16: cb_packed holds the bf16
// codebooks as TF32 with no lo part (ceil(K / 64) · ceil(d / 32) · 2048
// floats a stage), norms their f32 squared norms; total [m, d] is f32
// scratch for the sum, rounded once into quantized.
NS2_API int ns2_rvq_bf16(const ns2::bf16* x, const ns2::bf16* cb, const float* cb_packed,
                         const float* norms, unsigned long long* best, float* residual,
                         float* total, ns2::bf16* quantized, int* codes, int m, int d, int num_q,
                         int size, void* stream) {
  return rvq(x, cb, cb_packed, norms, best, residual, total, quantized, codes, m, d, num_q, size,
             stream);
}
