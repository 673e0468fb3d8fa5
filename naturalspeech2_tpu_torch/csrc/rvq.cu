// K6: residual vector quantization, its distances on the tensor cores: in
// split TF32 (f32), or on the bf16 GEMM core (bf16).
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
// product, flash.cuh); on bf16 codebooks three bf16 products per f32 one
// (the residual's planes, below), at twice TF32's rate.
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
// bf16. Here the distances run on the bf16 GEMM core (gemm_bf16.cuh: TMA
// copies into a 4-stage ring, bf16 `wgmma`, tiles by waves), each stage's
// codebook packed once per parameter version in "bf16_sw128" (exact). The
// first stage multiplies x itself, one bf16 pass (`Rows`; copied first into
// the planes' scratch at a row TMA takes where d % 8 != 0); from the second
// on the f32 residual is carried as its three bf16 planes, hi + mid + lo =
// r exactly (`split3`), and each plane times a bf16 code is exact in f32:
// three passes against the same B (`SplitLanes` with one lane, three
// parts), lo first. The `bgemm::ArgMin` epilogue merges each row's first
// minimum as above. The update kernel, a programmatic dependent of the
// stage's GEMM, gathers C_q[idx], keeps the residual and the sum in f32
// (the sum in a scratch of its own), writes the residual's planes for the
// next stage and the code, and at the last stage rounds the sum to bf16
// once. 2·Q launches (2·Q + 1 with the copy).
#include "gemm_bf16.cuh"
#include "gemm_tf32x3.cuh"

namespace {

namespace gemm = ns2::gemm;
namespace bgemm = ns2::bgemm;
using ns2::bf16;

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

// The f32 path on the split-TF32 core (three TF32 passes): total is the
// output.
int rvq_f32(const float* x, const float* cb, const float* cb_packed, const float* norms,
            unsigned long long* best, float* residual, float* total, int* codes, int m, int d,
            int num_q, int size, cudaStream_t st) {
  const int chunks = (d + gemm::kKC - 1) / gemm::kKC;
  const int n_tiles = (size + gemm::kBN - 1) / gemm::kBN;
  const size_t packed_stage = (size_t)n_tiles * chunks * gemm::kBParts * gemm::kTile;
  const unsigned update_blocks = (unsigned)(((size_t)m * d + ns2::kThreads - 1) / ns2::kThreads);
  for (int qi = 0; qi < num_q; ++qi) {
    const gemm::ArgMin argmin{norms + (size_t)qi * size, best + (size_t)qi * m, m, size};
    const float* r = qi == 0 ? x : residual;
    cudaError_t err = gemm::launch(gemm::Rows{r, m, d}, cb_packed + qi * packed_stage, m,
                                   chunks, n_tiles, argmin, st);
    if (err != cudaSuccess) return err;
    rvq_update_kernel<<<update_blocks, ns2::kThreads, 0, st>>>(
        r, residual, qi == 0 ? nullptr : total, total, cb + (size_t)qi * size * d,
        best + (size_t)qi * m, codes, m, d, num_q, qi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Stage qi's update on the bf16 path, one thread per element, a
// programmatic dependent of the stage's GEMM (it waits for that GEMM's
// codes before it reads them): c = C_q[idx], r = x − c at stage 0, else
// residual − c, and sum = c, else total + c, in f32. At the last stage the
// sum goes to out rounded to bf16; before it r to residual, its planes
// (`split3`: hi, mid, lo) to planes [3, m, ld] and the sum to total.
__global__ void __launch_bounds__(ns2::kThreads)
rvq_update_bf16_kernel(const bf16* __restrict__ x, float* residual, float* total,
                       bf16* __restrict__ planes, int ld, bf16* __restrict__ out,
                       const bf16* __restrict__ cbq, const unsigned long long* __restrict__ best,
                       int* __restrict__ codes, int m, int d, int num_q, int qi) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // the next stage's GEMM may start its blocks (its copies wait for this grid)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const size_t e = (size_t)blockIdx.x * ns2::kThreads + threadIdx.x;
  if (e >= (size_t)m * d) return;
  const int row = (int)(e / d), col = (int)(e % d);
  const int idx = (int)(uint32_t)(best[row] & 0xffffffffull);
  const float c = ns2::to_f32(cbq[(size_t)idx * d + col]);
  const float r = (qi == 0 ? ns2::to_f32(x[e]) : residual[e]) - c;
  const float sum = (qi == 0 ? 0.0f : total[e]) + c;
  if (qi == num_q - 1) {
    out[e] = ns2::from_f32<bf16>(sum);
  } else {
    residual[e] = r;
    total[e] = sum;
    float p[3];
    bgemm::split3(r, p);
    const size_t at = (size_t)row * ld + col, plane = (size_t)m * ld;
#pragma unroll
    for (int q = 0; q < 3; ++q) planes[q * plane + at] = ns2::from_f32<bf16>(p[q]);
  }
  if (col == 0) codes[(size_t)row * num_q + qi] = idx;
}

// The bf16 path on the bf16 core (see the top of this file): cb_packed the
// Q codebooks packed "bf16_sw128", [Q, ld / 64, K padded to 64, 64] with ld
// = d padded to 64; planes [3, m, ld] bf16 scratch.
int rvq_bf16(const bf16* x, const bf16* cb, const bf16* cb_packed, const float* norms,
             unsigned long long* best, float* residual, float* total, bf16* planes,
             bf16* quantized, int* codes, int m, int d, int num_q, int size, cudaStream_t st) {
  const int ld = bgemm::round_up(d, bgemm::kPad), per_stage = ld / bgemm::kKC;
  const int b_rows = bgemm::round_up(size, bgemm::kPad);
  const bgemm::Shape sh = bgemm::choose(1, m, b_rows);
  // x as TMA reads it: its own rows where they are 16-byte aligned, else a
  // copy in the planes' first plane (written over by the first update)
  const bool direct = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaSuccess;
  if (!direct) err = bgemm::copy_rows(x, planes, m, d, ld, st);
  CUtensorMap map_x, map_planes, map_b;
  if (err == cudaSuccess)
    err = bgemm::rows_map(&map_x, direct ? x : planes, 1, 1, m, d, direct ? d : ld, sh.bm);
  if (err == cudaSuccess) err = bgemm::rows_map(&map_planes, planes, 1, 3, m, d, ld, sh.bm);
  if (err == cudaSuccess) err = bgemm::b_map(&map_b, cb_packed, b_rows, num_q * per_stage, sh.bn);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((size_t)m * d + ns2::kThreads - 1) / ns2::kThreads));
  cfg.blockDim = dim3(ns2::kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int qi = 0; qi < num_q && err == cudaSuccess; ++qi) {
    const bgemm::ArgMin argmin{norms + (size_t)qi * size, best + (size_t)qi * m, size};
    err = qi == 0 ? bgemm::launch_at(sh, map_x, map_b,
                                     bgemm::Rows{direct ? x : planes, 1, m, direct ? d : ld, d},
                                     b_rows, per_stage, argmin, st)
                  : bgemm::launch_at(sh, map_planes, map_b,
                                     bgemm::SplitLanes{1, m, ld, 1, 3, 0, qi * per_stage}, b_rows,
                                     3 * per_stage, argmin, st);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, rvq_update_bf16_kernel, x, residual, total, planes, ld,
                               quantized, cb + (size_t)qi * size * d, best + (size_t)qi * m,
                               codes, m, d, num_q, qi);
  }
  return err;
}

bool rvq_ok(int m, int d, int num_q, int size) {
  return d > 0 && m > 0 && size > 0 && num_q > 0;
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
  if (!rvq_ok(m, d, num_q, size)) return cudaErrorInvalidValue;
  return rvq_f32(x, cb, cb_packed, norms, best, residual, quantized, codes, m, d, num_q, size,
                 static_cast<cudaStream_t>(stream));
}

// The same with x, cb and quantized in bf16 on the bf16 core: cb_packed
// the bf16 codebooks packed "bf16_sw128" (ops/rvq.py pack_codebooks: Q ·
// ceil(d / 64) chunks of [ceil(K / 64) · 64, 64]), norms their f32 squared
// norms; residual and total [m, d] f32 scratch (the sum rounded once into
// quantized), planes [3, m, ceil(d / 64) · 64] bf16 scratch (ops/rvq.py
// scratch). 2·Q launches, 2·Q + 1 where x's rows need a copy for TMA (d %
// 8 != 0 or x not 16-byte aligned).
NS2_API int ns2_rvq_bf16(const bf16* x, const bf16* cb, const bf16* cb_packed, const float* norms,
                         unsigned long long* best, float* residual, float* total, bf16* planes,
                         bf16* quantized, int* codes, int m, int d, int num_q, int size,
                         void* stream) {
  if (!rvq_ok(m, d, num_q, size)) return cudaErrorInvalidValue;
  return rvq_bf16(x, cb, cb_packed, norms, best, residual, total, planes, quantized, codes, m, d,
                  num_q, size, static_cast<cudaStream_t>(stream));
}
