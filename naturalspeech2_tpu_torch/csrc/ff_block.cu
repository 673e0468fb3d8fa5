// K3: the fused pre-norm feed-forward block of the denoiser transformer.
//
// Replaces the Pallas kernel `_ff_block_kernel` (entry `fused_ff_block`)
// in naturalspeech2_tpu/ops/ff_block_kernel.py:
//   y = x + W₂ · conv₃(gelu_tanh(n(x)·W_g + b_g) ∘ (n(x)·W_v + b_v)) + b₂
// with n(x) the adaptive RMSNorm and conv₃ the causal k=3 conv
// a_{t-2}·Wc₀ + a_{t-1}·Wc₁ + a_t·Wc₂ + b_c.
//
// What bounds it on the card: f32 multiply-adds and the shared-memory
// loads that feed them. At the flagship shape (b4 n1024 dm128, inner 341
// padded to 352) the block is about 4.5 GFLOP, three quarters of it in the
// inner x inner conv, against 1.6 MB of weights (read by every block, from
// L2) and 4 MB of activations; it runs near 10 TFLOP/s of the 67 (H100
// SXM, 700 W).
//
// Design: the TPU kernel keeps a whole sequence's [n, inner] activations
// in VMEM. Here one block owns 30 output rows of one batch element and
// recomputes the gated activation for its 2-row causal halo, so no
// intermediate leaves shared memory and no block waits on another. The
// gated activation a [32 rows, inner] and the conv output c share the
// block's ~105 KB of shared memory (two blocks fit on an SM); the
// weights stream through an 8-row staging buffer. The wrapper pads
// inner with exact zeros to a multiple of 16, which changes no sum.
//
// Wide shapes (the scaled config's dm 512, inner 1365 padded to 1408):
// the fused tiling would need ~370 KB of shared memory, so the block is
// split at the causal conv into three launches of 64 x 64 tiles (tile.cuh)
// through two f32 [b, n, inner] scratches in device memory:
//   1. ff_geglu_kernel: a = gelu_tanh(n(x)·W_g + b_g) ∘ (n(x)·W_v + b_v),
//      the norm in the prologue, both products in one block;
//   2. ff_tap_kernel, 3 taps: c_t = a_{t-2}·Wc₀ + a_{t-1}·Wc₁ + a_t·Wc₂ + b_c;
//   3. ff_tap_kernel, 1 tap: y = x + c·W₂ + b₂.
// The weights (Wc is 23 MB at inner 1408) are not held on chip: every
// 64-row tile streams its 64-column slice of them through shared memory,
// from L2. With the row tiles of one batch row first in the grid, a wave
// of blocks shares one pass over the weights. The wrapper pads inner to a
// multiple of 64 with exact zeros. Bound as the fused kernel is: about
// 16 TFLOP/s at b16 n1024 dm512 (252 GFLOP; H100 SXM, 700 W).
#include "tile.cuh"

namespace {

constexpr int TT = 30;      // output rows per block
constexpr int R = TT + 2;   // activation rows per block, including the halo
constexpr int KC = 8;       // weight rows per staging step

template <int DM, int IP>
struct FFSmem {
  float a[IP][R + 2];        // gated activation, transposed; rows R, R+1 stay zero
  union {
    float xn[DM][R + 1];     // normalised input, transposed (steps 1-2)
    float c[IP][R + 1];      // conv output, transposed (steps 3-4)
  } u;
  float stage[KC][IP > DM ? IP : DM];
  float part[R][8];
  float rnorm[R];
};

// acc[i][j] += Σ_k A[k][ty + 16i + off] · W[k][tx + 16j] over k in [0, K),
// with A in shared memory (row stride lda) and W [K, ncols] in device
// memory, streamed through `stage`.
template <int NJ, int LDA>
__device__ __forceinline__ void block_gemm(float (&acc)[2][NJ], const float* A, int off,
                                           const float* __restrict__ W, int K, float* stage) {
  constexpr int ncols = NJ * ns2::kGrid;
  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // previous step is done with `stage`
    for (int e = tid; e < KC * ncols; e += ns2::kThreads)
      stage[e] = W[(size_t)k0 * ncols + e];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float* arow = A + (size_t)(k0 + kk) * LDA + off;
      const float a0 = arow[ty], a1 = arow[ty + 16];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w = stage[kk * ncols + tx + 16 * j];
        acc[0][j] += a0 * w;
        acc[1][j] += a1 * w;
      }
    }
  }
}

// grid (ceil(n/TT), b); dynamic shared memory sizeof(FFSmem<DM, IP>)
template <int DM, int IP>
__global__ void __launch_bounds__(ns2::kThreads)
ff_block_kernel(const float* __restrict__ x,       // [b, n, DM]
                const float* __restrict__ gamma,   // [b, DM]
                const float* __restrict__ beta,    // [b, DM]
                const float* __restrict__ w_val,   // [DM, IP]
                const float* __restrict__ b_val,   // [IP]
                const float* __restrict__ w_gate,  // [DM, IP]
                const float* __restrict__ b_gate,  // [IP]
                const float* __restrict__ wc,      // [3, IP, IP]
                const float* __restrict__ bc,      // [IP]
                const float* __restrict__ w2,      // [IP, DM]
                const float* __restrict__ b2,      // [DM]
                float* __restrict__ out,           // [b, n, DM]
                int n) {
  static_assert(IP % ns2::kGrid == 0 && DM % ns2::kGrid == 0, "tile shape");
  constexpr int JI = IP / ns2::kGrid;
  constexpr int JD = DM / ns2::kGrid;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FFSmem<DM, IP>& sm = *reinterpret_cast<FFSmem<DM, IP>*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tbase = t0 - 2;  // time of activation row 0
  const float* xb = x + (size_t)bi * n * DM;

  // 1. adaptive RMSNorm of rows tbase .. tbase+R-1 (8 threads per row)
  {
    const int r = tid / 8, q = tid % 8, t = tbase + r;
    float ss = 0.0f;
    if (t >= 0 && t < n)
      for (int k = q; k < DM; k += 8) {
        const float v = xb[(size_t)t * DM + k];
        ss += v * v;
      }
    sm.part[r][q] = ss;
  }
  __syncthreads();
  if (tid < R) {
    float ss = 0.0f;
    for (int q = 0; q < 8; ++q) ss += sm.part[tid][q];
    sm.rnorm[tid] = fmaxf(sqrtf(ss), 1e-12f);
  }
  __syncthreads();
  const float sqrt_dm = sqrtf((float)DM);
  for (int e = tid; e < R * DM; e += ns2::kThreads) {
    const int r = e / DM, k = e % DM, t = tbase + r;
    sm.u.xn[k][r] = (t >= 0 && t < n)
                        ? xb[(size_t)t * DM + k] / sm.rnorm[r] * sqrt_dm * gamma[bi * DM + k] +
                              beta[bi * DM + k]
                        : 0.0f;
  }
  for (int e = tid; e < IP * 2; e += ns2::kThreads) sm.a[e / 2][R + e % 2] = 0.0f;

  // 2. a = gelu_tanh(n(x)·W_g + b_g) · (n(x)·W_v + b_v); zero before t = 0
  {
    float acc[2][JI] = {};
    block_gemm<JI, R + 1>(acc, &sm.u.xn[0][0], 0, w_val, DM, &sm.stage[0][0]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < JI; ++j) sm.a[tx + 16 * j][ty + 16 * i] = acc[i][j] + b_val[tx + 16 * j];
  }
  {
    float acc[2][JI] = {};
    block_gemm<JI, R + 1>(acc, &sm.u.xn[0][0], 0, w_gate, DM, &sm.stage[0][0]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool before_start = tbase + ty + 16 * i < 0;
#pragma unroll
      for (int j = 0; j < JI; ++j) {
        float& a = sm.a[tx + 16 * j][ty + 16 * i];
        a = before_start ? 0.0f : ns2::gelu_tanh(acc[i][j] + b_gate[tx + 16 * j]) * a;
      }
    }
  }

  // 3. c_t = a_{t-2}·Wc₀ + a_{t-1}·Wc₁ + a_t·Wc₂ + b_c, for output row
  //    t = t0 + r, which reads activation rows r, r+1 and r+2
  {
    float acc[2][JI] = {};
    for (int tap = 0; tap < 3; ++tap)
      block_gemm<JI, R + 2>(acc, &sm.a[0][0], tap, wc + (size_t)tap * IP * IP, IP,
                            &sm.stage[0][0]);
    // c overwrites xn: the barriers inside step 3 follow its last read
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < JI; ++j) sm.u.c[tx + 16 * j][ty + 16 * i] = acc[i][j] + bc[tx + 16 * j];
  }

  // 4. y = x + c·W₂ + b₂ for the TT valid rows
  {
    float acc[2][JD] = {};
    block_gemm<JD, R + 1>(acc, &sm.u.c[0][0], 0, w2, IP, &sm.stage[0][0]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty + 16 * i, t = t0 + r;
      if (r >= TT || t >= n) continue;
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int c = tx + 16 * j;
        const size_t idx = ((size_t)bi * n + t) * DM + c;
        out[idx] = x[idx] + acc[i][j] + b2[c];
      }
    }
  }
}

// ---- wide shapes: three launches of 64 x 64 tiles ---------------------

// a[b, n, ip] = gelu_tanh(n(x)·W_g + b_g) ∘ (n(x)·W_v + b_v):
// grid (ceil(n/TM), ip/TN, b)
__global__ void __launch_bounds__(ns2::kThreads)
ff_geglu_kernel(const float* __restrict__ x,       // [b, n, dm]
                const float* __restrict__ gamma,   // [b, dm]
                const float* __restrict__ beta,    // [b, dm]
                const float* __restrict__ w_val,   // [dm, ip]
                const float* __restrict__ b_val,   // [ip]
                const float* __restrict__ w_gate,  // [dm, ip]
                const float* __restrict__ b_gate,  // [ip]
                float* __restrict__ a,             // [b, n, ip]
                int n, int dm, int ip) {
  __shared__ float As[ns2::KC][ns2::TM];
  __shared__ float Vs[ns2::KC][ns2::TN];
  __shared__ float Gs[ns2::KC][ns2::TN];
  __shared__ float part[ns2::TM][4];
  __shared__ float rnorm[ns2::TM];

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int t0 = blockIdx.x * ns2::TM, n0 = blockIdx.y * ns2::TN, bi = blockIdx.z;
  const float* xb = x + (size_t)bi * n * dm;
  const float* g = gamma + (size_t)bi * dm;
  const float* be = beta + (size_t)bi * dm;

  {  // row norms: 4 threads per row
    const int r = tid / 4, q = tid % 4, t = t0 + r;
    float ss = 0.0f;
    if (t < n)
      for (int k = q; k < dm; k += 4) {
        const float v = xb[(size_t)t * dm + k];
        ss += v * v;
      }
    part[r][q] = ss;
  }
  __syncthreads();
  if (tid < ns2::TM)
    rnorm[tid] = fmaxf(sqrtf(part[tid][0] + part[tid][1] + part[tid][2] + part[tid][3]), 1e-12f);
  __syncthreads();

  const float sqrt_dm = sqrtf((float)dm);
  float accv[4][4] = {}, accg[4][4] = {};
  for (int k0 = 0; k0 < dm; k0 += ns2::KC) {
    for (int e = tid; e < ns2::TM * ns2::KC; e += ns2::kThreads) {
      const int r = e / ns2::KC, kk = e % ns2::KC, t = t0 + r, k = k0 + kk;
      As[kk][r] = (t < n) ? xb[(size_t)t * dm + k] / rnorm[r] * sqrt_dm * g[k] + be[k] : 0.0f;
    }
    ns2::stage_cols(w_val, ip, k0, n0, Vs);
    ns2::stage_cols(w_gate, ip, k0, n0, Gs);
    __syncthreads();
    ns2::fma_chunk(accv, As, Vs);
    ns2::fma_chunk(accg, As, Gs);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      a[((size_t)bi * n + t) * ip + c] =
          ns2::gelu_tanh(accg[i][j] + b_gate[c]) * (accv[i][j] + b_val[c]);
    }
  }
}

// out[b, t, :] = Σ_tap in[b, t - (taps - 1 - tap), :] · w[tap] + bias
// (+ residual[b, t, :]), rows before t = 0 read as zero: the causal conv
// (3 taps) and the out-projection with the residual (1 tap).
// grid (ceil(n/TM), ncols/TN, b)
__global__ void __launch_bounds__(ns2::kThreads)
ff_tap_kernel(const float* __restrict__ in,        // [b, n, K]
              const float* __restrict__ w,         // [taps, K, ncols]
              const float* __restrict__ bias,      // [ncols]
              const float* __restrict__ residual,  // [b, n, ncols] or null
              float* __restrict__ out,             // [b, n, ncols]
              int n, int K, int ncols, int taps) {
  __shared__ float As[ns2::KC][ns2::TM];
  __shared__ float Ws[ns2::KC][ns2::TN];

  const int ty = threadIdx.x / ns2::kGrid, tx = threadIdx.x % ns2::kGrid;
  const int t0 = blockIdx.x * ns2::TM, n0 = blockIdx.y * ns2::TN, bi = blockIdx.z;
  const float* inb = in + (size_t)bi * n * K;

  float acc[4][4] = {};
  for (int tap = 0; tap < taps; ++tap)
    ns2::tile_gemm(acc, inb, K, n, t0, taps - 1 - tap, w + (size_t)tap * K * ncols, ncols, n0, K,
                   As, Ws);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      const size_t idx = ((size_t)bi * n + t) * ncols + c;
      out[idx] = acc[i][j] + bias[c] + (residual ? residual[idx] : 0.0f);
    }
  }
}

}  // namespace

// x [b,n,dm] -> out [b,n,dm] for the shapes the fused kernel does not take:
// dm % 64 == 0 and inner padded with zeros to `inner_p`, a multiple of 64.
// a_buf and c_buf are [b, n, inner_p] f32 scratch. Three launches.
NS2_API int ns2_ff_block_wide(const float* x, const float* gamma, const float* beta,
                              const float* w_val, const float* b_val, const float* w_gate,
                              const float* b_gate, const float* wc, const float* bc,
                              const float* w2, const float* b2, float* a_buf, float* c_buf,
                              float* out, int b, int n, int dm, int inner_p, void* stream) {
  if (dm % ns2::TN != 0 || inner_p % ns2::TN != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_tiles = (n + ns2::TM - 1) / ns2::TM;
  const dim3 grid_inner(row_tiles, inner_p / ns2::TN, b), grid_out(row_tiles, dm / ns2::TN, b);
  ff_geglu_kernel<<<grid_inner, ns2::kThreads, 0, st>>>(x, gamma, beta, w_val, b_val, w_gate,
                                                        b_gate, a_buf, n, dm, inner_p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff_tap_kernel<<<grid_inner, ns2::kThreads, 0, st>>>(a_buf, wc, bc, nullptr, c_buf, n, inner_p,
                                                      inner_p, 3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ff_tap_kernel<<<grid_out, ns2::kThreads, 0, st>>>(c_buf, w2, b2, x, out, n, inner_p, dm, 1);
  return cudaGetLastError();
}

// x [b,n,dm] -> out [b,n,dm]. Weights are padded with zeros to the inner
// width `inner_p`. Supports dm = 128 with inner_p = 352 (the flagship's
// inner 341; checked by the Python wrapper, otherwise cudaErrorInvalidValue).
NS2_API int ns2_ff_block(const float* x, const float* gamma, const float* beta,
                         const float* w_val, const float* b_val, const float* w_gate,
                         const float* b_gate, const float* wc, const float* bc, const float* w2,
                         const float* b2, float* out, int b, int n, int dm, int inner_p,
                         void* stream) {
  if (dm != 128 || inner_p != 352) return cudaErrorInvalidValue;
  constexpr int DM = 128, IP = 352;
  const int bytes = (int)sizeof(FFSmem<DM, IP>);
  cudaError_t err = cudaFuncSetAttribute(ff_block_kernel<DM, IP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + TT - 1) / TT, b);
  ff_block_kernel<DM, IP><<<grid, ns2::kThreads, bytes, st>>>(x, gamma, beta, w_val, b_val,
                                                              w_gate, b_gate, wc, bc, w2, b2,
                                                              out, n);
  return cudaGetLastError();
}
