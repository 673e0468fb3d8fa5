// K2: the fused pre-norm self-attention block of the denoiser transformer.
//
// Replaces the Pallas kernel `_attn_block_kernel` (entry `fused_attn_block`)
// in naturalspeech2_tpu/ops/attn_block_kernel.py:
//   y = x + Σ_h softmax(q_h k_hᵀ · scale) v_h · W_o,h,
//   q, k, v = n(x) · W_{q,k,v},  n(x) = x / max(‖x‖, 1e-12) · √d · γ_b + β_b
// with no mask, no causal masking and no dropout.
//
// What bounds it on the card: f32 multiply-adds and the shared-memory
// loads that feed them. At the flagship shape (b4 n1024 dm128, 8 heads of
// 64) the logits and P·V products are 8.6 GFLOP per block against 2 MB of
// x and 12 MB of q/k/v, so HBM is not the limit; the core's 2x4 register
// tiles cost 0.75 shared-memory loads per FMA, and its 128 blocks are one
// wave on 132 SMs: near 9 TFLOP/s of the 67 (H100 SXM, 700 W). At dm 512
// (b16 n1024) a core block needs 186 KB of shared memory, one per SM: near
// 10 TFLOP/s. At b1 and long n the core's ⌈n/32⌉ blocks are one wave and a
// short tail (n 9000: 282 blocks, 264 resident), near 7 TFLOP/s.
//
// Design: the TPU kernel holds one head's whole [n, n] logits tile in
// VMEM; a Hopper block cannot, and cannot recompute k and v for all n keys
// per query tile cheaply. So two kernels:
//  1. attn_qkv_kernel: the adaptive norm as the prologue of one GEMM
//     n(x)[b·n, dm] · [W_q | W_k | W_v][dm, 3·H·dh], written to f32 scratch
//     [3, b, H, n, dh];
//  2. attn_core_kernel: one block per (batch, 32-query tile) loops over the
//     heads, runs an online softmax over 64-key tiles, multiplies each
//     head's output by W_o,h and sums the heads in f32 registers, then adds
//     the residual and writes the tile once. The per-head f32 sum is the
//     TPU kernel's f32 head accumulation.
#include "common.cuh"

namespace {

// ---- kernel 1: adaptive norm + q/k/v projection ------------------------
constexpr int TM = 64;  // rows (time steps) per block
constexpr int TN = 64;  // projection columns per block
constexpr int KC = 16;

// grid (ceil(n/TM), 3·H·dh / TN, b)
__global__ void __launch_bounds__(ns2::kThreads)
attn_qkv_kernel(const float* __restrict__ x,      // [b, n, dm]
                const float* __restrict__ gamma,  // [b, dm]
                const float* __restrict__ beta,   // [b, dm]
                const float* __restrict__ wqkv,   // [dm, 3·H·dh]
                float* __restrict__ qkv,          // [3, b, H, n, dh]
                int b, int n, int dm, int heads, int dh) {
  __shared__ float As[KC][TM];
  __shared__ float Bs[KC][TN];
  __shared__ float part[TM][4];
  __shared__ float rnorm[TM];

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int t0 = blockIdx.x * TM, n0 = blockIdx.y * TN, bi = blockIdx.z;
  const int ncol = 3 * heads * dh;
  const float* xb = x + (size_t)bi * n * dm;
  const float* g = gamma + (size_t)bi * dm;
  const float* be = beta + (size_t)bi * dm;

  // row norms: 4 threads per row
  {
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
  if (tid < TM) {
    const float nrm = sqrtf(part[tid][0] + part[tid][1] + part[tid][2] + part[tid][3]);
    rnorm[tid] = fmaxf(nrm, 1e-12f);
  }
  __syncthreads();

  const float sqrt_dm = sqrtf((float)dm);
  float acc[4][4] = {};
  for (int k0 = 0; k0 < dm; k0 += KC) {
    for (int e = tid; e < TM * KC; e += ns2::kThreads) {
      const int r = e / KC, kk = e % KC, t = t0 + r, k = k0 + kk;
      As[kk][r] = (t < n) ? xb[(size_t)t * dm + k] / rnorm[r] * sqrt_dm * g[k] + be[k] : 0.0f;
    }
    for (int e = tid; e < KC * TN; e += ns2::kThreads) {
      const int kk = e / TN, c = e % TN;
      Bs[kk][c] = wqkv[(size_t)(k0 + kk) * ncol + n0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
    }
    __syncthreads();
  }

  const int hd = heads * dh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      const int which = c / hd, h = (c % hd) / dh, e = c % dh;
      qkv[((((size_t)which * b + bi) * heads + h) * n + t) * dh + e] = acc[i][j];
    }
  }
}

// ---- kernel 2: online-softmax attention + out-projection + residual ----
constexpr int TQ = 32;  // queries per block
constexpr int TK = 64;  // keys per tile

template <int DH, int DM>
struct CoreSmem {
  float q[DH][TQ];    // q tile, transposed
  float k[DH][TK];    // key tile, transposed
  float v[TK][DH];
  float p[TK][TQ];    // probabilities, transposed
  float o[DH][TQ];    // normalised head output, transposed
  float wo[DH][DM];   // W_o,h
  float red[TQ][ns2::kGrid];
};

// grid (ceil(n/TQ), b); dynamic shared memory sizeof(CoreSmem<DH, DM>)
template <int DH, int DM>
__global__ void __launch_bounds__(ns2::kThreads)
attn_core_kernel(const float* __restrict__ x,    // [b, n, DM]
                 const float* __restrict__ qkv,  // [3, b, H, n, DH]
                 const float* __restrict__ wo,   // [H, DH, DM]
                 float* __restrict__ out,        // [b, n, DM]
                 int b, int n, int heads, float scale) {
  static_assert(DH % ns2::kGrid == 0 && DM % ns2::kGrid == 0, "tile shape");
  constexpr int JO = DH / ns2::kGrid;  // head-output columns per thread
  constexpr int JY = DM / ns2::kGrid;  // model columns per thread
  constexpr int JS = TK / ns2::kGrid;  // key columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CoreSmem<DH, DM>& sm = *reinterpret_cast<CoreSmem<DH, DM>*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int q0 = blockIdx.x * TQ, bi = blockIdx.y;
  const size_t plane = (size_t)b * heads * n * DH;  // one of q, k, v

  float y[2][JY] = {};
  for (int h = 0; h < heads; ++h) {
    const size_t head = ((size_t)bi * heads + h) * n * DH;
    const float* qh = qkv + head;
    const float* kh = qkv + plane + head;
    const float* vh = qkv + 2 * plane + head;

    __syncthreads();  // previous head is done with sm.q / sm.o / sm.wo
    for (int e = tid; e < TQ * DH; e += ns2::kThreads) {
      const int r = e / DH, c = e % DH;
      sm.q[c][r] = (q0 + r < n) ? qh[(size_t)(q0 + r) * DH + c] : 0.0f;
    }
    for (int e = tid; e < DH * DM; e += ns2::kThreads)
      sm.wo[e / DM][e % DM] = wo[(size_t)h * DH * DM + e];

    float m[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.0f, 0.0f};
    float o[2][JO] = {};
    for (int k0 = 0; k0 < n; k0 += TK) {
      __syncthreads();  // previous tile is done with sm.k / sm.v / sm.p
      for (int e = tid; e < TK * DH; e += ns2::kThreads) {
        const int r = e / DH, c = e % DH;
        const bool ok = k0 + r < n;
        sm.k[c][r] = ok ? kh[(size_t)(k0 + r) * DH + c] : 0.0f;
        sm.v[r][c] = ok ? vh[(size_t)(k0 + r) * DH + c] : 0.0f;
      }
      __syncthreads();

      float s[2][JS] = {};
#pragma unroll 8
      for (int c = 0; c < DH; ++c) {
        const float a0 = sm.q[c][ty], a1 = sm.q[c][ty + 16];
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          const float kv = sm.k[c][tx + 16 * j];
          s[0][j] += a0 * kv;
          s[1][j] += a1 * kv;
        }
      }
      float mloc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mloc[i] = -INFINITY;
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          s[i][j] = (k0 + tx + 16 * j < n) ? s[i][j] * scale : -INFINITY;
          mloc[i] = fmaxf(mloc[i], s[i][j]);
        }
        sm.red[ty + 16 * i][tx] = mloc[i];
      }
      __syncthreads();
      float mnew[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mnew[i] = m[i];
        for (int u = 0; u < ns2::kGrid; ++u) mnew[i] = fmaxf(mnew[i], sm.red[ty + 16 * i][u]);
      }
      __syncthreads();  // everyone has read sm.red before it is reused
      float ploc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ploc[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          const float p = expf(s[i][j] - mnew[i]);
          sm.p[tx + 16 * j][ty + 16 * i] = p;
          ploc[i] += p;
        }
        sm.red[ty + 16 * i][tx] = ploc[i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float rowsum = 0.0f;
        for (int u = 0; u < ns2::kGrid; ++u) rowsum += sm.red[ty + 16 * i][u];
        const float corr = expf(m[i] - mnew[i]);
        lsum[i] = lsum[i] * corr + rowsum;
        m[i] = mnew[i];
#pragma unroll
        for (int j = 0; j < JO; ++j) o[i][j] *= corr;
      }
#pragma unroll 8
      for (int r = 0; r < TK; ++r) {
        const float p0 = sm.p[r][ty], p1 = sm.p[r][ty + 16];
#pragma unroll
        for (int j = 0; j < JO; ++j) {
          const float vv = sm.v[r][tx + 16 * j];
          o[0][j] += p0 * vv;
          o[1][j] += p1 * vv;
        }
      }
    }

    // head output → shared, then y += o_h · W_o,h
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < JO; ++j) sm.o[tx + 16 * j][ty + 16 * i] = o[i][j] / lsum[i];
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < DH; ++c) {
      const float a0 = sm.o[c][ty], a1 = sm.o[c][ty + 16];
#pragma unroll
      for (int j = 0; j < JY; ++j) {
        const float w = sm.wo[c][tx + 16 * j];
        y[0][j] += a0 * w;
        y[1][j] += a1 * w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= n) continue;
    const size_t row = ((size_t)bi * n + t) * DM;
#pragma unroll
    for (int j = 0; j < JY; ++j) out[row + tx + 16 * j] = x[row + tx + 16 * j] + y[i][j];
  }
}

template <int DH, int DM>
int launch_core(const float* x, const float* qkv, const float* wo, float* out, int b, int n,
                int heads, float scale, cudaStream_t st) {
  const int bytes = (int)sizeof(CoreSmem<DH, DM>);
  cudaError_t err = cudaFuncSetAttribute(attn_core_kernel<DH, DM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TQ - 1) / TQ, b);
  attn_core_kernel<DH, DM><<<grid, ns2::kThreads, bytes, st>>>(x, qkv, wo, out, b, n, heads,
                                                               scale);
  return cudaGetLastError();
}

}  // namespace

// x [b,n,dm] -> out [b,n,dm]. wqkv [dm, 3·H·dh] is [W_q | W_k | W_v] with
// head h in columns h·dh..(h+1)·dh of each third; wo [H, dh, dm]; qkv is
// [3, b, H, n, dh] f32 scratch. Supports dh = 64 and dm = 128 or 512
// (checked by the Python wrapper; other widths return
// cudaErrorInvalidValue). At dm 512 the core's shared memory is 186 KB,
// W_o,h alone 128 KB of it: one block per SM.
NS2_API int ns2_attn_block(const float* x, const float* gamma, const float* beta,
                           const float* wqkv, const float* wo, float* qkv, float* out, int b,
                           int n, int dm, int heads, int dh, float scale, void* stream) {
  if (dh != 64 || (dm != 128 && dm != 512) || (3 * heads * dh) % TN != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_qkv((n + TM - 1) / TM, 3 * heads * dh / TN, b);
  attn_qkv_kernel<<<grid_qkv, ns2::kThreads, 0, st>>>(x, gamma, beta, wqkv, qkv, b, n, dm, heads,
                                                       dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dm == 512) return launch_core<64, 512>(x, qkv, wo, out, b, n, heads, scale, st);
  return launch_core<64, 128>(x, qkv, wo, out, b, n, heads, scale, st);
}
