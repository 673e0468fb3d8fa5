// K2b: the fused pre-norm cross-attention block of the conditional
// denoiser transformer.
//
// Replaces the Pallas kernel `_cross_attn_block_kernel` (entry
// `fused_cross_attn_block`) in naturalspeech2_tpu/ops/attn_block_kernel.py:
//   y = x + Σ_h softmax(q_h k_hᵀ · scale) v_h · W_o,h,
//   q = n(x) · W_q,  n(x) = x / max(‖x‖, 1e-12) · √dm · γ_b + β_b,
//   k, v = ctx · W_{k,v}  (the context is not normalised)
// with no mask, no causal masking and no dropout. The context is the 32
// resampled speech-prompt latents, so m is small and n is long.
//
// What bounds it on the card: f32 multiply-adds. At the conditional
// sampling shape (x [8, 512, 128], ctx [8, 32, 128], 8 heads of 64) the q
// and out projections are 0.54 GFLOP each, the logits and P·V 0.13 each
// and k/v 0.07, against 5.4 MB of inputs and outputs: 21 µs at 67 TFLOP/s
// against 1.6 µs of HBM traffic (H100 SXM, 700 W).
//
// Design: the TPU kernel holds one head's whole [n, m] logits tile and its
// q/k/v in VMEM, one head per grid step. Here two kernels:
//  1. cross_kv_kernel: k and v = ctx · [W_k | W_v], once per batch row,
//     into f32 scratch [2, b, H, m, dh]. Recomputing them in every query
//     tile would add 38-76 % to the FLOPs at this shape.
//  2. cross_core_kernel: one block per (batch, 32 queries) and up to 512
//     output columns. Its prologue takes the rows' norms. For each head it
//     projects q through W_q,h, 128 model rows at a time (the normalised x
//     chunk and W_q,h's rows staged in shared memory, so any dm), runs an
//     online softmax over 32-key tiles of k/v, normalises the head output
//     and multiplies it by W_o,h's columns of this block (staged in the
//     buffer of W_q,h), summing the heads in f32 registers; the epilogue
//     adds the residual and writes the tile once. The per-head f32 sum is
//     the TPU kernel's f32 head accumulation. Past dm 512 the core is
//     launched once per 512 output columns, each launch recomputing q and
//     the attention for its columns. Heads are DH = 64 or 128 wide (the
//     wrapper pads narrower heads with zeros).
#include "common.cuh"

namespace {

// ---- kernel 1: k/v projection of the context -----------------------------
constexpr int TM = 64;  // context rows per block
constexpr int TN = 64;  // projection columns per block
constexpr int KC = 16;

// grid (ceil(m/TM), 2·H·dh / TN, b)
__global__ void __launch_bounds__(ns2::kThreads)
cross_kv_kernel(const float* __restrict__ ctx,  // [b, m, dc]
                const float* __restrict__ wkv,  // [dc, 2·H·dh]
                float* __restrict__ kv,         // [2, b, H, m, dh]
                int b, int m, int dc, int heads, int dh) {
  __shared__ float As[KC][TM];
  __shared__ float Bs[KC][TN];

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int t0 = blockIdx.x * TM, n0 = blockIdx.y * TN, bi = blockIdx.z;
  const int ncol = 2 * heads * dh;
  const float* cb = ctx + (size_t)bi * m * dc;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < dc; k0 += KC) {
    for (int e = tid; e < TM * KC; e += ns2::kThreads) {
      const int r = e / KC, kk = e % KC, t = t0 + r;
      As[kk][r] = (t < m) ? cb[(size_t)t * dc + k0 + kk] : 0.0f;
    }
    for (int e = tid; e < KC * TN; e += ns2::kThreads) {
      const int kk = e / TN, c = e % TN;
      Bs[kk][c] = wkv[(size_t)(k0 + kk) * ncol + n0 + c];
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
    if (t >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      const int which = c / hd, h = (c % hd) / dh, e = c % dh;
      kv[((((size_t)which * b + bi) * heads + h) * m + t) * dh + e] = acc[i][j];
    }
  }
}

// ---- kernel 2: norm + q projection, online softmax, out-projection -------
constexpr int TQ = 32;  // queries per block
constexpr int TK = 32;  // keys per tile
constexpr int NPART = ns2::kThreads / TQ;  // threads per row in the norm

constexpr int WC = 128;      // model rows of W_q,h (columns of W_o,h) staged at a time
constexpr int kMaxOut = 512;  // output columns a launch of the core covers at most

template <int DH>
struct CrossSmem {
  float xn[WC][TQ];   // 128 columns of the normalised x tile, transposed
  float w[WC * DH];   // 128 rows of W_q,h as [WC][DH], or 128 columns of W_o,h as [DH][WC]
  float q[DH][TQ];    // q tile, transposed
  float k[DH][TK];    // key tile, transposed
  float v[TK][DH];
  float p[TK][TQ];    // probabilities, transposed
  float o[DH][TQ];    // normalised head output, transposed
  float red[TQ][ns2::kGrid];
  float part[TQ][NPART];
  float rnorm[TQ];
};

// grid (ceil(n/TQ), b); dynamic shared memory sizeof(CrossSmem<DH>). Writes
// output columns col0 .. col0 + DO - 1; dm % WC == 0.
template <int DH, int DO>
__global__ void __launch_bounds__(ns2::kThreads)
cross_core_kernel(const float* __restrict__ x,      // [b, n, dm]
                  const float* __restrict__ gamma,  // [b, dm]
                  const float* __restrict__ beta,   // [b, dm]
                  const float* __restrict__ wq,     // [dm, H·DH]
                  const float* __restrict__ kv,     // [2, b, H, m, DH]
                  const float* __restrict__ wo,     // [H·DH, dm]
                  float* __restrict__ out,          // [b, n, dm]
                  int b, int n, int m, int heads, int dm, int col0, float sqrt_dm,
                  float scale) {
  static_assert(DH % ns2::kGrid == 0 && DO % WC == 0, "tile shape");
  constexpr int JO = DH / ns2::kGrid;  // head columns per thread
  constexpr int JY = DO / ns2::kGrid;  // output columns per thread
  constexpr int JS = TK / ns2::kGrid;  // key columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CrossSmem<DH>& sm = *reinterpret_cast<CrossSmem<DH>*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int q0 = blockIdx.x * TQ, bi = blockIdx.y;
  const int hd = heads * DH;
  const float* xb = x + (size_t)bi * n * dm;
  const float* g = gamma + (size_t)bi * dm;
  const float* be = beta + (size_t)bi * dm;
  const size_t plane = (size_t)b * heads * m * DH;  // k, then v

  // prologue: row norms (NPART threads per row)
  {
    const int r = tid / NPART, part = tid % NPART, t = q0 + r;
    float ss = 0.0f;
    if (t < n)
      for (int c = part; c < dm; c += NPART) {
        const float val = xb[(size_t)t * dm + c];
        ss += val * val;
      }
    sm.part[r][part] = ss;
  }
  __syncthreads();
  if (tid < TQ) {
    float ss = 0.0f;
    for (int u = 0; u < NPART; ++u) ss += sm.part[tid][u];
    sm.rnorm[tid] = fmaxf(sqrtf(ss), 1e-12f);
  }

  float y[2][JY] = {};
  for (int h = 0; h < heads; ++h) {
    const float* kh = kv + ((size_t)bi * heads + h) * m * DH;
    const float* vh = kh + plane;

    {
      float qa[2][JO] = {};
      for (int c0 = 0; c0 < dm; c0 += WC) {
        __syncthreads();  // the previous head (or chunk) is done with sm.w, sm.xn and sm.o
        for (int e = tid; e < TQ * WC; e += ns2::kThreads) {
          const int r = e / WC, c = e % WC, t = q0 + r, col = c0 + c;
          sm.xn[c][r] = (t < n) ? xb[(size_t)t * dm + col] / sm.rnorm[r] * sqrt_dm * g[col] +
                                      be[col]
                                : 0.0f;
        }
        for (int e = tid; e < WC * DH; e += ns2::kThreads) {
          const int c = e / DH, j = e % DH;
          sm.w[e] = wq[(size_t)(c0 + c) * hd + h * DH + j];
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < WC; ++c) {
          const float a0 = sm.xn[c][ty], a1 = sm.xn[c][ty + 16];
#pragma unroll
          for (int j = 0; j < JO; ++j) {
            const float w = sm.w[c * DH + tx + 16 * j];
            qa[0][j] += a0 * w;
            qa[1][j] += a1 * w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < JO; ++j) sm.q[tx + 16 * j][ty + 16 * i] = qa[i][j];
    }

    float mrow[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.0f, 0.0f};
    float o[2][JO] = {};
    for (int k0 = 0; k0 < m; k0 += TK) {
      __syncthreads();  // sm.q is written; the previous tile is consumed
      for (int e = tid; e < TK * DH; e += ns2::kThreads) {
        const int r = e / DH, c = e % DH;
        const bool ok = k0 + r < m;
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
          const float kk = sm.k[c][tx + 16 * j];
          s[0][j] += a0 * kk;
          s[1][j] += a1 * kk;
        }
      }
      float mloc[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mloc[i] = -INFINITY;
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          s[i][j] = (k0 + tx + 16 * j < m) ? s[i][j] * scale : -INFINITY;
          mloc[i] = fmaxf(mloc[i], s[i][j]);
        }
        sm.red[ty + 16 * i][tx] = mloc[i];
      }
      __syncthreads();
      float mnew[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mnew[i] = mrow[i];
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
        const float corr = expf(mrow[i] - mnew[i]);
        lsum[i] = lsum[i] * corr + rowsum;
        mrow[i] = mnew[i];
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

    // head output → shared, then y += o_h · W_o,h, 128 of this block's
    // columns of W_o,h at a time in the buffer of W_q,h (whose last reader
    // passed the first barrier of the key loop)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < JO; ++j) sm.o[tx + 16 * j][ty + 16 * i] = o[i][j] / lsum[i];
#pragma unroll
    for (int cc = 0; cc < DO / WC; ++cc) {
      if (cc > 0) __syncthreads();  // the previous columns are consumed
      for (int e = tid; e < DH * WC; e += ns2::kThreads) {
        const int r = e / WC, c = e % WC;
        sm.w[e] = wo[((size_t)h * DH + r) * dm + col0 + cc * WC + c];
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DH; ++c) {
        const float a0 = sm.o[c][ty], a1 = sm.o[c][ty + 16];
#pragma unroll
        for (int j = 0; j < WC / ns2::kGrid; ++j) {
          const float w = sm.w[c * WC + tx + 16 * j];
          y[0][cc * (WC / ns2::kGrid) + j] += a0 * w;
          y[1][cc * (WC / ns2::kGrid) + j] += a1 * w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= n) continue;
    const size_t row = ((size_t)bi * n + t) * dm + col0;
#pragma unroll
    for (int j = 0; j < JY; ++j) out[row + tx + 16 * j] = x[row + tx + 16 * j] + y[i][j];
  }
}

template <int DH, int DO>
cudaError_t launch_core(const float* x, const float* gamma, const float* beta, const float* wq,
                        const float* kv, const float* wo, float* out, int b, int n, int m,
                        int heads, int dm, int col0, float sqrt_dm, float scale,
                        cudaStream_t st) {
  const int bytes = (int)sizeof(CrossSmem<DH>);
  cudaError_t err = cudaFuncSetAttribute(cross_core_kernel<DH, DO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TQ - 1) / TQ, b);
  cross_core_kernel<DH, DO><<<grid, ns2::kThreads, bytes, st>>>(
      x, gamma, beta, wq, kv, wo, out, b, n, m, heads, dm, col0, sqrt_dm, scale);
  return cudaGetLastError();
}

// Output columns col0 .. col0 + width - 1 (width a multiple of WC up to
// kMaxOut) through the core's template of that width.
template <int DH>
cudaError_t launch_columns(const float* x, const float* gamma, const float* beta,
                           const float* wq, const float* kv, const float* wo, float* out, int b,
                           int n, int m, int heads, int dm, int col0, int width, float sqrt_dm,
                           float scale, cudaStream_t st) {
  switch (width) {
    case 128:
      return launch_core<DH, 128>(x, gamma, beta, wq, kv, wo, out, b, n, m, heads, dm, col0,
                                  sqrt_dm, scale, st);
    case 256:
      return launch_core<DH, 256>(x, gamma, beta, wq, kv, wo, out, b, n, m, heads, dm, col0,
                                  sqrt_dm, scale, st);
    case 384:
      return launch_core<DH, 384>(x, gamma, beta, wq, kv, wo, out, b, n, m, heads, dm, col0,
                                  sqrt_dm, scale, st);
    default:
      return launch_core<DH, kMaxOut>(x, gamma, beta, wq, kv, wo, out, b, n, m, heads, dm, col0,
                                      sqrt_dm, scale, st);
  }
}

}  // namespace

// x [b,n,dm], ctx [b,m,dc] -> out [b,n,dm]. wq [dm, H·dh]; wkv [dc, 2·H·dh]
// with k in the first H·dh columns and head h in columns h·dh..(h+1)·dh of
// each half; wo [H·dh, dm]; kv is [2, b, H, m, dh] f32 scratch. Takes dh ∈
// {64, 128}, dm % 128 == 0 and dc % 16 == 0 (the Python wrapper pads
// narrower widths with zeros; other widths return cudaErrorInvalidValue),
// any n ≥ 1 and m ≥ 1. The norm takes √ from `norm_dim`, the width before
// padding. 1 + ceil(dm / 512) launches.
NS2_API int ns2_cross_attn_block(const float* x, const float* ctx, const float* gamma,
                                 const float* beta, const float* wq, const float* wkv,
                                 const float* wo, float* kv, float* out, int b, int n, int m,
                                 int dm, int dc, int heads, int dh, int norm_dim, float scale,
                                 void* stream) {
  if ((dh != 64 && dh != 128) || dm <= 0 || dm % WC != 0 || dc % KC != 0 || m < 1 ||
      (2 * heads * dh) % TN != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid_kv((m + TM - 1) / TM, 2 * heads * dh / TN, b);
  cross_kv_kernel<<<grid_kv, ns2::kThreads, 0, st>>>(ctx, wkv, kv, b, m, dc, heads, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float sqrt_dm = sqrtf((float)norm_dim);
  for (int col0 = 0; col0 < dm; col0 += kMaxOut) {
    const int width = dm - col0 < kMaxOut ? dm - col0 : kMaxOut;
    err = dh == 64 ? launch_columns<64>(x, gamma, beta, wq, kv, wo, out, b, n, m, heads, dm, col0,
                                        width, sqrt_dm, scale, st)
                   : launch_columns<128>(x, gamma, beta, wq, kv, wo, out, b, n, m, heads, dm,
                                         col0, width, sqrt_dm, scale, st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
