// K5: flash attention backward, dq and dk/dv.
//
// Replaces the Pallas kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` in naturalspeech2_tpu/ops/flash_attention.py. With
// the forward's per-row lse and delta = Σ_d dO·O (a plain reduction before
// the launch, as XLA computes it outside the TPU kernels):
//   P  = valid ? exp(q kᵀ · scale − lse) : 0      (masked P exactly 0)
//   A  = P ∘ keep,  dP = (dO vᵀ) ∘ keep            (keep: the forward's
//                                                    Threefry dropout mask)
//   dS = P ∘ (dP − delta) · scale
//   dq = dS k,  dk = dSᵀ q,  dv = Aᵀ dO.
//
// What bounds it on the card: f32 multiply-adds from shared memory, as in
// K4; the backward does 2.5 times the forward's products (S, dP and two
// accumulating products per tile in each kernel).
//
// Design: the TPU grid accumulates across a sequential axis in VMEM
// scratch. Here each output has one owner block that loops inside itself:
// flash_bwd_dq_kernel owns (batch·head, 64 query rows) and walks the key
// tiles; flash_bwd_dkv_kernel owns (batch·head, 64 keys) and walks the
// query tiles. Every sum stays in one thread's registers, so there are no
// atomics and the result is deterministic. Causal blocks skip the tiles
// above the diagonal. Shared tiles are padded by one column so the
// transposed stores and the column reads hit distinct banks.
#include "flash.cuh"

namespace {

using ns2::kTK;
using ns2::kTQ;

template <int D>
struct DqSmem {
  float q[D][kTQ + 1];     // query tile, transposed
  float dout[D][kTQ + 1];  // dO tile, transposed
  float k[kTK][D + 1];
  float v[kTK][D + 1];
  float ds[kTK][kTQ + 1];  // dS, transposed
};

template <int D>
struct DkvSmem {
  float k[D][kTK + 1];     // key tile, transposed
  float v[D][kTK + 1];     // value tile, transposed
  float q[kTQ][D + 1];
  float dout[kTQ][D + 1];
  float a[kTQ][kTK + 1];   // dropped probabilities
  float ds[kTQ][kTK + 1];
  float lse[kTQ];
  float delta[kTQ];
};

// grid (ceil(n_q / kTQ), b·h); dynamic shared memory sizeof(DqSmem<D>)
template <int D>
__global__ void __launch_bounds__(ns2::kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const unsigned char* __restrict__ mask,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ dout, float* __restrict__ dq, int heads, int n_q,
                    int n_kv, int causal, float scale, ns2::Dropout dr) {
  constexpr int JD = D / ns2::kGrid;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int q0 = blockIdx.x * kTQ, bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  const unsigned char* mask_b = mask ? mask + (size_t)bi * n_kv : nullptr;

  for (int e = tid; e < kTQ * D; e += ns2::kThreads) {
    const int r = e / D, c = e % D;
    const bool ok = q0 + r < n_q;
    sm.q[c][r] = ok ? q[(qbase + q0 + r) * D + c] : 0.0f;
    sm.dout[c][r] = ok ? dout[(qbase + q0 + r) * D + c] : 0.0f;
  }
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    row_lse[i] = row < n_q ? lse[qbase + row] : 0.0f;
    row_delta[i] = row < n_q ? delta[qbase + row] : 0.0f;
  }

  float acc[4][JD] = {};
  const int k_end = causal ? min(n_kv, q0 + kTQ) : n_kv;
  for (int k0 = 0; k0 < k_end; k0 += kTK) {
    __syncthreads();  // the previous tile is done with sm.k / sm.v / sm.ds
    for (int e = tid; e < kTK * D; e += ns2::kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < n_kv;
      sm.k[r][c] = ok ? k[(kbase + k0 + r) * D + c] : 0.0f;
      sm.v[r][c] = ok ? v[(kbase + k0 + r) * D + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float aq[4], ad[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = sm.q[c][ty + 16 * i];
        ad[i] = sm.dout[c][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sm.k[tx + 16 * j][c];
        bv[j] = sm.v[tx + 16 * j][c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += aq[i] * bk[j];
          dp[i][j] += ad[i] * bv[j];
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.0f;
        if (ns2::visible(mask_b, row, col, n_q, n_kv, causal)) {
          const float p = expf(s[i][j] * scale - row_lse[i]);
          float d = dp[i][j];
          if (dr.rate > 0.0f) d *= ns2::keep_mult(dr, bi, hi, row, col);
          ds = p * (d - row_delta[i]) * scale;
        }
        sm.ds[tx + 16 * j][ty + 16 * i] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTK; ++c) {
      float a[4], b[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.ds[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < JD; ++j) b[j] = sm.k[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) acc[i][j] += a[i] * b[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n_q) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) dq[(qbase + row) * D + tx + 16 * j] = acc[i][j];
  }
}

// grid (ceil(n_kv / kTK), b·h); dynamic shared memory sizeof(DkvSmem<D>)
template <int D>
__global__ void __launch_bounds__(ns2::kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const unsigned char* __restrict__ mask,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ dout, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int n_q, int n_kv, int causal,
                     float scale, ns2::Dropout dr) {
  constexpr int JD = D / ns2::kGrid;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int kv0 = blockIdx.x * kTK, bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const size_t qbase = (size_t)bh * n_q, kbase = (size_t)bh * n_kv;
  const unsigned char* mask_b = mask ? mask + (size_t)bi * n_kv : nullptr;

  for (int e = tid; e < kTK * D; e += ns2::kThreads) {
    const int r = e / D, c = e % D;
    const bool ok = kv0 + r < n_kv;
    sm.k[c][r] = ok ? k[(kbase + kv0 + r) * D + c] : 0.0f;
    sm.v[c][r] = ok ? v[(kbase + kv0 + r) * D + c] : 0.0f;
  }

  float acc_k[4][JD] = {}, acc_v[4][JD] = {};
  // causal: query tiles that end before this key tile starts see none of it
  const int q_begin = causal ? (kv0 / kTQ) * kTQ : 0;
  for (int q0 = q_begin; q0 < n_q; q0 += kTQ) {
    __syncthreads();  // the previous tile is done with sm.q / sm.dout / sm.a / sm.ds
    for (int e = tid; e < kTQ * D; e += ns2::kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = q0 + r < n_q;
      sm.q[r][c] = ok ? q[(qbase + q0 + r) * D + c] : 0.0f;
      sm.dout[r][c] = ok ? dout[(qbase + q0 + r) * D + c] : 0.0f;
    }
    if (tid < kTQ) {
      const bool ok = q0 + tid < n_q;
      sm.lse[tid] = ok ? lse[qbase + q0 + tid] : 0.0f;
      sm.delta[tid] = ok ? delta[qbase + q0 + tid] : 0.0f;
    }
    __syncthreads();

    // transposed tiles: element [i][j] is (key kv0 + ty + 16i, query q0 + tx + 16j)
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 2
    for (int c = 0; c < D; ++c) {
      float ak[4], av[4], bq[4], bd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = sm.k[c][ty + 16 * i];
        av[i] = sm.v[c][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j] = sm.q[tx + 16 * j][c];
        bd[j] = sm.dout[tx + 16 * j][c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += ak[i] * bq[j];
          dp[i][j] += av[i] * bd[j];
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = kv0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j, row = q0 + qr;
        float a = 0.0f, ds = 0.0f;
        if (ns2::visible(mask_b, row, col, n_q, n_kv, causal)) {
          const float p = expf(s[i][j] * scale - sm.lse[qr]);
          float d = dp[i][j];
          a = p;
          if (dr.rate > 0.0f) {
            const float keep = ns2::keep_mult(dr, bi, hi, row, col);
            a = p * keep;
            d *= keep;
          }
          ds = p * (d - sm.delta[qr]) * scale;
        }
        sm.a[qr][ty + 16 * i] = a;
        sm.ds[qr][ty + 16 * i] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTQ; ++c) {
      float aa[4], ad[4], bd[JD], bq[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aa[i] = sm.a[c][ty + 16 * i];
        ad[i] = sm.ds[c][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        bd[j] = sm.dout[c][tx + 16 * j];
        bq[j] = sm.q[c][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JD; ++j) {
          acc_v[i][j] += aa[i] * bd[j];
          acc_k[i][j] += ad[i] * bq[j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = kv0 + ty + 16 * i;
    if (col >= n_kv) continue;
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      dk[(kbase + col) * D + tx + 16 * j] = acc_k[i][j];
      dv[(kbase + col) * D + tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <int D>
int launch_bwd(const float* q, const float* k, const float* v, const unsigned char* mask,
               const float* lse, const float* delta, const float* dout, float* dq, float* dk,
               float* dv, int b, int h, int n_q, int n_kv, int causal, float scale,
               const ns2::Dropout& dr, cudaStream_t st) {
  const int dq_bytes = (int)sizeof(DqSmem<D>);
  const int dkv_bytes = (int)sizeof(DkvSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((n_q + kTQ - 1) / kTQ, b * h);
  flash_bwd_dq_kernel<D><<<grid_q, ns2::kThreads, dq_bytes, st>>>(
      q, k, v, mask, lse, delta, dout, dq, h, n_q, n_kv, causal, scale, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((n_kv + kTK - 1) / kTK, b * h);
  flash_bwd_dkv_kernel<D><<<grid_kv, ns2::kThreads, dkv_bytes, st>>>(
      q, k, v, mask, lse, delta, dout, dk, dv, h, n_q, n_kv, causal, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// q/dout [b,h,n_q,d], k/v [b,h,n_kv,d], mask [b,n_kv] uint8 or null, lse and
// delta [b,h,n_q] -> dq [b,h,n_q,d], dk/dv [b,h,n_kv,d]. Dropout arguments as
// for ns2_flash_fwd; d = 64 only (other widths return cudaErrorInvalidValue).
NS2_API int ns2_flash_bwd(const float* q, const float* k, const float* v,
                          const unsigned char* mask, const float* lse, const float* delta,
                          const float* dout, float* dq, float* dk, float* dv, int b, int h,
                          int n_q, int n_kv, int d, int causal, float scale, unsigned seed0,
                          unsigned seed1, float rate, int stride, unsigned threshold,
                          float keep_scale, void* stream) {
  if (d != 64 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  const ns2::Dropout dr{seed0, seed1, rate, stride, threshold, keep_scale};
  return launch_bwd<64>(q, k, v, mask, lse, delta, dout, dq, dk, dv, b, h, n_q, n_kv, causal,
                        scale, dr, static_cast<cudaStream_t>(stream));
}
