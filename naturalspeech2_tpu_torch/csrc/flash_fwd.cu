// K4: flash attention forward.
//
// Replaces the Pallas kernels `_flash_kernel` (online softmax over kv
// blocks) and `_flash_oneshot_kernel` (one kv block) in
// naturalspeech2_tpu/ops/flash_attention.py, which compute one function:
//   o = softmax(q kᵀ · scale) v,  lse = m + log l  per query row,
// with a [b, n_kv] key-padding mask, causal masking (row >= col) and
// Threefry dropout on the probabilities (the normaliser l uses the undropped
// ones). Masked logits are NEG_INF (finite) and masked probabilities exactly
// 0, so a fully masked row gives o = 0 and lse = NEG_INF.
//
// What bounds it on the card: f32 multiply-adds fed from shared memory. At
// the training shape (b16 h8 n150 d64) the logits and P·V products are
// 0.74 GFLOP against 7.4 MB of q/k/v/o, far above the f32 ridge of the
// H100 (67 TFLOP/s over 3.35 TB/s, 20 FLOP per byte), so the limit is the
// CUDA cores and the shared-memory loads that feed them.
//
// Design: the TPU kernels hold up to 1024 x 1024 logits in VMEM and carry
// the online-softmax state across the sequential grid axis. Here one block
// owns (batch·head, 64 query rows) and walks the kv axis inside the block
// in 64-key tiles: S = Q Kᵀ in 4 x 4 register tiles per thread, the row
// max and sum by half-warp shuffles, the scaled probabilities staged
// transposed in shared memory for O += P V. Causal blocks stop at the
// diagonal. The dropout mask is regenerated per element from its global
// (row, col), so tiles need not match the TPU's.
#include "flash.cuh"

namespace {

using ns2::kTK;
using ns2::kTQ;

template <int D>
struct FwdSmem {
  float q[D][kTQ + 1];   // query tile, transposed
  float k[kTK][D + 1];   // key tile
  float v[kTK][D];       // value tile
  float p[kTK][kTQ + 1]; // probabilities (dropped, scaled), transposed
};

// grid (ceil(n_q / kTQ), b·h); dynamic shared memory sizeof(FwdSmem<D>)
template <int D>
__global__ void __launch_bounds__(ns2::kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const unsigned char* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int heads, int n_q, int n_kv,
                 int causal, float scale, ns2::Dropout dr) {
  static_assert(D % ns2::kGrid == 0, "head dim");
  constexpr int JD = D / ns2::kGrid;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / ns2::kGrid, tx = tid % ns2::kGrid;
  const int q0 = blockIdx.x * kTQ, bh = blockIdx.y;
  const int bi = bh / heads, hi = bh % heads;
  const float* qh = q + (size_t)bh * n_q * D;
  const float* kh = k + (size_t)bh * n_kv * D;
  const float* vh = v + (size_t)bh * n_kv * D;
  const unsigned char* mask_b = mask ? mask + (size_t)bi * n_kv : nullptr;

  for (int e = tid; e < kTQ * D; e += ns2::kThreads) {
    const int r = e / D, c = e % D;
    sm.q[c][r] = (q0 + r < n_q) ? qh[(size_t)(q0 + r) * D + c] : 0.0f;
  }

  float m[4], l[4], acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ns2::kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.0f;
  }

  const int k_end = causal ? min(n_kv, q0 + kTQ) : n_kv;
  for (int k0 = 0; k0 < k_end; k0 += kTK) {
    __syncthreads();  // the previous tile is done with sm.k / sm.v / sm.p
    for (int e = tid; e < kTK * D; e += ns2::kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < n_kv;
      sm.k[r][c] = ok ? kh[(size_t)(k0 + r) * D + c] : 0.0f;
      sm.v[r][c] = ok ? vh[(size_t)(k0 + r) * D + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.q[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.k[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mt = ns2::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = ns2::visible(mask_b, row, k0 + tx + 16 * j, n_q, n_kv, causal);
        s[i][j] = ok[j] ? s[i][j] * scale : ns2::kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], ns2::half_warp_max(mt));
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        ps += p;
        if (dr.rate > 0.0f && ok[j]) p *= ns2::keep_mult(dr, bi, hi, row, k0 + tx + 16 * j);
        sm.p[tx + 16 * j][ty + 16 * i] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + ns2::half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTK; ++c) {
      float a[4], b[JD];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.p[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < JD; ++j) b[j] = sm.v[c][tx + 16 * j];
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
    const float safe_l = l[i] == 0.0f ? 1.0f : l[i];
    float* orow = o + ((size_t)bh * n_q + row) * D;
#pragma unroll
    for (int j = 0; j < JD; ++j) orow[tx + 16 * j] = acc[i][j] / safe_l;
    if (tx == 0) lse[(size_t)bh * n_q + row] = m[i] + logf(safe_l);
  }
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, const unsigned char* mask,
               float* o, float* lse, int b, int h, int n_q, int n_kv, int causal, float scale,
               const ns2::Dropout& dr, cudaStream_t st) {
  const int bytes = (int)sizeof(FwdSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_q + kTQ - 1) / kTQ, b * h);
  flash_fwd_kernel<D><<<grid, ns2::kThreads, bytes, st>>>(q, k, v, mask, o, lse, h, n_q, n_kv,
                                                          causal, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// q [b,h,n_q,d], k/v [b,h,n_kv,d], mask [b,n_kv] uint8 or null -> o
// [b,h,n_q,d], lse [b,h,n_q]. Dropout is on when rate > 0: seed, counter
// stride, keep threshold and keep scale come from the Python wrapper, as
// the JAX package derives them. Supports d = 64 (checked by the wrapper;
// other widths return cudaErrorInvalidValue).
NS2_API int ns2_flash_fwd(const float* q, const float* k, const float* v,
                          const unsigned char* mask, float* o, float* lse, int b, int h, int n_q,
                          int n_kv, int d, int causal, float scale, unsigned seed0,
                          unsigned seed1, float rate, int stride, unsigned threshold,
                          float keep_scale, void* stream) {
  if (d != 64 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  const ns2::Dropout dr{seed0, seed1, rate, stride, threshold, keep_scale};
  return launch_fwd<64>(q, k, v, mask, o, lse, b, h, n_q, n_kv, causal, scale, dr,
                        static_cast<cudaStream_t>(stream));
}
