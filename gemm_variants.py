#!/usr/bin/env python3
"""Where the time of the kernels on the GEMM cores goes, on one NVIDIA GPU.

    python3 gemm_variants.py [variant ...]

Builds the port's kernel library (as `chip_smoke.py` does), then builds
variants of the two GEMM cores, each with one design choice changed or one
part of the work taken out, and times the kernels' C entry points side by
side (CUDA events, without the Python wrappers; the weights packed once),
with each variant's error against the plain versions relative to the
largest entry of y - x (K2, K3) or of the output (K1, K1b).

The split-TF32 core `csrc/gemm_tf32x3.cuh` of K1 (`csrc/wavenet.cu`), K1b
(`csrc/wavenet_lane.cu`), K2 (`csrc/attn_block.cu`) and K3
(`csrc/ff_block.cu`) in f32, timed at SHAPES and WAVENET_SHAPES:

  base         the cores as committed
  one_wg       blocks of one warpgroup everywhere, none sharing A
  no_a_loads   A's global loads replaced by constants (wrong)
  no_a_stores  A's split and shared-memory stores taken out (wrong)
  no_b_copies  B's copies into shared memory taken out (wrong)
  one_pass     one TF32 pass per product (hi·hi): fast and wrong
  no_products  no wgmma at all: the loads, splits, stores and barriers
               alone (wrong)
  late_b       chunk c + 2 of B copied at the top of iteration c + 1,
               after its barrier, which then is the loop's only one
  k1_wn1       K1's and K1b's block launches one warpgroup to a block
               (three an SM), each staging A for its own column tile
  k1_wn2_x1    K1's and K1b's blocks of two warpgroups one an SM (up to
               255 registers a thread) rather than two (at most 128)
  k1_wn3       K1's stack launches as K2 and K3 launch on large grids:
               three warpgroups to a block sharing A (at d 128 two of the
               six column tiles of a block's pair are past the last)

The bf16 core `csrc/gemm_bf16.cuh` of K2 and K3 in bf16, timed at
BF16_SHAPES (each K3 and K2 GEMM launch of base beside `torch.matmul` in
bf16 at the same M x N x K, a cuBLAS yardstick the port never calls, and
their other launches' device times):

  bf16_stages3, bf16_stages2
               the ring 3 or 2 chunks deep (4)
  bf16_no_loop_pins
               the accumulator not pinned around each chunk's products
  bf16_wait0   each chunk's products waited for before the next is issued
  bf16_norm_loader
               n(x) staged by the producer warpgroup through registers
               (a loader this script inserts, _NORM_ROWS) in the first
               GEMM of K2 and K3, no norm pre-pass
  bf16_tile_128x256, bf16_tile_128x128, bf16_tile_64x64
               every GEMM at that tile shape, where base chooses by waves
  bf16_no_pdl  every launch after the stream's previous kernel has ended,
               where base launches each as a programmatic dependent
  k2b_mixed_two_prepasses
               K2b mixed's context split by a launch of its own, where base
               splits it in the norm pre-pass's launch; K2b mixed is timed
               at AMP's shape and chip_smoke.AMP_K2B_RAGGED under every
               bf16 variant

The bf16 core's WaveNet (K1 and K1b in bf16: the f32 lanes as three bf16
planes), timed at WAVENET_SHAPES with base's launches by kernel:

  k1_bf16_res_tap2
               the residual columns' products on tap 2 alone: the chunks
               of taps 0 and 1 run `wgmma.m64n32k16` on each 64-column
               group's 32 conv columns (4d² products a row where base runs
               6d², the residual rows of taps 0 and 1 being zeros)
  k1b_bf16_one_lane, k1b_bf16_two_lanes
               K1b's blocks one or two lanes a launch (csrc/wavenet_lane.cu's
               kLaneGroup, 4 in base)
  k1_bf16_no_pdl
               as bf16_no_pdl, for K1 and K1b
  k1_bf16_no_gate, k1_bf16_no_stores
               the gate's bias, FiLM, tanh and sigmoid taken out of
               `WaveGateSplit` (the planes of conv + res), or its TMA stores
               of the staged planes (wrong)
  k1_bf16_no_shift
               every tap's box at the tile's own rows, no dilation (wrong)
  k1_bf16_tile_64x128
               the WaveNet blocks on 64 x 128 tiles, two blocks an SM (one
               block's mainloop beside the other's epilogue), where base
               chooses them by waves as K2's and K3's (128 x 256 / 128 x 128,
               one block an SM, at these shapes)
  k1b_bf16_tile_128x256, k1b_bf16_tile_128x128
               K1b's blocks (bf16 and `bf16_matmul`) at that tile shape
  bf16_gate_no_clobber
               the gate's stores into the staging panels without the
               "memory" clobber, so that the compiler may hoist the next
               columns' bias and FiLM loads above them
  bf16_gate_no_loads
               the gate's bias and FiLM as constants, no loads (wrong)
  bf16mm_gate_loads
               `bf16_matmul`'s gate reading its f32 bias and FiLM from
               device memory in its loop, as the three parts do, where base
               stages the tile's columns in shared memory first

K1b's `bf16_matmul` (one bf16 plane a lane) runs beside K1b bf16 at
BF16MM_SHAPES, and K1's mixed entry (x's three planes by a pre-pass, the
gate on f32 parameters) at MIXED_SHAPES, under every WaveNet variant.

With variant names, builds and times only those beside base. Exits
non-zero without a CUDA device. Not part of the smoke run.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

CORE = "gemm_tf32x3.cuh"
BF16_CORE = "gemm_bf16.cuh"
VARIANTS = {
    "base": [],
    "one_wg": [(CORE, "  if (shared >= sm_count())\n", "  if (false)\n")],
    "no_a_loads": [(CORE, "areg[i] = ld.get(4 * (cq + kLanes * i));",
                    "areg[i] = make_float4(c, i, 1.0f, 2.0f);")],
    "no_a_stores": [(CORE, "store_split4(sm.a[s][0], sm.a[s][1], kmajor<kBM>(sr, k), areg[i]);",
                     "if (areg[i].x == 12345.0f) sm.a[s][0][i] = areg[i].y;")],
    "no_b_copies": [(CORE, "cp_async16(dst + e, src + e, true);", "(void)dst; (void)src;")],
    "one_pass": [(CORE, "      wgmma_ss_n64(small, a_hi, kmajor_desc<kBN>(sm.b[s][wg][1], ks));\n"
                        "      wgmma_ss_n64(small, a_lo, b_hi);\n", "")],
    "no_products": [(CORE, "      wgmma_ss_n64(small, a_hi, kmajor_desc<kBN>(sm.b[s][wg][1], ks));\n"
                           "      wgmma_ss_n64(small, a_lo, b_hi);\n"
                           "      wgmma_ss_n64(big, a_hi, b_hi);\n", "")],
    "late_b": [(CORE, "    cp_async_wait<1>();  // chunk c of B has landed (c + 1 may be in flight)\n",
                "    if (c == 0) cp_async_wait<1>(); else cp_async_wait<0>();\n"),
               (CORE, "    __syncthreads();     // chunk c of A and B is in shared memory, for wgmma too\n",
                "    __syncthreads();     // chunk c of A and B is in shared memory, for wgmma too\n"
                "    if (c >= 1 && c + 1 < chunks) {\n      load_b(c + 1, s ^ 1);\n"
                "      cp_async_commit();\n    }\n"),
               (CORE, "    __syncthreads();  // every warp's products are done with stage s\n"
                      "    if (c + 2 < chunks) load_b(c + 2, s);\n"
                      "    cp_async_commit();  // possibly empty: one group per chunk keeps the count\n",
                "")],
    "k1_wn1": [("wavenet.cu", "gemm::launch_wn<2>(", "gemm::launch_wn<1>("),
               ("wavenet_lane.cu", "gemm::launch_wn<2>(", "gemm::launch_wn<1>(")],
    "k1_wn2_x1": [(CORE, "WN == 1 ? 3 : (WN == 2 ? 2 : 1)", "WN == 1 ? 3 : 1")],
    "k1_wn3": [("wavenet.cu", "gemm::launch_wn<2>(", "gemm::launch(")],
}
# bf16_norm_loader's loader: A = n(x), the adaptive RMSNorm x / max(‖x‖,
# 1e-12) · √dm · γ_b + β_b of x [b, n, dm] (γ, β [b, dm]) in f32, rounded to
# bf16, zero past dm, staged by the producer warpgroup through registers
# into the swizzled A panel (dm a multiple of 8; x, γ and β 16-byte
# aligned): `scales` computes the tile's row scales once (one warp a row)
# into shared memory past the barriers, `stage` writes one chunk's panel.
# Every producer thread arrives on the stage's full barrier after its
# stores; B still comes by TMA.
_NORM_ROWS = r"""struct NormRows {
  const bf16* x;
  const bf16* gamma;
  const bf16* beta;
  int batch, n, dm;

  cudaError_t map(CUtensorMap*, int) const { return cudaSuccess; }  // no copies of A

  __device__ void scales(float* s, int bi, int t0, int bm, int ptid) const {
    const int warp = ptid / 32, lane = ptid % 32;
    for (int r = warp; r < bm; r += kProducers / 32) {
      const int t = t0 + r;
      float ss = 0.0f;
      if (t < n) {
        const bf16* p = x + ((size_t)bi * n + t) * dm;
        for (int k = 8 * lane; k < dm; k += 256) {
          const uint4 u = *reinterpret_cast<const uint4*>(p + k);
          const float4 a = unpack_bf16x4(make_uint2(u.x, u.y));
          const float4 b = unpack_bf16x4(make_uint2(u.z, u.w));
          ss += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w + b.x * b.x + b.y * b.y +
                b.z * b.z + b.w * b.w;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (lane == 0) s[r] = sqrtf((float)dm) / fmaxf(sqrtf(ss), 1e-12f);
    }
    sm90::bar_sync(1, kProducers);  // the producer warpgroup's own barrier
  }

  __device__ static uint32_t norm2(uint32_t xw, uint32_t gw, uint32_t bw, float sc) {
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw));
    const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw));
    const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw));
    return pack_bf16x2(xv.x * sc * gv.x + bv.x, xv.y * sc * gv.y + bv.y);
  }

  __device__ void stage(uint32_t panel, const float* s, int bi, int t0, int bm, int kc,
                        int ptid) const {
    const bf16* g = gamma + (size_t)bi * dm;
    const bf16* be = beta + (size_t)bi * dm;
#pragma unroll 1
    for (int e = ptid; e < bm * 8; e += kProducers) {
      const int r = e / 8, k = kc * kKC + 8 * (e % 8), t = t0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < n && k < dm) {
        const uint4 xv = *reinterpret_cast<const uint4*>(x + ((size_t)bi * n + t) * dm + k);
        const uint4 gv = *reinterpret_cast<const uint4*>(g + k);
        const uint4 bv = *reinterpret_cast<const uint4*>(be + k);
        const float sc = s[r];
        v = make_uint4(norm2(xv.x, gv.x, bv.x, sc), norm2(xv.y, gv.y, bv.y, sc),
                       norm2(xv.z, gv.z, bv.z, sc), norm2(xv.w, gv.w, bv.w, sc));
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       panel + sm90::swizzled(r, e % 8)),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
};
template <class L>
constexpr bool kStagedA = false;
template <>
constexpr bool kStagedA<NormRows> = true;

"""
_STAGED_PRODUCER = r"""    if constexpr (kStagedA<Loader>) {
      const int ptid = tid - T::kConsumers;
      float* scales =
          reinterpret_cast<float*>(bgemm_smem + (base - raw) + T::kBars + 16 * kStages);
      ld.scales(scales, bi, t0, BM, ptid);
      for (int kc = 0; kc < chunks; ++kc) {
        const int st = kc % kStages;
        sm90::mbar_wait(&empty[st], ((kc / kStages) & 1) ^ 1);
        const uint32_t a_at = base + st * T::kStage;
        if (ptid == 0) {
          mbar_expect_tx(&full[st], T::kPanelB);
          tma_load_3d(a_at + T::kPanelA, &map_b, &full[st], 0, n0, kc);
        }
        ld.stage(a_at, scales, bi, t0, BM, kc, ptid);
        fence_proxy_async();  // the stores, made visible to wgmma
        sm90::mbar_arrive(&full[st]);
      }
    } else if (tid == T::kConsumers) {
"""
_TILE = "  const Shape s = choose(ld.batch, ld.n, b_rows);\n"
_PDL = "attr[0].val.programmaticStreamSerializationAllowed = 1;"
_NO_PDL = "attr[0].val.programmaticStreamSerializationAllowed = 0;"
_STAGES = "constexpr int kStages = 4; "
# k2b_mixed_two_prepasses: K2b mixed's context split by a launch of its own
# before the norm pre-pass, where base splits it in the norm pre-pass's
# launch (`bgemm::SplitTail`)
_K2B_ONE_PREPASS = """  cudaError_t err = bgemm::launch_normed_split(
      x, gamma, beta, planes, b, n, dm, bt_q, hd, bgemm::QkvScatterT<float>{q, n, heads, b, dh, 1},
      st, bgemm::SplitTail{ctx, ctx_planes, b * m, m, dc, dc_pad});
"""
_K2B_TWO_PREPASSES = """  cudaError_t err = bgemm::split_planes(ctx, ctx_planes, b, m, dc, dc_pad, st);
  if (err == cudaSuccess)
    err = bgemm::launch_normed_split(x, gamma, beta, planes, b, n, dm, bt_q, hd,
                                     bgemm::QkvScatterT<float>{q, n, heads, b, dh, 1}, st);
"""
BF16_VARIANTS = {
    "bf16_stages3": [(BF16_CORE, _STAGES, "constexpr int kStages = 3; ")],
    "bf16_stages2": [(BF16_CORE, _STAGES, "constexpr int kStages = 2; ")],
    "bf16_no_loop_pins": [(BF16_CORE, "    sm90::pin(acc);\n    wg_fence();\n", "    wg_fence();\n"),
                          (BF16_CORE, "    sm90::wg_wait<1>();  // chunk kc - 1's products are done, "
                                      "kc's may run\n    sm90::pin(acc);\n",
                           "    sm90::wg_wait<1>();\n")],
    "bf16_wait0": [(BF16_CORE, "    sm90::wg_wait<1>();  // chunk kc - 1's products are done, "
                               "kc's may run\n", "    sm90::wg_wait<0>();\n")],
    "bf16_norm_loader": [
        (BF16_CORE, "// B: the packed Bᵀ [chunks, b_rows, 64] as a 3-dim map",
         _NORM_ROWS + "// B: the packed Bᵀ [chunks, b_rows, 64] as a 3-dim map"),
        (BF16_CORE, "(int)kBars + 16 * kStages + 1024;", "(int)kBars + 16 * kStages + 4 * BM + 1024;"),
        (BF16_CORE, "sm90::mbar_init(&full[st], 1);",
         "sm90::mbar_init(&full[st], kStagedA<Loader> ? 1 + kProducers : 1);"),
        (BF16_CORE, "    if (tid == T::kConsumers) {\n", _STAGED_PRODUCER),
        (BF16_CORE, "  const cudaError_t err = norm_rows(x, gamma, beta, scratch, b * n, n, dm, "
                    "dm_pad, stream);\n  if (err != cudaSuccess) return err;\n"
                    "  return launch(Rows{scratch, b, n, dm_pad, dm_pad}, bt, b_rows, chunks, "
                    "epi, stream);\n",
         "  return launch(NormRows{x, gamma, beta, b, n, dm}, bt, b_rows, chunks, epi, stream);\n")],
    "bf16_tile_128x256": [(BF16_CORE, _TILE, "  const Shape s = kShapes[0];\n")],
    "bf16_tile_128x128": [(BF16_CORE, _TILE, "  const Shape s = kShapes[1];\n")],
    "bf16_tile_64x64": [(BF16_CORE, _TILE, "  const Shape s = kShapes[2];\n")],
    "bf16_no_pdl": [(BF16_CORE, _PDL, _NO_PDL)],
    "k2b_mixed_two_prepasses": [("cross_attn_block.cu", _K2B_ONE_PREPASS, _K2B_TWO_PREPASSES)],
}
# k1_bf16_res_tap2's products: a chunk of taps 0 and 1 of a WaveNet block
# (`SplitTaps`) runs on the conv columns of each 64-column group alone
_CONV_ONLY = r"""template <class L>
__device__ __forceinline__ bool conv_only(const L&, int) { return false; }
__device__ __forceinline__ bool conv_only(const SplitTaps& ld, int kc) {
  return kc % (3 * ld.w / kKC) * kKC < 2 * ld.w;
}

// ---- the kernel -----------------------------------------------------------
"""
_LANE_GROUP = "constexpr int kLaneGroup = 4;"
_GATE = ("        const float v0 = tanhf(y0) * sigmoid(y0) + acc[j + 4][2 * r] + rbc.x;\n"
         "        const float v1 = tanhf(y1) * sigmoid(y1) + acc[j + 4][2 * r + 1] + rbc.y;\n")
_NO_GATE = ("        const float v0 = acc[j][2 * r] + acc[j + 4][2 * r];\n"
            "        const float v1 = acc[j][2 * r + 1] + acc[j + 4][2 * r + 1];\n")
# the gate's bias and FiLM: staged in shared memory when f32 (one part, and
# K1 mixed), read from device memory when bf16
_GATE_LOADS = ("      float2 cbc, rbc, gamma, beta;\n"
               "      if constexpr (kStaged) {\n"
               "        cbc = ld_shared2(params + 4 * cc);\n"
               "        rbc = ld_shared2(params + 4 * (kCols + cc));\n"
               "        gamma = ld_shared2(params + 4 * (2 * kCols + cc));\n"
               "        beta = ld_shared2(params + 4 * (3 * kCols + cc));\n"
               "      } else {\n"
               "        cbc = load2(cbl + c);\n"
               "        rbc = load2(rbl + c);\n"
               "        gamma = load2(f + c);\n"
               "        beta = load2(f + w + c);\n"
               "      }\n")
_PLANE_STORES = "      for (int b = 0; b < boxes && c0 + 64 * b < w; ++b)\n"
_WAVE_SHAPE = "  const bgemm::Shape sh = bgemm::choose("
_MMA = ("#pragma unroll\n    for (int ks = 0; ks < kKC / 16; ++ks)\n"
        "      mma<BN>(acc, sm90::desc(a_at + 32 * ks), sm90::desc(b_at + 32 * ks));\n")
WAVENET_BF16_VARIANTS = {
    "k1_bf16_res_tap2": [
        (BF16_CORE, "// ---- the kernel -----------------------------------------------------------\n",
         _CONV_ONLY),
        (BF16_CORE, _MMA,
         "    if (conv_only(ld, kc)) {\n#pragma unroll\n      for (int ks = 0; ks < kKC / 16; ++ks)\n"
         "#pragma unroll\n        for (int g = 0; g < BN / 64; ++g)\n"
         "          sm90::wgmma_ss_n32(*reinterpret_cast<float(*)[4][4]>(&acc[8 * g]),\n"
         "                             sm90::desc(a_at + 32 * ks),\n"
         "                             sm90::desc(b_at + g * 64 * sm90::kPanelRowBytes + 32 * ks), 1);\n"
         "    } else {\n" + _MMA + "    }\n")],
    "k1b_bf16_one_lane": [("wavenet_lane.cu", _LANE_GROUP, "constexpr int kLaneGroup = 1;")],
    "k1b_bf16_two_lanes": [("wavenet_lane.cu", _LANE_GROUP, "constexpr int kLaneGroup = 2;")],
    "k1_bf16_no_pdl": [(BF16_CORE, _PDL, _NO_PDL)],
    "k1_bf16_no_gate": [(BF16_CORE, _GATE, _NO_GATE)],
    "k1_bf16_no_stores": [(BF16_CORE, _PLANE_STORES,
                           "      for (int b = 0; b < 0; ++b)\n")],
    "k1_bf16_tile_64x128": [
        (BF16_CORE, "  if (s.bm == 128) return go(Int<128>{}, Int<128>{});\n",
         "  if (s.bm == 128) return go(Int<128>{}, Int<128>{});\n"
         "  if (s.bn == 128) return go(Int<64>{}, Int<128>{});\n"),
        ("wavenet.cu", _WAVE_SHAPE, "  const bgemm::Shape sh = bgemm::Shape{64, 128, 2, 1.0f};  // "),
        ("wavenet_lane.cu", _WAVE_SHAPE,
         "  const bgemm::Shape sh = bgemm::Shape{64, 128, 2, 1.0f};  // ")],
    "k1_bf16_no_shift": [(BF16_CORE, "    c[1] = t0 - ((2 - tap) << (lane0 + lane));\n",
                          "    c[1] = t0;\n")],
    "bf16_gate_no_clobber": [(BF16_CORE, "\"r\"(pack_bf16x2(p[0][q], p[1][q]))\n"
                                         "                   : \"memory\");",
                              "\"r\"(pack_bf16x2(p[0][q], p[1][q])));")],
    "bf16_gate_no_loads": [(BF16_CORE, _GATE_LOADS,
                            "      const float2 cbc = make_float2(0.1f, 0.2f), rbc = cbc, "
                            "gamma = make_float2(1.0f, 1.1f), beta = cbc;\n")],
    "bf16mm_gate_loads": [(BF16_CORE, "    if constexpr (kStaged) {\n"
                                      "      for (int t = 32 * warp + lane;",
                           "    if constexpr (false) {\n"
                           "      for (int t = 32 * warp + lane;"),
                          (BF16_CORE, _GATE_LOADS,
                           "      const float2 cbc = load2(cbl + c), rbc = load2(rbl + c), "
                           "gamma = load2(f + c),\n"
                           "                   beta = load2(f + w + c);\n"),
                          (BF16_CORE, "  __device__ static void st_shared(",
                           "  __device__ static float2 load2(const float* p) {\n"
                           "    return *reinterpret_cast<const float2*>(p);\n  }\n"
                           "  __device__ static void st_shared(")],
    "k1b_bf16_tile_128x256": [("wavenet_lane.cu", _WAVE_SHAPE,
                               "  const bgemm::Shape sh = bgemm::kShapes[0];  // ")],
    "k1b_bf16_tile_128x128": [("wavenet_lane.cu", _WAVE_SHAPE,
                               "  const bgemm::Shape sh = bgemm::kShapes[1];  // ")],
}
# the sources each set of variants builds (K2's and K2b's attention core is K4)
BF16_SOURCES = ("ff_block.cu", "attn_block.cu", "cross_attn_block.cu", "flash_fwd.cu",
                "flash_fwd_bf16.cu", "runtime.cu")
SOURCES = (*BF16_SOURCES, "wavenet.cu", "wavenet_lane.cu")
# (name, b, n, dm)
SHAPES = (("flagship", 4, 1024, 128), ("conditional", 8, 512, 128), ("long", 1, 9000, 128),
          ("scaled", 16, 1024, 512))
# (name, b, n, route) of the WaveNet body at d 128, 4 x 8: K1 at the
# flagship and n4500, K1b at n9000
WAVENET_SHAPES = (("flagship", 4, 1024, "stack"), ("long", 1, 4500, "stack"),
                  ("long", 1, 9000, "lanes"))
# (name, b, n, d) of K1b's `bf16_matmul`, 4 x 8: the d-512 probe's and the
# long form's lanes
BF16MM_SHAPES = (("probe", 16, 1024, 512), ("long", 1, 9000, 128))


# (name, b, n, dm, blocks) of K2 and K3 in bf16: the bf16 flagship's, the
# served request's, the scaled model's, and K3 on the n-9000 long form
BF16_SHAPES = (("flagship", 4, 1024, 128, ("ff_block", "attn_block")),
               ("served", 2, 512, 128, ("ff_block", "attn_block")),
               ("scaled", 16, 1024, 512, ("ff_block", "attn_block")),
               ("long", 1, 9000, 128, ("ff_block",)))
ENTRIES = ("ns2_ff_block", "ns2_attn_block", "ns2_ff_block_bf16", "ns2_attn_block_bf16",
           "ns2_cross_attn_block_mixed")
WAVENET_ENTRIES = ("ns2_wavenet_body", "ns2_wavenet_lanes", "ns2_wavenet_body_bf16",
                   "ns2_wavenet_lanes_bf16", "ns2_wavenet_lanes_bf16mm", "ns2_wavenet_body_mixed")
# K1's mixed entry (f32 x against bf16 weights): AMP training's shape
MIXED_SHAPES = (("amp", 16, 150, 128),)
WAVENET_SOURCES = ("wavenet.cu", "wavenet_lane.cu", "runtime.cu")


def build_variants(_build, variants: dict, sources: tuple) -> dict:
    """Each variant's copy of csrc/ with its edits, ``sources`` built into
    one library (all variants at once); its ptxas registers (and spills) of
    the cores' kernels."""
    work_name = "gemm_variants_wavenet" if sources == WAVENET_SOURCES else "gemm_variants"
    work = _build.BUILD_DIR / work_name
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    for name, edits in variants.items():
        d = work / name
        shutil.copytree(_build.CSRC, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise AssertionError(f"variant {name}: {old[:40]!r} not in {f}")
            (d / f).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             *(str(d / f) for f in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate(timeout=900)[0]
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out[-3000:]}")
        regs, in_core, spill = [], False, ""
        for line in out.splitlines():
            if "warning" in line or "C75" in line:
                print(f"variant {name}: {line.strip()[:300]}", flush=True)
            if "Compiling entry" in line:
                in_core, spill = "gemm_kernel" in line and (
                    sources != WAVENET_SOURCES or "SplitTaps" in line), ""
            elif in_core and "spill stores" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spill = " (" + line.split("info    :")[-1].strip() + ")"
            elif in_core and "registers" in line:
                regs.append(line.split("info    :")[-1].strip() + spill)
                in_core = False
        print(f"variant {name}: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        entries = (ENTRIES if "ff_block.cu" in sources else ()) + (
            WAVENET_ENTRIES if "wavenet.cu" in sources else ())
        for fn in entries:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variants(cs, libs, label: str, entry: str, args, out, ref, base) -> None:
    """Each variant's entry point on ``args`` (writing ``out``): its error
    relative to the largest entry of ref - base, and its time in two
    rounds, the variants in turn."""
    import torch

    times, errs = {}, {}
    for name, lib in libs.items():
        code = getattr(lib, entry)(*args)
        torch.cuda.synchronize()
        if code:
            print(f"{label}: variant {name} returned CUDA error {code}", flush=True)
            continue
        diff = (out.float() - ref.float()).abs().max()
        errs[name] = (diff / (ref.float() - base).abs().max()).item()
    for _ in range(2):  # two rounds, variants in turn
        for name, lib in libs.items():
            if name not in errs:
                continue
            fn = getattr(lib, entry)
            times.setdefault(name, []).append(cs.cuda_ms(lambda: fn(*args), reps=10))
    print(f"{label} ms (two rounds) and error relative to the largest entry of the reference: "
          + "; ".join(f"{name} {t[0]:.4f} {t[1]:.4f} err {errs[name]:.1e}"
                      for name, t in times.items()), flush=True)


def f32_cores(cs, libs) -> None:
    """The split-TF32 core's variants: K3 and K2 at SHAPES, K1 and K1b at
    WAVENET_SHAPES, f32."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for label, b, n, dm in SHAPES:
        x, gamma, beta, wq, wkv, wo = cs.attn_inputs(gen, b, n, dm)
        inner = int(dm * 8 / 3)
        rn = cs._randn(gen)
        w1, b1 = rn(dm, 2 * inner, scale=dm**-0.5), rn(2 * inner, scale=0.1)
        wc, bc = rn(3, inner, inner, scale=(3 * inner) ** -0.5), rn(inner, scale=0.1)
        w2, b2 = rn(inner, dm, scale=inner**-0.5), rn(dm, scale=0.1)
        ff_ref = fk.ff_block_plain(x, gamma, beta, w1, b1, wc, bc, w2, b2)
        heads = ak.split_heads(wq, wkv, wo, cs.HEADS, cs.DIM_HEAD)
        attn_ref = ak.attn_block_torch(x, gamma, beta, *heads, scale=cs.DIM_HEAD**-0.5)
        wt = fk.pack_ff_weights(w1, b1, wc, bc, w2)
        bt_qkv, bt_out = ak.pack_attn_weights(wq, wkv, wo, cs.HEADS, cs.DIM_HEAD)
        scratch = torch.empty((2, b * n, wt.ip), device="cuda")
        qkv = torch.empty((3, b, cs.HEADS, n, 64), device="cuda")
        o = torch.empty((b, cs.HEADS, n, 64), device="cuda")
        out = torch.empty_like(x)
        ff_args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.geglu.data_ptr(),
                   wt.b_val.data_ptr(), wt.b_gate.data_ptr(), wt.conv.data_ptr(),
                   wt.bc.data_ptr(), wt.out.data_ptr(), b2.data_ptr(), scratch[0].data_ptr(),
                   scratch[1].data_ptr(), out.data_ptr(), b, n, dm, wt.ip, stream)
        attn_args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bt_qkv.data_ptr(),
                     bt_out.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(), b, n, dm,
                     cs.HEADS, 64, cs.DIM_HEAD**-0.5, 1, stream)
        for block, entry, args, ref in (("K3", "ns2_ff_block", ff_args, ff_ref),
                                        ("K2", "ns2_attn_block", attn_args, attn_ref)):
            time_variants(cs, libs, f"{block} {label} [{b},{n},{dm}]", entry, args, out, ref, x)
        del x, gamma, beta, wq, wkv, wo, w1, b1, wc, bc, w2, b2, wt, scratch, qkv, o, out
        torch.cuda.empty_cache()

    for label, b, n, route in WAVENET_SHAPES:
        (x, *weights, film), _ = cs.wavenet_inputs(gen, b, n, cs.DIM)
        ref = (wk.wavenet_body_lanes_torch if route == "lanes" else wk.wavenet_body_torch)(
            x, *weights, film)
        wt = wk.pack_wavenet_weights(*weights, route)
        L = cs.WAVENET_LAYERS
        state = torch.empty((2, b * n * cs.DIM * (1 if route == "lanes" else L)), device="cuda")
        out = torch.empty_like(x)
        args = (x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
                wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(), state[0].data_ptr(),
                state[1].data_ptr(), out.data_ptr(), b, n, cs.DIM, cs.WAVENET_STACKS, L, stream)
        entry = "ns2_wavenet_lanes" if route == "lanes" else "ns2_wavenet_body"
        name = "K1b" if route == "lanes" else "K1"
        time_variants(cs, libs, f"{name} {label} [{b},{n},{cs.DIM}]", entry, args, out, ref, 0.0)
        del x, weights, film, ref, wt, state, out
        torch.cuda.empty_cache()


def _device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """torch.profiler's device time a call, by kernel name, over ``calls``
    calls of ``fn`` (after one warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def bf16_cores(cs, libs) -> None:
    """The bf16 core's variants: K3 and K2 bf16 at BF16_SHAPES; base's K3
    launches by kernel beside torch.matmul in bf16 at their M x N x K; K2b
    mixed at AMP's shape and AMP_K2B_RAGGED, with its launches by kernel."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 200)
    for label, b, n, dm, blocks in BF16_SHAPES:
        for name, _, plain, _, work, residual, c_entry in cs.bf16_block_cases(gen, b, n, dm,
                                                                                blocks):
            ref = plain()
            out = c_entry()
            block = "K3" if name == "ff_block" else "K2"
            time_variants(cs, libs, f"{block} bf16 {label} [{b},{n},{dm}] (bound "
                                    f"{work['bound_ms']:.4f} ms)", f"ns2_{name}_bf16",
                          c_entry.args, out, ref, residual.float())
            if name == "ff_block":
                ip = c_entry.keep[0].ip
                gemms = (("::Rows, ns2::bgemm::Geglu", 2 * ip, dm),
                         ("::TapRows, ns2::bgemm::Store", ip, 3 * ip),
                         ("::Rows, ns2::bgemm::Store", dm, ip))
            else:
                hd = cs.HEADS * cs.DIM_HEAD
                gemms = (("::Rows, ns2::bgemm::QkvScatter", 3 * hd, dm),
                         ("::HeadRows, ns2::bgemm::Store", dm, hd))
            yardstick(cs, c_entry, b * n, gemms, f"{block} bf16 {label} [{b},{n},{dm}]")
            del ref, out, c_entry
        torch.cuda.empty_cache()
    # K2b mixed (f32 x and ctx against bf16 weights): AMP's step and a ragged
    # shape, (b, n, dm, dc, heads, dim_head)
    for b, n, dm, dc, heads, dim_head in ((16, 160, 128, 128, 8, 64), cs.AMP_K2B_RAGGED):
        args = cs.cross_inputs(gen, b, n, cs.NUM_LATENTS, dm, dc, heads, dim_head)
        acts, weights = args[:4], cs._bf16(*args[4:])
        cfg = dict(heads=heads, dim_head=dim_head, scale=dim_head**-0.5)
        ref = ak._cross_plain(*acts, *(w.float() for w in weights), **cfg)
        c_entry = cs.cross_c_entry(*acts, *weights, **cfg)
        out = c_entry()
        time_variants(cs, libs, f"K2b mixed [{b},{n},{dm}] ctx [{b},{cs.NUM_LATENTS},{dc}] "
                                f"{heads}x{dim_head}", "ns2_cross_attn_block_mixed",
                      c_entry.args, out, ref, acts[0])
        for variant in ("base", "k2b_mixed_two_prepasses"):
            if variant in libs:
                fn = getattr(libs[variant], "ns2_cross_attn_block_mixed")
                by_kernel = _device_ms_by_kernel(lambda: fn(*c_entry.args))
                print(f"K2b mixed [{b},{n},{dm}] {variant} launches: " + "; ".join(
                    f"{k[:80]} {ms:.4f} ms" for k, ms in by_kernel.items()), flush=True)
        del args, acts, weights, ref, c_entry, out
        torch.cuda.empty_cache()


def yardstick(cs, call, m: int, gemms, label: str) -> None:
    """The device time of each launch of ``call`` (torch.profiler): each
    GEMM (named by its loader and epilogue) beside torch.matmul in bf16 at
    its M x N x K (CUDA events, median of 20) and both rates; the other
    kernels (the norm pre-pass, K2's attention core) by name."""
    import torch

    by_kernel = _device_ms_by_kernel(call)
    parts = [f"{name[:48]} {ms:.4f} ms" for name, ms in by_kernel.items()
             if "bf16_gemm_kernel" not in name]
    for key, n, k in gemms:
        ms = sum(t for name, t in by_kernel.items()
                 if "bf16_gemm_kernel" in name and key in name)
        a = torch.randn(m, k, device="cuda").bfloat16()
        w = torch.randn(k, n, device="cuda").bfloat16()
        lib_ms = cs.cuda_ms(lambda: torch.matmul(a, w))
        flop = 2 * m * n * k
        parts.append(f"{key.strip(':').replace(', ns2::bgemm::', '+')} M {m} N {n} K {k}: core "
                     f"{ms:.4f} ms ({flop / ms / 1e9:.0f} TFLOP/s), torch.matmul bf16 "
                     f"{lib_ms:.4f} ms ({flop / lib_ms / 1e9:.0f} TFLOP/s)")
        del a, w
    print(f"{label} launches: " + "; ".join(parts), flush=True)


def wavenet_bf16(cs, libs) -> None:
    """The bf16 WaveNet variants: K1 and K1b bf16 at WAVENET_SHAPES and K1b's
    `bf16_matmul` at BF16MM_SHAPES against their plain versions, their C
    entry points in turns; base's launches by kernel (device time a
    call)."""
    import torch

    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 207)
    S, L = cs.WAVENET_STACKS, cs.WAVENET_LAYERS
    for label, b, n, route in WAVENET_SHAPES:
        x, *weights, film = cs._bf16(*cs.wavenet_inputs(gen, b, n, cs.DIM, S, L)[0])
        plain = wk.wavenet_body_lanes_bf16_torch if route == "lanes" else wk.wavenet_body_bf16_torch
        ref = plain(x, *weights, film)
        wt = wk.pack_wavenet_weights(*weights, route)
        state = wk.scratch(b, n, wt.d, L, route, torch.bfloat16, x.device)
        out = torch.empty_like(x)
        args = (x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
                wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(),
                *(t.data_ptr() for t in state), out.data_ptr(), b, n, cs.DIM, S, L, stream)
        entry = "ns2_wavenet_lanes_bf16" if route == "lanes" else "ns2_wavenet_body_bf16"
        name = "K1b" if route == "lanes" else "K1"
        time_variants(cs, libs, f"{name} bf16 {label} [{b},{n},{cs.DIM}]", entry, args, out, ref,
                      0.0)
        # launches by kernel; with programmatic dependent launches a kernel's
        # device time includes its wait for the one before (k1_bf16_no_pdl's
        # are each kernel's own)
        for variant in ("base", "k1_bf16_no_pdl"):
            if variant in libs:
                fn = getattr(libs[variant], entry)
                by_kernel = _device_ms_by_kernel(lambda: fn(*args))
                print(f"{name} bf16 {label} [{b},{n},{cs.DIM}] {variant} launches: " + "; ".join(
                    f"{k.split('<')[-1][:70]} {ms:.4f} ms" for k, ms in by_kernel.items()),
                    flush=True)
        del x, weights, film, ref, wt, state, out
        torch.cuda.empty_cache()
    for label, b, n, d in BF16MM_SHAPES:
        x, *weights, film = cs.wavenet_inputs(gen, b, n, d, S, L)[0]
        ref = wk.wavenet_body_lanes_bf16mm_torch(x, *weights, film)
        wt = wk.pack_wavenet_weights(*weights, "lanes", fmt="bf16_sw128")
        state = wk.scratch(b, n, wt.d, L, "bf16mm", torch.float32, x.device)
        out = torch.empty_like(x)
        args = (x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
                wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(),
                *(t.data_ptr() for t in state), out.data_ptr(), b, n, d, S, L, stream)
        entry = "ns2_wavenet_lanes_bf16mm"
        time_variants(cs, libs, f"K1b bf16_matmul {label} [{b},{n},{d}]", entry, args, out, ref,
                      0.0)
        fn = getattr(libs["base"], entry)
        by_kernel = _device_ms_by_kernel(lambda: fn(*args))
        print(f"K1b bf16_matmul {label} [{b},{n},{d}] base launches: " + "; ".join(
            f"{k[k.find('<'):][:90]} {ms:.4f} ms" for k, ms in by_kernel.items()), flush=True)
        del x, weights, film, ref, wt, state, out
        torch.cuda.empty_cache()
    for label, b, n, d in MIXED_SHAPES:
        wn = cs.wavenet_inputs(gen, b, n, d, S, L)[0]
        x, weights, film = wn[0], cs._bf16(*wn[1:7]), wn[7]
        ref = wk.wavenet_body_torch(x, *(w.float() for w in weights), film)
        wt = wk.pack_wavenet_weights(*weights, "stack", torch.float32, "bf16_sw128")
        state = wk.scratch(b, n, wt.d, L, "stack", torch.float32, x.device, wt.fmt)
        out = torch.empty_like(x)
        args = (x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
                wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(),
                *(t.data_ptr() for t in state), out.data_ptr(), b, n, d, S, L, stream)
        entry = "ns2_wavenet_body_mixed"
        time_variants(cs, libs, f"K1 mixed {label} [{b},{n},{d}]", entry, args, out, ref, 0.0)
        for variant in ("base", "k1_bf16_no_pdl"):
            if variant in libs:
                fn = getattr(libs[variant], entry)
                by_kernel = _device_ms_by_kernel(lambda: fn(*args))
                print(f"K1 mixed {label} [{b},{n},{d}] {variant} launches: " + "; ".join(
                    f"{k[k.find('<'):][:90]} {ms:.4f} ms" for k, ms in by_kernel.items()),
                    flush=True)
        del wn, x, weights, film, ref, wt, state, out
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from naturalspeech2_tpu_torch import _build

    names = sys.argv[1:]
    every = {**VARIANTS, **BF16_VARIANTS, **WAVENET_BF16_VARIANTS}
    unknown = [v for v in names if v not in every]
    if unknown:
        print(f"gemm_variants: no variant {unknown}; variants: {list(every)}", file=sys.stderr)
        return 2
    chosen = {"base": [], **{v: every[v] for v in (names or every) if v != "base"}}
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase1_card_and_build()
    run_f32 = not names or any(v in VARIANTS and v != "base" for v in names)
    run_bf16 = not names or any(v in BF16_VARIANTS for v in names)
    run_wavenet = not names or any(v in WAVENET_BF16_VARIANTS for v in names)
    cores = {v: e for v, e in chosen.items() if v not in WAVENET_BF16_VARIANTS}
    if run_f32 or run_bf16:
        libs = build_variants(_build, cores, SOURCES if run_f32 else BF16_SOURCES)
        if run_f32:
            f32_cores(cs, {v: lib for v, lib in libs.items() if v in VARIANTS})
        if run_bf16:
            bf16_cores(cs, {v: lib for v, lib in libs.items()
                            if v == "base" or v in BF16_VARIANTS})
    if run_wavenet:
        wavenet = {v: e for v, e in chosen.items() if v == "base" or v in WAVENET_BF16_VARIANTS}
        wavenet_bf16(cs, build_variants(_build, wavenet, WAVENET_SOURCES))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
