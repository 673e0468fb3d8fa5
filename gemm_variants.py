#!/usr/bin/env python3
"""Where the time of the kernels on the GEMM core goes, on one NVIDIA GPU.

    python3 gemm_variants.py

Builds the port's kernel library (as `chip_smoke.py` does), then builds
variants of the split-TF32 GEMM core `csrc/gemm_tf32x3.cuh` that K1
(`csrc/wavenet.cu`), K1b (`csrc/wavenet_lane.cu`), K2
(`csrc/attn_block.cu`) and K3 (`csrc/ff_block.cu`) run on, each with one
design choice changed or one part of the work taken out, and times the
kernels' C entry points side by side (CUDA events, without the Python
wrappers; the weights packed once), with each variant's error against the
plain versions relative to the largest entry of y - x (K2, K3) or of the
output (K1, K1b):

  base         the core as committed
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

Exits non-zero without a CUDA device. Not part of the smoke run.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

CORE = "gemm_tf32x3.cuh"
VARIANTS = {
    "base": [],
    "one_wg": [(CORE, "  if (shared >= sm_count())\n", "  if (false)\n")],
    "no_a_loads": [(CORE, "areg[i] = ld.get(4 * (cq + kLanes * i));",
                    "areg[i] = make_float4(c, i, 1.0f, 2.0f);")],
    "no_a_stores": [(CORE, "store_split4(sm.a[s][0], sm.a[s][1], kmajor<kBM>(sr, 4 * (cq + kLanes * i)), "
                           "areg[i]);",
                     "if (areg[i].x == 12345.0f) sm.a[s][0][i] = areg[i].y;")],
    "no_b_copies": [(CORE, "cp_async16(dst + e, src + e, true);", "(void)dst; (void)src;")],
    "one_pass": [(CORE, "      wgmma_ss_n64(small, a_hi, b_lo);\n"
                        "      wgmma_ss_n64(small, a_lo, b_hi);\n", "")],
    "no_products": [(CORE, "      wgmma_ss_n64(small, a_hi, b_lo);\n"
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
    "k1_wn1": [("wavenet.cu", "cudaError_t err = gemm::launch_wn<2>(",
                "cudaError_t err = gemm::launch_wn<1>("),
               ("wavenet_lane.cu", "cudaError_t err = gemm::launch_wn<2>(",
                "cudaError_t err = gemm::launch_wn<1>(")],
    "k1_wn2_x1": [(CORE, "WN == 1 ? 3 : (WN == 2 ? 2 : 1)", "WN == 1 ? 3 : 1")],
    "k1_wn3": [("wavenet.cu", "cudaError_t err = gemm::launch_wn<2>(",
                "cudaError_t err = gemm::launch(")],
}
# (name, b, n, dm)
SHAPES = (("flagship", 4, 1024, 128), ("conditional", 8, 512, 128), ("long", 1, 9000, 128),
          ("scaled", 16, 1024, 512))
# (name, b, n, route) of the WaveNet body at d 128, 4 x 8: K1 at the
# flagship and n4500, K1b at n9000
WAVENET_SHAPES = (("flagship", 4, 1024, "stack"), ("long", 1, 4500, "stack"),
                  ("long", 1, 9000, "lanes"))


def build_variants(_build) -> dict:
    work = _build.BUILD_DIR / "gemm_variants"
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    for name, edits in VARIANTS.items():
        d = work / name
        shutil.copytree(_build.CSRC, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise AssertionError(f"variant {name}: {old[:40]!r} not in {f}")
            (d / f).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "ff_block.cu"), str(d / "attn_block.cu"), str(d / "flash_fwd.cu"),
             str(d / "wavenet.cu"), str(d / "wavenet_lane.cu"), str(d / "runtime.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate(timeout=900)[0]
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out[-3000:]}")
        regs, in_core, spill = [], False, ""
        for line in out.splitlines():
            if "Compiling entry" in line:
                in_core, spill = "gemm_kernel" in line, ""
            elif in_core and "spill stores" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spill = " (" + line.split("info    :")[-1].strip() + ")"
            elif in_core and "registers" in line:
                regs.append(line.split("info    :")[-1].strip() + spill)
                in_core = False
        print(f"variant {name}: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        for fn in ("ns2_ff_block", "ns2_attn_block", "ns2_wavenet_body", "ns2_wavenet_lanes"):
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
        errs[name] = ((out - ref).abs().max() / (ref - base).abs().max()).item()
    for _ in range(2):  # two rounds, variants in turn
        for name, lib in libs.items():
            if name not in errs:
                continue
            fn = getattr(lib, entry)
            times.setdefault(name, []).append(cs.cuda_ms(lambda: fn(*args), reps=10))
    print(f"{label} ms (two rounds) and error relative to the largest entry of the reference: "
          + "; ".join(f"{name} {t[0]:.4f} {t[1]:.4f} err {errs[name]:.1e}"
                      for name, t in times.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase1_card_and_build()
    libs = build_variants(_build)
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
                     cs.HEADS, cs.DIM_HEAD, cs.DIM_HEAD**-0.5, stream)
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
