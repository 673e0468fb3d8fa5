#!/usr/bin/env python3
"""Where the time of the fused blocks K2 and K3 goes, on one NVIDIA GPU.

    python3 gemm_variants.py

Builds the port's kernel library (as `chip_smoke.py` does), then builds
variants of the split-TF32 GEMM core `csrc/gemm_tf32x3.cuh` that K2
(`csrc/attn_block.cu`) and K3 (`csrc/ff_block.cu`) run on, each with one
design choice changed or one part of the work taken out, and times the
blocks' C entry points side by side (CUDA events, without the Python
wrappers; the weights packed once), with each variant's error against the
plain versions relative to the largest entry of y - x:

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
}
# (name, b, n, dm)
SHAPES = (("flagship", 4, 1024, 128), ("conditional", 8, 512, 128), ("long", 1, 9000, 128),
          ("scaled", 16, 1024, 512))


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
             str(d / "runtime.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate(timeout=900)[0]
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out[-3000:]}")
        regs, in_core = [], False
        for line in out.splitlines():
            if "Compiling entry" in line:
                in_core = "gemm_kernel" in line
            elif in_core and "registers" in line:
                regs.append(line.split("info    :")[-1].strip())
                in_core = False
        print(f"variant {name}: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        for fn in ("ns2_ff_block", "ns2_attn_block"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk

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
                     cs.HEADS, cs.DIM_HEAD**-0.5, stream)
        for block, entry, args, ref in (("K3", "ns2_ff_block", ff_args, ff_ref),
                                        ("K2", "ns2_attn_block", attn_args, attn_ref)):
            times, errs = {}, {}
            for name, lib in libs.items():
                code = getattr(lib, entry)(*args)
                torch.cuda.synchronize()
                if code:
                    print(f"{block} {label}: variant {name} returned CUDA error {code}", flush=True)
                    continue
                errs[name] = ((out - ref).abs().max() / (ref - x).abs().max()).item()
            for _ in range(2):  # two rounds, variants in turn
                for name, lib in libs.items():
                    if name not in errs:
                        continue
                    fn = getattr(lib, entry)
                    times.setdefault(name, []).append(cs.cuda_ms(lambda: fn(*args), reps=10))
            print(f"{block} {label} [{b},{n},{dm}] ms (two rounds) and error relative to max "
                  f"|y - x|: " + "; ".join(f"{name} {t[0]:.4f} {t[1]:.4f} err {errs[name]:.1e}"
                                          for name, t in times.items()), flush=True)
        del x, gamma, beta, wq, wkv, wo, w1, b1, wc, bc, w2, b2, wt, scratch, qkv, o, out
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
