#!/usr/bin/env python3
"""Where the flash-attention kernels' time goes, on one NVIDIA GPU.

    python3 flash_variants.py [variant ...]

Builds the port's kernel library (as `chip_smoke.py` does), prints the SASS
opcode counts of the K4 and K5 kernels (f32 and bf16), then builds variants
of `csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`, `csrc/flash_fwd_bf16.cu` and
`csrc/flash_bwd_bf16.cu`, each with one design choice undone or one part
of the work taken out, and times them side by side (CUDA events, the C
entry points called directly, without the Python wrappers), the f32
entry points at SHAPES and the bf16 ones at BF16_SHAPES, with each
variant's error against the plain versions:

  base            the kernels as committed
  k4_3blocks      K4 held to 168 registers, three blocks an SM
  k5_walk64       K5's two kernels walk 64 rows a tile (two blocks an SM)
  dq64, dkv64     only K5's dq or dk/dv kernel walks 64 rows
  expf            e^x by expf instead of the special-function unit
  one_pass        one TF32 pass per product (hi·hi): fast and wrong
  one_acc         the small terms of S and dP into the large ones'
                  accumulator, and K5's tile products straight into its
                  sums: the tensor cores' truncating adds pile up
  bf16_k4_stages3, bf16_k4_stages2
                  K4 bf16's ring of K and V tiles 3 or 2 stages deep (4 at
                  head 64)
  bf16_k4_groups2, bf16_k4_groups3
                  K4 bf16 at head 64 always with two consumer warpgroups
                  (128 query rows a block) or always with three (192), where
                  it takes three only on long non-causal query runs
  bf16_k5_stages3 K5 bf16's rings 3 stages deep (4)

With variant names, builds and times only those beside base. Exits
non-zero without a CUDA device. Not part of the smoke run.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from collections import Counter

VARIANTS = {
    "base": [],
    "k4_3blocks": [("flash_fwd.cu", "__launch_bounds__(kFlashThreads, D == 64 ? 2 : 1)",
                    "__launch_bounds__(kFlashThreads, D == 64 ? 3 : 1)")],
    "k5_walk64": [("flash_bwd.cu", "constexpr int kDqWalk = 32;", "constexpr int kDqWalk = 64;"),
                  ("flash_bwd.cu", "constexpr int kDkvWalk = 32;", "constexpr int kDkvWalk = 64;")],
    "dq64": [("flash_bwd.cu", "constexpr int kDqWalk = 32;", "constexpr int kDqWalk = 64;")],
    "dkv64": [("flash_bwd.cu", "constexpr int kDkvWalk = 32;", "constexpr int kDkvWalk = 64;")],
    "expf": [("flash.cuh", "return exp2f(x * 1.4426950408889634f);", "return expf(x);")],
    "one_pass": [("flash.cuh", "  mma_tf32(d, a_hi, b_lo);\n  mma_tf32(d, a_lo, b_hi);\n", ""),
                 ("flash.cuh", "          mma_tf32(small[j + i], a_hi, bl);\n"
                               "          mma_tf32(small[j + i], a_lo, bh);\n", ""),
                 ("flash_fwd.cu", "    wgmma_ss_n32(small, qa_hi, kb_lo);\n"
                                  "    wgmma_ss_n32(small, qa_lo, kb_hi);\n", ""),
                 ("flash_fwd.cu", "      wgmma_rs_n64(part, pa_hi[ks], vb_lo);\n"
                                  "      wgmma_rs_n64(part, pa_lo[ks], vb_hi);\n", "")],
    "one_acc": [("flash.cuh", "          mma_tf32(small[j + i], a_hi, bl);\n"
                              "          mma_tf32(small[j + i], a_lo, bh);\n",
                 "          mma_tf32(d[j + i], a_hi, bl);\n          mma_tf32(d[j + i], a_lo, bh);\n"),
                ("flash.cuh", "mma_split(part[j], a_hi, a_lo, b_hi, b_lo);",
                 "mma_split(acc[c0 + j], a_hi, a_lo, b_hi, b_lo);"),
                ("flash_fwd.cu", "    wgmma_ss_n32(small, qa_hi, kb_lo);\n"
                                 "    wgmma_ss_n32(small, qa_lo, kb_hi);\n",
                 "    wgmma_ss_n32(s, qa_hi, kb_lo);\n    wgmma_ss_n32(s, qa_lo, kb_hi);\n")],
    "bf16_k4_stages3": [("flash_fwd_bf16.cu", "kStages = D == 64 ? 4 : 3;",
                         "kStages = D == 64 ? 3 : 3;")],
    "bf16_k4_stages2": [("flash_fwd_bf16.cu", "kStages = D == 64 ? 4 : 3;",
                         "kStages = D == 64 ? 2 : 3;")],
    "bf16_k4_groups2": [("flash_fwd_bf16.cu", "const bool three = !causal && n_q > 2048;",
                         "const bool three = false;")],
    "bf16_k4_groups3": [("flash_fwd_bf16.cu", "const bool three = !causal && n_q > 2048;",
                         "const bool three = true;")],
    "bf16_k5_stages3": [("flash_bwd_bf16.cu", "constexpr int kStages = 4;",
                         "constexpr int kStages = 3;")],
}
# (b, h, n, with K5)
SHAPES = ((16, 8, 150, True), (4, 8, 1024, True), (1, 8, 4500, False), (1, 8, 9000, False),
          (8, 8, 32, False), (4, 8, 102, False))
# bf16: (b, h, n, causal and masked, with K5); the non-causal n 1024-3072
# rows place K4 bf16's 2,048-query switch to three consumer warpgroups
BF16_SHAPES = ((1, 8, 9000, False, False), (1, 8, 4500, False, True),
               (4, 8, 1024, True, True), (16, 8, 150, False, True),
               (4, 8, 1024, False, False), (1, 8, 1536, False, False),
               (1, 8, 2048, False, False), (1, 8, 2560, False, False),
               (1, 8, 3072, False, False))
ENTRIES = ("ns2_flash_fwd", "ns2_flash_bwd", "ns2_flash_fwd_bf16", "ns2_flash_bwd_bf16")
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "flash_fwd_bf16.cu", "flash_bwd_bf16.cu",
           "runtime.cu")


def sass_counts(lib_path) -> None:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            counts[fn][m.group(2).split(".")[0]] += 1
    for fn, c in counts.items():
        if "flash" in fn:
            print(f"SASS {fn[:80]}: {sum(c.values())} instructions (static); "
                  + ", ".join(f"{k} {v}" for k, v in c.most_common(12)), flush=True)


def build_variants(_build, names) -> dict:
    work = _build.BUILD_DIR / "variants"
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    for name, edits in VARIANTS.items():
        if names and name != "base" and name not in names:
            continue
        d = work / name
        shutil.copytree(_build.CSRC, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise AssertionError(f"variant {name}: {old[:40]!r} not in {f}")
            (d / f).write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             *(str(d / f) for f in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate(timeout=900)[0]
        if p.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{out[-3000:]}")
        regs = [l.split("info    :")[-1].strip() for l in out.splitlines() if "registers" in l]
        print(f"variant {name}: {' | '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_bf16(cs, fa, _build, libs, gen, stream, b, h, n, causal, backward) -> None:
    """The bf16 entry points of every variant at [b, h, n, 64], causal and
    masked when ``causal``: two rounds, variants in turn, and each
    variant's error relative to the plain bf16 version's largest entry."""
    import torch

    q, k, v, do = (torch.randn(b, h, n, 64, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    mask = torch.rand(b, n, generator=gen, device="cuda") > 0.2 if causal else None
    m8 = None if mask is None else mask.to(torch.uint8)
    mp = None if m8 is None else m8.data_ptr()
    o_ref, lse = fa.flash_forward_torch(q, k, v, mask, None, causal=causal, scale=0.125)
    refs = fa.flash_backward_torch(q, k, v, mask, None, lse, o_ref, do, causal=causal,
                                   scale=0.125) if backward else None
    o, lse_out = torch.empty_like(q), torch.empty(b, h, n, device="cuda")
    grads = [torch.empty_like(q) for _ in range(3)]
    delta = (do.float() * o_ref.float()).sum(-1)
    tail = (*fa._dropout_args(None, 0.0, n), stream)
    cases = [("K4 bf16", "ns2_flash_fwd_bf16", [o], [o_ref],
              (q.data_ptr(), k.data_ptr(), v.data_ptr(), mp, o.data_ptr(), lse_out.data_ptr(),
               b, h, n, n, 64, int(causal), 0.125, *tail))]
    if backward:
        cases.append(("K5 bf16", "ns2_flash_bwd_bf16", grads, refs,
                      (q.data_ptr(), k.data_ptr(), v.data_ptr(), mp, lse.data_ptr(),
                       delta.data_ptr(), do.data_ptr(), *(g.data_ptr() for g in grads), b, h, n,
                       n, 64, int(causal), 0.125, *tail)))
    for label, entry, outs, want, args in cases:
        times, errs = {}, {}
        for name, lib in libs.items():
            _build.check(getattr(lib, entry)(*args), entry)
            torch.cuda.synchronize()
            errs[name] = max(((x.float() - r.float()).abs().max() / r.float().abs().max()).item()
                             for x, r in zip(outs, want))
        for _ in range(2):
            for name, lib in libs.items():
                fn = getattr(lib, entry)
                times.setdefault(name, []).append(cs.cuda_ms(lambda: fn(*args)))
        print(f"{label} [{b},{h},{n},64]{' causal masked' if causal else ''} ms (two rounds) and "
              "max error relative to the largest entry: "
              + "; ".join(f"{name} {t[0]:.4f} {t[1]:.4f} err {errs[name]:.1e}"
                          for name, t in times.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(sys.argv[1:]) - set(VARIANTS)
    if unknown:
        print(f"flash_variants: no variant {sorted(unknown)}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase1_card_and_build()
    sass_counts(_build.BUILD_DIR / f"ns2_kernels_{_build._digest()}.so")
    libs = build_variants(_build, set(sys.argv[1:]))
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for b, h, n, backward in SHAPES:
        q, k, v, do = (torch.randn(b, h, n, 64, generator=gen, device="cuda") for _ in range(4))
        o_ref, lse_ref = fa.flash_forward_torch(q, k, v, None, None, causal=False, scale=0.125)
        refs = fa.flash_backward_torch(q, k, v, None, None, lse_ref, o_ref, do, causal=False,
                                       scale=0.125) if backward else None
        delta = (do * o_ref).sum(-1)
        o, lse = torch.empty_like(q), torch.empty(b, h, n, device="cuda")
        grads = [torch.empty_like(q) for _ in range(3)]
        tail = (*fa._dropout_args(None, 0.0, n), stream)
        fwd = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), lse.data_ptr(),
               b, h, n, n, 64, 0, 0.125, *tail)
        bwd = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, lse_ref.data_ptr(),
               delta.data_ptr(), do.data_ptr(), *(g.data_ptr() for g in grads), b, h, n, n, 64, 0,
               0.125, *tail)
        cases = [("K4", "ns2_flash_fwd", fwd)]
        if backward:
            cases.append(("K5", "ns2_flash_bwd", bwd))
        for label, entry, args in cases:
            times, errs = {}, {}
            for name, lib in libs.items():
                fn = getattr(lib, entry)
                _build.check(fn(*args), entry)
                torch.cuda.synchronize()
                if label == "K4":
                    errs[name] = max((o - o_ref).abs().max().item(),
                                     (lse - lse_ref).abs().max().item())
                else:
                    errs[name] = max(((g - r).abs().max() / r.abs().max()).item()
                                     for g, r in zip(grads, refs))
            for _ in range(2):  # two rounds, variants in turn
                for name, lib in libs.items():
                    fn = getattr(lib, entry)
                    times.setdefault(name, []).append(cs.cuda_ms(lambda: fn(*args)))
            print(f"{label} [{b},{h},{n},64] ms (two rounds) and max error (K4 abs, K5 relative): "
                  + "; ".join(f"{name} {t[0]:.4f} {t[1]:.4f} err {errs[name]:.1e}"
                              for name, t in times.items()), flush=True)
        del q, k, v, do, o_ref, lse_ref, refs
        torch.cuda.empty_cache()
    for b, h, n, causal, backward in BF16_SHAPES:
        time_bf16(cs, fa, _build, libs, gen, stream, b, h, n, causal, backward)
    print(cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
