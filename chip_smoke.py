#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. the card's name and power limit (nvidia-smi), and the kernel build;
  2. each hand-written kernel against its plain PyTorch version on the
     card at the flagship's shapes, f32 with TF32 off: max error against
     the stated tolerance, and both times (CUDA events, median of 20);
  3. the slice: unconditional `sample()` of the flagship (Model dim 128,
     depth 6; SoundStream; NaturalSpeech2(timesteps=1000) run for 100
     DDIM steps) at batch 4 x 1024 latent frames, seeded random weights;
     a finite (4, 327680) waveform, the wall time and ms per denoise
     step, and launch counts proving every step ran every kernel;
  4. one flagship denoiser forward at b4 x n1024 on the card (kernels)
     against the same weights on the CPU (plain versions);
  5. a short sample (2 steps, 50 frames) on the card against the CPU.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

SEED = 0
BATCH, LENGTH, STEPS = 4, 1024, 100
DIM, DEPTH, HEADS, DIM_HEAD = 128, 6, 8, 64
# Kernel vs plain, both f32 on the card: the same products summed in
# another order (tiles, online softmax) differ by ~1e-6 relative on these
# activations (|values| up to ~20 after K1's 32 blocks); a wrong index or
# layout differs by O(1). An absolute 1e-3 separates the two with room on
# both sides.
KERNEL_TOL = 1e-3
# Card vs CPU through the whole network (32 WaveNet blocks, 6 transformer
# layers) or a short sample with codec decode: the same f32 reorderings,
# compounded over ~50 chained products.
PATH_TOL = 2e-3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def compare(phase: str, name: str, actual, reference, tol: float) -> float:
    """Max abs error of ``actual`` against ``reference``; raises above ``tol``."""
    import torch

    actual, reference = actual.float().cpu(), reference.float().cpu()
    if actual.shape != reference.shape:
        raise AssertionError(f"{name}: shape {tuple(actual.shape)} vs {tuple(reference.shape)}")
    if not torch.isfinite(actual).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (actual - reference).abs().max().item()
    rel = err / reference.abs().max().clamp(min=1e-30).item()
    log(phase, f"{name}: max_abs_err {err:.3e} max_rel_err {rel:.3e} (tolerance {tol:g} abs)")
    if err > tol:
        raise AssertionError(f"{name}: max abs error {err:.3e} above {tol:g}")
    return err


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(gen):
    """(name, source, replaces, kernel call, plain call) at the flagship's
    shapes, inputs drawn from ``gen`` on the card."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel, ff_block_kernel, wavenet_kernel

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    b, n, d, S, L = BATCH, LENGTH, DIM, 4, 8
    wn = (rn(b, n, d), rn(S, L, 3 * d, d, scale=(3 * d) ** -0.5), rn(S, L, d, scale=0.1),
          rn(S, L, d, d, scale=d**-0.5), rn(S, L, d, scale=0.1), rn(L, d, d, scale=d**-0.5),
          rn(L, d, scale=0.1), 1 + rn(b, S, L, 2 * d, scale=0.1))
    hd = HEADS * DIM_HEAD
    x, gamma, beta = rn(b, n, d), 1 + rn(b, d, scale=0.1), rn(b, d, scale=0.1)
    wq, wkv, wo = rn(d, hd, scale=d**-0.5), rn(d, 2 * hd, scale=d**-0.5), rn(hd, d, scale=hd**-0.5)
    heads = attn_block_kernel.split_heads(wq, wkv, wo, HEADS, DIM_HEAD)
    inner = int(d * 4 * 2 / 3)
    w1, b1 = rn(d, 2 * inner, scale=d**-0.5), rn(2 * inner, scale=0.1)
    wc, bc = rn(3, inner, inner, scale=(3 * inner) ** -0.5), rn(inner, scale=0.1)
    w2, b2 = rn(inner, d, scale=inner**-0.5), rn(d, scale=0.1)
    scale = DIM_HEAD**-0.5
    return [
        ("wavenet_body", "naturalspeech2_tpu_torch/csrc/wavenet.cu",
         "naturalspeech2_tpu/ops/wavenet_kernel.py:80",
         lambda: wavenet_kernel.wavenet_body(*wn),
         lambda: wavenet_kernel.wavenet_body_torch(*wn)),
        ("attn_block", "naturalspeech2_tpu_torch/csrc/attn_block.cu",
         "naturalspeech2_tpu/ops/attn_block_kernel.py:92",
         lambda: attn_block_kernel.attn_block(x, gamma, beta, wq, wkv, wo, heads=HEADS,
                                              dim_head=DIM_HEAD, scale=scale),
         lambda: attn_block_kernel.attn_block_torch(x, gamma, beta, *heads, scale=scale)),
        ("ff_block", "naturalspeech2_tpu_torch/csrc/ff_block.cu",
         "naturalspeech2_tpu/ops/ff_block_kernel.py:97",
         lambda: ff_block_kernel.ff_block(x, gamma, beta, w1, b1, wc, bc, w2, b2),
         lambda: ff_block_kernel.ff_block_torch(x, gamma, beta, w1[:, :inner], b1[:inner],
                                                w1[:, inner:], b1[inner:], wc, bc, w2, b2)),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)

    # 1. the card and the build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)  # name, power limit: as nvidia-smi gives them
    log("1", f"torch {torch.__version__} cuda {torch.version.cuda} device "
             f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log("1", f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
             f"cudnn {torch.backends.cudnn.allow_tf32}")
    start = time.perf_counter()
    _build.library()
    built = (f"nvcc {_build.build_seconds:.1f} s" if _build.build_seconds is not None
             else "loaded from an earlier build")
    log("1", f"kernel library ready in {time.perf_counter() - start:.1f} s ({built})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("1", "ptxas: " + line.split("ptxas info    :")[-1].strip())

    # 2. each kernel against its plain version, on the card
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    summary = []
    for name, source, replaces, kernel, plain in kernel_cases(gen):
        out = kernel()
        torch.cuda.synchronize()
        err = compare("2", name, out, plain(), KERNEL_TOL)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        log("2", f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # 3. the slice: unconditional sample() of the flagship
    with torch.no_grad():
        ns2 = ns2pkg.NaturalSpeech2(
            ns2pkg.Model(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD),
            ns2pkg.SoundStream(), timesteps=1000,
        )
        # seeded noise on every parameter, so no zero or one init hides a
        # layout fault from phases 4 and 5
        jitter = torch.Generator().manual_seed(SEED + 1)
        for p in ns2.parameters():
            p.add_(torch.randn(p.shape, generator=jitter) * 0.02)
    ns2_cpu = copy.deepcopy(ns2).eval()
    ns2 = ns2.cuda().eval()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    audio = ns2pkg.sample(ns2, batch_size=BATCH, length=LENGTH, timesteps=STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = ops.launch_counts()
    if tuple(audio.shape) != (BATCH, LENGTH * 320):
        raise AssertionError(f"sample: shape {tuple(audio.shape)}")
    if not torch.isfinite(audio).all():
        raise AssertionError("sample: non-finite waveform")
    log("3", f"sample(batch_size={BATCH}, length={LENGTH}, timesteps={STEPS}): waveform "
             f"{tuple(audio.shape)} finite, |audio| max {audio.abs().max().item():.4f}, "
             f"wall {wall:.3f} s incl. codec decode")
    expect = {"wavenet_body": STEPS, "attn_block": STEPS * DEPTH, "ff_block": STEPS * DEPTH}
    log("3", f"launch counts {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    for entry in summary:
        entry["launches"] = counts[entry["name"]]

    with torch.no_grad():
        x = torch.randn(BATCH, LENGTH, DIM, generator=gen, device="cuda")
        times = torch.full((BATCH,), 0.5, device="cuda")
        step_ms = cuda_ms(lambda: ns2.model(x, times), reps=10)
        decode_ms = cuda_ms(lambda: ns2.codec.decode(x), reps=3, warmup=1)
    log("3", f"denoiser forward {step_ms:.3f} ms per denoise step (median of 10), "
             f"codec decode {decode_ms:.3f} ms (median of 3)")

    # 4. one flagship denoiser forward: card (kernels) vs CPU (plain)
    with torch.no_grad():
        x = torch.randn(BATCH, LENGTH, DIM, generator=torch.Generator().manual_seed(SEED + 3))
        times = torch.rand(BATCH, generator=torch.Generator().manual_seed(SEED + 4))
        on_card = ns2.model(x.cuda(), times.cuda())
        on_cpu = ns2_cpu.model(x, times)
    compare("4", "denoiser b4 x n1024, card vs CPU", on_card, on_cpu, PATH_TOL)

    # 5. a short sample through DDIM and the codec, card vs CPU; 50 frames
    #    leave a ragged last tile in every kernel (tiles of 64, 32 and 30 rows)
    noise = torch.randn(1, 50, DIM, generator=torch.Generator().manual_seed(SEED + 5))
    short = dict(batch_size=1, length=50, timesteps=2)
    compare("5", "sample 2 steps x 50 frames, card vs CPU",
            ns2pkg.sample(ns2, noise=noise.cuda(), **short),
            ns2pkg.sample(ns2_cpu, noise=noise, **short), PATH_TOL)

    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
