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
  5. a short sample (2 steps, 50 frames) on the card against the CPU;
  6. each training-path kernel against its plain version on the card: flash
     attention forward (K4) and backward (K5) at the training shape
     [16, 8, 150, 64] and at [4, 8, 1024, 64], a masked, causal, dropout
     case whose keep masks must agree exactly, and RVQ (K6) at m 2400,
     Q 8, K 1024, d 128 (codes tie-tolerantly);
  7. the training slice: the flagship `Trainer` on a folder of seeded
     synthetic WAVs, b16 x 2 s, 10 steps with an EMA sample and checkpoint
     at step 10; finite losses, moved parameters, the EMA, the files, a
     resume at step 10 with equal state, ms per step, peak memory, and the
     exact launch counts of one optimizer step;
  8. one `NaturalSpeech2.forward` loss and its gradients at b2 x 0.4 s,
     flagship widths: the card (kernels) against the CPU (plain versions).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# Training-path kernels (K4, K5, K6) vs plain, f32 on the card: the same
# products (64-term dots, softmax over up to 1024 keys) in another order
# differ by ~1e-6 on unit-scale inputs; dq/dk/dv sum up to 1024 rows of
# O(1) products, so 1e-3 abs keeps the margin of KERNEL_TOL.
# RVQ near-ties: squared distances are ~256 at d 128; two candidates closer
# than this may swap between the kernel and the plain version.
RVQ_TIE_TOL = 1e-3
# Card vs CPU gradients of the training loss (phase 8), per parameter
# tensor relative to its largest entry: reorderings through the backward
# of 32 WaveNet blocks and 6 transformer layers, ~1e-5; a wrong index in a
# kernel or a backward is O(1).
GRAD_RTOL = 1e-3
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_STEPS, SAMPLE_FRAMES = 16, 2.0, 10, 32
# per optimizer step: the forward runs K1, 6 x K2, 6 x K3 and the codec's
# RVQ (K6); each K2 backward recomputes the core with K4 and runs K5
PER_STEP = {"wavenet_body": 1, "attn_block": DEPTH, "ff_block": DEPTH, "flash_forward": DEPTH,
            "flash_backward": DEPTH, "rvq": 1}
PER_DENOISE = {"wavenet_body": 1, "attn_block": DEPTH, "ff_block": DEPTH, "flash_forward": 0,
               "flash_backward": 0, "rvq": 0}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def compare(phase: str, name: str, actual, reference, tol: float) -> float:
    """Max abs error of ``actual`` against ``reference`` (tensors or tuples
    of them); raises above ``tol``."""
    import torch

    if isinstance(actual, (tuple, list)):
        return max(compare(phase, f"{name}[{i}]", a, r, tol)
                   for i, (a, r) in enumerate(zip(actual, reference)))
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


def flagship(seed: int):
    """The flagship NaturalSpeech2 on the CPU, seeded noise on every
    parameter, so no zero or one init hides a layout fault."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg

    torch.manual_seed(seed)
    with torch.no_grad():
        ns2 = ns2pkg.NaturalSpeech2(
            ns2pkg.Model(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD),
            ns2pkg.SoundStream(), timesteps=1000,
        )
        jitter = torch.Generator().manual_seed(seed + 1)
        for p in ns2.parameters():
            p.add_(torch.randn(p.shape, generator=jitter) * 0.02)
    return ns2


def phase1_card_and_build() -> None:
    import torch

    from naturalspeech2_tpu_torch import _build

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


def phase2_sampling_kernels() -> list:
    import torch

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
    return summary


def phase3_sample(ns2) -> dict:
    """The sampling path; returns its launch counts."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

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
    expect = {k: STEPS * v for k, v in PER_DENOISE.items()}
    log("3", f"launch counts {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")

    with torch.no_grad():
        x = torch.randn(BATCH, LENGTH, DIM, generator=gen, device="cuda")
        times = torch.full((BATCH,), 0.5, device="cuda")
        step_ms = cuda_ms(lambda: ns2.model(x, times), reps=10)
        decode_ms = cuda_ms(lambda: ns2.codec.decode(x), reps=3, warmup=1)
    log("3", f"denoiser forward {step_ms:.3f} ms per denoise step (median of 10), "
             f"codec decode {decode_ms:.3f} ms (median of 3)")
    return counts


def phase4_5_card_vs_cpu(ns2, ns2_cpu) -> None:
    import torch

    import naturalspeech2_tpu_torch as ns2pkg

    with torch.no_grad():
        x = torch.randn(BATCH, LENGTH, DIM, generator=torch.Generator().manual_seed(SEED + 3))
        times = torch.rand(BATCH, generator=torch.Generator().manual_seed(SEED + 4))
        on_card = ns2.model(x.cuda(), times.cuda())
        on_cpu = ns2_cpu.model(x, times)
    compare("4", "denoiser b4 x n1024, card vs CPU", on_card, on_cpu, PATH_TOL)

    # 50 frames leave a ragged last tile in every kernel (tiles of 64, 32
    # and 30 rows)
    noise = torch.randn(1, 50, DIM, generator=torch.Generator().manual_seed(SEED + 5))
    short = dict(batch_size=1, length=50, timesteps=2)
    compare("5", "sample 2 steps x 50 frames, card vs CPU",
            ns2pkg.sample(ns2, noise=noise.cuda(), **short),
            ns2pkg.sample(ns2_cpu, noise=noise, **short), PATH_TOL)


def _flash_timed_cases(gen) -> tuple[list, dict]:
    """K4 and K5 at the training shape and at n 1024: errors and times."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    errs = {"flash_forward": 0.0, "flash_backward": 0.0}
    times = {}
    for b, h, n, d in ((16, 8, 150, 64), (4, 8, 1024, 64)):
        q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device="cuda") for _ in range(4))
        cfg = dict(causal=False, scale=d**-0.5)
        fwd = lambda: fa.flash_forward(q, k, v, None, None, **cfg)  # noqa: E731
        fwd_plain = lambda: fa.flash_forward_torch(q, k, v, None, None, **cfg)  # noqa: E731
        o, lse = fwd_plain()
        bwd = lambda: fa.flash_backward(q, k, v, None, None, lse, o, do, **cfg)  # noqa: E731
        bwd_plain = lambda: fa.flash_backward_torch(q, k, v, None, None, lse, o, do, **cfg)  # noqa: E731
        shape = f"[{b},{h},{n},{d}]"
        for name, kernel, plain in (("flash_forward", fwd, fwd_plain),
                                    ("flash_backward", bwd, bwd_plain)):
            out = kernel()
            torch.cuda.synchronize()
            errs[name] = max(errs[name], compare("6", f"{name} {shape}", out, plain(), KERNEL_TOL))
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            log("6", f"{name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20)")
            times.setdefault(name, {})[shape] = {"ms": ms, "plain_ms": plain_ms}
    return errs, times


def _flash_masked_dropout_case(gen) -> dict:
    """A masked, causal, dropout case with fully masked rows: outputs and
    gradients within tolerance, masked keys' gradients exactly 0, and the
    kernel's keep mask equal to the plain one element for element."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    b, h, n, d, rate, seed = 3, 2, 200, 64, 0.1, (0x0BADC0DE, 0x5EED)
    mask = torch.ones(b, n, dtype=torch.bool, device="cuda")
    mask[1, :3] = False  # with causal masking, batch 1's rows 0..2 see no key
    mask[2] = False      # batch 2 sees none at all
    cfg = dict(causal=True, scale=d**-0.5, dropout_rate=rate)
    q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device="cuda") for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, mask, seed, **cfg)
    o_ref, lse_ref = fa.flash_forward_torch(q, k, v, mask, seed, **cfg)
    err = compare("6", "flash_forward masked causal dropout", (o, lse), (o_ref, lse_ref),
                  KERNEL_TOL)
    if not (torch.all(o[2] == 0) and torch.all(lse[2] == fa.NEG_INF)
            and torch.all(o[1, :, :3] == 0)):
        raise AssertionError("flash_forward: fully masked rows are not o = 0, lse = NEG_INF")
    grads = fa.flash_backward(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)
    grads_ref = fa.flash_backward_torch(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)
    err_b = compare("6", "flash_backward masked causal dropout", grads, grads_ref, KERNEL_TOL)
    masked = ~mask
    for g in grads[1:]:
        if not torch.all(g.permute(0, 2, 1, 3)[masked] == 0):
            raise AssertionError("flash_backward: gradient leaked into masked keys")

    # keep masks: with q = k = 0 every visible key has probability 1/count,
    # so with v one-hot over a 64-key window, o[row, c] != 0 exactly where
    # key window + c is visible and kept
    zeros = torch.zeros(b, h, n, d, device="cuda")
    kept, kept_ref = [], []
    for w0 in range(0, n, d):
        onehot = torch.zeros(b, h, n, d, device="cuda")
        cols = torch.arange(w0, min(w0 + d, n), device="cuda")
        onehot[:, :, cols, cols - w0] = 1.0
        kept.append(fa.flash_forward(zeros, zeros, onehot, mask, seed, **cfg)[0] != 0)
        kept_ref.append(fa.flash_forward_torch(zeros, zeros, onehot, mask, seed, **cfg)[0] != 0)
    kept = torch.cat(kept, dim=-1)[..., :n]
    kept_ref = torch.cat(kept_ref, dim=-1)[..., :n]
    keep = fa.dropout_keep_scaled(seed, b, h, n, n, rate, device="cuda") != 0
    visible = fa._valid(b, n, n, mask, True, "cuda").expand(b, h, n, n)
    if not (torch.equal(kept, kept_ref) and torch.equal(kept, keep & visible)):
        raise AssertionError("flash_forward: the kernel's dropout keep mask differs")
    log("6", f"dropout keep masks identical: {int(kept.sum())} of {int(visible.sum())} visible "
             f"probabilities kept at rate {rate} (kernel, plain and the Threefry mask)")
    return {"flash_forward": err, "flash_backward": err_b}


def _rvq_case(gen) -> tuple[float, float, float]:
    import torch

    from naturalspeech2_tpu_torch.ops import rvq as rvq_ops

    m, num_q, size, d = TRAIN_BATCH * int(TRAIN_SECONDS * 24000) // 320, 8, 1024, 128
    x = torch.randn(m, d, generator=gen, device="cuda")
    cb = torch.randn(num_q, size, d, generator=gen, device="cuda")
    kernel = lambda: rvq_ops.rvq(x, cb)  # noqa: E731
    plain = lambda: rvq_ops.rvq_torch(x, cb)  # noqa: E731
    (q, codes), (q_ref, codes_ref) = kernel(), plain()
    torch.cuda.synchronize()
    # tie-tolerant codes: a row may part from the plain codes only at a
    # stage whose two candidates are within RVQ_TIE_TOL of the residual
    xd, cbd = x.double().cpu(), cb.double().cpu()
    codes_c, ref_c = codes.long().cpu(), codes_ref.long().cpu()
    same = (codes_c == ref_c).all(dim=1)
    for row in torch.nonzero(~same).flatten().tolist():
        stage = int(torch.nonzero(codes_c[row] != ref_c[row])[0])
        r = xd[row] - sum(cbd[s][ref_c[row, s]] for s in range(stage))
        gap = abs(((r - cbd[stage][codes_c[row, stage]]) ** 2).sum()
                  - ((r - cbd[stage][ref_c[row, stage]]) ** 2).sum())
        if gap > RVQ_TIE_TOL:
            raise AssertionError(f"rvq: row {row} stage {stage} code differs by {gap:.3e} in d²")
    if (~same).sum() > m // 100:
        raise AssertionError(f"rvq: {int((~same).sum())} rows part at near-ties, over 1 %")
    log("6", f"rvq: codes [{m},{num_q}] equal in {int(same.sum())} of {m} rows, the rest "
             f"near-ties within {RVQ_TIE_TOL:g}")
    err = compare("6", "rvq quantized (agreeing rows)", q[same.cuda()], q_ref[same.cuda()],
                  KERNEL_TOL)
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    log("6", f"rvq [{m},{d}] Q{num_q} K{size}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
             "(median of 20)")
    return err, ms, plain_ms


def phase6_training_kernels() -> list:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    errs, times = _flash_timed_cases(gen)
    for name, err in _flash_masked_dropout_case(gen).items():
        errs[name] = max(errs[name], err)
    rvq_err, rvq_ms, rvq_plain_ms = _rvq_case(gen)
    train_shape = f"[{TRAIN_BATCH},{HEADS},150,{DIM_HEAD}]"
    summary = []
    for name, source, replaces, also in (
        ("flash_forward", "flash_fwd.cu", ":98", ":192"),
        ("flash_backward", "flash_bwd.cu", ":361", ":430"),
    ):
        summary.append({
            "name": name, "route": "cuda", "source": f"naturalspeech2_tpu_torch/csrc/{source}",
            "replaces": f"naturalspeech2_tpu/ops/flash_attention.py{replaces}",
            "replaces_also": f"naturalspeech2_tpu/ops/flash_attention.py{also}",
            "max_abs_err": errs[name], "ms": times[name][train_shape]["ms"],
            "plain_ms": times[name][train_shape]["plain_ms"], "by_shape": times[name],
        })
    summary.append({"name": "rvq", "route": "cuda", "source": "naturalspeech2_tpu_torch/csrc/rvq.cu",
                    "replaces": "naturalspeech2_tpu/ops/rvq.py:60", "max_abs_err": rvq_err,
                    "ms": rvq_ms, "plain_ms": rvq_plain_ms})
    return summary


def _write_wavs(folder: Path, count: int = 32, seconds: float = 3.0, sr: int = 24000) -> None:
    """Seeded tones (two partials, a slow vibrato) plus noise."""
    import numpy as np

    from naturalspeech2_tpu_torch.data import write_wav

    rng = np.random.default_rng(SEED + 7)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(count):
        f0 = rng.uniform(100.0, 400.0)
        phase = 2 * np.pi * f0 * t + 3.0 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        audio = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.05 * rng.standard_normal(t.size)
        write_wav(folder / f"clip{i:02d}.wav", audio.astype(np.float32), sr)


def phase7_train(work: Path) -> dict:
    """The training path; returns its launch counts."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.data import load_audio

    folder, results = work / "wavs", work / "results"
    folder.mkdir()
    _write_wavs(folder)
    kwargs = dict(folder=str(folder), train_batch_size=TRAIN_BATCH,
                  data_max_length_seconds=TRAIN_SECONDS, save_and_sample_every=TRAIN_STEPS,
                  sample_length=SAMPLE_FRAMES, results_folder=str(results))
    ns2 = flagship(SEED + 10).cuda()
    start_params = {n: p.detach().clone() for n, p in ns2.named_parameters()}
    trainer = ns2pkg.Trainer(ns2, train_num_steps=TRAIN_STEPS, **kwargs)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    trainer.train(log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    rows = [json.loads(line) for line in (results / "metrics.jsonl").read_text().splitlines()]
    if [r["step"] for r in rows] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f"metrics.jsonl steps {[r['step'] for r in rows]}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss in {losses}")
    step_ms = statistics.median(r["step_time_s"] for r in rows[2:]) * 1e3
    log("7", f"Trainer b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s ({int(TRAIN_SECONDS * 24000) // 320} "
             f"frames), {TRAIN_STEPS} steps: losses {', '.join(f'{v:.4f}' for v in losses)}")
    log("7", f"{step_ms:.3f} ms per optimizer step (median of steps 3-{TRAIN_STEPS}, host clock, "
             f"synchronised), peak device memory {peak_gib:.3f} GiB, train() wall {wall:.2f} s "
             f"incl. the step-{TRAIN_STEPS} EMA sample ({SAMPLE_FRAMES} frames, "
             f"{ns2.timesteps} DDIM steps) and checkpoint")

    params = dict(ns2.named_parameters())
    still = [n for n in params if n.startswith("model.") and torch.equal(params[n], start_params[n])]
    if still:
        raise AssertionError(f"denoiser parameters did not move: {still}")
    d = trainer.ema_decay
    ema_err = max((trainer.ema[n] - (start_params[n] * d + params[n].detach() * (1 - d))).abs().max().item()
                  for n in params)
    if ema_err > 1e-6 or torch.equal(trainer.ema["model.to_time_hidden.weight"],
                                     start_params["model.to_time_hidden.weight"]):
        raise AssertionError(f"EMA not applied at step {TRAIN_STEPS}: max err {ema_err:.3e}")
    log("7", f"every denoiser parameter moved; EMA at step {TRAIN_STEPS} = {d}·start + "
             f"{1 - d:.3f}·params within {ema_err:.2e}")
    for name in ("metrics.jsonl", "model-1.ckpt", "sample-1.wav"):
        if not (results / name).exists():
            raise AssertionError(f"{name} was not written")
    wav, sr = load_audio(results / "sample-1.wav")
    if sr != 24000 or wav.shape != (SAMPLE_FRAMES * 320,):
        raise AssertionError(f"sample-1.wav: {wav.shape} at {sr} Hz")
    expect = {k: TRAIN_STEPS * PER_STEP[k] + ns2.timesteps * PER_DENOISE[k] for k in PER_STEP}
    log("7", f"launch counts over train() {counts}, expected {expect} "
             f"({TRAIN_STEPS} steps and a {ns2.timesteps}-step sample)")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")

    # a fresh Trainer on the same folder resumes at step 10, state equal
    resumed = ns2pkg.Trainer(flagship(SEED + 20).cuda(), train_num_steps=TRAIN_STEPS + 1, **kwargs)
    resumed.load(resumed.latest_checkpoint())
    if resumed.step != TRAIN_STEPS:
        raise AssertionError(f"resumed at step {resumed.step}")
    for (name, a), b in zip(ns2.named_parameters(), resumed.ns2.parameters()):
        sa, sb = trainer.optimizer.state[a], resumed.optimizer.state[b]
        if not (torch.equal(a, b) and torch.equal(trainer.ema[name], resumed.ema[name])
                and all(torch.equal(sa[k].cpu(), sb[k].cpu())
                        for k in ("step", "exp_avg", "exp_avg_sq"))):
            raise AssertionError(f"resumed state differs at {name}")
    ops.reset_launch_counts()
    resumed.train(log_every=1)  # step 11: no milestone
    step_counts = ops.launch_counts()
    log("7", f"resumed at step {TRAIN_STEPS} with equal params, Adam state and EMA; one more "
             f"optimizer step launched {step_counts}, expected {PER_STEP}")
    if step_counts != PER_STEP or resumed.step != TRAIN_STEPS + 1:
        raise AssertionError(f"per-step launch counts {step_counts} != {PER_STEP}")
    return counts


def phase8_loss_card_vs_cpu(ns2, ns2_cpu) -> None:
    import torch

    g = torch.Generator().manual_seed(SEED + 8)
    samples = int(0.4 * 24000)  # 30 frames: ragged in every kernel's tiles
    audio = torch.tanh(torch.randn(2, samples, generator=g))
    times = torch.rand(2, generator=g)
    noise = torch.randn(2, samples // 320, DIM, generator=g)
    results = []
    for model, device in ((ns2, "cuda"), (ns2_cpu, "cpu")):
        model.zero_grad(set_to_none=True)
        losses = model(audio.to(device), times=times.to(device), noise=noise.to(device))
        losses["loss"].backward()
        results.append((losses["loss"].detach().cpu(),
                        {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}))
    (loss_card, grads_card), (loss_cpu, grads_cpu) = results
    rel = abs(loss_card.item() - loss_cpu.item()) / abs(loss_cpu.item())
    log("8", f"loss b2 x 0.4 s: card {loss_card.item():.7f}, CPU {loss_cpu.item():.7f}, "
             f"rel err {rel:.3e} (tolerance {GRAD_RTOL:g})")
    if rel > GRAD_RTOL:
        raise AssertionError(f"loss card vs CPU rel err {rel:.3e}")
    if set(grads_card) != set(grads_cpu) or not any(n.startswith("model.") for n in grads_cpu):
        raise AssertionError("card and CPU differ in which parameters have gradients")
    worst, worst_name = 0.0, ""
    for name, g_cpu in grads_cpu.items():
        err = ((grads_card[name] - g_cpu).abs().max() / g_cpu.abs().max().clamp(min=1e-30)).item()
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    log("8", f"{len(grads_cpu)} parameter gradients, card vs CPU: max err relative to each "
             f"tensor's largest entry {worst:.3e} at {worst_name} (tolerance {GRAD_RTOL:g})")
    if not worst <= GRAD_RTOL:
        raise AssertionError(f"gradient card vs CPU: {worst:.3e} at {worst_name}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)

    phase1_card_and_build()
    summary = phase2_sampling_kernels()
    ns2_cpu = flagship(SEED)
    ns2 = copy.deepcopy(ns2_cpu).cuda()
    sample_counts = phase3_sample(ns2)
    phase4_5_card_vs_cpu(ns2, ns2_cpu)
    summary += phase6_training_kernels()
    with tempfile.TemporaryDirectory() as work:
        train_counts = phase7_train(Path(work))
    phase8_loss_card_vs_cpu(ns2, ns2_cpu)

    for entry in summary:
        by_path = {"sample": sample_counts[entry["name"]], "train": train_counts[entry["name"]]}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
