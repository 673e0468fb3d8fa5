#!/usr/bin/env python3
"""One source tree's end-to-end figures on one NVIDIA GPU, to hold two
versions of the port against each other within one machine.

    python3 compare_trees.py <tree root> <label> [--kernels]

Imports `chip_smoke.py` and the port from ``<tree root>`` (this checkout,
or another unpacked with ``git archive <commit> | tar -x -C <dir>``),
builds its kernels and prints one line ``RESULT {...}``: the flagship
denoise step at b4 x n1024 (CUDA events, median of 20), the flagship
training step at b16 x 2 s (host clock, synchronised, median of steps
3-8) and the served p50 of 12 sequential README config 2 requests at the
(64, 512) bucket and 100 steps (host clock). With ``--kernels`` instead:
K4 and K5 in bf16 at the shapes of their PERF rows (CUDA events, median of
20; through the wrapper and through the C entry point alone, which both
trees export with one signature) and the long-form bf16 denoise step at
n 4500 and n 9000 (CUDA events, median of 10). Run the two trees in turns
in one command (A, B, B, A): the host-bound figures move between machines.

Exits non-zero without a CUDA device. Not part of the smoke run.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time
from pathlib import Path


# K4 bf16 (b, h, n_q, n_kv, causal, masked, dropout rate, with K5), head 64:
# the served and guided shapes, the long-form ones, AMP's three (K5's rows)
BF16_FLASH_SHAPES = ((2, 8, 32, 134, False, False, 0.0, False),
                     (8, 8, 32, 134, False, False, 0.0, False),
                     (2, 8, 510, 510, False, False, 0.0, False),
                     (2, 8, 510, 32, False, False, 0.0, False),
                     (1, 8, 4500, 4500, False, False, 0.0, False),
                     (1, 8, 9000, 9000, False, False, 0.0, False),
                     (16, 8, 102, 102, False, False, 0.2, True),
                     (16, 8, 150, 150, False, False, 0.0, True),
                     (4, 8, 1024, 1024, True, True, 0.0, True))


def bf16_kernels(cs, out: dict) -> None:
    """K4 and K5 bf16 times at BF16_FLASH_SHAPES and the long-form bf16
    denoise step into ``out``."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.models.naturalspeech2 import cast_floating
    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(7)
    fwd_c, bwd_c = (_build.entry(n, torch.bfloat16) for n in ("ns2_flash_fwd", "ns2_flash_bwd"))
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, n_q, n_kv, causal, masked, rate, backward in BF16_FLASH_SHAPES:
        q, do = (torch.randn(b, h, n_q, 64, generator=gen, device="cuda").bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(b, h, n_kv, 64, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        mask = torch.rand(b, n_kv, generator=gen, device="cuda") > 0.2 if masked else None
        seed = (0x5EED0046, 0xC0DE) if rate else None
        cfg = dict(causal=causal, scale=0.125, dropout_rate=rate)
        shape = f"[{b},{h},{n_q}|{n_kv},64]" + (" causal" if causal else "") + (
            " masked" if masked else "") + (f" dropout {rate:g}" if rate else "")
        o, lse = fa.flash_forward(q, k, v, mask, seed, **cfg)
        mask8 = None if mask is None else mask.to(torch.uint8).contiguous()
        m = None if mask8 is None else mask8.data_ptr()
        tail = (*fa._dropout_args(seed, rate, n_kv), stream)
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
        fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m, o2.data_ptr(), lse2.data_ptr(),
                    b, h, n_q, n_kv, 64, int(causal), 0.125, *tail)
        res = {"k4_ms": cs.cuda_ms(lambda: fa.flash_forward(q, k, v, mask, seed, **cfg)),
               "k4_c_entry_ms": cs.cuda_ms(lambda: fwd_c(*fwd_args))}
        if backward:
            delta = (do.float() * o.float()).sum(-1)
            grads = [torch.empty_like(t) for t in (q, k, v)]
            bwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m, lse.data_ptr(),
                        delta.data_ptr(), do.data_ptr(), *(g.data_ptr() for g in grads), b, h,
                        n_q, n_kv, 64, int(causal), 0.125, *tail)
            res["k5_ms"] = cs.cuda_ms(
                lambda: fa.flash_backward(q, k, v, mask, seed, lse, o, do, **cfg))
            res["k5_c_entry_ms"] = cs.cuda_ms(lambda: bwd_c(*bwd_args))
        out.setdefault("flash_bf16", {})[shape] = res
        torch.cuda.empty_cache()
    ns2 = cs.flagship(cs.SEED + 40, scan_layers=True).cuda()
    model = cast_floating(ns2.model, torch.bfloat16)
    with torch.no_grad():
        for n in cs.LONG_LENGTHS:
            x = torch.randn(1, n, cs.DIM, generator=gen, device="cuda").bfloat16()
            times = torch.full((1,), 0.5, device="cuda")
            out.setdefault("longform_bf16_step_ms", {})[n] = cs.cuda_ms(
                lambda: model(x, times), reps=10, warmup=2)


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_trees: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import cli

    if not Path(ns2pkg.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported the port from {ns2pkg.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(cs.SEED)
    cs.phase1_card_and_build()
    out = {"label": label}
    if "--kernels" in sys.argv[3:]:
        bf16_kernels(cs, out)
        print("RESULT", json.dumps(out), flush=True)
        return 0
    ns2 = cs.flagship(cs.SEED).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        x = torch.randn(cs.BATCH, cs.LENGTH, cs.DIM, generator=gen, device="cuda")
        times = torch.full((cs.BATCH,), 0.5, device="cuda")
        out["denoise_ms"] = cs.cuda_ms(lambda: ns2.model(x, times), reps=20, warmup=3)
    with tempfile.TemporaryDirectory() as work:
        trainer = ns2pkg.Trainer(ns2, batches=iter(()), train_batch_size=cs.TRAIN_BATCH,
                                 results_folder=work)
        walls = []
        for i in range(8):
            batch = cs._seeded_audio(100 + i, cs.TRAIN_BATCH,
                                     int(cs.TRAIN_SECONDS * 24000)).numpy()
            torch.cuda.synchronize()
            start = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - start) * 1e3)
        out["train_ms"] = statistics.median(walls[2:])
        del trainer, ns2
        config, checkpoint = cs._serving_checkpoint(Path(work))
        engine = cli.build_engine(config, checkpoint, timesteps=cs.STEPS,
                                  cond_scale=cs.SERVE_COND_SCALE, device="cuda",
                                  prompt_samples=cs.PROMPT_SAMPLES)
        engine.warmup([cs.SERVE_BUCKET])
        prompt = cs._serving_prompt()
        walls = []
        for i in range(12):
            start = time.perf_counter()
            engine.tts(cs.SERVE_SENTENCE, prompt, seconds=cs.SERVE_SECONDS, seed=i)
            walls.append((time.perf_counter() - start) * 1e3)
        out["serve_p50_ms"] = float(np.percentile(walls, 50))
    print("RESULT", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
