#!/usr/bin/env python3
"""One source tree's end-to-end figures on one NVIDIA GPU, to hold two
versions of the port against each other within one machine.

    python3 compare_trees.py <tree root> <label>

Imports `chip_smoke.py` and the port from ``<tree root>`` (this checkout,
or another unpacked with ``git archive <commit> | tar -x -C <dir>``),
builds its kernels and prints one line ``RESULT {...}``: the flagship
denoise step at b4 x n1024 (CUDA events, median of 20), the flagship
training step at b16 x 2 s (host clock, synchronised, median of steps
3-8) and the served p50 of 12 sequential README config 2 requests at the
(64, 512) bucket and 100 steps (host clock). Run the two trees in turns in
one command (A, B, B, A): the host-bound figures move between machines.

Exits non-zero without a CUDA device. Not part of the smoke run.
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time
from pathlib import Path


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
