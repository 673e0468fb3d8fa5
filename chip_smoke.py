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
     [16, 8, 150, 64] and at [4, 8, 1024, 64] within FLASH_TOL, a masked,
     causal, dropout case whose keep masks must agree exactly, and RVQ (K6)
     at m 2400, Q 8, K 1024, d 128 (codes tie-tolerantly);
  7. the training slice: the flagship `Trainer` on a folder of seeded
     synthetic WAVs, b16 x 2 s, 10 steps with an EMA sample and checkpoint
     at step 10; finite losses, moved parameters, the EMA, the files, a
     resume at step 10 with equal state, ms per step, peak memory, and the
     exact launch counts of one optimizer step (at 150 frames the JAX
     package's gates run the attention unfused on K4 and K5, and the
     feed-forward unfused);
  8. one `NaturalSpeech2.forward` loss and its gradients at b2 x 0.4 s,
     flagship widths: the card (kernels) against the CPU (plain versions);
  9. the conditional path's kernels against their plain versions: the
     cross-attention block (K2b, within BLOCK_TOL) at x [8, 512, 128], ctx
     [8, 32, 128], and
     flash attention (K4) at the resampler's [8, 8, 32 | 134, 64] and the
     prompt encoder's [4, 8, 102, 64]; F.scaled_dot_product_attention is
     timed beside K4 and K5 as a yardstick the port never calls;
 10. the conditional slice: README config 2 (Model dim 128, depth 6,
     dim_prompt 512, condition_on_prompt; SoundStream; the default
     conditioning stack) with seeded random weights; `sample()` from
     prompt audio (4, 32768) and text ids (4, 100), length 512, cond_scale
     3, 100 DDIM steps: a finite (4, 163840) waveform, wall time, ms per
     guided denoise step, the time of `conditioning_for_sample`, and
     exact launch counts;
 11. `conditioning_for_sample` and a short conditional sample (2 steps, 48
     frames, cond_scale 3) on the card against the CPU, with the
     durations and pitch the card predicted passed to both;
 12. the long-form and scaled kernels against their plain versions: the
     per-lane WaveNet body (K1b) at b1 x n9000 and n6501 (d 128, 4 x 8), K1
     against K1b at n9000, K1, K2 and K3 at b1 x n4500 and K3 at n9000,
     K1, K2 and K3 at the scaled width (b16 x n1024, d 512, inner 1365),
     K2 against the JAX package's long-sequence route `attn_block_flash`
     (norm and projections, then flash attention K4) at n9000, and K4 at
     the long-form shapes [1, 8, 4500 | 9000, 64] against its plain version
     and SDPA;
 13. long-form `sample()` (Model dim 128, depth 6, scan_layers; SoundStream)
     at b1, 50 DDIM steps, n4500 (60 s of audio: K1, attention on K4, the
     feed-forward unfused) and n9000 (120 s: K1b, attention on K4, K3):
     wall time, real-time factor and exact launch counts;
 14. scaled sampling: Model(dim=512, depth=12, scan_layers=True) at b16 x
     n1024, latents only, STEPS_SCALED DDIM steps: ms per step and exact
     launch counts (the WaveNet is the plain body at d 512, as the JAX
     package runs its XLA twin there);
 15. one denoiser forward on the card against the CPU: the long-form model
     at b1 x n4500 and n9000 and the scaled model at b2 x n1024;
 16. the widths of the JAX package's tests (dim 16, dim_head 8, codebook
     dim 16, a 24-wide context), which every wrapper pads to its kernel's:
     each kernel against its plain version; the wide widths (heads of 96,
     128, 192 and 256 through K4, K5 (masked, causal, dropout keep masks
     bit for bit), K2 and K2b; K2b at dim 640, RVQ at codebook dim 192 and
     256; K4 and K5 timed at [4, 8, 1024, 128] and [4, 8, 1024, 256] beside
     SDPA, K2b at x [8, 512, 640]); then the port's two CPU test configs
     (tests/test_torch_conditional.py, tests/test_torch_scan_layers.py)
     card against CPU, a guided forward and a 2-step conditional sample
     each with exact launch counts, and the scan-layers transformer;
 17. the conditional training path's kernels at its shapes against their
     plain versions: K4 and K5 at the prompt encoder's [16, 8, 102, 64]
     with dropout 0.2 (keep masks bit for bit), the denoiser's unfused
     [16, 8, 150, 64] and [16, 8, 150 | 32, 64] and the resampler's
     [16, 8, 32 | 134, 64], timed beside SDPA; K1 at [16, 150, 128]; K6 on
     the prompt (m 1632);
 18. conditional training: README config 2 with the default conditioning
     stack (the JAX bench's leg `measure_conditional_train_throughput`,
     bench.py:267-331) in `Trainer` on seeded dict batches (audio 16 x
     48000, text 16 x 100, prompt 16 x 32768), 10 optimizer steps: finite
     loss, diffusion, duration, pitch and align; the aligner's, encoders',
     duration / pitch trunks' and denoiser's parameters all moved; ms per
     step, peak memory, exact launch counts of the 10 steps and of one
     more; the host time of the MAS, CTC and pitch loops;
 19. one conditional loss and its gradients at b2, full width, eval mode,
     injected times, noise and drop masks, card against CPU: mel and pitch
     first (frames picking another lag counted), then the MAS durations
     (rows that differ counted), then the losses and every gradient with
     the card's mel and pitch passed to both;
 20. the serving path's kernels against their plain versions at one
     request's shapes: K1, K2 and K3 on the batch-doubled [2, 512, 128],
     K2b at x [2, 512, 128], ctx [2, 32, 128], K4 at [2, 8, 32 | 134, 64]
     and [1, 8, 102, 64], K6 at m 102; then the serving slice (the JAX
     bench's leg `measure_serving`,
     bench.py:383-431): README config 2 with Tokenizer() and seeded random
     weights, saved as a port checkpoint and loaded by
     `cli.build_engine` with the default buckets (text 32, 64, 128;
     frames 256, 512, 1024), 32,768-sample prompts, 100 guided steps at
     cond_scale 2.5; the (64, 512) bucket warmed, then 50 sequential
     `engine.tts` of the bench's sentence at 6.8 s (p50 and p95 latency,
     the real-time factor over all of them, the exact launch counts of
     each request), one request whose length the duration predictor
     picks, one untimed and ten timed rounds of four concurrent requests
     through the micro-batcher, each round sharing exactly one device
     call (round wall p50 / p95, audio-seconds per second over the ten),
     and `TTSServer` on 127.0.0.1 over urllib: /healthz, /metrics, ten
     POST /tts with a base64 WAV prompt (p50 / p95), a streamed reply, a
     text past the largest bucket (long-formed) and a FLAC header
     (400); every waveform finite and of its length;
 21. the same engine at full width on the card against the CPU, 2 steps,
     200 frames, the same injected noise: equal token ids, the waveform
     within PATH_TOL, the duration predictor's frames per token within
     PATH_TOL and its total frames equal (a token whose truncation flips
     must lie within DURATION_TIE of an integer on the CPU);
 22. the bf16 kernels (the JAX kernels' bf16 path) against their
     plain bf16 versions within BF16_TOL, each timed beside the f32 kernel
     at the same shape and values: K1 at [4, 1024, 128], [2, 512, 128],
     [8, 512, 128] and [1, 4500, 128], K1b at [1, 9000, 128], K2 and K3 at
     [4, 1024, 128], [2, 512, 128] and [16, 1024, 512] and the ragged [16,
     150, 128], [3, 1000, 128] and dm 96 (K3's inner 200), K3 at [1, 9000,
     128] (both on the bf16 GEMM core, timed through the wrapper and the C
     entry point; K2 also without the residual on 4 heads at dm 512, and a
     profile proving their launches ran the bf16 core's kernels, not the
     split-TF32 core's), K2b at x [2 | 8, 512, 128], ctx [·, 32, 128] (on
     the bf16 core too: through the wrapper and the C entry, at dm 96, dc
     100, heads of 128 and without the residual, and profiles of five
     launches, six where the context is copied for TMA), K4
     forward at [2 | 8, 8, 32 | 134, 64] and [1, 8, 4500 | 9000, 64] beside
     SDPA in bf16, and at the unbucketed guided step's [2, 8, 510, 64] and
     [2, 8, 510 | 32, 64]; bounds at the dense bf16 peak (K1, K1b: three
     bf16 passes);
 23. the flagship `sample(dtype=torch.bfloat16)` (b4 x n1024, 100 steps):
     a finite float32 waveform, launches equal to phase 3's, all on the
     bf16 entry points, the module not cast in place, and the denoise step
     in bf16 beside f32 (CUDA events, in turns), and README config 2's
     guided step (8 x 512) likewise;
 24. long-form bf16 `sample()` at n4500 and n9000 (K1b in bf16) and the
     scaled model's (dim 512, depth 12, b16 x n1024), launches equal to
     phases 13's and 14's on the bf16 entry points, the scaled step in
     bf16 beside f32;
 25. README config 2 served in bf16: `cli.build_engine(dtype="bfloat16")`
     beside phase 20's f32 engine, each 20 sequential requests and 4
     rounds of four in two turns, f32, bf16, bf16, f32 (p50 / p95,
     audio-s per s; every request's launches:
     the denoiser's on the bf16 entry points, the conditioning's prompt
     encoder K4 and K6 on the f32 ones), then `cli.main(["sample",
     "--bf16", ...])` in-process;
 26. bf16 card against bf16 CPU at README config 2's full width: a guided
     denoiser forward and a 2-step served sample within BF16_PATH_TOL,
     correlated ≥ BF16_CORR, and the card's bf16 sample's correlation
     with its f32 one (≥ BF16_F32_CORR);
 27. the AMP kernels against their plain versions: K4 in bf16 with
     dropout 0.2 and K5 in bf16 at the prompt encoder's [16, 8, 102, 64]
     (keep masks bit for bit against the f32 kernel's), K5 in bf16 at
     [16, 8, 150, 64] and [4, 8, 1024, 64] causal and masked (within
     BF16_TOL, beside SDPA in bf16 and its backward), K6 on bf16 x and
     codebooks at m 2400 and 1632 (codes equal to the f32 kernel's on the
     same values but for near-ties, the sum bit-equal), and the mixed
     entry points (f32 activations against bf16 weights): K1 at [16, 150,
     128], K2, K3 and K2b at [16, 160, 128] (K2 and K2b also with the
     residual off), K3, K2 and K2b at a ragged shape each, K1b at
     AMP_K1B_SHAPES, within WAVENET_TOL / BLOCK_TOL of the f32 plain
     versions; the profiles of the mixed K1, K1b, K2, K2b and K3 show the
     bf16 core's launches, their pre-passes and K4 f32 alone;
 28. flagship AMP training: `Trainer(amp=True)` on synthetic WAVs, b16 x
     2 s, 10 steps with the EMA sample and checkpoint: finite losses,
     moved parameters, f32 master state, EMA and checkpoint, a resume,
     exact launch counts by kind of entry point (bf16 K6, mixed K1, f32 K4
     and K5) and the f32 trainer's unchanged, the step beside the f32
     one in turns, one AMP step at 160 frames (mixed K2 and K3) and
     `cli.main(["train", "--amp", ...])` for two steps;
 29. conditional AMP training at README config 2 as phase 18, with exact
     launch counts (bf16 K4 with dropout and K5, bf16 K6 x 2) and a step at
     160 frames (mixed K2, K2b, K3);
 30. one AMP loss and its f32 master gradients card against CPU, the
     flagship at b2 x 0.4 s and README config 2 at b2, held to
     AMP_LOSS_RTOL / AMP_GRAD_RTOL or to the card's own bf16 noise floor.
 31. K1b's `bf16_matmul` option (every product on bf16 operands, f32
     accumulation; `ns2_wavenet_lanes_bf16mm` on the bf16 core, one bf16
     plane a lane) against its plain version at [16, 1024, 512], [1, 9000,
     128] and [2, 1000, 96], 4 x 8: within BF16_TOL of the largest entry,
     correlated at least BF16MM_CORR, the f32 K1b's difference from it
     printed, exact launches (a profile: S·L/4 + L of the bf16 core and
     the rounding pre-pass), its time beside the f32 K1b's and the plain
     version's with the bound at the bf16 peak; then
     the d-512 probe's 20-body chains
     (naturalspeech2_tpu_torch/examples/wavenet_d512_probe.py) with exact
     launch counts;
 32. few-step sampling of the flagship at b4 x n1024 from one starting
     noise: DDIM at 1000 steps as the reference trajectory, DDIM and
     DPM++ at 8, 16, 25 and 50 steps (latent MSE against it, ms per
     step, exact launches; DPM++ below DDIM at 8 and 16 steps);
     `sample()` with DDPM at 50 steps from step noise and DPM++ at 25,
     each with codec decode; a self-conditioned flagship with DPM++ at
     25; DPM++, DDPM and the self-conditioned DPM++ at 3 steps x 50
     frames card against CPU within PATH_TOL (run after phase 5);
 33. README config 2 served by DPM++ at 25 steps (a config with
     `ns2.sampler = "dpmpp"` through `cli.build_engine`) beside phase
     20's DDIM engine at 100, 20 sequential requests each in turns:
     p50 / p95, the ratio of the p50s, every request's launches exact
     (run after phase 26);
 34. the self-conditioned flagship `Trainer` at b16 x 2 s for 3 steps
     (finite losses, `to_self_cond` moved, exact launches per step),
     then `ProgressiveDistiller.distill_round` at b4 x n1024, 8 student
     steps, 3 updates (exact launches, ms per update);
 35. card against CPU within GRAD_RTOL: the self-conditioned loss and its
     gradients (injected times, noise and bootstrap rows, one row
     bootstrapped and one not) and the distillation loss and the
     student's gradients (injected grid index and noise);
 36. K6 at Encodec's shapes against its plain version: the latents of the
     24-kHz Encodec (facebook/encodec_24khz's architecture, seeded random
     weights) at b16 x 2 s (m 2400) and of a 6.8-s prompt (m 510), Q 8, K
     1024, d 128, against its own codebooks;
 37. NaturalSpeech2(Model(dim=128, depth=6), Encodec()): the codec's encode
     at b16 x 2 s (ms, one K6 launch), `Trainer` at b16 x 2 s for
     ENC_TRAIN_STEPS steps (ms per step, exact launches), a 100-step DDIM
     `sample()` of 512 frames with Encodec decode (exact launches), the
     decode of a 6.8-s sample (ms); card against CPU: latents and codes
     (tie-tolerantly), the loss and every gradient at b2 x 0.4 s, a 2-step
     sample's audio;
 38. `CodecTrainer` on the card for SoundStream() and Encodec(), adversarial
     from step 0, b8 x 1 s, CODEC_TRAIN_STEPS steps: finite losses, moved
     codec, codebooks and discriminator, ms per step, one K6 launch a
     step; a save / load round trip (the state equal bit for bit, the
     next step's metrics within GRAD_RTOL of the unbroken run's); card
     against CPU at b2 x 0.4 s: the generator
     loss and its gradients (the STFT term off, see CODEC_CHECK) and one
     step's losses;
 39. the 48-kHz knobs (time_group_norm, split padding, stereo, loudness
     normalisation, 1-s chunks at 1 % overlap) at facebook/encodec_48khz's
     widths: chunked encode and overlap-add decode of 2.5 s of stereo
     (three chunks, the last partial; one K6 launch each), card against
     CPU: codes tie-tolerantly, scales, the decoded audio;
 40. Model(use_fused_wavenet=False) at the flagship's widths (its WaveNet
     block by block on cuDNN convs): a 100-step DDIM `sample()` at b4 x
     n1024 with exact launches (no K1; K2 and K3 600 each), its denoise step
     beside the fused flagship's in turns (CUDA events), one forward card
     against CPU within PATH_TOL;
 41. ConditionableTransformer(dim_cond_mult=None, ff_causal_conv=False) at
     the flagship's widths, b4 x n1024: the forward (K4 once a layer) and
     the backward (K5 once a layer) with exact launches, the output within
     PATH_TOL and every gradient within GRAD_RTOL card against CPU, times;
 42. the native decoder and the trainers' options: FLAC_FILES seeded FLACs
     (2.5 s, 24 kHz) decoded to their PCM16 / 32768 exactly and timed; the
     flagship `Trainer` on them at b16 x 2 s for 8 steps at
     steps_per_dispatch 4 and at 1 from one seed (states within
     GRAD_RTOL, launches exact, the dispatch's logged loss the mean of its
     steps'), `profile_steps=(2, 4)` leaving a trace that names the port's
     kernels, one dispatch against four single steps in turns (ms per
     step, exact launches); `CodecTrainer.train(6, steps_per_jit=4)` ending
     at step 6 with the JAX log rule; `CodecTrainer(amp=True)` for
     SoundStream and Encodec card against CPU to phase 30's AMP floor (the
     STFT term off, as phase 38), then two AMP steps on the card;
 43. (run after phase 33, on phase 20's engine) POST /tts of phase 20's
     sentence at 6.8 s with phase 20's prompt as a PCM16 FLAC, three
     times: 200, a PCM16 WAV of 163,200 samples, the wall time of each,
     exact launches;
 44. data-parallel and FSDP training (`parallel/`): the flagship `Trainer`
     at b16 x 2 s for DP_STEPS steps (EMA every step), README config 2 for
     one step with its conditioning stack's dropout off and text lengths
     that differ between the batch's halves (DP_TEXT_LENS), and
     `CodecTrainer(SoundStream())` at b8 x 1 s for DP_CODEC_STEPS
     adversarial steps (the STFT term off), each run plain first; (a)
     world size 1 over NCCL in this process, `param_sharding`
     "replicated" and "fsdp", held to the plain runs within DP_STATE_RTOL
     of each tensor's largest entry (states, each step's reduced gradient,
     metrics; the codec within GRAD_RTOL by every step's reduced codec and
     discriminator gradients, its codebook EMA and counts and its metrics,
     each step after the first from the plain run's checkpoint, not by its
     weights), launches exact; (b) the same on two gloo ranks
     sharing this card (two processes, collectives through host memory),
     held to the plain runs within GRAD_RTOL, each rank's launches exact and printed,
     killed past DP_LIMIT_S; two NCCL ranks, one per card, only where the
     host has two cards (else a line says that leg did not run); ms per
     step of each, (b)'s labelled as two ranks on one card.
 45. tensor and sequence parallelism (`parallel/tp.py`, `sp.py`) on two
     gloo ranks sharing this card at (data 1, model 2): (a) the flagship
     `Trainer(param_sharding="tp")` at b16 x 2 s for TP_STEPS steps and
     README config 2 for one step with its dropout on, against the single
     process within GRAD_RTOL; (b) the scaled Model(dim 512, depth 12)
     denoise step at b16 x n1024 within TP_SCALED_RTOL; (c) README config 2
     served by `cli.build_engine(tp=2)`, a batch of four requests and a
     predicted-length one, within TP_SERVE_ATOL of the single-process
     engine; (d) `sp_attend` with its K5 gradient and flash `ring_attend`
     at SP_SHAPE against K4 / K5 on the whole within FLASH_TOL; (e) K2 /
     K2b with the residual off and K4 / K5 with dropout offsets against
     their plain versions, K4's keep mask bit for bit. Each rank's
     launches are exact and printed; killed past TP_LIMIT_S.
K2, K2b and K3 are held to BLOCK_TOL (split TF32 on the tensor cores
against f32 plain versions) at every shape they run: b4 x n1024 x dim 128,
the conditional [8, 512, 128], the long-form n4500 and n9000 and the
scaled b16 x n1024 x dim 512; K1 and K1b to WAVENET_TOL at every shape
they run (b4 x n1024, n4500, n9000, n6733, dim 512 pinned, dim 16).
The line before the last is the kernels' JSON summary (each kernel's
time, plain time, bound and launches, by path: "serve" counts phase 20's
50 sequential requests, "train_amp" and "conditional_train_amp" phases 28
and 29's ten AMP steps, "encodec_*" and "codec_train_*" phases 37-39's
paths, "unfused_wavenet_sample", "plain_transformer", "flac_train_k4" /
"flac_train_k1", "dispatch", "codec_train_jit", "codec_train_amp_*" and
"serve_flac" phases 40-43's, "dp_nccl1_*" and "dp_gloo2_rank0_*" phase
44's (a) and (b) runs, "tp_gloo2_rank0_*" phase 45's rank 0; a row per dtype, "mixed" for f32 activations
against bf16 weights, the bf16 and mixed rows with their f32 kernel's
time at the same shape, and a "bf16_matmul" row for K1b's option, whose
launches are the probe's); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.

    python3 chip_smoke.py --profile

instead profiles 10 flagship denoise steps, a 10-step conditional sample
of README config 2, 10 guided steps and their 60 K2b calls alone, one RVQ
call, one long-form denoise step at n4500 and at n9000, one scaled
denoise step, one training step, one conditional training step (with
its loops' host times) and one served request with torch.profiler and
prints
the device time by kernel, and the kernels that
F.scaled_dot_product_attention (K4's and K5's yardstick) runs.
"""

from __future__ import annotations

import argparse
import copy
import itertools
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
# Flash attention (K4, K5) vs plain on unit-normal inputs: absolute on K4's
# o and lse, relative to each gradient's largest entry for K5, at every
# shape and in the masked, causal, dropout case. The kernels run split TF32
# (three TF32 products per f32 product) where the plain versions run f32.
# Emulated on the CPU, three passes stay within 1.2e-6 of f64 at n 150 and
# 1024 and one TF32 pass errs by 1.7e-4 to 8e-4
# (tests/test_torch_tf32_split.py); on the card the tensor cores' truncating
# adds bring the kernels to a few 1e-6. 1e-5 passes three passes with room
# and fails one.
FLASH_TOL = 1e-5
# The fused blocks K2, K2b and K3 vs plain on the card, relative to the
# largest entry of y - x (the block's own output, without the residual):
# all run their products in split TF32 on the GEMM core (K2's and K2b's
# attention cores on K4), the plain versions in f32. Emulated on the CPU
# with the tensor cores' truncating adds, the core stays within 5e-7 of f64
# at the K of K3's conv (3 x 352 and 3 x 1376) and one TF32 pass errs by
# 3e-4; K2b's four launches at the conditional widths within 6.9e-7, one
# pass 8.5e-4 (tests/test_torch_tf32_split.py). 1e-5 passes three passes
# with room and fails one; KERNEL_TOL's 1e-3 absolute would pass a kernel
# that quietly ran one pass.
BLOCK_TOL = 1e-5
# The WaveNet body K1 / K1b vs plain on the card, relative to the largest
# entry of the output: every block's product and the skips run split TF32
# on the GEMM core, the plain versions f32. Emulated on the CPU with the
# tensor cores' truncating adds, the 32-block chain (4 x 8, d 128) stays
# within 4e-7 of f64 and one TF32 pass errs by 5e-4; the plain f32 chain is
# within 5e-7 (tests/test_torch_tf32_split.py). 1e-5 passes three passes
# with room and fails one, where KERNEL_TOL's 1e-3 absolute would not.
WAVENET_TOL = 1e-5
# RVQ near-ties: squared distances are ~256 at d 128; two candidates closer
# than this may swap between the kernel and the plain version. The kernel's
# distances run split TF32 on the tensor cores: emulated on the CPU with
# their truncating adds they err by up to 4.4e-5 in d² at d 128 and one
# TF32 pass by 5.5e-2 (tests/test_torch_tf32_split.py).
RVQ_TIE_TOL = 1e-3
# Card vs CPU gradients of the training loss (phase 8), per parameter
# tensor relative to its largest entry: reorderings through the backward
# of 32 WaveNet blocks and 6 transformer layers, ~1e-5; a wrong index in a
# kernel or a backward is O(1).
GRAD_RTOL = 1e-3
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_STEPS, SAMPLE_FRAMES = 16, 2.0, 10, 32
# per optimizer step at 150 frames, off the JAX package's block gates
# (150 % 8 != 0): the forward runs K1, 6 unfused attention blocks on K4,
# 6 unfused feed-forwards and the codec's RVQ (K6); the backward runs K5
# for each attention block
PER_STEP = {"wavenet_body": 1, "wavenet_body_lanes": 0, "attn_block": 0,
            "cross_attn_block": 0, "ff_block": 0, "flash_forward": DEPTH,
            "flash_backward": DEPTH, "rvq": 1}
PER_DENOISE = {"wavenet_body": 1, "wavenet_body_lanes": 0, "attn_block": DEPTH,
               "cross_attn_block": 0, "ff_block": DEPTH, "flash_forward": 0,
               "flash_backward": 0, "rvq": 0}
# README config 2 and the old bench's conditional leg (bench.py:334-380)
DIM_PROMPT, NUM_LATENTS, RESAMPLER_DEPTH, PROMPT_DEPTH = 512, 32, 2, 6
COND_BATCH, TEXT_LEN, PROMPT_SAMPLES, COND_LENGTH, COND_SCALE = 4, 100, 32768, 512, 3.0
TEXT_LENS = (100, 100, 80, 120)
# per conditional sample of STEPS guided steps: each runs the denoiser on
# the doubled batch (K1, 6 x K2, 6 x K2b, 6 x K3, the resampler's 2 x K4);
# the conditioning runs the prompt encoder's 6 x K4 and the prompt's RVQ
PER_COND_SAMPLE = {"wavenet_body": STEPS, "wavenet_body_lanes": 0, "attn_block": DEPTH * STEPS,
                   "cross_attn_block": DEPTH * STEPS, "ff_block": DEPTH * STEPS,
                   "flash_forward": PROMPT_DEPTH + RESAMPLER_DEPTH * STEPS,
                   "flash_backward": 0, "rvq": 1}
# Long-form and scaled sampling, the JAX bench's legs `longform` and
# `scaled` (bench.py:147-192, :617-628): Model(heads=8, dim_head=64,
# scan_layers=True), v-objective, sigmoid schedule. Long-form: dim 128,
# depth 6 with SoundStream, b1, 50 DDIM steps, 60 s (n 4500) and 120 s
# (n 9000). Scaled: dim 512, depth 12, b16 x n1024, latents only
# (SoundStream's codebook is 128 wide), cut from 100 DDIM steps to
# STEPS_SCALED (each step is the same work).
LONG_LENGTHS, LONG_STEPS = (4500, 9000), 50
RAGGED_LANES = 6733  # past K1's budget (n > 6712), so K1b, and off every tile
SCALED_DIM, SCALED_DEPTH, SCALED_BATCH, STEPS_SCALED = 512, 12, 16, 20
# per denoise step, by the JAX package's gates: at n 4500 (4500 % 8 != 0)
# K1, attention unfused on K4, the feed-forward unfused; at n 9000 K1b (past
# K1's budget), attention on K4 (past K2's), K3; at d 512 the plain
# WaveNet body (past both WaveNet budgets), K2 and K3
PER_LONG_DENOISE = {LONG_LENGTHS[0]: {"wavenet_body": 1, "flash_forward": DEPTH},
                    LONG_LENGTHS[1]: {"wavenet_body_lanes": 1, "ff_block": DEPTH,
                                      "flash_forward": DEPTH}}
PER_SCALED_DENOISE = {"attn_block": SCALED_DEPTH, "ff_block": SCALED_DEPTH}
WAVENET_STACKS, WAVENET_LAYERS = 4, 8
# Phase 16, the widths the JAX package's tests run its Pallas kernels at:
# dim 16, dim_head 8, codebook dim 16, a context 24 wide, 16 frames; and the
# port's CPU test configs, copied from tests/test_torch_conditional.py
# (MODEL_CFG, CODEC_CFG, NS2_CFG) and tests/test_torch_scan_layers.py
# (CT_CFG; COND_MODEL_CFG with scan_layers and its CODEC_CFG).
W_DIM, W_HEADS, W_DIM_HEAD, W_CONTEXT, W_LENGTH, W_BATCH = 16, 2, 8, 24, 16, 2
W_COND_MODEL = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                    condition_on_prompt=True, dim_prompt=24, num_latents_m=8, resampler_depth=1,
                    cond_drop_prob=0.25)
W_COND_CODEC = dict(codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16)
W_NS2 = dict(
    timesteps=1000, num_phoneme_tokens=20, duration_pitch_dim=24, aligner_dim_in=8,
    aligner_dim_hidden=24, aligner_attn_channels=8, pitch_emb_pp_hidden_dim=24,
    phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, depth=1, heads=2, dim_head=8),
    prompt_enc_kwargs=dict(dims=(24, 24), depth=1, heads=2, dim_head=8),
    duration_pitch_kwargs=dict(dim_hidden=24, depth=1, heads=2, dim_head=8,
                               dim_encoded_prompts=24),
)
W_CT = dict(dim=16, depth=3, dim_head=8, heads=2, ff_causal_conv=True, dim_cond_mult=4)
W_SCAN_MODEL = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2,
                    condition_on_prompt=True, dim_prompt=24, num_latents_m=8, resampler_depth=1,
                    scan_layers=True)
W_SCAN_CODEC = dict(channels=4, codebook_dim=16)
# per guided forward of those models at 16 frames, by the JAX package's
# gates (all pass): K1, K2, K2b and K3 per layer, the resampler's K4; a
# 2-step guided sample adds the conditioning's prompt encoder (K4) and the
# prompt's RVQ (K6)
W_PER_FORWARD = {"wavenet_body": 1, "wavenet_body_lanes": 0, "attn_block": 2,
                 "cross_attn_block": 2, "ff_block": 2, "flash_forward": 1, "flash_backward": 0,
                 "rvq": 0}
W_PER_SAMPLE = {**{k: 2 * v for k, v in W_PER_FORWARD.items()}, "flash_forward": 1 + 2, "rvq": 1}
# Conditional training, the JAX bench's leg `measure_conditional_train_throughput`
# (bench.py:267-331): README config 2 (as phase 10, with scan_layers) and the
# default conditioning stack (prompt encoder depth 6 with attention dropout
# 0.2 on K4 / K5, phoneme encoder depth 6, duration / pitch trunks depth 10,
# aligner 512 wide, 80 mel bins, ACF pitch) at b16, 2-s crops (48,000
# samples: 150 latent frames, 301 mel frames at hop 160), 100 text tokens and
# a 32,768-sample prompt (102 latent frames), cut to CT_STEPS optimizer steps.
CT_BATCH, CT_SAMPLES, CT_TEXT, CT_STEPS, CT_DROPOUT = 16, 48000, 100, 10, 0.2
CT_FRAMES, CT_PROMPT_FRAMES, CT_MEL_FRAMES = CT_SAMPLES // 320, PROMPT_SAMPLES // 320, 301
# per conditional optimizer step: K6 on the audio and on the prompt; K1 once
# (its backward is the vjp of the plain body, as in JAX); K4 for the prompt
# encoder's 6 layers, the resampler's 2 and the denoiser's 6 self- and 6
# cross-attention blocks (all unfused: 150 % 8 != 0), K5 for each of them;
# the phoneme encoder and the duration / pitch trunks attend on the plain
# route (their JAX defaults); K1b, K2, K2b and K3 never run
CT_FLASH = PROMPT_DEPTH + RESAMPLER_DEPTH + 2 * DEPTH
PER_COND_TRAIN_STEP = {"wavenet_body": 1, "wavenet_body_lanes": 0, "attn_block": 0,
                       "cross_attn_block": 0, "ff_block": 0, "flash_forward": CT_FLASH,
                       "flash_backward": CT_FLASH, "rvq": 2}
# Phase 19, card against CPU: mel in dB (an STFT and a filterbank product by
# cuFFT against pocketfft, ~1e-4 dB), pitch in Hz on frames picking the same
# lag (a frame may pick another where two lags nearly tie: at most 1 in 50)
MEL_TOL_DB, PITCH_TOL_HZ, PITCH_TIE_SHARE = 1e-2, 1e-2, 0.02
# Serving, the JAX bench's leg `measure_serving` (bench.py:383-431): README
# config 2 with Tokenizer() (num_phoneme_tokens = its vocab_size) behind
# `cli.build_engine` with the JAX engine's default buckets, 100 guided DDIM
# steps at cond_scale 2.5, the bench's sentence (54 tokens: the 64 text
# bucket) at 6.8 s (510 frames: the 512 frame bucket). The timed window:
# SERVE_REQUESTS sequential requests, SERVE_ROUNDS rounds of SERVE_BATCH
# concurrent ones (after one untimed round), SERVE_POSTS POSTs over HTTP
SERVE_MODEL = dict(dim=DIM, depth=DEPTH, dim_prompt=DIM_PROMPT, cond_drop_prob=0.25,
                   condition_on_prompt=True)
SERVE_COND_SCALE, SERVE_SECONDS, SERVE_BUCKET = 2.5, 6.8, (64, 512)
SERVE_REQUESTS, SERVE_BATCH, SERVE_ROUNDS, SERVE_POSTS = 50, 4, 10, 10
SERVE_SENTENCE = "speech synthesis on tensor processing units runs fast."
SERVE_STREAM_TEXT = "Hello there, this is a streamed reply. It comes in two sentences."
# 190 tokens, past the largest text bucket (128): long-formed by sentence
SERVE_LONG_TEXT = ("The quick brown fox jumps over the lazy dog near the river bank. It was a "
                   "bright cold day in April, and the clocks were striking thirteen. Speech "
                   "synthesis turns written words into sound.")
# Phase 21, card against CPU: 200 frames (the 256 bucket, trimmed), 2 steps;
# a token's truncated duration may flip where the CPU's lies this close to
# an integer
SERVE_CHECK_FRAMES, SERVE_CHECK_STEPS, DURATION_TIE = 200, 2, 1e-3
# H100 SXM peaks at 700 W (NVIDIA's data sheet): dense TF32 on the tensor
# cores, and HBM3. Split TF32, three TF32 products per f32 product, is the
# fastest f32-accurate way the card has to run a matrix product.
PEAK_TF32_FLOPS, TF32_PASSES, PEAK_BYTES_PER_S = 495e12, 3, 3.35e12
# bf16 (phases 22-26). A bf16 kernel against its plain bf16 version, which
# rounds at the same points (the JAX kernels' `.astype(mm)`), relative to
# the plain output's largest entry (of y - x for K2, K2b and K3): the
# products' f32 sums in another order, P rounded against K4's running row
# max where the plain version uses the final one (one bf16 ulp on some
# probabilities), and a bf16 output that may round to the other neighbour
# (2^-8 of its magnitude). A dropped rounding point or a layout fault is
# O(1e-1) or more. The blocks' residual x is drawn at BF16_RESIDUAL_SCALE:
# the norm makes y - x independent of |x|, and at unit scale the output's
# own ulp (2^-6 at |x| ≥ 2) would exceed 1e-2 of max |y - x| by itself.
BF16_TOL, BF16_RESIDUAL_SCALE = 1e-2, 1 / 16
# phase 22's ragged K2 / K3 bf16 shapes (b, n, dm, K3's inner or None): n off
# the bf16 core's 128-row tiles (150, 1000: a sequence's last tile runs past
# its end, the conv's taps past its start), dm and inner off its 64 (dm 96,
# inner 200), and ff_mult 1 (dm 512, inner 341: n(x) padded to 512 columns
# is wider than ip 384, in K3's c scratch)
BF16_RAGGED = ((16, 150, 128, None), (3, 1000, 128, None), (4, 256, 96, 200),
               (2, 200, 512, 341))
# phase 22's K2b bf16 widths beside the served ones, (label, dm, dc, heads,
# dim_head, residual) at x [2, 512, dm], ctx [2, 32, dc]: dm off the core's
# 64, a context whose rows TMA cannot read as they are (dc % 8 != 0: copied
# first, one launch more), heads of 128 (H·dh 512 past dm), and a
# tensor-parallel rank's partial sum (half the heads, no residual)
BF16_CROSS_CASES = (("dm 96", 96, 128, 8, 64, True), ("dc 100", 128, 100, 8, 64, True),
                    ("heads of 128", 128, 128, 4, 128, True),
                    ("residual off, 4 heads", 128, 128, 4, 64, False))
# bf16 card against bf16 CPU through the network (phase 26): the same
# rounding points, sums in another order, so a value near a rounding
# boundary lands on the other neighbour and carries 2^-8 relative through
# the following layers; JAX's own bound for bf16 against f32 is 5e-2
# (tests/test_attn_block.py) and its bf16 sample's correlation with the f32
# one > 0.98 (tests/test_naturalspeech2.py).
BF16_PATH_TOL, BF16_CORR, BF16_F32_CORR = 5e-2, 0.99, 0.98
# phase 25's window, each engine: sequential requests, timed rounds of four
BF16_SERVE_REQUESTS, BF16_SERVE_ROUNDS = 20, 4
# phase 25's `sample --bf16` at SERVE_SECONDS, unbucketed: 510 frames
CLI_BF16_FRAMES = int(round(SERVE_SECONDS * 24000 / 320))
SERVE_SAMPLES = CLI_BF16_FRAMES * 320
# H100 SXM dense bf16 on the tensor cores at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
# Work outside the tensor cores (dropout's Threefry-2x32-20 keep bits: 20
# rounds of add, rotate and xor, 5 key injections of two adds, the counter
# and the compare, ~75 integer operations a probability) is counted at the
# float32 peak, 67 TFLOP/s, the fastest the card's ALUs run: a bound that
# stays a lower bound.
PEAK_F32_FLOPS, THREEFRY_OPS = 67e12, 75
# AMP training (phases 27-30). AMP_FUSED_FRAMES: 51,200 samples, where the
# JAX package's block gates pass (160 % 8 == 0), so the mixed K2, K2b and
# K3 and K2's backward run on a path. Card against CPU (phase 30): the
# codec and the conditioning encoders run bf16 chains whose f32 sums round
# to the other bf16 neighbour here and there on one side (one ulp in some
# layers), and the gradients amplify that, as JAX's own do when the input
# moves by one bf16 ulp (tests/test_torch_amp.py). At README config 2's
# full depth that floor reaches past 1 for the prompt encoder's deepest
# layers' q projections, whose gradients reach the loss through softmax
# attention in bf16 and the duration and pitch trunks' L1 (a sign) on
# bf16 predictions, and one draw of it can be several times another's
# (NVIDIA H100 80GB HBM3). So each loss and each f32 master gradient is
# held to AMP_LOSS_RTOL / AMP_GRAD_RTOL, or to AMP_FLOOR_FACTOR times its
# floor (the largest of AMP_FLOOR_DRAWS draws of a one-ulp move of every
# bf16 input, one of them on the CPU) where that is higher, and all
# gradients together to a correlation of AMP_GRAD_CORR: across 818
# tensors, one draw's change can be several times the largest of three
# others'.
AMP_FUSED_FRAMES = 160
AMP_LOSS_RTOL, AMP_GRAD_RTOL, AMP_GRAD_CORR = 2e-2, 5e-2, 0.99
AMP_FLOOR_DRAWS, AMP_FLOOR_FACTOR = 5, 6.0
# K1 mixed at a width off 64 (padded to 128), (b, n, d); K6 bf16 (m, Q, K,
# d) at a ragged shape (m off the row tile, K and d off 64) and at a d off
# 8, whose rows TMA cannot read (x copied first)
AMP_K1_PADDED = (2, 200, 96)
AMP_RVQ_RAGGED = (510, 4, 1000, 72)
AMP_RVQ_COPIED = (130, 4, 1000, 70)
# K3 and K2 mixed at one ragged shape each that the wrappers take, (b, n,
# dm, inner or None): K3 with neither dm nor inner a multiple of 64 (PERF's
# ragged K3 bf16 shape), K2 at a length off the row tile (held with the
# residual off too)
AMP_K3_RAGGED = (4, 256, 96, 200)
AMP_K2_RAGGED = (3, 1000, 128, None)
# K2b mixed at a ragged shape, (b, n, dm, dc, heads, dim_head): dm and dc
# off 64 (dc 100 off 8 too: the context's rows as they lie are no TMA
# rows), heads of 128, n off the row tile; K1b mixed (b, n, d) at the
# long form's first K1b length and at a width off 64 (padded to 128)
AMP_K2B_RAGGED = (3, 200, 96, 100, 2, 128)
AMP_K1B_SHAPES = ((1, RAGGED_LANES, DIM), (2, 1000, 96))

# Few-step sampling (phases 31-35). Phase 31: K1b's `bf16_matmul` option at
# the JAX probe's shape (b16 x n1024 x d512, 4 x 8; examples/
# wavenet_d512_probe.py) and the long-form lanes shape, held to BF16_TOL of
# the plain version's largest entry (bf16 operands, f32 sums in another
# order, so a product may round its operand to the other bf16 neighbour)
# and a correlation of at least BF16MM_CORR; and at d 96 (padded to 128),
# n 1000 (off the 128-row tiles). Each call is S·L / LANE_GROUP + L launches
# of the bf16 core and one rounding pre-pass of x (profiled).
BF16MM_SHAPES, BF16MM_CORR = ((16, 1024, 512), (1, 9000, 128), (2, 1000, 96)), 0.999
# Phase 32: the flagship's latents from one starting noise by DDIM and
# DPM++ at FEW_STEPS against DDIM at FEW_REF_STEPS (the reference
# trajectory); `sample()` with DDPM at DDPM_STEPS and DPM++ at DPMPP_STEPS;
# DPM++ and DDPM at FEW_CHECK_STEPS x FEW_CHECK_FRAMES card against CPU
# within PATH_TOL.
FEW_STEPS, FEW_REF_STEPS, DDPM_STEPS, DPMPP_STEPS = (8, 16, 25, 50), 1000, 50, 25
FEW_CHECK_STEPS, FEW_CHECK_FRAMES = 3, 50
# Phase 33: README config 2 served by DPM++ at FEW_SERVE_STEPS beside DDIM at
# STEPS, FEW_SERVE_REQUESTS sequential requests each, in turns.
FEW_SERVE_STEPS, FEW_SERVE_REQUESTS = 25, 20
# Phase 34: the self-conditioned flagship Trainer for SC_TRAIN_STEPS steps
# at b16 x 2 s; progressive distillation at b DISTILL_BATCH x n LENGTH,
# DISTILL_STUDENT_STEPS student steps, DISTILL_UPDATES updates. Phase 35
# holds the distillation loss card against CPU at DISTILL_CHECK_FRAMES
# frames (on every block's gate).
SC_TRAIN_STEPS = 3
DISTILL_BATCH, DISTILL_STUDENT_STEPS, DISTILL_UPDATES, DISTILL_CHECK_FRAMES = 4, 8, 3, 64

# The codec slice (phases 36-39): Encodec() at facebook/encodec_24khz's
# architecture (32 filters, ratios 8/5/4/2: hop 320, 75 frames/s; hidden
# 128; a 2-layer LSTM; 8 codebooks of 1024, 6 kbps), seeded random weights
# (no pretrained weights are in the repository). Phase 37: NaturalSpeech2
# on it, trained at b16 x 2 s for ENC_TRAIN_STEPS steps, sampled at
# ENC_SAMPLE_FRAMES frames (6.8 s, on every block's gate), its decode timed
# on a 6.8-s prompt's ENC_PROMPT_FRAMES. Phase 38: CodecTrainer at
# CODEC_TRAIN_BATCH x CODEC_TRAIN_SECONDS for CODEC_TRAIN_STEPS steps,
# adversarial from step 0; card against CPU at CODEC_CHECK_BATCH x
# CODEC_CHECK_SECONDS with the STFT term weighted 0: its log-magnitude term
# has a gradient of 1/|S| along a direction that the FFT's rounding decides
# at bins near zero (cuFFT and pocketfft round differently), which moves
# gradients by ~7 % of their largest entries even between two CPU FFT
# libraries (tests/test_torch_codec_trainer.py). Phase 39: the 48-kHz knobs
# at facebook/encodec_48khz's widths on ENC48_SECONDS of stereo.
ENC_TRAIN_STEPS, ENC_SAMPLE_FRAMES, ENC_PROMPT_FRAMES = 5, 512, 510
CODEC_TRAIN_BATCH, CODEC_TRAIN_SECONDS, CODEC_TRAIN_STEPS = 8, 1.0, 5
CODEC_CHECK_BATCH, CODEC_CHECK_SECONDS = 2, 0.4
ENC48 = dict(target_sample_hz=48000, causal=False, norm_type="time_group_norm",
             audio_channels=2, normalize=True, chunk_length_s=1.0, overlap=0.01)
ENC48_SECONDS = 2.5

# The missing modules (phases 40-43). Phase 40: Model(use_fused_wavenet=False)
# at the flagship's widths (its WaveNet block by block on cuDNN convs, K2 and
# K3 in its transformer). Phase 41: ConditionableTransformer(dim_cond_mult=
# None, ff_causal_conv=False) at the flagship's widths, b4 x n1024 (its
# attention unfused on K4 forward and K5 backward). Phase 42: FLAC_FILES
# seeded FLACs of FLAC_SECONDS (one verbatim frame holds at most 65,535
# samples) feeding the flagship Trainer at b16 x 2 s for DISPATCH_STEPS
# steps, at steps_per_dispatch DISPATCH_K and at 1 (traced over
# PROFILE_STEPS), CodecTrainer.train(CODEC_JIT_STEPS,
# steps_per_jit=CODEC_JIT_K), and CodecTrainer(amp=True) for both codecs,
# card against CPU at phase 38's check size to phase 30's AMP floor. Phase
# 43: phase 20's sentence POSTed with a FLAC prompt, FLAC_POSTS times.
FLAC_FILES, FLAC_SECONDS = 32, 2.5
DISPATCH_K, DISPATCH_STEPS, PROFILE_STEPS = 4, 8, (2, 4)
CODEC_JIT_STEPS, CODEC_JIT_K = 6, 4
FLAC_POSTS = 3
# the port's kernels as torch.profiler names them (the split-TF32 GEMM core
# of K1, K2, K2b, K3 and K6; K4; K5; K6's update; the bf16 GEMM core of
# the bf16 blocks and its norm pre-pass): every string of an entry must
# appear in one kernel's name. K4's and K5's take an ns2::Dropout, which
# tells them from PyTorch's own pytorch_flash::flash_fwd_kernel. Phase 42's
# f32 training trace runs all but BF16_CORE_KERNELS; phase 22 profiles those.
BF16_CORE_KERNELS = (("ns2::bgemm::bf16_gemm_kernel",), ("ns2::bgemm::norm_rows_kernel",))
PORT_KERNELS = (("ns2::gemm::gemm_kernel",), ("flash_fwd_kernel", "ns2::Dropout"),
                ("flash_bwd_dq_kernel", "ns2::Dropout"), ("flash_bwd_dkv_kernel", "ns2::Dropout"),
                ("rvq_update_kernel",), *BF16_CORE_KERNELS)


# Phase 44, data-parallel and FSDP training (parallel/): phase 7's flagship
# at b16 x 2 s for DP_STEPS steps (EMA every step), README config 2 at b16
# x 2 s for one step with the conditioning stack's dropout off (each rank
# draws dropout from its own generator) and text lengths that differ
# between the halves (DP_TEXT_LENS), and CodecTrainer(SoundStream()) at
# phase 38's b8 x 1 s for two adversarial steps, the STFT term off as in
# phase 38's check (its value is a logged metric).
# (a) world size 1 over NCCL in this process, held to the plain Trainer
# within DP_STATE_RTOL of each tensor's largest entry; (b) two ranks on
# this one card over gloo (collectives through host memory), held to (a)'s
# single process within GRAD_RTOL, within DP_LIMIT_S.
DP_STEPS, DP_CODEC_STEPS, DP_STATE_RTOL, DP_LIMIT_S = 3, 2, 1e-6, 600
# The codec's runs are held within GRAD_RTOL by what its data-parallel
# code computes: every step's reduced codec and discriminator gradients,
# the codebook EMA and counts after the steps, and every step's metrics;
# each step after the first starts from the plain run's state. Its
# weights are not held: the codebook update sums with index_add_, whose
# CUDA atomics add in no fixed order, and Adam turns the sign of a
# near-zero gradient into a step of lr either way, so two plain runs on
# the same inputs already differ by 1.1e-4 in a weight
DP_CODEC_LR = 3e-4
DP_TEXT_LENS = (100,) * 8 + (40, 55, 70, 85, 30, 45, 60, 75)
# the conditional step's tensors held card-rank against single process: the
# denoiser's and the duration / pitch predictor's (whose loss is the masked
# mean)
DP_COND_GROUPS = ("model.", "duration_pitch.")

# Phase 45, tensor and sequence parallelism (parallel/tp.py, sp.py): two
# gloo ranks share this one card at (data 1, model 2), collectives through
# host memory, so no figure of it is a multi-card one. (a) phase 44's
# flagship at b16 x 2 s for TP_STEPS steps (its attention unfused, on K4 /
# K5 over each rank's 4 heads) and README config 2, unrolled, for one step
# at phase 18's shapes with its dropout on (the draws seeded alike before
# the step), each against the single process within GRAD_RTOL; (b) the
# scaled Model(dim 512, depth 12), unrolled (JAX keeps a scan_layers tree
# replicated), one denoise step at b16 x n1024 on K2 over 4 heads a rank,
# within TP_SCALED_RTOL of the largest entry; (c) README config 2 with
# Tokenizer() served by cli.build_engine(tp=2) at TP_SERVE_STEPS steps: a
# batch of four requests and one whose length the duration predictor
# chooses, against the single-process engine within TP_SERVE_ATOL;
# (d) sp_attend (K4, and K5 for its gradient) and flash ring_attend at
# SP_SHAPE, 4500 positions a rank, against one K4 / K5 call on the whole;
# (e) in this process, K2 / K2b without the residual and K4 / K5 with
# dropout offsets against their plain versions.
TP_STEPS, TP_SCALED_RTOL, TP_SERVE_STEPS, TP_SERVE_ATOL, TP_LIMIT_S = 3, 1e-5, 10, 2e-4, 600
SP_SHAPE = (1, 8, 9000, 64)
TP_COND_GROUPS = ("model.", "duration_pitch.", "phoneme_enc.")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def compare(phase: str, name: str, actual, reference, tol: float,
            relative: bool = False) -> float:
    """Max abs error of ``actual`` against ``reference`` (tensors or tuples
    of them); raises when it, or with ``relative`` the error relative to
    the reference's largest entry, is above ``tol``."""
    import torch

    if isinstance(actual, (tuple, list)):
        return max(compare(phase, f"{name}[{i}]", a, r, tol, relative)
                   for i, (a, r) in enumerate(zip(actual, reference)))
    actual, reference = actual.float().cpu(), reference.float().cpu()
    if actual.shape != reference.shape:
        raise AssertionError(f"{name}: shape {tuple(actual.shape)} vs {tuple(reference.shape)}")
    if not torch.isfinite(actual).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (actual - reference).abs().max().item()
    rel = err / reference.abs().max().clamp(min=1e-30).item()
    kind = "relative to the largest entry" if relative else "abs"
    log(phase, f"{name}: max_abs_err {err:.3e} max_rel_err {rel:.3e} (tolerance {tol:g} {kind})")
    if (rel if relative else err) > tol:
        worst = rel if relative else err
        raise AssertionError(f"{name}: max {kind} error {worst:.3e} above {tol:g}")
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


def _randn(gen):
    import torch

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    return rn


def wavenet_inputs(gen, b, n, d, S=WAVENET_STACKS, L=WAVENET_LAYERS):
    """The WaveNet body's inputs at one shape, and its bound."""
    rn = _randn(gen)
    wn = (rn(b, n, d), rn(S, L, 3 * d, d, scale=(3 * d) ** -0.5), rn(S, L, d, scale=0.1),
          rn(S, L, d, d, scale=d**-0.5), rn(S, L, d, scale=0.1), rn(L, d, d, scale=d**-0.5),
          rn(L, d, scale=0.1), 1 + rn(b, S, L, 2 * d, scale=0.1))
    # multiply-adds of the matrix products, 2 FLOPs each
    return wn, bound(2 * b * n * d * d * (S * L * 4 + L), nbytes(*wn) + b * n * d * 4)


def attn_inputs(gen, b, n, d, heads=HEADS, dim_head=DIM_HEAD):
    """x, γ, β and the Dense layouts W_q, W_kv, W_o of the attention block."""
    rn = _randn(gen)
    hd = heads * dim_head
    return (rn(b, n, d), 1 + rn(b, d, scale=0.1), rn(b, d, scale=0.1), rn(d, hd, scale=d**-0.5),
            rn(d, 2 * hd, scale=d**-0.5), rn(hd, d, scale=hd**-0.5))


def kernel_cases(gen, b=BATCH, n=LENGTH, d=DIM, heads=HEADS, dim_head=DIM_HEAD,
                 stacks=WAVENET_STACKS, layers=WAVENET_LAYERS):
    """(name, source, replaces, kernel call, plain call, bound, residual) of
    K1, K2 and K3 at one shape (the flagship's by default), inputs drawn
    from ``gen`` on the card; ``residual`` is the block's x (K2, K3), which
    BLOCK_TOL's comparison takes off, or None (K1, held to WAVENET_TOL)."""
    from naturalspeech2_tpu_torch.ops import attn_block_kernel, ff_block_kernel, wavenet_kernel

    rn = _randn(gen)
    inner = int(d * 4 * 2 / 3)
    out_bytes = b * n * d * 4
    wn, wn_work = wavenet_inputs(gen, b, n, d, stacks, layers)
    attn = attn_inputs(gen, b, n, d, heads, dim_head)
    x, gamma, beta = attn[:3]
    split = attn_block_kernel.split_heads(*attn[3:], heads, dim_head)
    w1, b1 = rn(d, 2 * inner, scale=d**-0.5), rn(2 * inner, scale=0.1)
    wc, bc = rn(3, inner, inner, scale=(3 * inner) ** -0.5), rn(inner, scale=0.1)
    w2, b2 = rn(inner, d, scale=inner**-0.5), rn(d, scale=0.1)
    scale = dim_head**-0.5
    ff_flops = 2 * b * n * (d * 2 * inner + 3 * inner * inner + inner * d)
    return [
        ("wavenet_body", "naturalspeech2_tpu_torch/csrc/wavenet.cu",
         "naturalspeech2_tpu/ops/wavenet_kernel.py:80",
         lambda: wavenet_kernel._forward("stack", *wn),
         lambda: wavenet_kernel.wavenet_body_torch(*wn), wn_work, None),
        ("attn_block", "naturalspeech2_tpu_torch/csrc/attn_block.cu",
         "naturalspeech2_tpu/ops/attn_block_kernel.py:92",
         lambda: attn_block_kernel.attn_block(*attn, heads=heads, dim_head=dim_head, scale=scale),
         lambda: attn_block_kernel.attn_block_torch(x, gamma, beta, *split, scale=scale),
         attn_work(b, n, d, attn, heads, dim_head), x),
        ("ff_block", "naturalspeech2_tpu_torch/csrc/ff_block.cu",
         "naturalspeech2_tpu/ops/ff_block_kernel.py:97",
         lambda: ff_block_kernel.ff_block(x, gamma, beta, w1, b1, wc, bc, w2, b2),
         lambda: ff_block_kernel.ff_block_torch(x, gamma, beta, w1[:, :inner], b1[:inner],
                                                w1[:, inner:], b1[inner:], wc, bc, w2, b2),
         bound(ff_flops, nbytes(x, gamma, beta, w1, b1, wc, bc, w2, b2) + out_bytes), x),
    ]


def attn_work(b, n, d, attn, heads=HEADS, dim_head=DIM_HEAD) -> dict:
    """Bound of K2: the q/k/v and out projections and the n² logits and
    P·V products."""
    hd = heads * dim_head
    flops = 2 * b * n * d * 4 * hd + 4 * b * heads * n * n * dim_head
    return bound(flops, nbytes(*attn) + b * n * d * 4)


def hold(phase: str, label: str, out, ref, residual=None) -> float:
    """A fused block against its plain version: with the block's
    ``residual`` x (K2, K3) y - x within BLOCK_TOL of the largest entry of
    the plain y - x, else (K1, K1b) the body's output within WAVENET_TOL of
    its largest entry. Returns the max abs error."""
    if residual is None:
        return compare(phase, label, out, ref, WAVENET_TOL, relative=True)
    return compare(phase, f"{label} (y - x)", out - residual, ref - residual, BLOCK_TOL,
                   relative=True)


def timed_case(phase: str, label: str, kernel, plain, work: dict, reps: int = 20,
               residual=None) -> dict:
    """A kernel against its plain version on the card (``hold``): the max
    abs error, both times and the bound."""
    import torch

    out = kernel()
    torch.cuda.synchronize()
    err = hold(phase, label, out, plain(), residual)
    del out
    ms, plain_ms = cuda_ms(kernel, reps=reps), cuda_ms(plain, reps=reps)
    log(phase, f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of {reps}), bound "
               f"{work['bound_ms']:.4f} ms ({work['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **work}


def flagship(seed: int, conditional: bool = False, codec: bool = True, **model_kw):
    """The flagship NaturalSpeech2 on the CPU, or with ``conditional`` README
    config 2, or with ``model_kw`` overriding the Model's arguments (the
    long-form and scaled configs; ``codec=False`` samples latents only),
    with seeded noise on every parameter, so no zero or one init hides a
    layout fault."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg

    cond = dict(dim_prompt=DIM_PROMPT, cond_drop_prob=0.25, condition_on_prompt=True)
    model_kw = {"dim": DIM, "depth": DEPTH, "heads": HEADS, "dim_head": DIM_HEAD,
                **(cond if conditional else {}), **model_kw}
    torch.manual_seed(seed)
    ns2 = ns2pkg.NaturalSpeech2(ns2pkg.Model(**model_kw), ns2pkg.SoundStream() if codec else None,
                                timesteps=1000)
    return jitter_params(ns2, seed + 1)


def jitter_params(module, seed: int):
    """Seeded noise (std 0.02) on every parameter of ``module``."""
    import torch

    with torch.no_grad():
        jitter = torch.Generator().manual_seed(seed)
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=jitter) * 0.02)
    return module


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, vector_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the matrix
    operations in split TF32 (three TF32 passes each) over the TF32 peak,
    other operations over the float32 peak, and the bytes (each input read
    once, each output written once) over the memory rate."""
    ops_ms = max(TF32_PASSES * flops / PEAK_TF32_FLOPS, vector_ops / PEAK_F32_FLOPS) * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


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
    for name, source, replaces, kernel, plain, work, residual in kernel_cases(gen):
        timing = timed_case("2", name, kernel, plain, work, residual=residual)
        summary.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        **timing, "library_ms": None,
                        "by_shape": {f"[{BATCH},{LENGTH},{DIM}]": timing}})
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


def sdpa_calls(q, k, v, do, scale: float, dropout_p: float = 0.0):
    """One PyTorch call computing K4's function (F.scaled_dot_product_attention,
    with ``dropout_p`` its own random keep mask) and one computing K5's (its
    autograd backward), a yardstick only."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale, dropout_p=dropout_p)
    fwd = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale,  # noqa: E731
                                                 dropout_p=dropout_p)
    bwd = lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
    return fwd, bwd


def flash_work(b, h, n_q, n_kv, d, backward: bool = False, dropout: bool = False) -> dict:
    """Bound of K4 (QKᵀ and PV) or K5 (QKᵀ, dO·Vᵀ, dV, dQ, dK), unmasked: the
    inputs q, k, v (and lse, o, dO) read once, the outputs written once;
    with ``dropout`` the keep bits of every probability (K5 regenerates
    them in its dq and its dk/dv kernel)."""
    q_bytes, kv_bytes, lse_bytes = 4 * b * h * n_q * d, 4 * b * h * n_kv * d, 4 * b * h * n_q
    keep_ops = THREEFRY_OPS * b * h * n_q * n_kv if dropout else 0.0
    if backward:
        return bound(10 * b * h * n_q * n_kv * d,
                     3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes + 2 * kv_bytes,
                     2 * keep_ops)
    return bound(4 * b * h * n_q * n_kv * d, q_bytes + 2 * kv_bytes + q_bytes + lse_bytes,
                 keep_ops)


def flash_case(phase: str, gen, b, h, n_q, n_kv, d=DIM_HEAD, backward: bool = True,
               dropout_rate: float = 0.0, seed=(0x5EED0017, 0xC0DE)):
    """K4 (and K5) at one shape, with attention dropout at ``dropout_rate``
    from ``seed``, against the plain versions within FLASH_TOL (absolute for
    o and lse, relative to each gradient's largest entry): errors, the
    kernels', plain versions' and SDPA's times, and the bounds."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    q, do = (torch.randn(b, h, n_q, d, generator=gen, device="cuda") for _ in range(2))
    k, v = (torch.randn(b, h, n_kv, d, generator=gen, device="cuda") for _ in range(2))
    cfg = dict(causal=False, scale=d**-0.5, dropout_rate=dropout_rate)
    seed = seed if dropout_rate > 0.0 else None
    fwd = lambda: fa.flash_forward(q, k, v, None, seed, **cfg)  # noqa: E731
    fwd_plain = lambda: fa.flash_forward_torch(q, k, v, None, seed, **cfg)  # noqa: E731
    o, lse = fwd_plain()
    bwd = lambda: fa.flash_backward(q, k, v, None, seed, lse, o, do, **cfg)  # noqa: E731
    bwd_plain = lambda: fa.flash_backward_torch(q, k, v, None, seed, lse, o, do, **cfg)  # noqa: E731
    lib_fwd, lib_bwd = sdpa_calls(q, k, v, do, cfg["scale"], dropout_rate)
    shape = f"[{b},{h},{n_q},{d}]" if n_q == n_kv else f"[{b},{h},{n_q}|{n_kv},{d}]"
    if dropout_rate > 0.0:
        shape += f" dropout {dropout_rate:g}"
    drops = dropout_rate > 0.0
    cases = [("flash_forward", fwd, fwd_plain, lib_fwd,
              flash_work(b, h, n_q, n_kv, d, dropout=drops))]
    if backward:
        cases.append(("flash_backward", bwd, bwd_plain, lib_bwd,
                      flash_work(b, h, n_q, n_kv, d, backward=True, dropout=drops)))
    results = {}
    for name, kernel, plain, library, work in cases:
        out = kernel()
        torch.cuda.synchronize()
        err = compare(phase, f"{name} {shape}", out, plain(), FLASH_TOL,
                      relative=name == "flash_backward")
        del out
        ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), cuda_ms(library)
        log(phase, f"{name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                   f"SDPA {lib_ms:.4f} ms (median of 20), bound {work['bound_ms']:.4f} ms "
                   f"({work['bound_by']})")
        results[name] = (shape, err, {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                      **work})
    return results


def _flash_timed_cases(gen) -> tuple[dict, dict]:
    """K4 and K5 at the training shape and at n 1024: errors and times."""
    errs = {"flash_forward": 0.0, "flash_backward": 0.0}
    times = {}
    for b, h, n, d in ((TRAIN_BATCH, HEADS, 150, DIM_HEAD), (4, HEADS, 1024, DIM_HEAD)):
        for name, (shape, err, timing) in flash_case("6", gen, b, h, n, n, d).items():
            errs[name] = max(errs[name], err)
            times.setdefault(name, {})[shape] = timing
    return errs, times


def _flash_masked_dropout_case(gen, d: int = DIM_HEAD, phase: str = "6") -> dict:
    """A masked, causal, dropout case with fully masked rows at head dim
    ``d``: outputs and gradients within tolerance, masked keys' gradients
    exactly 0, and the kernel's keep mask equal to the plain one element
    for element."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    b, h, n, rate, seed = 3, 2, 200, 0.1, (0x0BADC0DE, 0x5EED)
    mask = torch.ones(b, n, dtype=torch.bool, device="cuda")
    mask[1, :3] = False  # with causal masking, batch 1's rows 0..2 see no key
    mask[2] = False      # batch 2 sees none at all
    cfg = dict(causal=True, scale=d**-0.5, dropout_rate=rate)
    q, k, v, do = (torch.randn(b, h, n, d, generator=gen, device="cuda") for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, mask, seed, **cfg)
    o_ref, lse_ref = fa.flash_forward_torch(q, k, v, mask, seed, **cfg)
    err = compare(phase, f"flash_forward masked causal dropout d {d}", (o, lse), (o_ref, lse_ref),
                  FLASH_TOL)
    if not (torch.all(o[2] == 0) and torch.all(lse[2] == fa.NEG_INF)
            and torch.all(o[1, :, :3] == 0)):
        raise AssertionError("flash_forward: fully masked rows are not o = 0, lse = NEG_INF")
    grads = fa.flash_backward(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)
    grads_ref = fa.flash_backward_torch(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)
    err_b = compare(phase, f"flash_backward masked causal dropout d {d}", grads, grads_ref,
                    FLASH_TOL, relative=True)
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
    log(phase, f"dropout keep masks identical at d {d}: {int(kept.sum())} of "
               f"{int(visible.sum())} visible probabilities kept at rate {rate} (kernel, plain "
               "and the Threefry mask)")
    return {"flash_forward": err, "flash_backward": err_b}


def codes_tie_tolerant(phase: str, label: str, x, codebooks, codes, ref):
    """RVQ codes [m, Q] against reference codes of the rows x [m, d]: a row
    may part from the reference only at a stage whose two candidates are
    within RVQ_TIE_TOL of the residual (advanced along the reference
    codes), and at most 1 % of rows may; returns the mask of agreeing
    rows."""
    import torch

    xd, cbd = x.detach().double().cpu(), codebooks.detach().double().cpu()
    codes_c, ref_c = codes.long().cpu(), ref.long().cpu()
    m, num_q = codes_c.shape
    same = (codes_c == ref_c).all(dim=1)
    for row in torch.nonzero(~same).flatten().tolist():
        stage = int(torch.nonzero(codes_c[row] != ref_c[row])[0])
        r = xd[row] - sum(cbd[s][ref_c[row, s]] for s in range(stage))
        gap = abs(((r - cbd[stage][codes_c[row, stage]]) ** 2).sum()
                  - ((r - cbd[stage][ref_c[row, stage]]) ** 2).sum())
        if gap > RVQ_TIE_TOL:
            raise AssertionError(f"{label}: row {row} stage {stage} code differs by {gap:.3e} in d²")
    if (~same).sum() > m // 100:
        raise AssertionError(f"{label}: {int((~same).sum())} rows part at near-ties, over 1 %")
    log(phase, f"{label}: codes [{m},{num_q}] equal in {int(same.sum())} of {m} rows, the rest "
               f"near-ties within {RVQ_TIE_TOL:g}")
    return same


def _rvq_case(gen, m=TRAIN_BATCH * int(TRAIN_SECONDS * 24000) // 320, num_q=8, size=1024,
              d=128, phase="6", timed=True, x=None, cb=None):
    """K6 against its plain version, codes tie-tolerantly: the error of the
    agreeing rows and, if ``timed``, both times and the bound. Rows ``x``
    [m, d] and codebooks ``cb`` [Q, K, d] are drawn from ``gen`` unless
    given."""
    import torch

    from naturalspeech2_tpu_torch.ops import rvq as rvq_ops

    if x is None:
        x = torch.randn(m, d, generator=gen, device="cuda")
        cb = torch.randn(num_q, size, d, generator=gen, device="cuda")
    kernel = lambda: rvq_ops.rvq(x, cb)  # noqa: E731
    plain = lambda: rvq_ops.rvq_torch(x, cb)  # noqa: E731
    (q, codes), (q_ref, codes_ref) = kernel(), plain()
    torch.cuda.synchronize()
    same = codes_tie_tolerant(phase, f"rvq d {d}", x, cb, codes, codes_ref)
    err = compare(phase, f"rvq quantized d {d} (agreeing rows)", q[same.cuda()],
                  q_ref[same.cuda()], KERNEL_TOL)
    if not timed:
        return err
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    work = bound(2 * num_q * m * size * d, nbytes(x, cb, q, codes))
    log(phase, f"rvq [{m},{d}] Q{num_q} K{size}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
               f"(median of 20), bound {work['bound_ms']:.4f} ms ({work['bound_by']})")
    return err, ms, plain_ms, work


def phase6_training_kernels() -> list:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    errs, times = _flash_timed_cases(gen)
    for name, err in _flash_masked_dropout_case(gen).items():
        errs[name] = max(errs[name], err)
    rvq_err, rvq_ms, rvq_plain_ms, rvq_work = _rvq_case(gen)
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
            "max_abs_err": errs[name], **times[name][train_shape], "by_shape": times[name],
        })
    rvq_timing = {"ms": rvq_ms, "plain_ms": rvq_plain_ms, **rvq_work}
    summary.append({"name": "rvq", "route": "cuda", "source": "naturalspeech2_tpu_torch/csrc/rvq.cu",
                    "replaces": "naturalspeech2_tpu/ops/rvq.py:60", "max_abs_err": rvq_err,
                    **rvq_timing, "library_ms": None, "by_shape": {"d 128": rvq_timing}})
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
        results.append((losses["loss"].item(),
                        {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}))
    if not any(n.startswith("model.") for n in results[1][1]):
        raise AssertionError("the denoiser has no gradients")
    _grads_card_vs_cpu("8", "loss b2 x 0.4 s", results)


def cross_inputs(gen, b, n, m, d, dc, heads=HEADS, dim_head=DIM_HEAD) -> tuple:
    """x [b, n, d], ctx [b, m, dc], γ, β and the Dense layouts W_q, W_kv,
    W_o of the cross-attention block, drawn from ``gen`` on the card."""
    rn = _randn(gen)
    hd = heads * dim_head
    return (rn(b, n, d), rn(b, m, dc), 1 + rn(b, d, scale=0.1), rn(b, d, scale=0.1),
            rn(d, hd, scale=d**-0.5), rn(dc, 2 * hd, scale=dc**-0.5), rn(hd, d, scale=hd**-0.5))


def cross_case(phase: str, gen, b, n, m, d, dc, heads=HEADS, dim_head=DIM_HEAD,
               timed: bool = True) -> dict:
    """K2b against its plain version at x [b, n, d], ctx [b, m, dc]: y - x
    within BLOCK_TOL (``hold``), the max abs error and, if ``timed``, both
    times and the bound."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak

    x, ctx, gamma, beta, wq, wkv, wo = args = cross_inputs(gen, b, n, m, d, dc, heads, dim_head)
    hd = heads * dim_head
    split = ak.split_heads(wq, wkv, wo, heads, dim_head)
    scale = dim_head**-0.5
    kernel = lambda: ak.cross_attn_block(*args, heads=heads, dim_head=dim_head,  # noqa: E731
                                         scale=scale)
    plain = lambda: ak.cross_attn_block_torch(x, ctx, gamma, beta, *split, scale=scale)  # noqa: E731
    out = kernel()
    torch.cuda.synchronize()
    err = hold(phase, f"cross_attn_block x [{b},{n},{d}] ctx [{b},{m},{dc}] dh {dim_head}", out,
               plain(), x)
    if not timed:
        return {"max_abs_err": err}
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
    flops = 2 * b * n * d * 2 * hd + 2 * b * m * dc * 2 * hd + 4 * b * heads * n * m * dim_head
    work = bound(flops, nbytes(x, ctx, gamma, beta, wq, wkv, wo) + nbytes(out))
    log(phase, f"cross_attn_block: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20), "
               f"{flops / 1e9:.3f} GFLOP, bound {work['bound_ms']:.4f} ms ({work['bound_by']}), "
               f"{flops / ms / 1e9:.2f} TFLOP/s")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **work}


def phase9_conditional_kernels(summary: list) -> tuple[list, dict]:
    """K2b, K2 and K3 at the conditional denoiser's shape (K2's and K3's
    timings go to their entries in ``summary``), and K4 at the resampler's
    and the prompt encoder's shapes; returns K2b's summary entry and K4's
    timings by shape."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    # the guided batch is doubled; the context is the 32 resampled latents
    b, n, m, d = 2 * COND_BATCH, COND_LENGTH, NUM_LATENTS, DIM
    timing = cross_case("9", gen, b, n, m, d, d)
    entry = {"name": "cross_attn_block", "route": "cuda",
             "source": "naturalspeech2_tpu_torch/csrc/cross_attn_block.cu",
             "replaces": "naturalspeech2_tpu/ops/attn_block_kernel.py:237", **timing,
             "library_ms": None, "by_shape": {f"x [{b},{n},{d}], ctx [{b},{m},{d}]": timing}}
    entries = {e["name"]: e for e in summary}
    shape = f"[{b},{n},{d}]"
    for name, _, _, kernel, plain, work, residual in kernel_cases(gen, b, n, d):
        if residual is not None:
            entries[name]["by_shape"][shape] = timed_case("9", f"{name} {shape}", kernel, plain,
                                                          work, residual=residual)

    prompt_frames = PROMPT_SAMPLES // 320
    flash = {}
    for shape in ((b, HEADS, m, m + prompt_frames), (COND_BATCH, HEADS, prompt_frames,
                                                      prompt_frames)):
        for name, (key, err_k4, timing) in flash_case("9", gen, *shape, backward=False).items():
            flash[key] = (err_k4, timing)
    return [entry], flash


def _conditional_inputs():
    """Prompt audio (4, 32768) in [-1, 1), text ids (4, 100) in [0, 100)
    and text_lens, seeded, on the CPU."""
    import torch

    g = torch.Generator().manual_seed(SEED + 11)
    prompt = torch.rand(COND_BATCH, PROMPT_SAMPLES, generator=g) * 2 - 1
    text = torch.randint(0, 100, (COND_BATCH, TEXT_LEN), generator=g)
    return prompt, text, torch.tensor(TEXT_LENS)


def phase10_conditional_sample(ns2) -> dict:
    """The conditional sampling path; returns its launch counts."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale

    prompt, text, text_lens = (t.cuda() for t in _conditional_inputs())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    audio = ns2pkg.sample(ns2, length=COND_LENGTH, prompt=prompt, text=text, text_lens=text_lens,
                          cond_scale=COND_SCALE, timesteps=STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = ops.launch_counts()
    samples = COND_LENGTH * 320
    if tuple(audio.shape) != (COND_BATCH, samples):
        raise AssertionError(f"conditional sample: shape {tuple(audio.shape)}")
    if not torch.isfinite(audio).all():
        raise AssertionError("conditional sample: non-finite waveform")
    seconds = COND_BATCH * samples / 24000
    log("10", f"sample(prompt (4, {PROMPT_SAMPLES}), text (4, {TEXT_LEN}), length={COND_LENGTH}, "
              f"cond_scale={COND_SCALE:g}, timesteps={STEPS}): waveform {tuple(audio.shape)} "
              f"finite, |audio| max {audio.abs().max().item():.4f}; wall {wall:.3f} s incl. "
              f"conditioning and codec decode for {seconds:.2f} s of audio: "
              f"{seconds / wall:.2f}x real time")
    log("10", f"launch counts {counts}, expected {PER_COND_SAMPLE}")
    if counts != PER_COND_SAMPLE:
        raise AssertionError(f"launch counts {counts} != {PER_COND_SAMPLE}")

    with torch.no_grad():
        cond_ms = cuda_ms(lambda: ns2.conditioning_for_sample(prompt, text, text_lens,
                                                              COND_LENGTH), reps=5, warmup=1)
        prompt_enc, cond, duration = ns2.conditioning_for_sample(prompt, text, text_lens,
                                                                 COND_LENGTH)
        x = torch.randn(COND_BATCH, COND_LENGTH, DIM, generator=gen, device="cuda")
        times = torch.full((COND_BATCH,), 0.5, device="cuda")
        step_ms = cuda_ms(lambda: forward_with_cond_scale(
            ns2.model, x, times, prompt=prompt_enc, cond=cond, cond_scale=COND_SCALE), reps=10)
        decode_ms = cuda_ms(lambda: ns2.codec.decode(x), reps=3, warmup=1)
    frames = duration.to(torch.int32).sum(dim=-1).tolist()
    log("10", f"conditioning_for_sample {cond_ms:.3f} ms (median of 5; prompt encoding "
              f"{tuple(prompt_enc.shape)}, predicted frames per row {frames}); guided denoise "
              f"step {step_ms:.3f} ms (median of 10, batch {2 * COND_BATCH}); codec decode "
              f"{decode_ms:.3f} ms (median of 3)")
    return counts


def phase11_conditional_card_vs_cpu(ns2, ns2_cpu) -> None:
    import torch

    import naturalspeech2_tpu_torch as ns2pkg

    prompt, text, _ = _conditional_inputs()
    length = 48  # off every kernel's tile
    results = []
    with torch.no_grad():
        for model, device in ((ns2, "cuda"), (ns2_cpu, "cpu")):
            model.eval()
            p, t = prompt.to(device), text.to(device)
            prompt_enc = model.prompt_enc(model.process_prompt(p))
            duration, pitch = model.duration_pitch(model.phoneme_enc(t), prompt_enc)
            results.append([prompt_enc, duration, pitch])
    (enc_card, dur_card, pitch_card), (enc_cpu, dur_cpu, pitch_cpu) = results
    compare("11", "prompt encoding, card vs CPU", enc_card, enc_cpu, PATH_TOL)
    compare("11", "duration prediction (frames), card vs CPU", dur_card, dur_cpu, PATH_TOL)
    compare("11", "pitch prediction (log1p Hz), card vs CPU", pitch_card, pitch_cpu, PATH_TOL)

    # the card's predictions fix the integer frame layout on both sides
    duration, pitch = dur_card.cpu(), torch.expm1(pitch_card).cpu()
    fixed = dict(pitch=pitch, duration=duration)
    with torch.no_grad():
        conds = [model.conditioning_for_sample(prompt.to(device), text.to(device), None, length,
                                               **{k: v.to(device) for k, v in fixed.items()})[1]
                 for model, device in ((ns2, "cuda"), (ns2_cpu, "cpu"))]
    compare("11", f"cond [{COND_BATCH},{length},{DIM_PROMPT}], card vs CPU", *conds, PATH_TOL)
    log("11", f"predicted frames per row {duration.to(torch.int32).sum(-1).tolist()}, cut to "
              f"{length}")
    noise = torch.randn(COND_BATCH, length, DIM, generator=torch.Generator().manual_seed(SEED + 13))
    short = dict(length=length, timesteps=2, cond_scale=COND_SCALE)
    waves = [ns2pkg.sample(model, prompt=prompt.to(device), text=text.to(device),
                           noise=noise.to(device), **short,
                           **{k: v.to(device) for k, v in fixed.items()})
             for model, device in ((ns2, "cuda"), (ns2_cpu, "cpu"))]
    compare("11", f"conditional sample 2 steps x {length} frames, card vs CPU", *waves, PATH_TOL)


def denoise_counts(per_step: dict, steps: int) -> dict:
    """Launch counts of ``steps`` unconditional denoise steps, each
    launching ``per_step`` (every other kernel 0 times)."""
    return {k: steps * per_step.get(k, 0) for k in PER_DENOISE}


def phase12_longform_scaled_kernels(summary: list) -> dict:
    """K1b at the long-form shapes against its plain version and K1; K1,
    K2 and K3 at n 4500 and K3 at n 9000 against their plain versions; K1,
    K2 and K3 at the scaled width; K2 against the unfused route
    (`attn_block_flash`, on K4) at n 9000; K4 at the long-form shapes
    against its plain version and SDPA. Returns K1b's summary entry and
    adds the other shapes to the entries of ``summary`` under "by_shape"."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    entries = {e["name"]: e for e in summary}
    lanes = {"name": "wavenet_body_lanes", "route": "cuda",
             "source": "naturalspeech2_tpu_torch/csrc/wavenet_lane.cu",
             "replaces": "naturalspeech2_tpu/ops/wavenet_kernel.py:167", "library_ms": None,
             "by_shape": {}}
    for n in (LONG_LENGTHS[1], RAGGED_LANES):
        route = wk.wavenet_route(n, DIM, WAVENET_LAYERS)
        if route != "lanes":
            raise AssertionError(f"n {n} routes {route}, not K1b")
        wn, work = wavenet_inputs(gen, 1, n, DIM)
        shape = f"[1,{n},{DIM}]"
        timing = timed_case("12", f"wavenet_body_lanes {shape}", lambda: wk.wavenet_body_lanes(*wn),
                            lambda: wk.wavenet_body_lanes_torch(*wn), work)
        lanes["by_shape"][shape] = timing
        if n == LONG_LENGTHS[1]:
            lanes.update(timing)
            k1 = lambda: wk._forward("stack", *wn)  # noqa: E731
            err = hold("12", f"wavenet_body (K1) against K1b {shape}", k1(),
                       wk.wavenet_body_lanes(*wn))
            k1_ms, k1_plain_ms = cuda_ms(k1), cuda_ms(lambda: wk.wavenet_body_torch(*wn))
            log("12", f"K1 {shape}: {k1_ms:.4f} ms against K1b {timing['ms']:.4f} ms, plain "
                      f"{k1_plain_ms:.4f} ms (median of 20); K1's lane scratch "
                      f"{2 * WAVENET_LAYERS * n * DIM * 4} bytes, K1b's state {3 * n * DIM * 4}")
            entries["wavenet_body"]["by_shape"][shape] = {
                "max_abs_err": err, "ms": k1_ms, "plain_ms": k1_plain_ms, **work}
        del wn

    # the long-form shapes at b1 d128, off every 64-row tile: K1, K2 and K3
    # at n 4500 (the path runs K1 there, as the JAX package), and K3 at
    # n 9000 (K2 there is timed below, K1 above)
    if wk.wavenet_route(LONG_LENGTHS[0], DIM, WAVENET_LAYERS) != "stack":
        raise AssertionError(f"n {LONG_LENGTHS[0]} does not route K1")
    for n, names in ((LONG_LENGTHS[0], ("wavenet_body", "attn_block", "ff_block")),
                     (LONG_LENGTHS[1], ("ff_block",))):
        shape = f"[1,{n},{DIM}]"
        for name, _, _, kernel, plain, work, residual in kernel_cases(gen, 1, n, DIM):
            if name in names:
                entries[name]["by_shape"][shape] = timed_case("12", f"{name} {shape}", kernel,
                                                              plain, work, residual=residual)

    # the scaled width: K1 (pinned: the path runs the plain body there, as
    # the JAX package its XLA twin), K2, K3
    b, n, d = SCALED_BATCH, LENGTH, SCALED_DIM
    shape = f"[{b},{n},{d}]"
    for name, _, _, kernel, plain, work, residual in kernel_cases(gen, b, n, d):
        entries[name]["by_shape"][shape] = timed_case("12", f"{name} {shape}", kernel, plain, work,
                                                      reps=5, residual=residual)
    torch.cuda.empty_cache()

    # K2 at the long-form n 9000 against the JAX package's route there,
    # `attn_block_flash` (norm and projections, then flash attention K4)
    n = LONG_LENGTHS[1]
    shape = f"[1,{n},{DIM}]"
    attn = attn_inputs(gen, 1, n, DIM)
    cfg = dict(heads=HEADS, dim_head=DIM_HEAD, scale=DIM_HEAD**-0.5)
    kernel = lambda: ak.attn_block(*attn, **cfg)  # noqa: E731
    heads = ak.split_heads(*attn[3:], HEADS, DIM_HEAD)
    timing = timed_case("12", f"attn_block {shape}", kernel,
                        lambda: ak.attn_block_torch(*attn[:3], *heads, scale=cfg["scale"]),
                        attn_work(1, n, DIM, attn), residual=attn[0])
    flash_route = lambda: ak.attn_block_flash(*attn, **cfg)  # noqa: E731
    with torch.no_grad():
        timing["flash_route_err"] = compare("12", f"attn_block against attn_block_flash {shape}",
                                            kernel(), flash_route(), KERNEL_TOL)
        timing["flash_route_ms"] = cuda_ms(flash_route)
    log("12", f"attn_block {shape}: K2 {timing['ms']:.4f} ms, attn_block_flash (on K4) "
              f"{timing['flash_route_ms']:.4f} ms (median of 20)")
    entries["attn_block"]["by_shape"][shape] = timing
    del attn
    torch.cuda.empty_cache()

    # K4 at the long-form shapes, where the path runs its attention on K4
    for n in LONG_LENGTHS:
        for name, (key, err, timing) in flash_case("12", gen, 1, HEADS, n, n,
                                                   backward=False).items():
            entries[name]["by_shape"][key] = timing
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
        torch.cuda.empty_cache()
    return lanes


def phase13_longform(ns2) -> dict:
    """Long-form `sample()`, b1 at n 4500 (60 s, K1) and n 9000 (120 s,
    K1b), codec decode included; returns the launch counts by length."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    counts_by_n = {}
    for n in LONG_LENGTHS:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = ns2pkg.sample(ns2, batch_size=1, length=n, timesteps=LONG_STEPS, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = ops.launch_counts()
        if tuple(audio.shape) != (1, n * 320):
            raise AssertionError(f"long-form sample: shape {tuple(audio.shape)}")
        if not torch.isfinite(audio).all():
            raise AssertionError("long-form sample: non-finite waveform")
        seconds = n * 320 / 24000
        log("13", f"sample(batch_size=1, length={n}, timesteps={LONG_STEPS}): waveform "
                  f"{tuple(audio.shape)} finite, |audio| max {audio.abs().max().item():.4f}; "
                  f"wall {wall:.3f} s incl. codec decode for {seconds:g} s of audio: "
                  f"{seconds / wall:.2f}x real time")
        expect = denoise_counts(PER_LONG_DENOISE[n], LONG_STEPS)
        log("13", f"launch counts {counts}, expected {expect}")
        if counts != expect:
            raise AssertionError(f"launch counts {counts} != {expect}")
        del audio
        with torch.no_grad():
            x = torch.randn(1, n, DIM, generator=gen, device="cuda")
            times = torch.full((1,), 0.5, device="cuda")
            step_ms = cuda_ms(lambda: ns2.model(x, times), reps=5, warmup=1)
            decode_ms = cuda_ms(lambda: ns2.codec.decode(x), reps=3, warmup=1)
        log("13", f"n {n}: denoiser forward {step_ms:.3f} ms per denoise step (median of 5), "
                  f"codec decode {decode_ms:.3f} ms (median of 3)")
        counts_by_n[n] = counts
    return counts_by_n


def phase14_scaled(ns2) -> dict:
    """Scaled sampling: the dim-512, depth-12 model at b16 x n1024, latents
    only, STEPS_SCALED DDIM steps; returns its launch counts."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    latents = ns2pkg.sample(ns2, batch_size=SCALED_BATCH, length=LENGTH, timesteps=STEPS_SCALED,
                            generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = ops.launch_counts()
    if tuple(latents.shape) != (SCALED_BATCH, LENGTH, SCALED_DIM):
        raise AssertionError(f"scaled sample: shape {tuple(latents.shape)}")
    if not torch.isfinite(latents).all():
        raise AssertionError("scaled sample: non-finite latents")
    expect = denoise_counts(PER_SCALED_DENOISE, STEPS_SCALED)
    log("14", f"sample(batch_size={SCALED_BATCH}, length={LENGTH}, timesteps={STEPS_SCALED}) of "
              f"Model(dim={SCALED_DIM}, depth={SCALED_DEPTH}): latents {tuple(latents.shape)} "
              f"finite, |latents| max {latents.abs().max().item():.4f}; wall {wall:.3f} s, "
              f"{wall / STEPS_SCALED * 1e3:.3f} ms per denoise step (host clock)")
    log("14", f"launch counts {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    with torch.no_grad():
        x = torch.randn(SCALED_BATCH, LENGTH, SCALED_DIM, generator=gen, device="cuda")
        times = torch.full((SCALED_BATCH,), 0.5, device="cuda")
        step_ms = cuda_ms(lambda: ns2.model(x, times), reps=5, warmup=1)
    log("14", f"denoiser forward {step_ms:.3f} ms per denoise step (median of 5)")
    return counts


def phase15_card_vs_cpu(long_ns2, long_cpu, scaled, scaled_cpu) -> None:
    """One denoiser forward on the card (kernels) against the CPU (plain
    versions): the long-form model at b1 x n4500 (K1) and n9000 (K1b), and
    the scaled model at b2 x n1024."""
    import torch

    cases = ((long_ns2, long_cpu, 1, LONG_LENGTHS[0], DIM, "long-form"),
             (long_ns2, long_cpu, 1, LONG_LENGTHS[1], DIM, "long-form"),
             (scaled, scaled_cpu, 2, LENGTH, SCALED_DIM, "scaled"))
    for i, (card, cpu, b, n, d, label) in enumerate(cases):
        g = torch.Generator().manual_seed(SEED + 17 + i)
        x, times = torch.randn(b, n, d, generator=g), torch.rand(b, generator=g)
        with torch.no_grad():
            on_card = card.model(x.cuda(), times.cuda())
            on_cpu = cpu.model(x, times)
        compare("15", f"{label} denoiser b{b} x n{n}, card vs CPU", on_card, on_cpu, PATH_TOL)


def check_counts(phase: str, label: str, counts: dict, expect: dict) -> None:
    log(phase, f"{label}: launch counts {counts}, expected {expect}")
    if counts != expect:
        raise AssertionError(f"{label}: launch counts {counts} != {expect}")


def phase16_widths(summary: list) -> None:
    """The JAX package's test widths on the card: each kernel against its
    plain version at dim 16, dim_head 8, codebook dim 16 and a 24-wide
    context (narrower than the kernels' tiles, so padded by the wrappers);
    the wide widths (heads of 96, 128, 192 and 256 through K4, K5 with
    their masked, causal, dropout case, K2 and K2b; K2b at dim 640, RVQ at
    codebook dim 192 and 256; K4 and K5 at [4, 8, 1024, 128 | 256], K2b at
    x [8, 512, 640] and RVQ at dim 256 timed into the entries of
    ``summary``); then the port's two CPU test configs, card against CPU
    under PATH_TOL with exact launch counts: a guided denoiser forward and
    a 2-step conditional sample each, and the scan-layers transformer's
    forward."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale
    from naturalspeech2_tpu_torch.models.transformer import ConditionableTransformer
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    b, n, d = W_BATCH, W_LENGTH, W_DIM
    for name, _, _, kernel, plain, _, residual in kernel_cases(gen, b, n, d, W_HEADS, W_DIM_HEAD,
                                                               stacks=2, layers=2):
        out = kernel()
        torch.cuda.synchronize()
        hold("16", f"{name} [{b},{n},{d}] dh {W_DIM_HEAD}", out, plain(), residual)
    wn, _ = wavenet_inputs(gen, b, n, d, 2, 2)
    hold("16", f"wavenet_body_lanes [{b},{n},{d}]", wk.wavenet_body_lanes(*wn),
         wk.wavenet_body_lanes_torch(*wn))
    cross_case("16", gen, b, n, 8, d, W_CONTEXT, W_HEADS, W_DIM_HEAD, timed=False)
    for shape in ((b, W_HEADS, n, n), (b, W_HEADS, 8, 12)):
        flash_case("16", gen, *shape, d=W_DIM_HEAD)
    _rvq_case(gen, m=200, num_q=2, size=16, d=16, phase="16", timed=False)

    # the wide widths: heads of 96 (padded to 128), 128, and past 128 (192
    # padded to 256, 256: K4's and K5's chunked kernels), K2b past dim 512,
    # wide codebooks
    entries = {e["name"]: e for e in summary}
    for dh in (96, 128, 192, 256):
        for name, (key, err, timing) in flash_case("16", gen, 2, 4, 150, 150, d=dh).items():
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
        for name, err in _flash_masked_dropout_case(gen, d=dh, phase="16").items():
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
        attn = attn_inputs(gen, b, 64, DIM, 4, dh)
        split = ak.split_heads(*attn[3:], 4, dh)
        hold("16", f"attn_block [{b},64,{DIM}] dh {dh}",
             ak.attn_block(*attn, heads=4, dim_head=dh, scale=dh**-0.5),
             ak.attn_block_torch(*attn[:3], *split, scale=dh**-0.5), attn[0])
        cross = cross_case("16", gen, b, 64, 32, DIM, DIM, 4, dh, timed=False)
        entries["cross_attn_block"]["max_abs_err"] = max(
            entries["cross_attn_block"]["max_abs_err"], cross["max_abs_err"])
    cross = cross_case("16", gen, 2 * COND_BATCH, COND_LENGTH, NUM_LATENTS, 640, DIM)
    entries["cross_attn_block"]["by_shape"]["x [8,512,640], ctx [8,32,128]"] = cross
    for dh in (128, 256):
        for name, (key, _, timing) in flash_case("16", gen, 4, HEADS, LENGTH, LENGTH,
                                                 d=dh).items():
            entries[name]["by_shape"][key] = timing
    _rvq_case(gen, m=200, num_q=2, size=64, d=192, phase="16", timed=False)
    err, ms, plain_ms, work = _rvq_case(gen, d=256, phase="16")
    entries["rvq"]["by_shape"]["d 256"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                           **work}

    g = torch.Generator().manual_seed(SEED + 61)
    prompt = torch.rand(b, 4 * 320, generator=g) * 2 - 1
    text = torch.randint(0, 20, (b, 6), generator=g)
    duration = torch.randint(1, 7, (b, 6), generator=g).float() + 0.5
    pitch = 80 + 220 * torch.rand(b, 6, generator=g)
    x, noise = torch.randn(b, n, d, generator=g), torch.randn(b, n, d, generator=g)
    times = torch.rand(b, generator=g)
    prompt_enc, cond = torch.randn(b, 5, 24, generator=g), torch.randn(b, 20, 24, generator=g)
    for label, model_kw, codec_kw in (("conditional test config", W_COND_MODEL, W_COND_CODEC),
                                      ("scan-layers test config", W_SCAN_MODEL, W_SCAN_CODEC)):
        torch.manual_seed(SEED + 62)
        with torch.no_grad():
            cpu = ns2pkg.NaturalSpeech2(ns2pkg.Model(**model_kw), ns2pkg.SoundStream(**codec_kw),
                                        **W_NS2)
            jitter = torch.Generator().manual_seed(SEED + 63)
            for p in cpu.parameters():
                p.add_(torch.randn(p.shape, generator=jitter) * 0.02)
        card = copy.deepcopy(cpu).cuda().eval()
        cpu.eval()
        outs = []
        for model, device in ((card, "cuda"), (cpu, "cpu")):
            ops.reset_launch_counts()
            with torch.no_grad():
                outs.append(forward_with_cond_scale(
                    model.model, x.to(device), times.to(device), prompt=prompt_enc.to(device),
                    cond=cond.to(device), cond_scale=COND_SCALE))
            if device == "cuda":
                check_counts("16", f"{label} guided forward", ops.launch_counts(), W_PER_FORWARD)
        compare("16", f"{label}: guided denoiser forward [{b},{n},{d}], card vs CPU", *outs,
                PATH_TOL)
        waves = []
        for model, device in ((card, "cuda"), (cpu, "cpu")):
            ops.reset_launch_counts()
            waves.append(ns2pkg.sample(
                model, prompt=prompt.to(device), text=text.to(device), noise=noise.to(device),
                length=n, timesteps=2, cond_scale=COND_SCALE, duration=duration.to(device),
                pitch=pitch.to(device)))
            if device == "cuda":
                check_counts("16", f"{label} 2-step sample", ops.launch_counts(), W_PER_SAMPLE)
        compare("16", f"{label}: 2-step conditional sample, card vs CPU", *waves, PATH_TOL)
        del card, cpu

    torch.manual_seed(SEED + 64)
    ct_cpu = ConditionableTransformer(**W_CT, cross_attn=True, scan_layers=True).eval()
    with torch.no_grad():
        for p in ct_cpu.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.02)
    ct_card = copy.deepcopy(ct_cpu).cuda()
    h, context = torch.randn(b, n, d, generator=g), torch.randn(b, 8, d, generator=g)
    t_cond = torch.randn(b, 4 * d, generator=g)
    ops.reset_launch_counts()
    with torch.no_grad():
        on_card = ct_card(h.cuda(), t_cond.cuda(), context.cuda())
        check_counts("16", "scan-layers transformer forward", ops.launch_counts(),
                     {**dict.fromkeys(W_PER_FORWARD, 0), "attn_block": 3, "cross_attn_block": 3,
                      "ff_block": 3})
        compare("16", f"scan-layers transformer [{b},{n},{d}], card vs CPU", on_card,
                ct_cpu(h, t_cond, context), PATH_TOL)


def _flash_keep_case(gen, b, h, n, d, rate, seed, phase: str) -> None:
    """K4's keep mask at [b, h, n, n] unmasked, against the plain version's
    and the Threefry mask, bit for bit: with q = k = 0 every probability is
    1/n, so with v one-hot over a d-key window o[row, c] != 0 exactly where
    key window + c is kept."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    zeros = torch.zeros(b, h, n, d, device="cuda")
    cfg = dict(causal=False, scale=d**-0.5, dropout_rate=rate)
    kept, kept_ref = [], []
    for w0 in range(0, n, d):
        onehot = torch.zeros(b, h, n, d, device="cuda")
        cols = torch.arange(w0, min(w0 + d, n), device="cuda")
        onehot[:, :, cols, cols - w0] = 1.0
        kept.append(fa.flash_forward(zeros, zeros, onehot, None, seed, **cfg)[0] != 0)
        kept_ref.append(fa.flash_forward_torch(zeros, zeros, onehot, None, seed, **cfg)[0] != 0)
    kept, kept_ref = torch.cat(kept, dim=-1)[..., :n], torch.cat(kept_ref, dim=-1)[..., :n]
    keep = fa.dropout_keep_scaled(seed, b, h, n, n, rate, device="cuda") != 0
    if not (torch.equal(kept, kept_ref) and torch.equal(kept, keep)):
        raise AssertionError(f"flash_forward [{b},{h},{n},{d}]: the kernel's keep mask differs")
    log(phase, f"dropout keep masks identical at [{b},{h},{n},{d}]: {int(kept.sum())} of "
               f"{kept.numel()} probabilities kept at rate {rate} ({kept.float().mean().item():.4f}; "
               "kernel, plain and the Threefry mask)")


def phase17_cond_train_kernels(summary: list) -> None:
    """The conditional training path's kernels at its own shapes, each
    against its plain version (timings into the entries of ``summary``):
    K4 and K5 at the prompt encoder's [16, 8, 102, 64] with dropout 0.2
    (keep masks bit for bit), the denoiser's unfused self-attention [16,
    8, 150, 64] and cross-attention [16, 8, 150 | 32, 64] and the
    resampler's [16, 8, 32 | 134, 64]; K1 at [16, 150, 128], 4 x 8; K6 on
    the prompt's m 1632 (the audio's m 2400 is phase 6's)."""
    import torch

    from naturalspeech2_tpu_torch.ops import wavenet_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    entries = {e["name"]: e for e in summary}
    b, h, d = CT_BATCH, HEADS, DIM_HEAD
    n, p, m, seed = CT_FRAMES, CT_PROMPT_FRAMES, NUM_LATENTS, (0x5EED0017, 0xC0DE)
    for (n_q, n_kv), rate in (((p, p), CT_DROPOUT), ((n, n), 0.0), ((n, m), 0.0),
                              ((m, m + p), 0.0)):
        for name, (key, err, timing) in flash_case("17", gen, b, h, n_q, n_kv, d,
                                                   dropout_rate=rate, seed=seed).items():
            entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], err)
            if key in entries[name]["by_shape"]:  # phase 6 timed it too: keep both
                key += " (phase 17)"
            entries[name]["by_shape"][key] = {"max_abs_err": err, **timing}
    _flash_keep_case(gen, b, h, p, d, CT_DROPOUT, seed, "17")

    route = wavenet_kernel.wavenet_route(n, DIM, WAVENET_LAYERS)
    if route != "stack":
        raise AssertionError(f"the WaveNet at n {n} routes {route!r}, not K1")
    wn, work = wavenet_inputs(gen, b, n, DIM)
    shape = f"[{b},{n},{DIM}]"
    timing = timed_case("17", f"wavenet_body {shape}", lambda: wavenet_kernel._forward("stack", *wn),
                        lambda: wavenet_kernel.wavenet_body_torch(*wn), work)
    entries["wavenet_body"]["by_shape"][shape] = timing
    entries["wavenet_body"]["max_abs_err"] = max(entries["wavenet_body"]["max_abs_err"],
                                                 timing["max_abs_err"])
    err, ms, plain_ms, work = _rvq_case(gen, m=b * p, phase="17")
    entries["rvq"]["by_shape"][f"m {b * p}"] = {"max_abs_err": err, "ms": ms,
                                                 "plain_ms": plain_ms, **work}
    entries["rvq"]["max_abs_err"] = max(entries["rvq"]["max_abs_err"], err)


def _cond_train_batches(seed: int):
    """The JAX bench's batches (bench.py:299-309): uniform audio and prompt
    in [-1, 1), phoneme ids in [0, 150), full text_lens."""
    import numpy as np

    rng = np.random.RandomState(seed)
    while True:
        yield {"audio": rng.uniform(-1, 1, (CT_BATCH, CT_SAMPLES)).astype(np.float32),
               "text": rng.randint(0, 150, (CT_BATCH, CT_TEXT)).astype(np.int32),
               "text_lens": np.full((CT_BATCH,), CT_TEXT, np.int32),
               "prompt": rng.uniform(-1, 1, (CT_BATCH, PROMPT_SAMPLES)).astype(np.float32)}


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of one call, synchronised before and after."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def loop_times(phase: str, audio) -> dict:
    """Host time of the conditional path's loops on the card, at its
    shapes: MAS over [16, 100, 301], the CTC forward-sum loss and its
    backward over [16, 1, 301, 100], the NCCF pitch's Viterbi over 301
    frames (the ACF pitch and the mel beside them, loop-free)."""
    import torch

    from naturalspeech2_tpu_torch.ops.ctc import forward_sum_loss
    from naturalspeech2_tpu_torch.ops.mas import maximum_path
    from naturalspeech2_tpu_torch.ops.mel import audio_to_mel
    from naturalspeech2_tpu_torch.ops.pitch import compute_pitch, compute_pitch_nccf

    g = torch.Generator(device="cuda").manual_seed(SEED + 71)
    b = audio.shape[0]
    soft = torch.rand(b, CT_TEXT, CT_MEL_FRAMES, generator=g, device="cuda")
    mask = torch.ones_like(soft)
    logp = torch.randn(b, 1, CT_MEL_FRAMES, CT_TEXT, generator=g, device="cuda",
                       requires_grad=True)
    key_lens = torch.full((b,), CT_TEXT, device="cuda")
    query_lens = torch.full((b,), CT_MEL_FRAMES, device="cuda")
    pitch_kw = dict(sample_rate=24000, hop_length=160)
    times = {
        "mas": host_ms(lambda: maximum_path(soft, mask)),
        "ctc_forward_backward": host_ms(
            lambda: forward_sum_loss(logp, key_lens, query_lens).backward()),
        "nccf_viterbi_pitch": host_ms(lambda: compute_pitch_nccf(audio, **pitch_kw)),
        "acf_pitch": host_ms(lambda: compute_pitch(audio, **pitch_kw)),
        "mel": host_ms(lambda: audio_to_mel(audio, n_mels=80, sample_rate=24000, hop_length=160)),
    }
    log(phase, "host time at b16 (median of 5, synchronised): "
               + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    return times


def phase18_cond_train(work: Path) -> dict:
    """The conditional training path; returns its launch counts."""
    import warnings

    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    ns2 = flagship(SEED + 80, conditional=True, scan_layers=True).cuda()
    start_params = {n: p.detach().clone() for n, p in ns2.named_parameters()}
    batches = _cond_train_batches(SEED + 81)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer = ns2pkg.Trainer(ns2, batches=batches, train_batch_size=CT_BATCH,
                                 train_num_steps=CT_STEPS, save_and_sample_every=10**9,
                                 results_folder=str(work / "cond_results"))
    log("18", f"Trainer warned: {[str(w.message)[:60] + '...' for w in caught]}")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    trainer.train(log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    rows = [json.loads(line) for line in (work / "cond_results" / "metrics.jsonl").read_text()
            .splitlines()]
    if [r["step"] for r in rows] != list(range(1, CT_STEPS + 1)):
        raise AssertionError(f"metrics.jsonl steps {[r['step'] for r in rows]}")
    for key in ("loss", "diffusion", "duration", "pitch", "align"):
        values = [r[key] for r in rows]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"non-finite {key} in {values}")
        log("18", f"{key}: {', '.join(f'{v:.4f}' for v in values)}")
    step_ms = statistics.median(r["step_time_s"] for r in rows[2:]) * 1e3
    log("18", f"conditional Trainer b{CT_BATCH} x {CT_SAMPLES / 24000:g} s ({CT_FRAMES} latent, "
              f"{CT_MEL_FRAMES} mel frames), text {CT_TEXT}, prompt {PROMPT_SAMPLES} samples "
              f"({CT_PROMPT_FRAMES} frames), {CT_STEPS} steps: {step_ms:.3f} ms per optimizer "
              f"step (median of steps 3-{CT_STEPS}, host clock, synchronised), peak device "
              f"memory {peak_gib:.3f} GiB, train() wall {wall:.2f} s")

    params = dict(ns2.named_parameters())
    groups = ("aligner", "phoneme_enc", "prompt_enc", "duration_pitch", "model")
    still = [n for n in params if n.split(".")[0] in groups
             and torch.equal(params[n], start_params[n])]
    if still:
        raise AssertionError(f"parameters did not move: {still}")
    moved = {g: sum(1 for n in params if n.startswith(g + ".")) for g in groups}
    log("18", f"every parameter tensor of {moved} moved; the frozen codec's did not: "
              f"{all(torch.equal(params[n], start_params[n]) for n in params if n.startswith('codec.'))}")
    expect = {k: CT_STEPS * v for k, v in PER_COND_TRAIN_STEP.items()}
    check_counts("18", f"{CT_STEPS} conditional optimizer steps", counts, expect)
    ops.reset_launch_counts()
    trainer.train_step(next(batches))
    check_counts("18", "one conditional optimizer step (K4 = K5 = prompt encoder "
                       f"{PROMPT_DEPTH} + resampler {RESAMPLER_DEPTH} + denoiser 2 x {DEPTH}; "
                       "K6 = audio + prompt; K1 = 1)", ops.launch_counts(), PER_COND_TRAIN_STEP)
    audio = torch.as_tensor(next(batches)["audio"]).cuda()
    loop_times("18", audio)
    return counts


def _cond_check_inputs():
    """Phase 19's seeded inputs on the CPU: voiced audio (2, 48000), prompt
    audio (2, 32768), phoneme ids (2, 100) with text_lens (100, 80), times,
    noise and the CFG drop masks (prompt dropped in row 0, frames in row 1)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 19)
    t = np.arange(CT_SAMPLES) / 24000
    rows = []
    for _ in range(2):
        phase = 2 * np.pi * rng.uniform(100, 300) * t + 3.0 * np.sin(2 * np.pi * 5 * t)
        rows.append(0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.05 * rng.standard_normal(t.size))
    audio = torch.from_numpy(np.stack(rows).astype(np.float32))
    g = torch.Generator().manual_seed(SEED + 19)
    return dict(audio=audio, prompt=torch.rand(2, PROMPT_SAMPLES, generator=g) * 2 - 1,
                text=torch.randint(0, 150, (2, CT_TEXT), generator=g),
                text_lens=torch.tensor([CT_TEXT, 80]), times=torch.rand(2, generator=g),
                noise=torch.randn(2, CT_FRAMES, DIM, generator=g),
                cond_drop_mask=(torch.tensor([True, False]), torch.tensor([False, True])))


def phase19_cond_loss_card_vs_cpu(ns2_cpu) -> None:
    """One conditional loss and its gradients at b2, full width, eval mode,
    card against CPU: first the features (mel, pitch), then the MAS
    durations from each side's own phoneme encodings, then the losses and
    gradients with the card's mel and pitch passed to both."""
    import torch

    from naturalspeech2_tpu_torch.ops.mel import audio_to_mel
    from naturalspeech2_tpu_torch.ops.pitch import compute_pitch
    from naturalspeech2_tpu_torch.utils.helpers import create_mask

    card = copy.deepcopy(ns2_cpu).cuda().eval()
    ns2_cpu.eval()
    inputs = _cond_check_inputs()
    sides = ((card, "cuda"), (ns2_cpu, "cpu"))

    def on(device):
        return {k: tuple(x.to(device) for x in v) if isinstance(v, tuple) else v.to(device)
                for k, v in inputs.items()}

    feats = []
    for _, device in sides:
        audio = inputs["audio"].to(device)
        feats.append((audio_to_mel(audio, n_mels=80, sample_rate=24000, hop_length=160),
                      compute_pitch(audio, sample_rate=24000, hop_length=160)))
    (mel_card, pitch_card), (mel_cpu, pitch_cpu) = feats
    compare("19", f"mel {tuple(mel_cpu.shape)} in dB, card vs CPU", mel_card, mel_cpu, MEL_TOL_DB)
    off = (pitch_card.cpu() - pitch_cpu).abs() > PITCH_TOL_HZ
    voiced = (pitch_cpu > 0).float().mean().item()
    log("19", f"pitch {tuple(pitch_cpu.shape)}, {voiced:.3f} of frames voiced: {int(off.sum())} "
              f"frames differ by more than {PITCH_TOL_HZ:g} Hz (another argmax lag), at "
              f"{torch.nonzero(off).tolist()[:10]}; max diff on the rest "
              f"{(pitch_card.cpu() - pitch_cpu).abs()[~off].max().item():.3e} Hz")
    if off.float().mean().item() > PITCH_TIE_SHARE:
        raise AssertionError(f"pitch: {int(off.sum())} frames differ, over {PITCH_TIE_SHARE:g}")

    durations = []
    with torch.no_grad():
        for model, device in sides:
            x = on(device)
            text_mask = create_mask(x["text_lens"], CT_TEXT)
            mel = mel_card.to(device)
            mel_mask = torch.ones(2, mel.shape[-1], dtype=torch.bool, device=device)
            hard = model.aligner(model.phoneme_enc(x["text"]), text_mask, mel, mel_mask)[0]
            durations.append(hard.cpu())
    rows = (durations[0] != durations[1]).any(dim=1)
    log("19", f"MAS durations [2, {CT_TEXT}] over {mel_card.shape[-1]} frames: {int(rows.sum())} of "
              f"2 rows differ card vs CPU; row sums {durations[0].sum(dim=1).tolist()}")

    results = []
    for model, device in sides:
        model.zero_grad(set_to_none=True)
        x = on(device)
        losses = model(x.pop("audio"), mel=mel_card.to(device), pitch=pitch_card[:, None].to(device),
                       **x)
        losses["loss"].backward()
        results.append(({k: v.item() for k, v in losses.items()},
                        {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}))
    (loss_card, grads_card), (loss_cpu, grads_cpu) = results
    for key, value in loss_cpu.items():
        rel = abs(loss_card[key] - value) / max(abs(value), 1e-30)
        log("19", f"{key}: card {loss_card[key]:.7f}, CPU {value:.7f}, rel err {rel:.3e} "
                  f"(tolerance {GRAD_RTOL:g})")
        if rel > GRAD_RTOL:
            raise AssertionError(f"{key} card vs CPU rel err {rel:.3e}")
    groups = {n.split(".")[0] for n in grads_cpu}
    if set(grads_card) != set(grads_cpu) or groups != {"model", "phoneme_enc", "prompt_enc",
                                                      "duration_pitch", "aligner", "pitch_emb"}:
        raise AssertionError(f"gradients reach {sorted(groups)} (card: {len(grads_card)}, CPU: "
                             f"{len(grads_cpu)} tensors)")
    errs = {name: ((grads_card[name] - g_cpu).abs().max()
                   / g_cpu.abs().max().clamp(min=1e-30)).item()
            for name, g_cpu in grads_cpu.items()}
    ranked = sorted(errs.items(), key=lambda kv: -kv[1] if math.isfinite(kv[1]) else -math.inf)
    worst_name, worst = ranked[0]
    log("19", f"{len(grads_cpu)} parameter gradients, card vs CPU: max err relative to each "
              f"tensor's largest entry {worst:.3e} at {worst_name} (tolerance {GRAD_RTOL:g}); "
              "next: " + ", ".join(f"{n} {e:.2e}" for n, e in ranked[1:5]))
    if not all(e <= GRAD_RTOL for e in errs.values()):
        bad = [n for n, e in errs.items() if not e <= GRAD_RTOL]
        raise AssertionError(f"gradient card vs CPU above {GRAD_RTOL:g} at {bad[:5]}")
    del card


def _serving_checkpoint(work: Path) -> tuple[str, str]:
    """README config 2 with Tokenizer() and seeded random weights, built by
    the CLI from a config file and saved as a port checkpoint: (config
    path, checkpoint path)."""
    import torch

    from naturalspeech2_tpu_torch import cli
    from naturalspeech2_tpu_torch.utils.tokenizer import Tokenizer

    config = work / "serve.json"
    config.write_text(json.dumps({"model": SERVE_MODEL, "ns2": {
        "timesteps": 1000, "num_phoneme_tokens": Tokenizer().vocab_size}}))
    torch.manual_seed(SEED + 100)
    ns2 = jitter_params(cli.build_ns2(cli.load_config(str(config))), SEED + 101)
    checkpoint = work / "serve.ckpt"
    torch.save({"params": ns2.state_dict()}, checkpoint)
    log("20", f"README config 2 with Tokenizer(): {sum(p.numel() for p in ns2.parameters()):,} "
              f"parameters, saved to a port checkpoint")
    return str(config), str(checkpoint)


def _serving_prompt():
    import numpy as np

    return np.random.default_rng(SEED + 102).uniform(-1, 1, PROMPT_SAMPLES).astype(np.float32)


def _check_wave(label: str, wav, samples: int) -> None:
    import numpy as np

    if wav.shape != (samples,) or not np.isfinite(wav).all():
        raise AssertionError(f"{label}: waveform {wav.shape}, expected ({samples},) finite")


def _percentiles(walls: list) -> str:
    import numpy as np

    p50, p95 = np.percentile(np.asarray(walls) * 1e3, [50, 95])
    return (f"p50 {p50:.1f} ms, p95 {p95:.1f} ms, min {min(walls) * 1e3:.1f}, "
            f"max {max(walls) * 1e3:.1f}")


def _concurrent_tts(engine, prompt) -> tuple[list, float]:
    """SERVE_BATCH same-bucket requests from as many threads at once:
    (waveforms, wall seconds)."""
    import threading

    results, errors = [None] * SERVE_BATCH, []

    def worker(i):
        try:
            results[i] = engine.tts(SERVE_SENTENCE, prompt, seconds=SERVE_SECONDS, seed=10 + i)[0]
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(SERVE_BATCH)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - start
    if errors:
        raise errors[0]
    return results, wall


def _http(base: str, path: str, payload=None):
    """(status, content type, body) of a GET, or of a POST of ``payload``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def phase20_serving_kernels(summary: list) -> None:
    """Each kernel of the serving path against its plain version at the
    shapes one request gives it (timings into the entries of ``summary``):
    K1, K2 and K3 on the batch-doubled [2, 512, 128]; K2b at x [2, 512,
    128], ctx [2, 32, 128]; K4 at the resampler's [2, 8, 32 | 134, 64] and
    the prompt encoder's [1, 8, 102, 64]; K6 on the prompt's m 102."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 104)
    entries = {e["name"]: e for e in summary}

    def add(name: str, key: str, timing: dict) -> None:
        entries[name]["by_shape"][key + " (serve)"] = timing
        entries[name]["max_abs_err"] = max(entries[name]["max_abs_err"], timing["max_abs_err"])

    b, n, m, d = 2, SERVE_BUCKET[1], NUM_LATENTS, DIM
    shape = f"[{b},{n},{d}]"
    for name, _, _, kernel, plain, work, residual in kernel_cases(gen, b, n, d):
        add(name, shape, timed_case("20", f"{name} {shape}", kernel, plain, work,
                                    residual=residual))
    add("cross_attn_block", f"x {shape}, ctx [{b},{m},{d}]", cross_case("20", gen, b, n, m, d, d))
    p = PROMPT_SAMPLES // 320
    for flash_shape in ((b, HEADS, m, m + p), (1, HEADS, p, p)):
        for name, (key, err, timing) in flash_case("20", gen, *flash_shape,
                                                   backward=False).items():
            add(name, key, {"max_abs_err": err, **timing})
    err, ms, plain_ms, work = _rvq_case(gen, m=p, phase="20")
    add("rvq", f"m {p}", {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **work})


def phase20_serving(work: Path):
    """The serving slice; returns (its launch counts, the engine, the
    config and checkpoint paths)."""
    import base64
    import io
    import threading
    import wave

    import numpy as np

    from naturalspeech2_tpu_torch import cli, ops
    from naturalspeech2_tpu_torch.serve import TTSServer, _wav_bytes

    config, checkpoint = _serving_checkpoint(work)
    start = time.perf_counter()
    engine = cli.build_engine(config, checkpoint, timesteps=STEPS, cond_scale=SERVE_COND_SCALE,
                              device="cuda", prompt_samples=PROMPT_SAMPLES)
    log("20", f"cli.build_engine: {time.perf_counter() - start:.2f} s (config, checkpoint, "
              f"to the card); buckets text {tuple(engine.text_buckets)} x frames "
              f"{tuple(engine.frame_buckets)}, prompt {engine.prompt_samples} samples, "
              f"{engine.timesteps} steps, cond_scale {engine.cond_scale:g}")
    prompt = _serving_prompt()
    req = engine._prepare(SERVE_SENTENCE, prompt, SERVE_SECONDS, 0)
    if (req.t_bucket, req.f_bucket) != SERVE_BUCKET:
        raise AssertionError(f"the bench request lands in {(req.t_bucket, req.f_bucket)}")
    start = time.perf_counter()
    warm = engine.warmup([SERVE_BUCKET])
    log("20", f"warmup {warm}: {time.perf_counter() - start:.2f} s; the sentence is "
              f"{req.n_tokens} tokens, {SERVE_SECONDS:g} s is {req.frames} frames")

    # 1. sequential single requests: latency, real-time factor, launches
    # (each request's counts are checked; the first is printed)
    samples = req.frames * 320
    requests_before = engine.stats()["requests"]
    ops.reset_launch_counts()
    walls, before = [], ops.launch_counts()
    for i in range(SERVE_REQUESTS):
        start = time.perf_counter()
        wav, sr = engine.tts(SERVE_SENTENCE, prompt, seconds=SERVE_SECONDS, seed=i)
        walls.append(time.perf_counter() - start)
        _check_wave(f"request {i}", wav, samples)
        after = ops.launch_counts()
        counts = {k: after[k] - before[k] for k in after}
        if i == 0 or counts != PER_COND_SAMPLE:
            check_counts("20", f"request {i} (each of {SERVE_REQUESTS})", counts, PER_COND_SAMPLE)
        before = after
    serve_counts = ops.launch_counts()
    audio_s = SERVE_REQUESTS * samples / sr
    log("20", f"{SERVE_REQUESTS} sequential engine.tts at {SERVE_BUCKET}: latency "
              f"{_percentiles(walls)}; real-time factor {audio_s / sum(walls):.2f} audio-s "
              f"per wall-s ({audio_s:.2f} s of audio in {sum(walls):.3f} s)")

    # 2. no seconds: the duration predictor picks the length
    predicted = engine._prepare(SERVE_SENTENCE, prompt, None, 7)
    ops.reset_launch_counts()
    start = time.perf_counter()
    wav, _ = engine.tts(SERVE_SENTENCE, prompt, seed=7)
    wall = time.perf_counter() - start
    _check_wave("predicted-length request", wav, predicted.frames * 320)
    check_counts("20", f"predicted-length request ({predicted.frames} frames, bucket "
                       f"{predicted.f_bucket}; the duration call adds the prompt encoder's K4 and "
                       "the prompt's K6)", ops.launch_counts(),
                 {**PER_COND_SAMPLE, "flash_forward": PER_COND_SAMPLE["flash_forward"] + PROMPT_DEPTH,
                  "rvq": PER_COND_SAMPLE["rvq"] + 1})
    log("20", f"predicted-length request: {predicted.frames} frames, wall {wall * 1e3:.1f} ms "
              "(first call of its bucket)")

    # 3. the micro-batcher: each round's concurrent same-bucket requests
    # share one call (one untimed round, then SERVE_ROUNDS timed)
    engine.batch_window_ms = 200.0
    engine.start_batcher()
    try:
        rounds = []
        for r in range(SERVE_ROUNDS + 1):
            calls = engine._device_calls
            ops.reset_launch_counts()
            waves, wall = _concurrent_tts(engine, prompt)
            if engine._device_calls - calls != 1:
                raise AssertionError(f"round {r}: {engine._device_calls - calls} device calls "
                                     f"for {SERVE_BATCH} concurrent requests")
            for i, w in enumerate(waves):
                _check_wave(f"batched request {i}", w, samples)
            counts = ops.launch_counts()
            if r == 0 or counts != PER_COND_SAMPLE:
                check_counts("20", f"batched round {r} (one sample call at b{SERVE_BATCH})",
                             counts, PER_COND_SAMPLE)
            rounds.append(wall)
        rounds = rounds[1:]
        batch_audio_s = SERVE_ROUNDS * SERVE_BATCH * samples / sr
        log("20", f"{SERVE_ROUNDS} rounds of {SERVE_BATCH} concurrent requests, one device call "
                  f"each: round wall {_percentiles(rounds)}; {batch_audio_s / sum(rounds):.2f} "
                  f"audio-s per wall-s ({batch_audio_s:.2f} s of audio in {sum(rounds):.3f} s)")
        engine.batch_window_ms = 8.0

        # 4. the HTTP server
        server = TTSServer(engine, ("127.0.0.1", 0))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            status, _, body = _http(base, "/healthz")
            health = json.loads(body)
            if status != 200 or health["status"] != "ok" or not health["batching"]:
                raise AssertionError(f"/healthz {status} {health}")
            status, _, body = _http(base, "/metrics")
            metrics = json.loads(body)
            served = requests_before + SERVE_REQUESTS + 1 + (SERVE_ROUNDS + 1) * SERVE_BATCH
            if status != 200 or metrics["requests"] != served:
                raise AssertionError(f"/metrics {status} {metrics}")
            log("20", f"/healthz {health}; /metrics {metrics}")
            prompt_b64 = base64.b64encode(_wav_bytes(prompt, 24000)).decode()
            walls = []
            for _ in range(SERVE_POSTS):
                start = time.perf_counter()
                status, kind, body = _http(base, "/tts", {"text": SERVE_SENTENCE,
                                                          "seconds": SERVE_SECONDS,
                                                          "prompt_wav_base64": prompt_b64})
                walls.append(time.perf_counter() - start)
                with wave.open(io.BytesIO(body)) as w:
                    if (status, kind, w.getframerate(), w.getnframes()) != (
                            200, "audio/wav", 24000, samples):
                        raise AssertionError(f"POST /tts: {status} {kind} {w.getnframes()} "
                                             "frames")
            log("20", f"POST /tts x {SERVE_POSTS}: 200 audio/wav, {samples} samples at 24000 Hz; "
                      f"first {walls[0] * 1e3:.1f} ms; {_percentiles(walls)}")
            status, kind, body = _http(base, "/tts", {"text": SERVE_STREAM_TEXT, "stream": True,
                                                      "prompt_wav_base64": prompt_b64})
            pcm = np.frombuffer(body[44:], dtype="<i2")
            if status != 200 or body[:4] != b"RIFF" or body[8:12] != b"WAVE" or pcm.size == 0:
                raise AssertionError(f"streamed POST /tts: {status} {body[:12]!r}")
            log("20", f"streamed POST /tts: 200, RIFF/WAVE, {pcm.size} samples")
            chunks = engine._split_text(SERVE_LONG_TEXT)
            status, kind, body = _http(base, "/tts", {"text": SERVE_LONG_TEXT,
                                                      "prompt_wav_base64": prompt_b64})
            with wave.open(io.BytesIO(body)) as w:
                if status != 200 or len(chunks) < 2 or w.getnframes() == 0:
                    raise AssertionError(f"long POST /tts: {status}, {len(chunks)} chunks")
                log("20", f"long POST /tts ({len(chunks)} chunks past the "
                          f"{max(engine.text_buckets)}-token bucket): 200, {w.getnframes()} "
                          "samples")
            status, _, body = _http(base, "/tts", {"text": SERVE_SENTENCE, "prompt_wav_base64":
                                                   base64.b64encode(b"fLaC" + bytes(60)).decode()})
            if status != 400:
                raise AssertionError(f"a FLAC header with no stream: {status}, expected 400")
            log("20", f"a FLAC header with no stream as the prompt: 400 {json.loads(body)}")
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
    finally:
        engine.stop_batcher()
    log("20", f"engine stats {engine.stats()}")
    return serve_counts, engine, config, checkpoint


def phase21_serving_card_vs_cpu(engine, config: str, checkpoint: str) -> None:
    """The same engine at full width on the card and on the CPU, with the
    same injected noise: token ids, waveform, the duration predictor."""
    import torch

    from naturalspeech2_tpu_torch import cli

    cpu = cli.build_engine(config, checkpoint, timesteps=SERVE_CHECK_STEPS,
                           cond_scale=SERVE_COND_SCALE, device="cpu",
                           prompt_samples=PROMPT_SAMPLES)
    engine.timesteps = SERVE_CHECK_STEPS
    seconds = SERVE_CHECK_FRAMES * 320 / 24000
    card_req, cpu_req = (e._prepare(SERVE_SENTENCE, _serving_prompt(), seconds, 0)
                         for e in (engine, cpu))
    if not (card_req.ids == cpu_req.ids).all() or card_req.frames != cpu_req.frames:
        raise AssertionError("token ids or frames differ card vs CPU")
    noise = torch.randn(1, card_req.f_bucket, DIM,
                        generator=torch.Generator().manual_seed(SEED + 103))
    wave_card = engine._run_batch([card_req], noise=noise.cuda())[0]
    wave_cpu = cpu._run_batch([cpu_req], noise=noise)[0]
    compare("21", f"served waveform ({card_req.frames} of {card_req.f_bucket} frames, "
                  f"{SERVE_CHECK_STEPS} guided steps), card vs CPU",
            torch.from_numpy(wave_card), torch.from_numpy(wave_cpu), PATH_TOL)

    ids, n = card_req.ids, card_req.n_tokens
    d_card, d_cpu = (e._durations(card_req.prompt, ids)[0] for e in (engine, cpu))
    compare("21", f"predicted durations [{ids.size}] (frames), card vs CPU", d_card, d_cpu,
            PATH_TOL)
    frames_card, frames_cpu = (e._predicted_frames(card_req.prompt, ids, n) for e in (engine, cpu))
    log("21", f"duration predictor: {frames_card} frames on the card, {frames_cpu} on the CPU "
              f"over {n} tokens")
    if frames_card != frames_cpu:
        flipped = [i for i in range(n) if int(d_card[i]) != int(d_cpu[i])]
        for i in flipped:
            v = d_cpu[i].item()
            log("21", f"token {i}: card {d_card[i].item():.6f}, CPU {v:.6f} frames")
            if abs(v - round(v)) > DURATION_TIE:
                raise AssertionError(f"token {i}'s duration truncates differently card vs CPU, "
                                     f"{abs(v - round(v)):.2e} from an integer")
    engine.timesteps = STEPS


# ---- bf16 inference: phases 22-26 -----------------------------------------

def bound_bf16(flops: float, moved: int, f32_lanes: bool = False) -> dict:
    """The least time the card could take for a bf16 kernel's work: the
    matrix operations at the dense bf16 peak (989 TFLOP/s) and the bytes
    (each input read once, each output written once) over the memory rate.
    With ``f32_lanes`` (K1, K1b: f32 lanes against bf16 weights) the
    products are at the least-cost exact scheme the card offers: each f32
    lane split into three bf16 parts (8 + 8 + 8 of f32's 24 significant
    bits), each part's product with a bf16 weight exact, so three bf16
    passes (989 / 3 TFLOP/s), faster than two TF32 passes (495 / 2)."""
    rate = PEAK_BF16_FLOPS / 3 if f32_lanes else PEAK_BF16_FLOPS
    ops_ms = flops / rate * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def bf16_timed(phase: str, label: str, kernel, plain, f32_kernel, work: dict, residual=None,
               library=None, reps: int = 20, c_entry=None) -> dict:
    """A bf16 kernel against its plain bf16 version on the card: the error
    of its output (with ``residual`` x, of y - x) relative to the plain
    version's largest entry within BF16_TOL; its time beside the f32
    kernel's at the same shape (on the same values), the plain version's
    and, where given, the ``library`` call's and the kernel's C entry point
    alone (``c_entry``: the launches without the wrapper's checks,
    allocations and weight-cache lookup)."""
    import torch

    out = kernel()
    torch.cuda.synchronize()
    if out.dtype != torch.bfloat16:
        raise AssertionError(f"{label}: output {out.dtype}, expected bfloat16")
    ref = plain()
    if residual is not None:
        out, ref = out.float() - residual.float(), ref.float() - residual.float()
        label += " (y - x)"
    err = compare(phase, label, out, ref, BF16_TOL, relative=True)
    del out, ref
    ms, f32_ms, plain_ms = (cuda_ms(f, reps=reps) for f in (kernel, f32_kernel, plain))
    lib_ms = cuda_ms(library, reps=reps) if library is not None else None
    lib = f", SDPA bf16 {lib_ms:.4f} ms" if lib_ms is not None else ""
    entry_ms = cuda_ms(c_entry, reps=reps) if c_entry is not None else None
    entry = f", C entry {entry_ms:.4f} ms" if entry_ms is not None else ""
    log(phase, f"{label}: bf16 kernel {ms:.4f} ms{entry}, f32 kernel {f32_ms:.4f} ms, plain "
               f"bf16 {plain_ms:.4f} ms{lib} (median of {reps}), bound {work['bound_ms']:.4f} "
               f"ms ({work['bound_by']})")
    extra = {"c_entry_ms": entry_ms} if c_entry is not None else {}
    return {"max_abs_err": err, "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **extra, **work}


def _bf16(*tensors):
    """The tensors rounded to bf16."""
    import torch

    return tuple(t.to(torch.bfloat16) for t in tensors)


def ff_c_entry(x, gamma, beta, w1, b1, wc, bc, w2, b2):
    """K3's C entry point alone on bf16 (or f32) inputs: the weights packed
    and the scratch allocated once, as the wrapper does, then a call that
    launches and returns (the wrapper's checks, allocations and cache
    lookup left out). Returns the call, which returns the output; its
    ``args`` are the C arguments (to call another build's entry point on),
    its ``keep`` the tensors they point into, alive as long as the call."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk

    from naturalspeech2_tpu_torch.ops import gemm_cache

    b, n, dm = x.shape
    wt = fk._pack_checked(w1, b1, wc, bc, w2, x.dtype)
    b2 = b2.to(x.dtype)
    scratch = fk.scratch(b, n, dm, wt.ip, x.dtype, x.device,
                         gemm_cache.fmt_of(x.dtype, w1.dtype, "ff_block"))
    out = torch.empty_like(x)
    fn = _build.entry("ns2_ff_block", x.dtype, w1.dtype)
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wt.geglu.data_ptr(),
            wt.b_val.data_ptr(), wt.b_gate.data_ptr(), wt.conv.data_ptr(), wt.bc.data_ptr(),
            wt.out.data_ptr(), b2.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            out.data_ptr(), b, n, dm, wt.ip, torch.cuda.current_stream().cuda_stream)

    def call():
        _build.check(fn(*args), "ns2_ff_block")
        return out

    call.args, call.keep = args, (wt, scratch, b2, out)
    return call


def attn_c_entry(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float,
                 residual: bool = True):
    """K2's C entry point alone, as ``ff_c_entry``: the scratch sized as the
    wrapper sizes it (``attn_scratch``)."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import gemm_cache
    from naturalspeech2_tpu_torch.ops.flash_attention import kernel_head_dim

    b, n, dm = x.shape
    dh = kernel_head_dim(dim_head)
    bt_qkv, bt_out = ak._pack_checked(wq, wkv, wo, heads, dim_head, x.dtype)
    state = ak.attn_scratch(b, n, dm, heads, dh, x.dtype, x.device,
                            gemm_cache.fmt_of(x.dtype, wq.dtype, "attn_block"))
    out = torch.empty_like(x)
    fn = _build.entry("ns2_attn_block", x.dtype, wq.dtype)
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bt_qkv.data_ptr(),
            bt_out.data_ptr(), *(t.data_ptr() for t in state), out.data_ptr(), b, n, dm, heads,
            dh, float(scale), int(residual), torch.cuda.current_stream().cuda_stream)

    def call():
        _build.check(fn(*args), "ns2_attn_block")
        return out

    call.args, call.keep = args, (bt_qkv, bt_out, state, out)
    return call


def cross_c_entry(x, ctx, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int,
                  scale: float, residual: bool = True):
    """K2b's C entry point alone, as ``ff_c_entry``: the weights packed and
    the scratch allocated as the wrapper does (``cross_scratch``)."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import gemm_cache
    from naturalspeech2_tpu_torch.ops.flash_attention import kernel_head_dim

    b, n, dm = x.shape
    m, dc = ctx.shape[1:]
    dh = kernel_head_dim(dim_head)
    packed = ak._pack_cross_checked(wq, wkv, wo, heads, dim_head, x.dtype)
    state = ak.cross_scratch(b, n, m, dm, dc, heads, dh, x.dtype, x.device,
                             gemm_cache.fmt_of(x.dtype, wq.dtype, "cross_attn_block"))
    out = torch.empty_like(x)
    fn = _build.entry("ns2_cross_attn_block", x.dtype, wq.dtype)
    args = (x.data_ptr(), ctx.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            *(p.data_ptr() for p in packed), *(t.data_ptr() for t in state), out.data_ptr(), b,
            n, m, dm, dc, heads, dh, float(scale), int(residual),
            torch.cuda.current_stream().cuda_stream)

    def call():
        _build.check(fn(*args), "ns2_cross_attn_block")
        return out

    call.args, call.keep = args, (packed, state, out)
    return call


def bf16_block_cases(gen, b, n, d, names=("wavenet_body", "attn_block", "ff_block"),
                     inner=None):
    """(name, bf16 kernel, plain bf16, f32 kernel on the same values, bound,
    residual, C entry or None) of K1, K2 and K3 at one shape (K3's inner
    width int(8d/3) unless given). The blocks' residual x is drawn at
    BF16_RESIDUAL_SCALE (see BF16_TOL). K2's and K3's C entry points are
    timed alone beside their wrappers."""
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    rn = _randn(gen)
    cases = []
    out_bytes = b * n * d * 2
    if "wavenet_body" in names:
        wn, _ = wavenet_inputs(gen, b, n, d, WAVENET_STACKS, WAVENET_LAYERS)
        wn16 = _bf16(*wn)
        wn32 = tuple(t.float() for t in wn16)
        flops = 2 * b * n * d * d * (WAVENET_STACKS * WAVENET_LAYERS * 4 + WAVENET_LAYERS)
        cases.append(("wavenet_body", lambda: wk._forward("stack", *wn16),
                      lambda: wk.wavenet_body_bf16_torch(*wn16),
                      lambda: wk._forward("stack", *wn32),
                      bound_bf16(flops, nbytes(*wn16) + out_bytes, f32_lanes=True), None, None))
    heads, dim_head = HEADS, DIM_HEAD
    scale = dim_head**-0.5
    if "attn_block" in names:
        attn = list(attn_inputs(gen, b, n, d, heads, dim_head))
        attn[0] = attn[0] * BF16_RESIDUAL_SCALE
        a16 = _bf16(*attn)
        a32 = tuple(t.float() for t in a16)
        split = ak.split_heads(*a16[3:], heads, dim_head)
        cfg = dict(heads=heads, dim_head=dim_head, scale=scale)
        hd = heads * dim_head
        flops = 2 * b * n * d * 4 * hd + 4 * b * heads * n * n * dim_head
        cases.append(("attn_block", lambda: ak.attn_block(*a16, **cfg),
                      lambda: ak.attn_block_bf16_torch(*a16[:3], *split, scale=scale),
                      lambda: ak.attn_block(*a32, **cfg),
                      bound_bf16(flops, nbytes(*a16) + out_bytes), a16[0],
                      attn_c_entry(*a16, **cfg)))
    if "ff_block" in names:
        inner = inner or int(d * 4 * 2 / 3)
        x = rn(b, n, d, scale=BF16_RESIDUAL_SCALE)
        ff = _bf16(x, 1 + rn(b, d, scale=0.1), rn(b, d, scale=0.1),
                   rn(d, 2 * inner, scale=d**-0.5), rn(2 * inner, scale=0.1),
                   rn(3, inner, inner, scale=(3 * inner) ** -0.5), rn(inner, scale=0.1),
                   rn(inner, d, scale=inner**-0.5), rn(d, scale=0.1))
        ff32 = tuple(t.float() for t in ff)
        flops = 2 * b * n * (d * 2 * inner + 3 * inner * inner + inner * d)
        cases.append(("ff_block", lambda: fk.ff_block(*ff), lambda: fk.ff_block_plain(*ff),
                      lambda: fk.ff_block(*ff32), bound_bf16(flops, nbytes(*ff) + out_bytes),
                      ff[0], ff_c_entry(*ff)))
    return cases


def profile_names(fn) -> list:
    """The names of the device kernels ``fn()`` launches (``profile_counts``)."""
    return list(profile_counts(fn))


def check_bf16_core(phase: str) -> None:
    """A profile of one K3 and one K2 bf16 call at the flagship's shape:
    their launches are the bf16 core's kernels (BF16_CORE_KERNELS) and K4
    bf16's, none of the split-TF32 core's."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 205)
    for name, kernel, *_ in bf16_block_cases(gen, BATCH, LENGTH, DIM, ("attn_block", "ff_block")):
        names = profile_names(kernel)
        log(phase, f"{name} bf16 profile, kernels: {[k[:90] for k in names]}")
        missing = [k for k in BF16_CORE_KERNELS
                   if not any(all(part in n for part in k) for n in names)]
        old = [n for n in names if "ns2::gemm::gemm_kernel" in n]
        if missing or old:
            raise AssertionError(f"{name} bf16: the bf16 core's {missing} not launched, or the "
                                 f"split-TF32 core's {old} launched")


def profile_counts(fn, attempts: int = 3, short=None) -> dict:
    """{device kernel name: launches} of one call of ``fn`` (torch.profiler,
    after one warm-up call). A session that lost events is made again,
    logged, up to ``attempts`` sessions: one that recorded no device
    activity at all (seen now and then late in a whole run of this script,
    never in 150 sessions of a process that did nothing else; PERF.md), or,
    with ``short``, one in which ``short`` finds only expected kernels, none
    launched more often than expected and some less (a session late in a
    whole run once lost the launch of a split pre-pass that the same call's
    sessions in other runs recorded; PERF.md). Any other session is
    returned as it is, an unexpected kernel or launch included, for the
    caller's check to fail on; after ``attempts`` the last one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for attempt in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if counts and not (short and short(counts)):
            return counts
        log("profile", f"session {attempt + 1} of {attempts} recorded "
                       + ("no device activity" if not counts else f"fewer launches: {counts}"))
    return counts


def check_wavenet_bf16_core(phase: str, label: str, fn, launches: int) -> None:
    """A profile of one K1 or K1b bf16 call: ``launches`` launches of the bf16
    core's kernel, each stack's writing the three planes (`WaveGateSplit`),
    and none of the split-TF32 core's."""
    counts = profile_counts(fn)
    core = {k: c for k, c in counts.items() if "ns2::bgemm::bf16_gemm_kernel" in k}
    log(phase, f"{label} profile: {sum(core.values())} bf16 core launches "
               f"{[(k[:110], c) for k, c in core.items()]}; all kernels {len(counts)}")
    old = [k for k in counts if "ns2::gemm::gemm_kernel" in k]
    gates = [k for k in core if "WaveGateSplit" in k]
    if old or not gates or sum(core.values()) != launches or len(counts) != len(core):
        raise AssertionError(f"{label}: {sum(core.values())} bf16 core launches (expected "
                             f"{launches}), planes written by {gates}, split-TF32 {old}, "
                             f"other kernels {[k for k in counts if k not in core]}")


def wavenet_bf16_cases(phase: str) -> None:
    """K1 and K1b bf16 at the widths and lengths the bf16 core's WaveNet
    loaders must take, each against its plain bf16 version within BF16_TOL:
    K1 at d 64, at d 96 (padded to 128) and at b3 n200, where the last
    layers' taps 2δ = 256 reach past the whole sequence; K1b at n 6733
    (K1's budget's first length past it) and at d 256; and the profiles of
    K1 at the flagship's shape and K1b at n 9000 (S + 1 and S·L / LANE_GROUP
    + L launches of the bf16 core)."""
    import torch

    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 206)
    S, L = WAVENET_STACKS, WAVENET_LAYERS
    for route, b, n, d in (("stack", 2, 512, 64), ("stack", 2, 512, 96), ("stack", 3, 200, DIM),
                           ("lanes", 1, 6733, DIM), ("lanes", 1, 2048, 256)):
        wn16 = _bf16(*wavenet_inputs(gen, b, n, d, S, L)[0])
        if route == "stack":
            out, ref = wk._forward("stack", *wn16), wk.wavenet_body_bf16_torch(*wn16)
        else:
            out, ref = wk.wavenet_body_lanes(*wn16), wk.wavenet_body_lanes_bf16_torch(*wn16)
        torch.cuda.synchronize()
        name = "wavenet_body" if route == "stack" else "wavenet_body_lanes"
        compare(phase, f"{name} bf16 [{b},{n},{d}]", out, ref, BF16_TOL, relative=True)
        del wn16, out, ref
    # K1b's blocks run LANE_GROUP lanes a launch, its skips one lane a launch
    lanes_launches = S * -(-L // wk.LANE_GROUP) + L
    for route, b, n in (("stack", BATCH, LENGTH), ("lanes", 1, LONG_LENGTHS[1])):
        wn16 = _bf16(*wavenet_inputs(gen, b, n, DIM, S, L)[0])
        fn = ((lambda: wk._forward("stack", *wn16)) if route == "stack"
              else (lambda: wk.wavenet_body_lanes(*wn16)))
        check_wavenet_bf16_core(phase, f"{'K1' if route == 'stack' else 'K1b'} bf16 [{b},{n},"
                                       f"{DIM}]", fn, S + 1 if route == "stack" else lanes_launches)
        del wn16
    torch.cuda.empty_cache()


def check_cross_bf16_core(phase: str, label: str, fn, copied: bool) -> None:
    """A profile of one K2b bf16 call: three launches of the bf16 core's
    kernel (the q, k/v and W_o GEMMs), the norm pre-pass, K4 bf16 and, where
    the context is copied for TMA, that copy; 5 (6) launches in all, none of
    the split-TF32 core's."""
    counts = profile_counts(fn)
    core = sum(c for k, c in counts.items() if "ns2::bgemm::bf16_gemm_kernel" in k)
    total = sum(counts.values())
    log(phase, f"{label} profile: {total} launches, {core} of the bf16 core: "
               f"{[(k[:90], c) for k, c in counts.items()]}")
    old = [k for k in counts if "ns2::gemm::gemm_kernel" in k]
    norms = sum(c for k, c in counts.items() if "norm_rows_kernel" in k)
    copies = sum(c for k, c in counts.items() if "copy_rows_kernel" in k)
    if old or core != 3 or norms != 1 or copies != int(copied) or total != 5 + int(copied):
        raise AssertionError(f"{label}: {total} launches (expected {5 + int(copied)}), {core} of "
                             f"the bf16 core (3), {norms} norm pre-passes, {copies} context "
                             f"copies ({int(copied)}), split-TF32 {old}")


def cross_bf16_cases(phase: str) -> None:
    """K2b bf16 at BF16_CROSS_CASES against its plain bf16 version within
    BF16_TOL (of y - x; of y where the residual is off), and the profiles of
    one call at the served shape and one whose context is copied."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak

    gen = torch.Generator(device="cuda").manual_seed(SEED + 207)
    b, n, m = 2, SERVE_BUCKET[1], NUM_LATENTS
    calls = {}
    for label, dm, dc, heads, dim_head, residual in (("served", DIM, DIM, HEADS, DIM_HEAD, True),
                                                      *BF16_CROSS_CASES):
        args = list(cross_inputs(gen, b, n, m, dm, dc, heads, dim_head))
        args[0] = args[0] * BF16_RESIDUAL_SCALE
        a16 = _bf16(*args)
        cfg = dict(heads=heads, dim_head=dim_head, scale=dim_head**-0.5, residual=residual)
        out = ak.cross_attn_block(*a16, **cfg)
        ref = ak.cross_attn_block_bf16_torch(*a16[:4], *ak.split_heads(*a16[4:], heads, dim_head),
                                             scale=cfg["scale"], residual=residual)
        torch.cuda.synchronize()
        if residual:
            out, ref = out.float() - a16[0].float(), ref.float() - a16[0].float()
        compare(phase, f"cross_attn_block bf16 {label}: x [{b},{n},{dm}], ctx [{b},{m},{dc}], "
                       f"{heads} heads of {dim_head}" + ("" if residual else ", residual off")
                       + (" (y - x)" if residual else ""), out, ref, BF16_TOL, relative=True)
        calls[label] = (lambda a=a16, c=cfg: ak.cross_attn_block(*a, **c)), dc % 8 != 0
    for label in ("served", "dc 100"):
        fn, copied = calls[label]
        check_cross_bf16_core(phase, f"K2b bf16 {label}", fn, copied)


def _bf16_entry(name: str) -> dict:
    sources = {"wavenet_body": ("wavenet.cu", "wavenet_kernel.py:80"),
               "wavenet_body_lanes": ("wavenet_lane.cu", "wavenet_kernel.py:167"),
               "attn_block": ("attn_block.cu", "attn_block_kernel.py:92"),
               "cross_attn_block": ("cross_attn_block.cu", "attn_block_kernel.py:237"),
               "ff_block": ("ff_block.cu", "ff_block_kernel.py:97"),
               "flash_forward": ("flash_fwd_bf16.cu", "flash_attention.py:98")}
    source, replaces = sources[name]
    return {"name": name, "dtype": "bfloat16", "route": "cuda",
            "source": f"naturalspeech2_tpu_torch/csrc/{source}",
            "replaces": f"naturalspeech2_tpu/ops/{replaces}", "by_shape": {}}


def phase22_bf16_kernels() -> list:
    """Each bf16 kernel against its plain bf16 version at the shapes the
    bf16 paths give it: K1 at [4,1024,128], [2,512,128], [8,512,128],
    [1,4500,128]; K1b at [1,9000,128]; K1 and K1b at the widths and
    lengths of ``wavenet_bf16_cases``, with their profiles; K2 and K3 at [4,1024,128],
    [2,512,128], [16,1024,512] and BF16_RAGGED, K3 at [1,9000,128], with
    their C entry points timed alone and a profile of their kernels; K2b at
    x [2|8,512,128], ctx [·,32,128], its C entry timed alone, and at the
    widths of ``cross_bf16_cases``, with profiles of its launches; K4 at the
    resampler's [2|8,8,32|134,64] and the long-form [1,8,4500|9000,64]
    beside SDPA in bf16. Returns the bf16 rows of the kernels' summary (the
    first shape's numbers at the top)."""
    import torch
    import torch.nn.functional as F

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import flash_attention as fa
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 200)
    rows = {}

    def add(name: str, shape: str, timing: dict) -> None:
        row = rows.setdefault(name, _bf16_entry(name))
        if not row["by_shape"]:
            row.update({k: timing[k] for k in ("max_abs_err", "ms", "f32_ms", "plain_ms",
                                               "library_ms", "bound_ms", "bound_by")})
        row["by_shape"][shape] = timing
        row["max_abs_err"] = max(row["max_abs_err"], timing["max_abs_err"])

    blocks = ("attn_block", "ff_block")
    # (b, n, d, K3's inner or None, kernels): the bf16 paths' shapes, then
    # ragged ones (128-row tiles straddling sequences, n % 64 != 0, dm and
    # inner off the core's 64)
    shapes = ((BATCH, LENGTH, DIM, None, ("wavenet_body", *blocks)),
              (2, SERVE_BUCKET[1], DIM, None, ("wavenet_body", *blocks)),
              (2 * COND_BATCH, COND_LENGTH, DIM, None, ("wavenet_body",)),
              (1, LONG_LENGTHS[0], DIM, None, ("wavenet_body",)),
              (SCALED_BATCH, LENGTH, SCALED_DIM, None, blocks),
              (1, LONG_LENGTHS[1], DIM, None, ("ff_block",)),
              *((b, n, d, inner, blocks) for b, n, d, inner in BF16_RAGGED))
    for b, n, d, inner, names in shapes:
        shape = f"[{b},{n},{d}]" + (f" inner {inner}" if inner else "")
        for name, kernel, plain, f32_kernel, work, residual, c_entry in bf16_block_cases(
                gen, b, n, d, names, inner):
            add(name, shape, bf16_timed("22", f"{name} bf16 {shape}", kernel, plain, f32_kernel,
                                        work, residual, reps=5 if d == SCALED_DIM else 20,
                                        c_entry=c_entry))
        torch.cuda.empty_cache()
    check_bf16_core("22")

    # K2 bf16 without the residual on 4 heads at dm 512 (a tensor-parallel
    # rank's share of the scaled model: H·dh 256 < dm, so o holds n(x) at
    # dm's width)
    heads = HEADS // 2
    attn = _bf16(*attn_inputs(gen, 2, SERVE_BUCKET[1], SCALED_DIM, heads, DIM_HEAD))
    cfg = dict(heads=heads, dim_head=DIM_HEAD, scale=DIM_HEAD**-0.5)
    compare("22", f"attn_block bf16 residual off, {heads} heads, [2,{SERVE_BUCKET[1]},"
                  f"{SCALED_DIM}]", ak.attn_block(*attn, residual=False, **cfg),
            ak.attn_block_bf16_torch(*attn[:3], *ak.split_heads(*attn[3:], heads, DIM_HEAD),
                                     scale=cfg["scale"], residual=False), BF16_TOL,
            relative=True)
    del attn

    # K1b at n 9000, past K1's budget
    n = LONG_LENGTHS[1]
    if wk.wavenet_route(n, DIM, WAVENET_LAYERS) != "lanes":
        raise AssertionError(f"n {n} does not route K1b")
    wn16 = _bf16(*wavenet_inputs(gen, 1, n, DIM, WAVENET_STACKS, WAVENET_LAYERS)[0])
    wn32 = tuple(t.float() for t in wn16)
    flops = 2 * n * DIM * DIM * (WAVENET_STACKS * WAVENET_LAYERS * 4 + WAVENET_LAYERS)
    add("wavenet_body_lanes", f"[1,{n},{DIM}]", bf16_timed(
        "22", f"wavenet_body_lanes bf16 [1,{n},{DIM}]", lambda: wk.wavenet_body_lanes(*wn16),
        lambda: wk.wavenet_body_lanes_bf16_torch(*wn16), lambda: wk.wavenet_body_lanes(*wn32),
        bound_bf16(flops, nbytes(*wn16) + n * DIM * 2, f32_lanes=True)))
    del wn16, wn32
    wavenet_bf16_cases("22")

    # K2b at the served and the conditional sample's guided batch
    for b in (2, 2 * COND_BATCH):
        args = list(cross_inputs(gen, b, COND_LENGTH, NUM_LATENTS, DIM, DIM, HEADS, DIM_HEAD))
        args[0] = args[0] * BF16_RESIDUAL_SCALE
        a16 = _bf16(*args)
        a32 = tuple(t.float() for t in a16)
        split = ak.split_heads(*a16[4:], HEADS, DIM_HEAD)
        cfg = dict(heads=HEADS, dim_head=DIM_HEAD, scale=DIM_HEAD**-0.5)
        hd = HEADS * DIM_HEAD
        flops = (2 * b * COND_LENGTH * DIM * 2 * hd + 2 * b * NUM_LATENTS * DIM * 2 * hd
                 + 4 * b * HEADS * COND_LENGTH * NUM_LATENTS * DIM_HEAD)
        shape = f"x [{b},{COND_LENGTH},{DIM}], ctx [{b},{NUM_LATENTS},{DIM}]"
        add("cross_attn_block", shape, bf16_timed(
            "22", f"cross_attn_block bf16 {shape}", lambda: ak.cross_attn_block(*a16, **cfg),
            lambda: ak.cross_attn_block_bf16_torch(*a16[:4], *split, scale=cfg["scale"]),
            lambda: ak.cross_attn_block(*a32, **cfg),
            bound_bf16(flops, nbytes(*a16) + b * COND_LENGTH * DIM * 2), a16[0],
            c_entry=cross_c_entry(*a16, **cfg)))
    cross_bf16_cases("22")

    # K4 forward: the resampler's, the unbucketed guided step's unfused self-
    # and cross-attention (phase 25's `sample --bf16` at 510 frames, off the
    # block gates) and the long-form unfused attention
    p = PROMPT_SAMPLES // 320
    for b, h, n_q, n_kv in ((2, HEADS, NUM_LATENTS, NUM_LATENTS + p),
                            (2 * COND_BATCH, HEADS, NUM_LATENTS, NUM_LATENTS + p),
                            (2, HEADS, CLI_BF16_FRAMES, CLI_BF16_FRAMES),
                            (2, HEADS, CLI_BF16_FRAMES, NUM_LATENTS),
                            (1, HEADS, LONG_LENGTHS[0], LONG_LENGTHS[0]),
                            (1, HEADS, LONG_LENGTHS[1], LONG_LENGTHS[1])):
        d = DIM_HEAD
        q = torch.randn(b, h, n_q, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, h, n_kv, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        q32, k32, v32 = q.float(), k.float(), v.float()
        scale = d**-0.5
        shape = f"[{b},{h},{n_q},{d}]" if n_q == n_kv else f"[{b},{h},{n_q}|{n_kv},{d}]"
        moved = 2 * (2 * b * h * n_q * d + 2 * b * h * n_kv * d) + 4 * b * h * n_q
        add("flash_forward", shape, bf16_timed(
            "22", f"flash_forward bf16 {shape}",
            lambda: fa.flash_forward(q, k, v, scale=scale)[0],
            lambda: fa.flash_forward_torch(q, k, v, None, None, causal=False, scale=scale)[0],
            lambda: fa.flash_forward(q32, k32, v32, scale=scale)[0],
            bound_bf16(4 * b * h * n_q * n_kv * d, moved),
            library=lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)))
        del q, k, v, q32, k32, v32
        torch.cuda.empty_cache()
    return list(rows.values())


def _in_turns(phase: str, label: str, f32_call, bf16_call, reps: int) -> tuple[float, float]:
    """Two calls timed in turns (f32, bf16, bf16, f32) under no_grad: the
    medians of CUDA-event times, each the mean of its two turns."""
    import torch

    with torch.no_grad():
        turns = [cuda_ms(fn, reps=reps, warmup=2)
                 for fn in (f32_call, bf16_call, bf16_call, f32_call)]
    f32_ms, bf16_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    log(phase, f"{label}: f32 {turns[0]:.3f} / {turns[3]:.3f} ms, bf16 {turns[1]:.3f} / "
               f"{turns[2]:.3f} ms (median of {reps} each, in turns); bf16 / f32 "
               f"{bf16_ms / f32_ms:.3f}")
    return f32_ms, bf16_ms


def _bf16_step_ms(phase: str, model, b: int, n: int, d: int, reps: int) -> tuple[float, float]:
    """One denoiser forward at b x n in f32 and through ``model``'s bf16
    copy (``cast_floating``), in turns."""
    import torch

    from naturalspeech2_tpu_torch.models.naturalspeech2 import cast_floating

    bf16_model = cast_floating(model, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 201)
    x = torch.randn(b, n, d, generator=gen, device="cuda")
    x16 = x.bfloat16()
    times = torch.full((b,), 0.5, device="cuda")
    return _in_turns(phase, f"denoiser forward b{b} x n{n} x d{d}", lambda: model(x, times),
                     lambda: bf16_model(x16, times), reps)


def phase23_bf16_guided_step(cond) -> None:
    """README config 2's guided denoise step (phase 10's: the batch-doubled
    8 x 512 with K2b and the resampler) in bf16 beside f32, in turns."""
    import torch

    from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale
    from naturalspeech2_tpu_torch.models.naturalspeech2 import cast_floating

    prompt, text, text_lens = (t.cuda() for t in _conditional_inputs())
    with torch.no_grad():
        prompt_enc, frames, _ = cond.conditioning_for_sample(prompt, text, text_lens,
                                                             COND_LENGTH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 204)
    x = torch.randn(COND_BATCH, COND_LENGTH, DIM, generator=gen, device="cuda")
    times = torch.full((COND_BATCH,), 0.5, device="cuda")
    bf16_model = cast_floating(cond.model, torch.bfloat16)
    x16, p16, c16 = x.bfloat16(), prompt_enc.bfloat16(), frames.bfloat16()
    _in_turns("23", f"guided denoise step, batch {2 * COND_BATCH} x {COND_LENGTH}",
              lambda: forward_with_cond_scale(cond.model, x, times, prompt=prompt_enc,
                                              cond=frames, cond_scale=COND_SCALE),
              lambda: forward_with_cond_scale(bf16_model, x16, times, prompt=p16, cond=c16,
                                              cond_scale=COND_SCALE), 10)


def _check_bf16_counts(phase: str, label: str, f32_counts: dict, bf16_counts: dict,
                       expect_f32: dict, expect_bf16: dict) -> None:
    """Launches of a bf16 run: its bf16 entry points' counts, and the f32
    ones (the conditioning's, which stays f32), each exactly as expected."""
    check_counts(phase, f"{label}, bf16 entry points", bf16_counts, expect_bf16)
    check_counts(phase, f"{label}, f32 entry points", f32_counts, expect_f32)


def phase23_bf16_flagship(ns2, f32_counts: dict) -> dict:
    """The flagship `sample(dtype=torch.bfloat16)`, b4 x n1024, STEPS DDIM
    steps: a finite f32 waveform and its wall (phase 3 prints the f32
    one), the launches equal to the f32 run's, all on the bf16 entry
    points, and ms per step in bf16 beside f32 (CUDA events, in turns).
    Returns the bf16 launch counts."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    audio = ns2pkg.sample(ns2, batch_size=BATCH, length=LENGTH, timesteps=STEPS, generator=gen,
                          dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if tuple(audio.shape) != (BATCH, LENGTH * 320) or audio.dtype != torch.float32:
        raise AssertionError(f"bf16 sample: {tuple(audio.shape)} {audio.dtype}")
    if not torch.isfinite(audio).all():
        raise AssertionError("bf16 sample: non-finite waveform")
    bf16_counts = ops.launch_counts(torch.bfloat16)
    _check_bf16_counts("23", f"sample(dtype=bfloat16, {STEPS} steps)", ops.launch_counts(),
                       bf16_counts, {k: 0 for k in f32_counts}, f32_counts)
    log("23", f"sample(batch_size={BATCH}, length={LENGTH}, timesteps={STEPS}, dtype=bfloat16): "
              f"waveform {tuple(audio.shape)} float32 finite, |audio| max "
              f"{audio.abs().max().item():.4f}; wall {wall:.3f} s incl. codec decode")
    if next(ns2.model.parameters()).dtype != torch.float32:
        raise AssertionError("sample(dtype=) cast the module in place")
    _bf16_step_ms("23", ns2.model, BATCH, LENGTH, DIM, reps=10)
    return bf16_counts


def phase24_bf16_longform_scaled(long_ns2, long_counts: dict, scaled,
                                 f32_counts: dict) -> tuple[dict, dict]:
    """Long-form `sample(dtype=torch.bfloat16)` at b1, LONG_STEPS steps, n
    4500 (K1, K4 unfused) and n 9000 (K1b, K4, K3), and the scaled model's
    at b16 x n1024, STEPS_SCALED steps: finite outputs, launches equal to
    the f32 runs' on the bf16 entry points, the long-form denoise step at
    each length and the scaled step in bf16 beside f32 (CUDA events, in
    turns). Returns (the long-form bf16 counts by length, the scaled ones)."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    long_bf16 = {}
    for n in LONG_LENGTHS:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = ns2pkg.sample(long_ns2, batch_size=1, length=n, timesteps=LONG_STEPS,
                              generator=gen, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        if tuple(audio.shape) != (1, n * 320) or not torch.isfinite(audio).all():
            raise AssertionError(f"long-form bf16 sample: {tuple(audio.shape)}, or non-finite")
        long_bf16[n] = ops.launch_counts(torch.bfloat16)
        _check_bf16_counts("24", f"long-form sample(length={n}, dtype=bfloat16)",
                           ops.launch_counts(), long_bf16[n], {k: 0 for k in long_counts[n]},
                           long_counts[n])
        log("24", f"long-form bf16 n {n}, {LONG_STEPS} steps: wall {wall:.3f} s incl. codec "
                  f"decode for {n * 320 / 24000:g} s of audio")
        del audio
        _bf16_step_ms("24", long_ns2.model, 1, n, DIM, reps=10)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    latents = ns2pkg.sample(scaled, batch_size=SCALED_BATCH, length=LENGTH,
                            timesteps=STEPS_SCALED, generator=gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if tuple(latents.shape) != (SCALED_BATCH, LENGTH, SCALED_DIM) or not torch.isfinite(
            latents).all():
        raise AssertionError(f"scaled bf16 sample: {tuple(latents.shape)}, or non-finite")
    bf16_counts = ops.launch_counts(torch.bfloat16)
    _check_bf16_counts("24", f"scaled sample(dtype=bfloat16, {STEPS_SCALED} steps)",
                       ops.launch_counts(), bf16_counts, {k: 0 for k in f32_counts}, f32_counts)
    log("24", f"scaled sample(dtype=bfloat16): latents {tuple(latents.shape)} finite, wall "
              f"{wall:.3f} s, {wall / STEPS_SCALED * 1e3:.3f} ms per step (host clock)")
    del latents
    _bf16_step_ms("24", scaled.model, SCALED_BATCH, LENGTH, SCALED_DIM, reps=5)
    return long_bf16, bf16_counts


# per served request in bf16: the denoiser's launches on the bf16 entry
# points, the conditioning's (the prompt encoder's K4, the prompt's K6) on
# the f32 ones
SERVE_F32_PART = {k: 0 for k in PER_COND_SAMPLE} | {"flash_forward": PROMPT_DEPTH, "rvq": 1}
SERVE_BF16_PART = {k: v - SERVE_F32_PART[k] for k, v in PER_COND_SAMPLE.items()}


def _serve_window(phase: str, label: str, engine, prompt, bf16: bool):
    """One turn of phase 25's window: BF16_SERVE_REQUESTS / 2 sequential
    requests, then one untimed and BF16_SERVE_ROUNDS / 2 timed rounds of
    SERVE_BATCH concurrent ones, each request's and round's launches
    checked. Returns the walls, the rounds' walls and request 0's
    launches, (f32 entry points, bf16 entry points)."""
    import torch

    from naturalspeech2_tpu_torch import ops

    expect_f32, expect_bf16 = ((SERVE_F32_PART, SERVE_BF16_PART) if bf16 else
                               (PER_COND_SAMPLE, {k: 0 for k in PER_COND_SAMPLE}))
    walls = []
    for i in range(BF16_SERVE_REQUESTS // 2):
        ops.reset_launch_counts()
        start = time.perf_counter()
        wav, _ = engine.tts(SERVE_SENTENCE, prompt, seconds=SERVE_SECONDS, seed=i)
        walls.append(time.perf_counter() - start)
        _check_wave(f"{label} request {i}", wav, SERVE_SAMPLES)
        got = (ops.launch_counts(), ops.launch_counts(torch.bfloat16))
        if i == 0:
            first = got
        if i == 0 or got != (expect_f32, expect_bf16):
            _check_bf16_counts(phase, f"{label} request {i}", *got, expect_f32, expect_bf16)
    engine.batch_window_ms = 200.0
    engine.start_batcher()
    try:
        rounds = []
        for r in range(BF16_SERVE_ROUNDS // 2 + 1):
            ops.reset_launch_counts()
            waves, wall = _concurrent_tts(engine, prompt)
            for w in waves:
                _check_wave(f"{label} batched request", w, SERVE_SAMPLES)
            got = (ops.launch_counts(), ops.launch_counts(torch.bfloat16))
            if r == 0 or got != (expect_f32, expect_bf16):
                _check_bf16_counts(phase, f"{label} round {r}", *got, expect_f32, expect_bf16)
            rounds.append(wall)
    finally:
        engine.stop_batcher()
        engine.batch_window_ms = 8.0
    log(phase, f"{label}, one turn: {len(walls)} sequential requests {_percentiles(walls)}; "
               f"{len(rounds) - 1} rounds of {SERVE_BATCH}: round {_percentiles(rounds[1:])}")
    return walls, rounds[1:], first


def phase25_bf16_serving(engine, config: str, checkpoint: str, work: Path) -> tuple:
    """README config 2 served in bf16: `cli.build_engine(dtype="bfloat16")`
    beside phase 20's f32 engine in this process (each BF16_SERVE_REQUESTS
    sequential requests and BF16_SERVE_ROUNDS rounds of four, in two turns
    of half each, f32, bf16, bf16, f32),
    then `cli.main(["sample", "--bf16", ...])` in-process. Returns (the bf16
    engine, its first request's launch counts by entry-point dtype)."""
    import numpy as np
    import torch

    from naturalspeech2_tpu_torch import cli, ops
    from naturalspeech2_tpu_torch.data import load_audio, write_wav

    bf16_engine = cli.build_engine(config, checkpoint, timesteps=STEPS,
                                   cond_scale=SERVE_COND_SCALE, device="cuda",
                                   prompt_samples=PROMPT_SAMPLES, dtype="bfloat16")
    dtypes = {p.dtype for p in bf16_engine.ns2.model.parameters()}
    if dtypes != {torch.bfloat16} or next(engine.ns2.model.parameters()).dtype != torch.float32:
        raise AssertionError(f"bf16 engine's denoiser holds {dtypes}")
    start = time.perf_counter()
    bf16_engine.warmup([SERVE_BUCKET])
    log("25", f"TTSEngine(dtype='bfloat16') from cli.build_engine, warmup {SERVE_BUCKET}: "
              f"{time.perf_counter() - start:.2f} s")
    prompt = _serving_prompt()
    # in turns, f32, bf16, bf16, f32: a drift of the host's speed over the
    # phase falls on both engines alike
    windows = {"f32": ([], []), "bf16": ([], [])}
    for name in ("f32", "bf16", "bf16", "f32"):
        bf16 = name == "bf16"
        walls, rounds, got = _serve_window("25", f"{name} engine", bf16_engine if bf16 else engine,
                                           prompt, bf16=bf16)
        windows[name][0].extend(walls)
        windows[name][1].extend(rounds)
        if bf16:
            counts = got
    for name, (walls, rounds) in windows.items():
        log("25", f"{name} engine, both turns: {len(walls)} sequential requests "
                  f"{_percentiles(walls)}, {len(walls) * SERVE_SAMPLES / 24000 / sum(walls):.2f} "
                  f"audio-s per wall-s; {len(rounds)} rounds of {SERVE_BATCH}: round "
                  f"{_percentiles(rounds)}, "
                  f"{len(rounds) * SERVE_BATCH * SERVE_SAMPLES / 24000 / sum(rounds):.2f} "
                  "audio-s per wall-s")

    # the CLI's sample --bf16, in-process, 10 steps from a WAV prompt
    wav_path, out_dir = work / "prompt.wav", work / "bf16_out"
    write_wav(wav_path, prompt, 24000)
    ops.reset_launch_counts()
    argv = ["sample", "--bf16", "--config", config, "--checkpoint", checkpoint,
            "--device", "cuda", "--text", SERVE_SENTENCE, "--prompt", str(wav_path),
            "--seconds", str(SERVE_SECONDS), "--timesteps", "10", "--cond-scale",
            str(SERVE_COND_SCALE), "--out", str(out_dir)]
    if cli.main(argv) != 0:
        raise AssertionError("cli sample --bf16 failed")
    wav, sr = load_audio(str(out_dir / "sample-0.wav"))
    if sr != 24000 or wav.size == 0 or not np.isfinite(wav).all():
        raise AssertionError(f"cli sample --bf16 wrote {wav.size} samples at {sr} Hz")
    # 6.8 s is 510 frames, unbucketed: off the JAX package's block gates
    # (510 % 8 != 0), so the self- and cross-attention run unfused on K4 and
    # the feed-forward as tensor ops, each step: K1, 2 x DEPTH + the
    # resampler's K4
    per_step = {k: 0 for k in SERVE_BF16_PART} | {
        "wavenet_body": 1, "flash_forward": 2 * DEPTH + RESAMPLER_DEPTH}
    _check_bf16_counts("25", "cli sample --bf16 (10 guided steps at 510 frames)",
                       ops.launch_counts(), ops.launch_counts(torch.bfloat16), SERVE_F32_PART,
                       {k: 10 * v for k, v in per_step.items()})
    log("25", f"cli.main(['sample', '--bf16', ...]): {wav.size} samples at {sr} Hz, finite")
    return bf16_engine, counts


def _correlation(a, b) -> float:
    import torch

    return torch.corrcoef(torch.stack([a.flatten().double(), b.flatten().double()]))[0, 1].item()


def phase26_bf16_card_vs_cpu(bf16_engine, engine, config: str, checkpoint: str) -> None:
    """bf16 on the card (kernels) against bf16 on the CPU (plain versions),
    README config 2 at full width: one guided denoiser forward (b1 x 200
    frames, cond_scale 2.5) and a 2-step served sample with the same
    injected noise, each within BF16_PATH_TOL of the CPU's largest entry
    and correlated ≥ BF16_CORR; the card's bf16 sample's correlation with
    its f32 one, at least BF16_F32_CORR."""
    import torch

    from naturalspeech2_tpu_torch import cli
    from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale

    cpu = cli.build_engine(config, checkpoint, timesteps=SERVE_CHECK_STEPS,
                           cond_scale=SERVE_COND_SCALE, device="cpu",
                           prompt_samples=PROMPT_SAMPLES, dtype="bfloat16")
    g = torch.Generator().manual_seed(SEED + 202)
    n, p = SERVE_CHECK_FRAMES, PROMPT_SAMPLES // 320
    x = torch.randn(1, n, DIM, generator=g).bfloat16()
    prompt_enc = torch.randn(1, p, DIM_PROMPT, generator=g).bfloat16()
    cond = torch.randn(1, n, DIM_PROMPT, generator=g).bfloat16()
    times = torch.full((1,), 0.5)
    with torch.no_grad():
        on_card = forward_with_cond_scale(bf16_engine.ns2.model, x.cuda(), times.cuda(),
                                          prompt=prompt_enc.cuda(), cond=cond.cuda(),
                                          cond_scale=SERVE_COND_SCALE)
        on_cpu = forward_with_cond_scale(cpu.ns2.model, x, times, prompt=prompt_enc, cond=cond,
                                         cond_scale=SERVE_COND_SCALE)
    compare("26", f"guided denoiser forward in bf16 b1 x n{n}, card vs CPU", on_card, on_cpu,
            BF16_PATH_TOL, relative=True)
    corr = _correlation(on_card.float().cpu(), on_cpu.float())
    log("26", f"guided forward card vs CPU correlation {corr:.6f} (at least {BF16_CORR})")
    if corr < BF16_CORR:
        raise AssertionError(f"guided forward correlation {corr:.6f} below {BF16_CORR}")

    seconds = SERVE_CHECK_FRAMES * 320 / 24000
    for e in (bf16_engine, engine):
        e.timesteps = SERVE_CHECK_STEPS
    try:
        reqs = [e._prepare(SERVE_SENTENCE, _serving_prompt(), seconds, 0)
                for e in (bf16_engine, cpu, engine)]
        noise = torch.randn(1, reqs[0].f_bucket, DIM,
                            generator=torch.Generator().manual_seed(SEED + 203))
        card = torch.from_numpy(bf16_engine._run_batch([reqs[0]], noise=noise.cuda())[0])
        host = torch.from_numpy(cpu._run_batch([reqs[1]], noise=noise)[0])
        card_f32 = torch.from_numpy(engine._run_batch([reqs[2]], noise=noise.cuda())[0])
    finally:
        for e in (bf16_engine, engine):
            e.timesteps = STEPS
    label = f"served waveform in bf16 ({SERVE_CHECK_STEPS} guided steps)"
    compare("26", f"{label}, card vs CPU", card, host, BF16_PATH_TOL, relative=True)
    corr, corr_f32 = _correlation(card, host), _correlation(card, card_f32)
    log("26", f"{label}: correlation card vs CPU {corr:.6f} (at least {BF16_CORR}); with the "
              f"card's f32 sample {corr_f32:.6f} (at least {BF16_F32_CORR})")
    if corr < BF16_CORR or corr_f32 < BF16_F32_CORR:
        raise AssertionError(f"bf16 sample correlations {corr:.6f}, {corr_f32:.6f}")


def _profile(label: str, fn) -> None:
    """torch.profiler around ``fn()`` (after one warm-up call): wall time,
    the device's busy share and launches, the device time by kernel, and
    the host operators with the most self CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    # device-side events only (kernels, copies): the operators that launch
    # them report the same device time again
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log("profile", f"{label}: wall {wall_ms:.2f} ms (profiled), device busy {busy_ms:.2f} ms "
                   f"({100 * busy_ms / wall_ms:.1f} %), {sum(e.count for e in kernels)} device "
                   "calls")
    for e in kernels[:20]:
        log("profile", f"{e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d} calls  "
                       f"{e.key[:100]}")
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:12]:
        log("profile", f"host {e.self_cpu_time_total / 1e3:10.3f} ms  {e.count:6d} calls  "
                       f"{e.key[:90]}")


def sdpa_kernel_names() -> None:
    """The device kernels that F.scaled_dot_product_attention runs on f32
    [4, 8, 1024, 64], forward and backward: what K4's and K5's yardstick is."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(4, HEADS, 1024, DIM_HEAD, generator=gen, device="cuda")
                   for _ in range(4))
    fwd, bwd = sdpa_calls(q, k, v, do, DIM_HEAD**-0.5)
    for label, fn in (("forward", fwd), ("backward", bwd)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        log("profile", f"SDPA {label} f32 [4,{HEADS},1024,{DIM_HEAD}] runs: {names}")


def profile_bf16_guided(ns2, x, times, prompt_enc, cond) -> None:
    """torch.profiler over 10 guided denoise steps of README config 2 in
    bf16 (a `cast_floating` copy of the denoiser, the inputs cast once, as
    `sample(dtype=torch.bfloat16)` runs them), then the same 10 steps in
    f32 again: the bf16 step's device time and busy share beside f32's."""
    import torch

    from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale
    from naturalspeech2_tpu_torch.models.naturalspeech2 import cast_floating

    bf16_model = cast_floating(ns2.model, torch.bfloat16)
    x16, p16, c16 = x.bfloat16(), prompt_enc.bfloat16(), cond.bfloat16()
    for label, model, args in (("bf16", bf16_model, (x16, p16, c16)),
                               ("f32, again", ns2.model, (x, prompt_enc, cond))):
        def steps(model=model, args=args):
            for _ in range(10):
                forward_with_cond_scale(model, args[0], times, prompt=args[1], cond=args[2],
                                        cond_scale=COND_SCALE)

        with torch.no_grad():
            _profile(f"10 guided denoise steps, {label}", steps)


# --------------------------------------------------------------------- #
# AMP training (phases 27-30)
# --------------------------------------------------------------------- #


def attended_pairs(b, h, n_q, n_kv, causal: bool, mask=None) -> int:
    """The (row, key) pairs whose product a flash kernel's function needs,
    over every batch and head: none for a key that the [b, n_kv] ``mask``
    drops, nor, with ``causal``, for a key past its row (key > row). A
    bound counts these, not the full n_q × n_kv square."""
    import torch

    seen = (torch.ones(b, n_kv, dtype=torch.bool) if mask is None else mask.bool()).long()
    if not causal:
        return h * n_q * int(seen.sum())
    upto = seen.cumsum(-1)  # row i sees the visible keys 0 .. min(i, n_kv - 1)
    m = min(n_q, n_kv)
    return h * int(upto[:, :m].sum() + (n_q - m) * upto[:, -1].sum())


def bound_amp_backward(b, h, n_q, n_kv, d, dropout: bool, pairs: int | None = None) -> dict:
    """Bound of K5 in bf16: S, dP, dQ and dK are products of bf16 values,
    at the dense bf16 peak; dV = Aᵀ·dO multiplies the f32 A by bf16 dO, at
    the least-cost exact scheme (A split into three bf16 parts, three bf16
    passes: `bound_bf16`'s f32_lanes); the keep bits (twice: the dq and the
    dk/dv kernel) at the f32 peak; bf16 q, k, v, o, dO and dq, dk, dv and
    f32 lse and delta moved once. ``pairs`` (`attended_pairs`) counts the
    products a masked or causal case needs; b·h·n_q·n_kv by default."""
    pairs = b * h * n_q * n_kv if pairs is None else pairs
    pair = 2 * pairs * d  # one product over the attended pairs, 2 FLOPs a multiply-add
    ops_ms = max((4 * pair / PEAK_BF16_FLOPS + pair / (PEAK_BF16_FLOPS / 3)) * 1e3,
                 (2 * THREEFRY_OPS * pairs if dropout else 0.0) / PEAK_F32_FLOPS * 1e3)
    moved = 2 * (3 * b * h * n_q * d + 4 * b * h * n_kv * d) + 2 * 4 * b * h * n_q
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _amp_entry(name: str, dtype: str, source: str, replaces: str) -> dict:
    return {"name": name, "dtype": dtype, "route": "cuda",
            "source": f"naturalspeech2_tpu_torch/csrc/{source}",
            "replaces": f"naturalspeech2_tpu/ops/{replaces}", "by_shape": {}}


def _add_shape(row: dict, shape: str, timing: dict) -> None:
    """A shape's numbers into a summary row (the first shape's at the top)."""
    if not row["by_shape"]:
        row.update({k: timing[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
    row["by_shape"][shape] = timing
    row["max_abs_err"] = max(row["max_abs_err"], timing["max_abs_err"])


def amp_flash_case(phase: str, gen, b, h, n_q, n_kv, d=DIM_HEAD, rate=0.0, causal=False,
                   masked=False, seed=(0x5EED0027, 0xC0DE)) -> dict:
    """K4 and K5 in bf16 at one shape against their plain bf16 versions
    (o and each gradient within BF16_TOL of their largest entry, lse within
    FLASH_TOL), timed beside the f32 kernels on the same values, the plain
    versions and SDPA in bf16 (forward, and its autograd backward):
    {name: (shape, timing)}."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    q, do = (torch.randn(b, h, n_q, d, generator=gen, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, h, n_kv, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    mask = None
    if masked:
        mask = torch.rand(b, n_kv, generator=gen, device="cuda") > 0.2
        mask[:, 0] = True
    seed = seed if rate > 0.0 else None
    cfg = dict(causal=causal, scale=d**-0.5, dropout_rate=rate)
    fwd = lambda: fa.flash_forward(q, k, v, mask, seed, **cfg)  # noqa: E731
    fwd_plain = lambda: fa.flash_forward_torch(q, k, v, mask, seed, **cfg)  # noqa: E731
    (o, lse), (o_ref, lse_ref) = fwd(), fwd_plain()
    torch.cuda.synchronize()
    shape = f"[{b},{h},{n_q},{d}]" if n_q == n_kv else f"[{b},{h},{n_q}|{n_kv},{d}]"
    shape += "".join([" causal" if causal else "", " masked" if masked else "",
                      f" dropout {rate:g}" if rate else ""])
    if o.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise AssertionError(f"flash_forward bf16: o {o.dtype}, lse {lse.dtype}")
    err_f = compare(phase, f"flash_forward bf16 {shape}", o, o_ref, BF16_TOL, relative=True)
    compare(phase, f"flash_forward bf16 {shape} lse", lse, lse_ref, FLASH_TOL)
    bwd = lambda: fa.flash_backward(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)  # noqa: E731
    bwd_plain = lambda: fa.flash_backward_torch(  # noqa: E731
        q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)
    grads = bwd()
    torch.cuda.synchronize()
    if any(g.dtype != torch.bfloat16 for g in grads):
        raise AssertionError(f"flash_backward bf16: {[g.dtype for g in grads]}")
    err_b = compare(phase, f"flash_backward bf16 {shape}", grads, bwd_plain(), BF16_TOL,
                    relative=True)
    del o, lse, grads
    lib_fwd, lib_bwd = sdpa_calls(q, k, v, do, cfg["scale"], rate)
    if causal or masked:  # SDPA's own mask arguments: a yardstick of the same work
        import torch.nn.functional as F

        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        attn_mask = fa._valid(b, n_q, n_kv, mask, causal, "cuda")
        lib_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=attn_mask, scale=cfg["scale"], dropout_p=rate)
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask,
                                               scale=cfg["scale"], dropout_p=rate)
        lib_bwd = lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,  # noqa: E731
                                              retain_graph=True)
    moved_f = 2 * (2 * b * h * n_q * d + 2 * b * h * n_kv * d) + 4 * b * h * n_q
    pairs = attended_pairs(b, h, n_q, n_kv, causal, mask)
    work_f = bound_bf16(4 * pairs * d, moved_f)
    if rate:
        keep_ms = THREEFRY_OPS * pairs / PEAK_F32_FLOPS * 1e3
        if keep_ms > work_f["bound_ms"]:
            work_f = {"bound_ms": keep_ms, "bound_by": "operations"}
    q32, k32, v32, do32, o32 = (t.float() for t in (q, k, v, do, o_ref))
    fwd32 = lambda: fa.flash_forward(q32, k32, v32, mask, seed, **cfg)  # noqa: E731
    bwd32 = lambda: fa.flash_backward(q32, k32, v32, mask, seed, lse_ref, o32, do32,  # noqa: E731
                                      **cfg)
    results = {}
    for name, kernel, f32_kernel, plain, library, work, err in (
            ("flash_forward", fwd, fwd32, fwd_plain, lib_fwd, work_f, err_f),
            ("flash_backward", bwd, bwd32, bwd_plain, lib_bwd,
             bound_amp_backward(b, h, n_q, n_kv, d, bool(rate), pairs), err_b)):
        ms, f32_ms, plain_ms, lib_ms = (cuda_ms(f) for f in (kernel, f32_kernel, plain, library))
        log(phase, f"{name} bf16 {shape}: kernel {ms:.4f} ms, f32 kernel {f32_ms:.4f} ms, plain "
                   f"bf16 {plain_ms:.4f} ms, SDPA bf16 {lib_ms:.4f} ms (median of 20), bound "
                   f"{work['bound_ms']:.4f} ms ({work['bound_by']})")
        results[name] = (shape, {"max_abs_err": err, "ms": ms, "f32_ms": f32_ms,
                                 "plain_ms": plain_ms, "library_ms": lib_ms, **work})
    return results


def _amp_keep_case(gen, b, h, n, d, rate, seed, phase: str) -> None:
    """K4's keep mask in bf16 at [b, h, n, n], bit for bit against the f32
    kernel's, the plain bf16 version's and the Threefry mask (as
    `_flash_keep_case`: q = k = 0, v one-hot over a d-key window, so
    o[row, c] != 0 exactly where key window + c is kept)."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    zeros = torch.zeros(b, h, n, d, device="cuda")
    cfg = dict(causal=False, scale=d**-0.5, dropout_rate=rate)
    masks = {"bf16": [], "f32": [], "plain bf16": []}
    for w0 in range(0, n, d):
        onehot = torch.zeros(b, h, n, d, device="cuda")
        cols = torch.arange(w0, min(w0 + d, n), device="cuda")
        onehot[:, :, cols, cols - w0] = 1.0
        z16, v16 = zeros.bfloat16(), onehot.bfloat16()
        masks["bf16"].append(fa.flash_forward(z16, z16, v16, None, seed, **cfg)[0] != 0)
        masks["f32"].append(fa.flash_forward(zeros, zeros, onehot, None, seed, **cfg)[0] != 0)
        masks["plain bf16"].append(
            fa.flash_forward_torch(z16, z16, v16, None, seed, **cfg)[0] != 0)
    kept = {k: torch.cat(v, dim=-1)[..., :n] for k, v in masks.items()}
    keep = fa.dropout_keep_scaled(seed, b, h, n, n, rate, device="cuda") != 0
    if not all(torch.equal(m, keep) for m in kept.values()):
        raise AssertionError(f"flash_forward bf16 [{b},{h},{n},{d}]: keep masks differ")
    log(phase, f"bf16 dropout keep masks identical at [{b},{h},{n},{d}]: {int(keep.sum())} of "
               f"{keep.numel()} kept at rate {rate} (bf16 kernel, f32 kernel, plain bf16 and "
               "the Threefry mask)")


def _amp_rvq_case(gen, m, phase: str, num_q=8, size=1024, d=128) -> dict:
    """K6 on bf16 x and codebooks against the f32 kernel on their widened
    values: codes equal but for near-ties (RVQ_TIE_TOL in d²), the bf16
    quantized sum equal to the f32 one rounded once on the agreeing rows;
    against the plain bf16 version likewise; timed beside both."""
    import torch

    from naturalspeech2_tpu_torch.ops import rvq as rvq_ops

    x = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
    cb = torch.randn(num_q, size, d, generator=gen, device="cuda").bfloat16()
    x32, cb32 = x.float(), cb.float()
    (q, codes), (q32, codes32) = rvq_ops.rvq(x, cb), rvq_ops.rvq(x32, cb32)
    q_plain, codes_plain = rvq_ops.rvq_bf16_torch(x, cb)
    torch.cuda.synchronize()
    if q.dtype != torch.bfloat16:
        raise AssertionError(f"rvq bf16: quantized is {q.dtype}")
    xd, cbd = x32.double().cpu(), cb32.double().cpu()
    for label, ref_codes, ref_q in (("the f32 kernel", codes32, q32.bfloat16()),
                                    ("the plain bf16 version", codes_plain, q_plain)):
        got, want = codes.long().cpu(), ref_codes.long().cpu()
        same = (got == want).all(dim=1)
        for row in torch.nonzero(~same).flatten().tolist():
            stage = int(torch.nonzero(got[row] != want[row])[0])
            r = xd[row] - sum(cbd[s][want[row, s]] for s in range(stage))
            gap = abs(((r - cbd[stage][got[row, stage]]) ** 2).sum()
                      - ((r - cbd[stage][want[row, stage]]) ** 2).sum())
            if gap > RVQ_TIE_TOL:
                raise AssertionError(f"rvq bf16 vs {label}: row {row} stage {stage} differs by "
                                     f"{gap:.3e} in d²")
        if (~same).sum() > m // 100:
            raise AssertionError(f"rvq bf16 vs {label}: {int((~same).sum())} rows part")
        rows = same.cuda()
        if not torch.equal(q[rows], ref_q[rows]):
            raise AssertionError(f"rvq bf16: quantized differs from {label} on agreeing rows")
        log(phase, f"rvq bf16 [{m},{d}] Q{num_q} K{size} vs {label}: codes equal in "
                   f"{int(same.sum())} of {m} rows (the rest near-ties within {RVQ_TIE_TOL:g}), "
                   "quantized bit-equal there")
    kernel = lambda: rvq_ops.rvq(x, cb)  # noqa: E731
    ms, f32_ms, plain_ms = (cuda_ms(f) for f in (kernel, lambda: rvq_ops.rvq(x32, cb32),
                                                 lambda: rvq_ops.rvq_bf16_torch(x, cb)))
    # stage 0 multiplies bf16 x by bf16 codes, one pass; the f32 residual after it three
    work = bound_bf16(2 * m * size * d * (1 + 3 * (num_q - 1)), nbytes(x, cb, q, codes))
    log(phase, f"rvq bf16 [{m},{d}]: kernel {ms:.4f} ms, f32 kernel {f32_ms:.4f} ms, plain bf16 "
               f"{plain_ms:.4f} ms (median of 20), bound {work['bound_ms']:.4f} ms "
               f"({work['bound_by']})")
    return {"max_abs_err": 0.0, "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
            "library_ms": None, **work}


def amp_mixed_cases(gen, b, n, d, names, inner=None, residual=True, dc=None, heads=HEADS,
                    dim_head=DIM_HEAD) -> list:
    """(name, mixed kernel, plain f32 on the widened weights, f32 kernel on
    the same values, bound, residual) of K1, K2, K3 and K2b at one shape:
    f32 activations against bf16 weights, as AMP's denoiser runs them. K3's
    inner width int(8d/3) unless given; K2b's context NUM_LATENTS rows of dc
    (default d); K2's and K2b's ``heads`` of ``dim_head``; with ``residual``
    False K2 and K2b leave x out (tensor parallelism's partial sums) and
    their cases' residual is None. The bounds count the f32 operands'
    products as three exact bf16 passes (989 / 3 TFLOP/s, the cheapest
    exact scheme), K2's and K2b's attention cores on K4 f32 in split TF32
    (495 / 3)."""
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    rn = _randn(gen)
    cases = []
    out_bytes = b * n * d * 4
    scale, hd = dim_head**-0.5, heads * dim_head

    def split(args, n_act):
        """(activations f32, weights bf16), and the weights widened."""
        acts, weights = args[:n_act], _bf16(*args[n_act:])
        return (*acts, *weights), (*acts, *(w.float() for w in weights))

    cfg = dict(heads=heads, dim_head=dim_head, scale=scale)
    rcfg = dict(cfg, residual=residual)

    def blocks_bound(gemm_flops, core_flops, moved):
        """The projections at three bf16 passes, the core at three TF32
        passes, against the bytes."""
        ops_ms = (bound_bf16(gemm_flops, 0, f32_lanes=True)["bound_ms"]
                  + TF32_PASSES * core_flops / PEAK_TF32_FLOPS * 1e3)
        bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
        return {"bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}

    if "wavenet_body" in names:
        wn, _ = wavenet_inputs(gen, b, n, d)
        w16, w32 = split((wn[0], wn[7], *wn[1:7]), 2)
        w16, w32 = ((a[0], *a[2:], a[1]) for a in (w16, w32))  # (x, weights, film)
        flops = 2 * b * n * d * d * (WAVENET_STACKS * WAVENET_LAYERS * 4 + WAVENET_LAYERS)
        cases.append(("wavenet_body", lambda: wk._forward("stack", *w16),
                      lambda: wk.wavenet_body_torch(*w32), lambda: wk._forward("stack", *w32),
                      bound_bf16(flops, nbytes(*w16) + out_bytes, f32_lanes=True), None))
    if "attn_block" in names:
        a16, a32 = split(attn_inputs(gen, b, n, d, heads, dim_head), 3)
        heads_32 = ak.split_heads(*a32[3:], heads, dim_head)
        # the core: 4·b·H·n²·dh
        work = blocks_bound(2 * b * n * d * 4 * hd, 4 * b * heads * n * n * dim_head,
                            nbytes(*a16) + out_bytes)
        cases.append(("attn_block", lambda: ak.attn_block(*a16, **rcfg),
                      lambda: ak.attn_block_torch(*a32[:3], *heads_32, scale=scale,
                                                  residual=residual),
                      lambda: ak.attn_block(*a32, **rcfg), work, a16[0] if residual else None))
    if "ff_block" in names:
        inner = inner or int(d * 4 * 2 / 3)
        f16, f32 = split((rn(b, n, d), 1 + rn(b, d, scale=0.1), rn(b, d, scale=0.1),
                          rn(d, 2 * inner, scale=d**-0.5), rn(2 * inner, scale=0.1),
                          rn(3, inner, inner, scale=(3 * inner) ** -0.5), rn(inner, scale=0.1),
                          rn(inner, d, scale=inner**-0.5), rn(d, scale=0.1)), 3)
        flops = 2 * b * n * (d * 2 * inner + 3 * inner * inner + inner * d)
        cases.append(("ff_block", lambda: fk.ff_block(*f16), lambda: fk.ff_block_plain(*f32),
                      lambda: fk.ff_block(*f32),
                      bound_bf16(flops, nbytes(*f16) + out_bytes, f32_lanes=True), f16[0]))
    if "cross_attn_block" in names:
        m, dc = NUM_LATENTS, dc or d
        c16, c32 = split(cross_inputs(gen, b, n, m, d, dc, heads, dim_head), 4)
        # q, k/v and W_o; the core: 4·b·H·n·m·dh
        work = blocks_bound(2 * b * n * d * hd + 2 * b * m * dc * 2 * hd + 2 * b * n * hd * d,
                            4 * b * heads * n * m * dim_head, nbytes(*c16) + out_bytes)
        cases.append(("cross_attn_block", lambda: ak.cross_attn_block(*c16, **rcfg),
                      lambda: ak._cross_plain(*c32, **rcfg),
                      lambda: ak.cross_attn_block(*c32, **rcfg), work,
                      c16[0] if residual else None))
    return cases


def phase27_amp_kernels(bf16_summary: list) -> list:
    """The kernels AMP training adds, each against its plain version on the
    card: K4 and K5 in bf16 at the prompt encoder's [16, 8, 102, 64] with
    dropout 0.2 (keep masks bit for bit against the f32 kernel's), K5 in
    bf16 at [16, 8, 150, 64] and [4, 8, 1024, 64] causal and masked, beside
    SDPA in bf16; K6 on bf16 x and codebooks at m 2400 and 1632 (Q 8, K
    1024, d 128), AMP_RVQ_RAGGED and AMP_RVQ_COPIED against the f32 kernel
    on the widened values; the mixed K1 at [16, 150, 128], [16, 160,
    128] and [2, 200, 96], and K2, K3 and K2b at [16, 160, 128] (f32
    activations against bf16 weights; K2b's context [16, 32, 128]) against
    the f32 plain versions on the widened weights (WAVENET_TOL, BLOCK_TOL),
    timed beside the f32 kernels on the same values; K3 mixed at
    AMP_K3_RAGGED, K2 mixed at AMP_K2_RAGGED and K2b mixed at
    AMP_K2B_RAGGED, K2 and K2b also with the residual off (the partial sum
    within BLOCK_TOL of its largest entry); K1b mixed at AMP_K1B_SHAPES (on
    no AMP path) held and timed likewise, logged. Adds the bf16 dropout
    shape to phase 22's bf16 K4 row; returns the new rows (bf16 K5 and K6,
    the mixed entries). The profiles of the mixed K1, K1b, K2, K2b and K3
    and of K6 bf16 run early (``check_amp_bf16_cores``)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 270)
    fwd_row = next(r for r in bf16_summary if r["name"] == "flash_forward")
    bwd_row = _amp_entry("flash_backward", "bfloat16", "flash_bwd_bf16.cu",
                         "flash_attention.py:361")
    bwd_row["replaces_also"] = "naturalspeech2_tpu/ops/flash_attention.py:430"
    b, h, d, p = CT_BATCH, HEADS, DIM_HEAD, CT_PROMPT_FRAMES
    seed = (0x5EED0027, 0xC0DE)
    for n, rate, causal, masked in ((p, CT_DROPOUT, False, False), (CT_FRAMES, 0.0, False, False),
                                    (1024, 0.0, True, True)):
        bb = b if n != 1024 else 4
        res = amp_flash_case("27", gen, bb, h, n, n, d, rate, causal, masked, seed)
        shape, timing = res["flash_forward"]
        fwd_row["by_shape"][shape] = timing
        fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], timing["max_abs_err"])
        _add_shape(bwd_row, *res["flash_backward"])
    _amp_keep_case(gen, b, h, p, d, CT_DROPOUT, seed, "27")

    rvq_row = _amp_entry("rvq", "bfloat16", "rvq.cu", "rvq.py:60")
    for m in (TRAIN_BATCH * int(TRAIN_SECONDS * 24000) // 320, CT_BATCH * p):
        _add_shape(rvq_row, f"m {m}", _amp_rvq_case(gen, m, "27"))
    for m, num_q, size, d in (AMP_RVQ_RAGGED, AMP_RVQ_COPIED):
        _add_shape(rvq_row, f"m {m} Q{num_q} K{size} d{d}",
                   _amp_rvq_case(gen, m, "27", num_q=num_q, size=size, d=d))

    rows = {}
    sources = {"wavenet_body": ("wavenet.cu", "wavenet_kernel.py:80"),
               "attn_block": ("attn_block.cu", "attn_block_kernel.py:92"),
               "ff_block": ("ff_block.cu", "ff_block_kernel.py:97"),
               "cross_attn_block": ("cross_attn_block.cu", "attn_block_kernel.py:237")}
    k3b, k3n, k3d, k3_inner = AMP_K3_RAGGED
    k2b, k2n, k2d, _ = AMP_K2_RAGGED
    xb, xn, xdm, xdc, xheads, xdh = AMP_K2B_RAGGED
    for bb, n, d, names, kw in (
            (CT_BATCH, CT_FRAMES, DIM, ("wavenet_body",), {}),
            (CT_BATCH, AMP_FUSED_FRAMES, DIM, ("wavenet_body", "attn_block", "ff_block",
                                               "cross_attn_block"), {}),
            (CT_BATCH, AMP_FUSED_FRAMES, DIM, ("attn_block",), {"residual": False}),
            (*AMP_K1_PADDED, ("wavenet_body",), {}),
            (k3b, k3n, k3d, ("ff_block",), {"inner": k3_inner}),
            (k2b, k2n, k2d, ("attn_block",), {}),
            (k2b, k2n, k2d, ("attn_block",), {"residual": False}),
            (CT_BATCH, AMP_FUSED_FRAMES, DIM, ("cross_attn_block",), {"residual": False}),
            (xb, xn, xdm, ("cross_attn_block",), {"dc": xdc, "heads": xheads,
                                                   "dim_head": xdh})):
        shape = (f"[{bb},{n},{d}]" + (f" inner {kw['inner']}" if "inner" in kw else "")
                 + (f" ctx [{bb},{NUM_LATENTS},{kw['dc']}], {kw['heads']} heads of "
                    f"{kw['dim_head']}" if "dc" in kw else "")
                 + (" residual off" if kw.get("residual") is False else ""))
        for name, kernel, plain, f32_kernel, work, residual in amp_mixed_cases(gen, bb, n, d,
                                                                                names, **kw):
            out = kernel()
            torch.cuda.synchronize()
            if out.dtype != torch.float32:
                raise AssertionError(f"{name} mixed: output {out.dtype}")
            err = hold("27", f"{name} mixed {shape}", out, plain(), residual)
            del out
            ms, f32_ms, plain_ms = cuda_ms(kernel), cuda_ms(f32_kernel), cuda_ms(plain)
            log("27", f"{name} mixed {shape}: kernel {ms:.4f} ms, f32 kernel {f32_ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms (median of 20), bound {work['bound_ms']:.4f} ms "
                      f"({work['bound_by']})")
            row = rows.setdefault(name, _amp_entry(name, "mixed", *sources[name]))
            _add_shape(row, shape, {"max_abs_err": err, "ms": ms, "f32_ms": f32_ms,
                                    "plain_ms": plain_ms, "library_ms": None, **work})
        torch.cuda.empty_cache()
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    # K1b mixed: on no AMP path, held and timed
    S, L = WAVENET_STACKS, WAVENET_LAYERS
    for b, n, d in AMP_K1B_SHAPES:
        wn, _ = wavenet_inputs(gen, b, n, d)
        wn = (wn[0], *_bf16(*wn[1:7]), wn[7])
        wide = tuple(t.float() for t in wn)
        kernel = lambda: wk.wavenet_body_lanes(*wn)  # noqa: E731
        plain = lambda: wk.wavenet_body_lanes_torch(*wide)  # noqa: E731
        out = kernel()
        torch.cuda.synchronize()
        if out.dtype != torch.float32:
            raise AssertionError(f"wavenet_body_lanes mixed: output {out.dtype}")
        label = f"wavenet_body_lanes mixed [{b},{n},{d}] (on no AMP path)"
        hold("27", label, out, plain())
        del out
        work = bound_bf16(2 * b * n * d * d * (S * L * 4 + L), nbytes(*wn) + b * n * d * 4,
                          f32_lanes=True)
        ms, f32_ms, plain_ms = (cuda_ms(f) for f in (
            kernel, lambda: wk.wavenet_body_lanes(*wide), plain))
        log("27", f"{label}: kernel {ms:.4f} ms, f32 kernel {f32_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (median of 20), bound {work['bound_ms']:.4f} ms "
                  f"({work['bound_by']})")
        del wn, wide
    return [bwd_row, rvq_row, *rows.values()]


# K3's, K2's, K2b's and K1b's mixed entry points as torch.profiler names
# their launches: {kind: (the strings one kernel's name holds, launches a
# call)}
K3_MIXED_LAUNCHES = {"norm pre-pass": (("norm_rows_kernel<float, 3>",), 1),
                     "GEGLU GEMM": (("bf16_gemm_kernel", "GegluSplit"), 1),
                     "conv GEMM": (("bf16_gemm_kernel", "StoreSplit"), 1),
                     "W2 GEMM": (("bf16_gemm_kernel", "Store<float"), 1)}
K2_MIXED_LAUNCHES = {"norm pre-pass": (("norm_rows_kernel<float, 3>",), 1),
                     "q/k/v GEMM": (("bf16_gemm_kernel", "QkvScatterT<float>"), 1),
                     "K4 f32": (("flash_fwd_kernel<float",), 1),
                     "o split": (("split3_kernel",), 1),
                     "W_o GEMM": (("bf16_gemm_kernel", "SplitHeadRows"), 1)}
# (K2b's norm pre-pass splits its context too)
K2B_MIXED_LAUNCHES = {"norm pre-pass": (("norm_rows_kernel<float, 3>",), 1),
                      "q and k/v GEMMs": (("bf16_gemm_kernel", "SplitLanes",
                                           "QkvScatterT<float>"), 2),
                      "K4 f32": (("flash_fwd_kernel<float",), 1),
                      "o split": (("split3_kernel",), 1),
                      "W_o GEMM": (("bf16_gemm_kernel", "SplitHeadRows"), 1)}


def k1b_mixed_launches(S: int, L: int) -> dict:
    """K1b mixed's launches: x's split, the blocks (LANE_GROUP lanes a
    launch, the gate on f32 parameters) and one skip GEMM a lane."""
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    return {"split pre-pass": (("split3_kernel",), 1),
            "block GEMMs": (("bf16_gemm_kernel", "WaveGateSplit<3, float"),
                            S * -(-L // wk.LANE_GROUP)),
            "skip GEMMs": (("bf16_gemm_kernel", "SplitLanes", "Store<float"), L)}


def check_mixed_block(phase: str, label: str, fn, expect: dict) -> None:
    """A profile of one mixed K1b, K2, K2b or K3 call: each kind of launch of
    ``expect`` as often as it says, no other kernel, none of the split-TF32
    core's (``gemm_tf32x3.cuh``)."""
    def tally(counts):
        got = {kind: sum(c for k, c in counts.items() if all(part in k for part in parts))
               for kind, (parts, _) in expect.items()}
        old = [k for k in counts if "ns2::gemm::" in k]
        want = sum(n for _, n in expect.values())
        ok = (not old and all(got[k] == n for k, (_, n) in expect.items())
              and sum(counts.values()) == want)
        short = (not old and all(got[k] <= n for k, (_, n) in expect.items())
                 and sum(got.values()) == sum(counts.values()) < want)
        return got, old, ok, short

    counts = profile_counts(fn, short=lambda c: tally(c)[-1])
    got, old, ok, _ = tally(counts)
    log(phase, f"{label} profile: {got}; {[(k[:110], c) for k, c in counts.items()]}")
    if not ok:
        raise AssertionError(f"{label}: launches {got}, expected "
                             f"{ {k: n for k, (_, n) in expect.items()} } and nothing else "
                             f"({sum(counts.values())} in all), split-TF32 core {old}")


def check_amp_bf16_cores(phase: str) -> None:
    """Profiles of the AMP entry points on the bf16 GEMM core: K3, K2 and
    K2b mixed at [16, 160, 128] (``check_mixed_block``: the norm pre-pass
    and three GEMMs; the norm pre-pass, the q/k/v GEMM, K4 f32, the split of
    o and the W_o GEMM; the norm pre-pass with the context's split, the q
    and k/v GEMMs, K4 f32, the split of o and the W_o GEMM), K1b mixed at
    [1, 6733, 128] (x's split, S·L / LANE_GROUP block and L skip GEMMs), K1
    mixed
    at [16, 150, 128] (S + 1 launches of the core, the blocks' gate on f32
    parameters, one split pre-pass of x, no other kernel) and K6 bf16 at m
    2400 (Q 8, K 1024, d 128), AMP_RVQ_RAGGED and AMP_RVQ_COPIED (Q launches
    of the core with the ArgMin epilogue, Q updates, a copy of x where d % 8
    != 0; other kernels, the wrapper's fill of the minima, logged); none of
    the split-TF32 core's."""
    import torch

    from naturalspeech2_tpu_torch.ops import rvq as rvq_ops
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 271)
    expect = {"ff_block": K3_MIXED_LAUNCHES, "attn_block": K2_MIXED_LAUNCHES,
              "cross_attn_block": K2B_MIXED_LAUNCHES}
    for name, kernel, *_ in amp_mixed_cases(gen, CT_BATCH, AMP_FUSED_FRAMES, DIM,
                                            ("ff_block", "attn_block", "cross_attn_block")):
        check_mixed_block(phase, f"{name} mixed [{CT_BATCH},{AMP_FUSED_FRAMES},{DIM}]", kernel,
                          expect[name])
    S = WAVENET_STACKS
    b, n, d = AMP_K1B_SHAPES[0]
    wn, _ = wavenet_inputs(gen, b, n, d)
    lanes_args = (wn[0], *_bf16(*wn[1:7]), wn[7])
    check_mixed_block(phase, f"wavenet_body_lanes mixed [{b},{n},{d}]",
                      lambda: wk.wavenet_body_lanes(*lanes_args),
                      k1b_mixed_launches(S, WAVENET_LAYERS))
    del wn, lanes_args
    wn, _ = wavenet_inputs(gen, CT_BATCH, CT_FRAMES, DIM)
    args = (wn[0], *_bf16(*wn[1:7]), wn[7])

    def k1_launches(counts):
        core = sum(c for k, c in counts.items() if "ns2::bgemm::bf16_gemm_kernel" in k)
        gates = [k for k in counts if "WaveGateSplit<3, float" in k]
        splits = sum(c for k, c in counts.items() if "split3_kernel" in k)
        old = [k for k in counts if "ns2::gemm::" in k]
        ok = (not old and core == S + 1 and splits == 1 and bool(gates)
              and sum(counts.values()) == S + 2)
        short = (core + splits == sum(counts.values()) < S + 2 and core <= S + 1
                 and splits <= 1)
        return core, gates, splits, old, ok, short

    counts = profile_counts(lambda: wk._forward("stack", *args),
                            short=lambda c: k1_launches(c)[-1])
    core, gates, splits, old, ok, _ = k1_launches(counts)
    log(phase, f"K1 mixed [{CT_BATCH},{CT_FRAMES},{DIM}] profile: {core} bf16 core launches, "
               f"{splits} split pre-pass; {[(k[:110], c) for k, c in counts.items()]}")
    if not ok:
        raise AssertionError(f"K1 mixed: {core} bf16 core launches (expected {S + 1}), {splits} "
                             f"split pre-passes (1), f32-parameter gates {gates}, split-TF32 "
                             f"{old}, {sum(counts.values())} launches in all ({S + 2})")
    del wn, args
    for m, num_q, size, d in ((TRAIN_BATCH * int(TRAIN_SECONDS * 24000) // 320, 8, 1024, 128),
                              AMP_RVQ_RAGGED, AMP_RVQ_COPIED):
        x = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
        cb = torch.randn(num_q, size, d, generator=gen, device="cuda").bfloat16()

        def k6_launches(counts, num_q=num_q, d=d):
            core = sum(c for k, c in counts.items()
                       if "ns2::bgemm::bf16_gemm_kernel" in k and "ArgMin" in k)
            updates = sum(c for k, c in counts.items() if "rvq_update_bf16_kernel" in k)
            copies = sum(c for k, c in counts.items() if "copy_rows_kernel" in k)
            old = [k for k in counts if "ns2::gemm::" in k or "rvq_update_kernel" in k]
            ok = not old and core == updates == num_q and copies == int(d % 8 != 0)
            short = (not old and core <= num_q and updates <= num_q
                     and copies <= int(d % 8 != 0) and not ok)
            return core, updates, copies, old, ok, short

        counts = profile_counts(lambda: rvq_ops.rvq(x, cb), short=lambda c: k6_launches(c)[-1])
        core, updates, copies, old, ok, _ = k6_launches(counts)
        log(phase, f"K6 bf16 m {m} Q{num_q} K{size} d{d} profile: {core} bf16 core launches, "
                   f"{updates} updates, {copies} copies of x; "
                   f"{[(k[:110], c) for k, c in counts.items()]}")
        if not ok:
            raise AssertionError(f"K6 bf16 m {m} d {d}: {core} bf16 core launches ({num_q}), "
                                 f"{updates} updates ({num_q}), {copies} copies "
                                 f"({int(d % 8 != 0)}), split-TF32 {old}")


def _amp_counts(ops) -> dict:
    """Launch counts by kind of entry point since the last reset."""
    import torch

    return {"f32": ops.launch_counts(), "bf16": ops.launch_counts(torch.bfloat16),
            "mixed": ops.launch_counts("mixed")}


def _per_step(f32=None, bf16=None, mixed=None) -> dict:
    zero = dict.fromkeys(PER_STEP, 0)
    return {"f32": {**zero, **(f32 or {})}, "bf16": {**zero, **(bf16 or {})},
            "mixed": {**zero, **(mixed or {})}}


def _scaled_counts(per_step: dict, steps: int) -> dict:
    return {kind: {k: v * steps for k, v in c.items()} for kind, c in per_step.items()}


def _check_f32_state(phase: str, trainer, checkpoint: str) -> None:
    """Master parameters, Adam's moments, the EMA and the checkpoint in f32."""
    import torch

    params = list(trainer.ns2.parameters())
    bad = [p.dtype for p in params if p.dtype != torch.float32]
    bad += [e.dtype for e in trainer.ema.values() if e.dtype != torch.float32]
    for p in params:
        state = trainer.optimizer.state.get(p, {})
        bad += [state[k].dtype for k in ("exp_avg", "exp_avg_sq") if k in state
                and state[k].dtype != torch.float32]
    payload = torch.load(checkpoint, map_location="cpu", weights_only=True)
    bad += [v.dtype for part in ("params", "ema_params") for v in payload[part].values()
            if v.is_floating_point() and v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"AMP state is not all f32: {set(bad)}")
    log(phase, f"master parameters ({len(params)} tensors), Adam's moments, the EMA and "
               f"{Path(checkpoint).name} are f32")


def _steps_in_turns(phase: str, label: str, calls: dict, batch, rounds: int = 2,
                    steps: int = 5) -> dict:
    """ms per optimizer step of each trainer, in turns (f32, AMP, AMP, f32
    for two), host clock, synchronised: {name: [ms per step of each turn]}."""
    import torch

    order = list(calls)
    turns = [order[i % 2] if (i // 2) % 2 == 0 else order[1 - i % 2] for i in range(2 * rounds)]
    times = {k: [] for k in order}
    for name in turns:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(steps):
            calls[name](batch)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - start) / steps * 1e3)
    log(phase, f"{label}, ms per optimizer step in turns ({' '.join(turns)}; {steps} steps a "
               "turn, host clock, synchronised): "
               + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in t)}" for k, t in times.items()))
    return times


def phase28_amp_train(work: Path) -> dict:
    """Flagship AMP training: `Trainer(amp=True)` on phase 7's folder of
    synthetic WAVs, b16 x 2 s, 10 steps with the step-10 EMA sample and
    checkpoint; finite losses, moved parameters, f32 master state, a resume
    at step 10 with equal state; exact launch counts of the 10 steps and of
    one more on each kind of entry point (bf16 K6, mixed K1, f32 K4 / K5 on
    the denoiser's unfused attention), the f32 trainer's unchanged; one AMP
    step at 160 frames (the JAX gates pass: mixed K2 and K3, K2's backward
    on K4 / K5); `cli.main(["train", "--amp", ...])` for two steps; ms per
    step beside the f32 trainer's in turns. Returns the counts by path."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import cli, ops

    folder, results = work / "wavs", work / "amp_results"
    folder.mkdir(exist_ok=True)
    _write_wavs(folder)
    kwargs = dict(folder=str(folder), train_batch_size=TRAIN_BATCH,
                  data_max_length_seconds=TRAIN_SECONDS, save_and_sample_every=TRAIN_STEPS,
                  sample_length=SAMPLE_FRAMES, results_folder=str(results))
    ns2 = flagship(SEED + 280).cuda()
    start_params = {n: p.detach().clone() for n, p in ns2.named_parameters()}
    trainer = ns2pkg.Trainer(ns2, train_num_steps=TRAIN_STEPS, amp=True, **kwargs)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(log_every=1)
    torch.cuda.synchronize()
    counts = _amp_counts(ops)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(line) for line in (results / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    if [r["step"] for r in rows] != list(range(1, TRAIN_STEPS + 1)) or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"AMP metrics: {rows}")
    step_ms = statistics.median(r["step_time_s"] for r in rows[2:]) * 1e3
    log("28", f"Trainer(amp=True) b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s, {TRAIN_STEPS} steps: "
              f"losses {', '.join(f'{v:.4f}' for v in losses)}; {step_ms:.3f} ms per optimizer "
              f"step (median of steps 3-{TRAIN_STEPS}, host clock, synchronised), peak device "
              f"memory {peak_gib:.3f} GiB")
    params = dict(ns2.named_parameters())
    still = [n for n in params if n.startswith("model.") and torch.equal(params[n], start_params[n])]
    if still:
        raise AssertionError(f"denoiser parameters did not move under AMP: {still}")
    _check_f32_state("28", trainer, str(results / "model-1.ckpt"))
    per_step = _per_step(f32={"flash_forward": DEPTH, "flash_backward": DEPTH},
                         bf16={"rvq": 1}, mixed={"wavenet_body": 1})
    expect = _scaled_counts(per_step, TRAIN_STEPS)
    for k, v in PER_DENOISE.items():  # the step-10 EMA sample runs in f32
        expect["f32"][k] += ns2.timesteps * v
    check_counts("28", f"{TRAIN_STEPS} AMP steps and a {ns2.timesteps}-step f32 EMA sample",
                 counts, expect)

    resumed = ns2pkg.Trainer(flagship(SEED + 281).cuda(), train_num_steps=TRAIN_STEPS + 1,
                             amp=True, **kwargs)
    resumed.load(resumed.latest_checkpoint())
    for (name, a), b in zip(ns2.named_parameters(), resumed.ns2.parameters()):
        sa, sb = trainer.optimizer.state[a], resumed.optimizer.state[b]
        if not (resumed.step == TRAIN_STEPS and torch.equal(a, b)
                and torch.equal(trainer.ema[name], resumed.ema[name])
                and all(torch.equal(sa[k].cpu(), sb[k].cpu())
                        for k in ("step", "exp_avg", "exp_avg_sq"))):
            raise AssertionError(f"AMP resume: state differs at {name}")
    ops.reset_launch_counts()
    resumed.train(log_every=1)
    check_counts("28", f"one AMP optimizer step after the resume at step {TRAIN_STEPS} (f32: "
                       f"the denoiser's {DEPTH} unfused attentions' K4 / K5; bf16: K6; mixed: "
                       "K1)",
                 _amp_counts(ops), per_step)

    # the f32 trainer's step is unchanged, and the two in turns
    batch = next(trainer.batches)
    f32_trainer = ns2pkg.Trainer(flagship(SEED + 282).cuda(), batches=iter([]),
                                 train_batch_size=TRAIN_BATCH, results_folder=str(work / "f32"))
    ops.reset_launch_counts()
    f32_trainer.train_step(batch)
    check_counts("28", "one f32 optimizer step (as phase 7)", _amp_counts(ops),
                 {"f32": PER_STEP, **{k: dict.fromkeys(PER_STEP, 0) for k in ("bf16", "mixed")}})
    _steps_in_turns("28", f"flagship b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s",
                    {"f32": f32_trainer.train_step, "amp": trainer.train_step}, batch, steps=4)
    del f32_trainer

    # 160 frames: the fused blocks' gates pass
    g = torch.Generator().manual_seed(SEED + 283)
    audio = torch.tanh(torch.randn(TRAIN_BATCH, AMP_FUSED_FRAMES * 320, generator=g)).numpy()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics = trainer.train_step(audio)
    fused = _amp_counts(ops)
    per_step_160 = _per_step(f32={"flash_forward": DEPTH, "flash_backward": DEPTH},
                             bf16={"rvq": 1},
                             mixed={"wavenet_body": 1, "attn_block": DEPTH, "ff_block": DEPTH})
    check_counts("28", f"one AMP step at {AMP_FUSED_FRAMES} frames (mixed K1, K2, K3; K2's "
                       "backward recomputes on f32 K4 and runs f32 K5)", fused, per_step_160)
    if not math.isfinite(metrics["loss"]):
        raise AssertionError(f"AMP step at {AMP_FUSED_FRAMES} frames: loss {metrics['loss']}")
    log("28", f"AMP step at {AMP_FUSED_FRAMES} frames: loss {metrics['loss']:.4f}, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    cli_results = work / "cli_amp"
    rc = cli.main(["train", "--amp", "--folder", str(folder), "--steps", "2", "--batch-size",
                   str(TRAIN_BATCH), "--save-every", "2", "--results", str(cli_results),
                   "--data-seconds", f"{TRAIN_SECONDS:g}", "--log-every", "1"])
    cli_rows = [json.loads(line) for line in (cli_results / "metrics.jsonl").read_text()
                .splitlines()]
    if rc != 0 or [r["step"] for r in cli_rows] != [1, 2] or not all(
            math.isfinite(r["loss"]) for r in cli_rows):
        raise AssertionError(f"cli train --amp: rc {rc}, {cli_rows}")
    log("28", f"cli.main(['train', '--amp', ...]): 2 steps, losses "
              f"{[round(r['loss'], 4) for r in cli_rows]}, checkpoint written")
    return {"train_amp": counts, "train_amp_160": fused}


def phase29_cond_amp_train(work: Path) -> dict:
    """Conditional AMP training at README config 2 as phase 18 (b16 x 2 s,
    text 100, prompt 32,768 samples, 10 steps): finite losses, every
    trained group moved, f32 master state; exact launch counts of the 10
    steps and of one more (bf16: K6 on the audio and the prompt, K4 with
    dropout and K5 for the prompt encoder's 6 layers and K4 / K5 for the
    resampler's 2; f32: K4 / K5 for the denoiser's 6 self- and 6
    cross-attentions; mixed: K1); one step at 160 frames (mixed K2, K2b,
    K3); ms per step beside the f32 trainer's in turns. Returns the counts
    by path."""
    import warnings

    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    ns2 = flagship(SEED + 290, conditional=True, scan_layers=True).cuda()
    start_params = {n: p.detach().clone() for n, p in ns2.named_parameters()}
    batches = _cond_train_batches(SEED + 291)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = ns2pkg.Trainer(ns2, batches=batches, train_batch_size=CT_BATCH, amp=True,
                                 train_num_steps=CT_STEPS, save_and_sample_every=10**9,
                                 results_folder=str(work / "cond_amp"))
        f32_trainer = ns2pkg.Trainer(flagship(SEED + 292, conditional=True,
                                              scan_layers=True).cuda(),
                                     batches=iter([]), train_batch_size=CT_BATCH,
                                     results_folder=str(work / "cond_f32"))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train(log_every=1)
    torch.cuda.synchronize()
    counts = _amp_counts(ops)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rows = [json.loads(line) for line in (work / "cond_amp" / "metrics.jsonl").read_text()
            .splitlines()]
    for key in ("loss", "diffusion", "duration", "pitch", "align"):
        values = [r[key] for r in rows]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"AMP: non-finite {key} in {values}")
        log("29", f"{key}: {', '.join(f'{v:.4f}' for v in values)}")
    step_ms = statistics.median(r["step_time_s"] for r in rows[2:]) * 1e3
    log("29", f"conditional Trainer(amp=True) b{CT_BATCH} x {CT_SAMPLES / 24000:g} s, "
              f"{CT_STEPS} steps: {step_ms:.3f} ms per optimizer step (median of steps "
              f"3-{CT_STEPS}, host clock, synchronised), peak device memory {peak_gib:.3f} GiB")
    params = dict(ns2.named_parameters())
    groups = ("aligner", "phoneme_enc", "prompt_enc", "duration_pitch", "model")
    still = [n for n in params if n.split(".")[0] in groups
             and torch.equal(params[n], start_params[n])]
    if still:
        raise AssertionError(f"parameters did not move under AMP: {still}")
    trainer.save("amp")
    _check_f32_state("29", trainer, str(work / "cond_amp" / "model-amp.ckpt"))
    cross = 2 * DEPTH
    prompt = PROMPT_DEPTH + RESAMPLER_DEPTH
    per_step = _per_step(f32={"flash_forward": cross, "flash_backward": cross},
                         bf16={"flash_forward": prompt, "flash_backward": prompt, "rvq": 2},
                         mixed={"wavenet_body": 1})
    check_counts("29", f"{CT_STEPS} conditional AMP steps", counts,
                 _scaled_counts(per_step, CT_STEPS))
    batch = next(batches)
    ops.reset_launch_counts()
    trainer.train_step(batch)
    check_counts("29", f"one conditional AMP step (bf16: K6 on audio and prompt, K4 with dropout "
                       f"and K5 for the prompt encoder's {PROMPT_DEPTH} layers, K4 / K5 for the "
                       f"resampler's {RESAMPLER_DEPTH}; f32: K4 / K5 for the denoiser's "
                       f"{DEPTH} self- and {DEPTH} cross-attentions; mixed: K1)",
                 _amp_counts(ops), per_step)
    ops.reset_launch_counts()
    f32_trainer.train_step(batch)
    check_counts("29", "one conditional f32 step (as phase 18)", _amp_counts(ops),
                 {"f32": PER_COND_TRAIN_STEP,
                  **{k: dict.fromkeys(PER_STEP, 0) for k in ("bf16", "mixed")}})
    _steps_in_turns("29", f"README config 2 b{CT_BATCH} x {CT_SAMPLES / 24000:g} s",
                    {"f32": f32_trainer.train_step, "amp": trainer.train_step}, batch, steps=2)
    del f32_trainer
    torch.cuda.empty_cache()

    import numpy as np

    rng = np.random.RandomState(SEED + 293)
    long_batch = dict(batch, audio=rng.uniform(-1, 1, (CT_BATCH, AMP_FUSED_FRAMES * 320))
                      .astype(np.float32))
    ops.reset_launch_counts()
    metrics = trainer.train_step(long_batch)
    fused = _amp_counts(ops)
    check_counts("29", f"one conditional AMP step at {AMP_FUSED_FRAMES} frames (mixed K1, K2, "
                       "K2b, K3)", fused,
                 _per_step(f32={"flash_forward": DEPTH, "flash_backward": DEPTH},
                           bf16={"flash_forward": prompt, "flash_backward": prompt, "rvq": 2},
                           mixed={"wavenet_body": 1, "attn_block": DEPTH, "ff_block": DEPTH,
                                  "cross_attn_block": DEPTH}))
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"conditional AMP step at {AMP_FUSED_FRAMES} frames: {metrics}")
    return {"conditional_train_amp": counts, "conditional_train_amp_160": fused}


def _amp_grads(phase: str, label: str, run) -> None:
    """One AMP loss and its f32 master gradients on the card and on the CPU
    (``run(device, moved)`` → (losses, grads)), held against bf16's own
    noise floor: how far a result moves when the bf16 inputs move by one
    ulp on about half their entries (AMP_FLOOR_DRAWS draws: all but one on
    the card, one on the CPU; each side against its own unmoved result),
    the largest of the draws. Each loss within
    AMP_LOSS_RTOL relative, or AMP_FLOOR_FACTOR times its floor where that
    is higher; each gradient within AMP_GRAD_RTOL of its largest entry, or
    AMP_FLOOR_FACTOR times its floor; all gradients together (each tensor
    scaled by its largest entry) correlated at least AMP_GRAD_CORR."""
    import torch

    (loss_card, grads_card), (loss_cpu, grads_cpu) = run("cuda", 0), run("cpu", 0)
    floors = [(run("cuda", i), (loss_card, grads_card)) for i in range(1, AMP_FLOOR_DRAWS)]
    floors.append((run("cpu", 1), (loss_cpu, grads_cpu)))
    if set(grads_card) != set(grads_cpu):
        raise AssertionError(f"{label}: card and CPU differ in which parameters have gradients")

    def rel_err(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    for key, value in loss_cpu.items():
        rel = rel_err(loss_card[key], value)
        floor = max(rel_err(m[0][key], base[0][key]) for m, base in floors)
        tol = max(AMP_LOSS_RTOL, AMP_FLOOR_FACTOR * floor)
        log(phase, f"{label} {key}: card {loss_card[key]:.6f}, CPU {value:.6f}, rel err {rel:.3e} "
                   f"(floor {floor:.3e}; tolerance {tol:.3e})")
        if rel > tol:
            raise AssertionError(f"{label} {key} card vs CPU rel err {rel:.3e}")

    def grad_err(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()

    bad, over, ratio = [], [], (0.0, "")
    scaled = []
    for name, g_cpu in grads_cpu.items():
        g = grads_card[name]
        err = grad_err(g, g_cpu)
        floor = max(grad_err(m[1][name], base[1][name]) for m, base in floors)
        tol = max(AMP_GRAD_RTOL, AMP_FLOOR_FACTOR * floor)
        if err > AMP_GRAD_RTOL:
            over.append(name)
        if err / tol > ratio[0]:
            ratio = (err / tol, f"{name} ({err:.3e}, floor {floor:.3e})")
        if err > tol:
            bad.append((name, err, floor))
        peak = g_cpu.abs().max().clamp(min=1e-30)
        scaled.append((g.flatten() / peak, g_cpu.flatten() / peak))
    corr = _correlation(torch.cat([a for a, _ in scaled]), torch.cat([b for _, b in scaled]))
    groups = sorted({n.split(".")[0] for n in over})
    log(phase, f"{label}: {len(grads_cpu)} f32 master gradients, card vs CPU, each relative to its "
               f"largest entry: {len(grads_cpu) - len(over)} within {AMP_GRAD_RTOL:g}, "
               f"{len(over)} past it (groups {groups}) within {AMP_FLOOR_FACTOR:g} x their floor; "
               f"the largest error against its tolerance {ratio[0]:.3f} at {ratio[1]}; all "
               f"together correlated {corr:.6f} (>= {AMP_GRAD_CORR:g})")
    if bad or corr < AMP_GRAD_CORR:
        raise AssertionError(f"{label}: gradients card vs CPU: {bad[:5]}, correlation {corr:.6f}")


def phase30_amp_card_vs_cpu() -> None:
    """One AMP loss and its f32 master gradients, card against CPU: the
    flagship at b2 x 0.4 s (as phase 8) and the conditional model at b2,
    eval mode, with the card's mel and pitch passed to both (as phase 19)."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch.ops.mel import audio_to_mel
    from naturalspeech2_tpu_torch.ops.pitch import compute_pitch

    def amp_run(models, args, keys):
        """run(device, moved): the AMP losses and f32 master gradients of
        the model on ``device`` (`Trainer.losses`, the batch's floats in
        bf16 but the times); ``moved`` (a draw's number, 0 for none) moves
        each of ``args[keys]`` by one bf16 ulp on about half its entries
        first (2^-9 relative, then rounded)."""
        trainers = {device: ns2pkg.Trainer(model, batches=iter([]), amp=True,
                                           results_folder=tempfile.mkdtemp())
                    for device, model in models.items()}

        def run(device, moved):
            trainer = trainers[device]
            trainer.ns2.zero_grad(set_to_none=True)
            x = dict(args)
            for i, key in enumerate(keys if moved else ()):
                draw = torch.Generator().manual_seed(SEED + 30 + 10 * moved + i)
                sign = torch.randint(0, 2, x[key].shape, generator=draw)
                x[key] = x[key] * (1 + 2.0**-9 * (2 * sign - 1))
            x = {k: tuple(t.to(device) for t in v) if isinstance(v, tuple)
                 else (v.to(torch.bfloat16) if v.is_floating_point() and k != "times" else v)
                 .to(device) for k, v in x.items()}
            audio = x.pop("audio")
            losses = trainer.losses(audio, x, {k: x.pop(k) for k in ("times", "noise")})
            losses["loss"].backward()
            return ({k: v.item() for k, v in losses.items()},
                    {n: p.grad.cpu() for n, p in trainer.ns2.named_parameters()
                     if p.grad is not None})

        return run

    ns2_cpu = flagship(SEED + 300)
    models = {"cuda": copy.deepcopy(ns2_cpu).cuda(), "cpu": ns2_cpu}
    g = torch.Generator().manual_seed(SEED + 8)
    samples = int(0.4 * 24000)
    args = {"audio": torch.tanh(torch.randn(2, samples, generator=g)),
            "times": torch.rand(2, generator=g),
            "noise": torch.randn(2, samples // 320, DIM, generator=g)}
    _amp_grads("30", "flagship b2 x 0.4 s", amp_run(models, args, ("audio",)))
    del models, ns2_cpu

    cond_cpu = flagship(SEED + 301, conditional=True, scan_layers=True).eval()
    models = {"cuda": copy.deepcopy(cond_cpu).cuda().eval(), "cpu": cond_cpu}
    inputs = _cond_check_inputs()
    audio = inputs["audio"].cuda()
    inputs["mel"] = audio_to_mel(audio, n_mels=80, sample_rate=24000, hop_length=160).cpu()
    inputs["pitch"] = compute_pitch(audio, sample_rate=24000, hop_length=160)[:, None].cpu()
    _amp_grads("30", "README config 2 b2", amp_run(models, inputs,
                                                   ("audio", "prompt", "mel", "pitch")))


# ---------------------------------------------------------------------------
# Few-step sampling, self-conditioning, distillation and K1b's bf16_matmul
# (phases 31-35)
# ---------------------------------------------------------------------------


def check_bf16mm_core(phase: str, label: str, fn, launches: int) -> None:
    """A profile of one `bf16_matmul` call: ``launches`` launches of the bf16
    core's kernel, the blocks' writing one plane (`WaveGateSplit<1, ...>`),
    one rounding pre-pass of x, none of the split-TF32 core's (the wrapper's
    own padding and slicing at a d off 64 are other kernels, logged)."""
    counts = profile_counts(fn)
    core = sum(c for k, c in counts.items() if "ns2::bgemm::bf16_gemm_kernel" in k)
    rounds = sum(c for k, c in counts.items() if "round_bf16_kernel" in k)
    gates = [k for k in counts if "WaveGateSplit<1" in k]
    old = [k for k in counts if "ns2::gemm::gemm_kernel" in k]
    log(phase, f"{label} profile: {core} bf16 core launches, {rounds} rounding pre-pass; "
               f"{[(k[:110], c) for k, c in counts.items()]}")
    if old or core != launches or rounds != 1 or not gates:
        raise AssertionError(f"{label}: {core} bf16 core launches (expected {launches}), "
                             f"{rounds} pre-passes (1), one-plane gates {gates}, split-TF32 {old}")


def phase31_bf16_matmul() -> dict:
    """K1b with ``bf16_matmul`` against its plain version at
    BF16MM_SHAPES: within BF16_TOL of the plain output's largest entry and
    correlated at least BF16MM_CORR, the f32 K1b's difference from it
    printed (the rounding is real), each call's launches exact, its time
    beside the f32 K1b's and the plain version's with its bound at the
    dense bf16 peak, and a profile of its device launches (the bf16 core's
    S·L / LANE_GROUP + L and the pre-pass, ``check_bf16mm_core``); then the
    probe's 20-body chain at b16 x n1024 x d512 with exact launch counts.
    Returns the kernels line's entry."""
    import torch

    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.examples import wavenet_d512_probe as probe
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 310)
    entry = {"name": "wavenet_body_lanes", "dtype": "bf16_matmul", "route": "cuda",
             "source": "naturalspeech2_tpu_torch/csrc/wavenet_lane.cu",
             "replaces": "naturalspeech2_tpu/ops/wavenet_kernel.py:167",
             "option": "bf16_matmul (wavenet_kernel.py:172, :208-217)", "library_ms": None,
             "max_abs_err": 0.0, "by_shape": {}}
    only_bf16mm = dict.fromkeys(PER_DENOISE, 0)
    for b, n, d in BF16MM_SHAPES:
        label = f"[{b},{n},{d}]"
        wn, _ = wavenet_inputs(gen, b, n, d)
        flops = 2 * b * n * (4 * d * d * WAVENET_STACKS * WAVENET_LAYERS + d * d * WAVENET_LAYERS)
        work = bound_bf16(flops, nbytes(*wn) + b * n * d * 4)
        kernel = lambda: wk.wavenet_body_lanes(*wn, bf16_matmul=True)  # noqa: E731
        plain = lambda: wk.wavenet_body_lanes_bf16mm_torch(*wn)  # noqa: E731
        f32_kernel = lambda: wk.wavenet_body_lanes(*wn)  # noqa: E731
        with torch.no_grad():
            ops.reset_launch_counts()
            out = kernel()
            torch.cuda.synchronize()
            check_counts("31", f"one bf16_matmul call at {label} (K1b's bf16mm entry point)",
                         {"f32": ops.launch_counts(), "bf16_matmul":
                          ops.launch_counts("bf16_matmul")},
                         {"f32": only_bf16mm, "bf16_matmul": {**only_bf16mm,
                                                              "wavenet_body_lanes": 1}})
            if out.dtype != torch.float32:
                raise AssertionError(f"bf16_matmul {label}: output {out.dtype}, expected float32")
            ref = plain()
            err = compare("31", f"wavenet_body_lanes bf16_matmul {label}", out, ref, BF16_TOL,
                          relative=True)
            corr = _correlation(out, ref)
            f32_diff = ((f32_kernel() - ref).abs().max() / ref.abs().max()).item()
            log("31", f"{label}: correlation with the plain version {corr:.7f} (at least "
                      f"{BF16MM_CORR}); the f32 K1b differs from the plain bf16_matmul version by "
                      f"{f32_diff:.3e} of its largest entry (the bf16 rounding), the kernel by "
                      f"{err / ref.abs().max().item():.3e}")
            if corr < BF16MM_CORR:
                raise AssertionError(f"bf16_matmul {label}: correlation {corr:.7f}")
            del out, ref
            reps = 10 if b * n * d > 2**24 else 20
            ms, f32_ms, plain_ms = (cuda_ms(f, reps=reps) for f in (kernel, f32_kernel, plain))
        log("31", f"wavenet_body_lanes bf16_matmul {label}: kernel {ms:.4f} ms, f32 K1b "
                  f"{f32_ms:.4f} ms, plain {plain_ms:.4f} ms (median of {reps}), bound "
                  f"{work['bound_ms']:.4f} ms ({work['bound_by']})")
        check_bf16mm_core("31", f"bf16_matmul {label}", kernel,
                          WAVENET_STACKS * -(-WAVENET_LAYERS // wk.LANE_GROUP) + WAVENET_LAYERS)
        timing = {"max_abs_err": err, "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
                  "correlation": corr, "f32_rel_diff": f32_diff, **work}
        entry["by_shape"][label] = timing
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if (b, n, d) == BF16MM_SHAPES[0]:
            entry.update({k: timing[k] for k in ("ms", "f32_ms", "plain_ms", "bound_ms",
                                                 "bound_by")})
        del wn

    ops.reset_launch_counts()
    result = probe.run("cuda")
    counts = ops.launch_counts("bf16_matmul")["wavenet_body_lanes"]
    f32_counts = ops.launch_counts()["wavenet_body_lanes"]
    # each bench: one untimed chain and three timed ones of ITERS bodies;
    # then one bf16_matmul body for the difference
    expect = (4 * probe.ITERS + 1, 4 * probe.ITERS)
    log("31", f"probe (b{probe.B} x n{probe.N} x d{probe.D}, {probe.S} x {probe.L}, "
              f"{probe.ITERS}-body chains): plain {result['plain_ms']:.3f} ms, bf16_matmul "
              f"{result['bf16_matmul_ms']:.3f} ms, f32 K1b {result['f32_ms']:.3f} ms per body; "
              f"bf16_matmul vs plain body max rel diff {result['max_rel_diff']:.3e}; launches "
              f"bf16_matmul {counts}, f32 K1b {f32_counts}, expected {expect}")
    if (counts, f32_counts) != expect:
        raise AssertionError(f"probe launches {(counts, f32_counts)} != {expect}")
    if not result["max_rel_diff"] <= BF16_TOL:
        raise AssertionError(f"probe: bf16_matmul vs plain {result['max_rel_diff']:.3e}")
    entry["by_shape"]["probe chain [16,1024,512]"] = {
        k: result[k] for k in ("plain_ms", "bf16_matmul_ms", "f32_ms", "max_rel_diff")}
    entry["launches"] = counts
    entry["launches_by_path"] = {"wavenet_d512_probe": counts}
    return entry


def few_step_counts(steps: int) -> dict:
    """Launches of ``steps`` flagship denoise steps (K1, 6 x K2, 6 x K3)."""
    return denoise_counts(PER_DENOISE, steps)


def phase32_few_step(ns2, ns2_cpu) -> dict:
    """Few-step sampling of the flagship at b4 x n1024 from one starting
    noise: DDIM at FEW_REF_STEPS is the reference trajectory; DDIM and DPM++
    at FEW_STEPS, each with its latent MSE against it, ms per step and
    exact launch counts (DPM++ below DDIM at 8 and 16 steps); `sample()`
    with DDPM at DDPM_STEPS from step noise and with DPM++ at DPMPP_STEPS,
    each with codec decode; a self-conditioned flagship (`to_self_cond`
    jittered off zero) with DPM++ at DPMPP_STEPS; DPM++ and DDPM (and the
    self-conditioned DPM++) at FEW_CHECK_STEPS x FEW_CHECK_FRAMES card
    against CPU within PATH_TOL. Returns the launches of its runs."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.models.naturalspeech2 import _eval_mode

    gen = torch.Generator(device="cuda").manual_seed(SEED + 320)
    shape = (BATCH, LENGTH, DIM)
    noise = torch.randn(shape, generator=gen, device="cuda")
    cfg = dict(gamma_schedule=ns2.gamma_schedule, objective=ns2.objective, noise=noise)
    total = dict.fromkeys(PER_DENOISE, 0)

    def run(fn, steps):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        with _eval_mode(ns2):
            out = fn(ns2.model, shape, timesteps=steps, **cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = ops.launch_counts()
        check_counts("32", f"{fn.__name__} {steps} steps", counts, few_step_counts(steps))
        for k, v in counts.items():
            total[k] += v
        if not torch.isfinite(out).all():
            raise AssertionError(f"{fn.__name__} {steps} steps: non-finite latents")
        return out, wall

    ref, wall = run(ns2pkg.ddim_sample, FEW_REF_STEPS)
    log("32", f"reference: DDIM {FEW_REF_STEPS} steps at b{BATCH} x n{LENGTH}, wall {wall:.3f} s "
              f"({wall / FEW_REF_STEPS * 1e3:.3f} ms per step, host clock, synchronised)")
    mse = {}
    for steps in FEW_STEPS:
        for fn in (ns2pkg.ddim_sample, ns2pkg.dpmpp_sample):
            out, wall = run(fn, steps)
            mse[(fn.__name__, steps)] = ((out - ref) ** 2).mean().item()
            log("32", f"{fn.__name__} {steps} steps: latent MSE against DDIM at {FEW_REF_STEPS} "
                      f"{mse[(fn.__name__, steps)]:.4e}, {wall / steps * 1e3:.3f} ms per step "
                      f"(wall {wall:.3f} s)")
    for steps in (8, 16):
        if not mse[("dpmpp_sample", steps)] < mse[("ddim_sample", steps)]:
            raise AssertionError(f"DPM++ at {steps} steps is not closer to the reference than "
                                 f"DDIM: {mse[('dpmpp_sample', steps)]:.4e} vs "
                                 f"{mse[('ddim_sample', steps)]:.4e}")

    def sampler_copy(model, name):
        clone = copy.copy(model)
        clone.sampler = name
        return clone

    step_noise = torch.randn((DDPM_STEPS, *shape), generator=gen, device="cuda")
    sc_cpu = flagship(SEED + 321, self_cond=True)
    if not sc_cpu.model.to_self_cond.weight.any():
        raise AssertionError("to_self_cond is still zero")
    sc = copy.deepcopy(sc_cpu).cuda()
    runs = (("DDPM", sampler_copy(ns2, "ddpm"), DDPM_STEPS, {"step_noise": step_noise}),
            ("DPM++", sampler_copy(ns2, "dpmpp"), DPMPP_STEPS, {}),
            ("self-conditioned DPM++", sampler_copy(sc, "dpmpp"), DPMPP_STEPS, {}))
    for label, model, steps, extra in runs:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        audio = ns2pkg.sample(model, batch_size=BATCH, length=LENGTH, timesteps=steps,
                              noise=noise, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = ops.launch_counts()
        check_counts("32", f"sample() {label} {steps} steps", counts, few_step_counts(steps))
        for k, v in counts.items():
            total[k] += v
        if tuple(audio.shape) != (BATCH, LENGTH * 320) or not torch.isfinite(audio).all():
            raise AssertionError(f"sample() {label}: waveform {tuple(audio.shape)}")
        log("32", f"sample() {label} {steps} steps: waveform {tuple(audio.shape)} finite, |audio| "
                  f"max {audio.abs().max().item():.4f}, wall {wall:.3f} s incl. codec decode")
        del audio

    g = torch.Generator().manual_seed(SEED + 322)
    small = (2, FEW_CHECK_FRAMES, DIM)
    start_noise = torch.randn(small, generator=g)
    small_steps = torch.randn((FEW_CHECK_STEPS, *small), generator=g)
    for label, card, host, name in (("DPM++", ns2, ns2_cpu, "dpmpp"),
                                    ("DDPM", ns2, ns2_cpu, "ddpm"),
                                    ("self-conditioned DPM++", sc, sc_cpu, "dpmpp")):
        outs = []
        for model, device in ((card, "cuda"), (host, "cpu")):
            extra = {"step_noise": small_steps.to(device)} if name == "ddpm" else {}
            outs.append(ns2pkg.sample(sampler_copy(model, name), batch_size=2,
                                      length=FEW_CHECK_FRAMES, timesteps=FEW_CHECK_STEPS,
                                      noise=start_noise.to(device), **extra))
        compare("32", f"{label} {FEW_CHECK_STEPS} steps x {FEW_CHECK_FRAMES} frames, card vs CPU",
                *outs, PATH_TOL)
    del sc, sc_cpu
    return total


def cond_sample_counts(steps: int) -> dict:
    """Launches of one conditional sample of ``steps`` guided steps (as
    PER_COND_SAMPLE for STEPS)."""
    return {**{k: steps * v // STEPS for k, v in PER_COND_SAMPLE.items()},
            "flash_forward": PROMPT_DEPTH + RESAMPLER_DEPTH * steps, "rvq": 1}


def phase33_few_step_serving(engine, config: str, checkpoint: str, work: Path) -> dict:
    """README config 2 served by DPM++ at FEW_SERVE_STEPS (a config with
    ``ns2.sampler = "dpmpp"`` through `cli.build_engine`) beside phase 20's
    DDIM engine at STEPS, in turns (DDIM, DPM++, DPM++, DDIM), each
    FEW_SERVE_REQUESTS sequential requests in all, every request's launches
    exact; p50 / p95 and the ratio of the p50s. Returns the DPM++
    requests' launch counts."""
    import numpy as np

    from naturalspeech2_tpu_torch import cli, ops

    cfg = json.loads(Path(config).read_text())
    cfg["ns2"]["sampler"] = "dpmpp"
    dpm_config = work / "serve_dpmpp.json"
    dpm_config.write_text(json.dumps(cfg))
    dpm = cli.build_engine(str(dpm_config), checkpoint, timesteps=FEW_SERVE_STEPS,
                           cond_scale=SERVE_COND_SCALE, device="cuda",
                           prompt_samples=PROMPT_SAMPLES)
    if dpm.ns2.sampler_name != "dpmpp" or engine.ns2.sampler_name != "ddim":
        raise AssertionError(f"samplers {dpm.ns2.sampler_name}, {engine.ns2.sampler_name}")
    dpm.warmup([SERVE_BUCKET])
    prompt = _serving_prompt()
    samples = engine._prepare(SERVE_SENTENCE, prompt, SERVE_SECONDS, 0).frames * 320
    engines = {"ddim": (engine, STEPS), "dpmpp": (dpm, FEW_SERVE_STEPS)}
    walls = {k: [] for k in engines}
    totals = {k: dict.fromkeys(PER_COND_SAMPLE, 0) for k in engines}
    for name in ("ddim", "dpmpp", "dpmpp", "ddim"):
        eng, steps = engines[name]
        expect = cond_sample_counts(steps)
        for i in range(FEW_SERVE_REQUESTS // 2):
            ops.reset_launch_counts()
            start = time.perf_counter()
            wav, _ = eng.tts(SERVE_SENTENCE, prompt, seconds=SERVE_SECONDS, seed=i)
            walls[name].append(time.perf_counter() - start)
            _check_wave(f"{name} request {i}", wav, samples)
            counts = ops.launch_counts()
            if i == 0 or counts != expect:
                check_counts("33", f"{name} request at {steps} steps", counts, expect)
            for k, v in counts.items():
                totals[name][k] += v
    p50 = {k: float(np.percentile(np.asarray(w) * 1e3, 50)) for k, w in walls.items()}
    for name, (_, steps) in engines.items():
        log("33", f"{name} at {steps} steps, {len(walls[name])} sequential requests in two turns: "
                  f"{_percentiles(walls[name])}")
    log("33", f"served p50 DPM++ at {FEW_SERVE_STEPS} steps / DDIM at {STEPS} steps: "
              f"{p50['dpmpp'] / p50['ddim']:.3f} ({p50['dpmpp']:.1f} / {p50['ddim']:.1f} ms)")
    del dpm
    return totals["dpmpp"]


def phase34_self_cond_train_and_distill(work: Path) -> dict:
    """The self-conditioned flagship `Trainer` (b16 x 2 s, synthetic WAVs)
    for SC_TRAIN_STEPS steps: finite losses, `to_self_cond` moved, exact
    launches per step (the bootstrap forward adds K1 and the unfused
    attentions' K4); then `ProgressiveDistiller.distill_round` at
    b DISTILL_BATCH x n LENGTH, DISTILL_STUDENT_STEPS student steps,
    DISTILL_UPDATES updates, with exact launch counts, and ms per update.
    Returns the launch counts by path."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    folder = work / "sc_wavs"
    folder.mkdir(exist_ok=True)
    _write_wavs(folder)
    ns2 = flagship(SEED + 340, self_cond=True).cuda()
    trainer = ns2pkg.Trainer(ns2, folder=str(folder), train_batch_size=TRAIN_BATCH,
                             data_max_length_seconds=TRAIN_SECONDS, train_num_steps=SC_TRAIN_STEPS,
                             save_and_sample_every=10**9, results_folder=str(work / "sc_results"))
    before = ns2.model.to_self_cond.weight.detach().clone()
    per_step = {**dict.fromkeys(PER_STEP, 0), "wavenet_body": 2, "flash_forward": 2 * DEPTH,
                "flash_backward": DEPTH, "rvq": 1}
    sc_counts = dict.fromkeys(PER_STEP, 0)
    for step in range(SC_TRAIN_STEPS):
        batch = next(trainer.batches)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        metrics = trainer.train_step(batch)
        wall = time.perf_counter() - start
        counts = ops.launch_counts()
        check_counts("34", f"self-conditioned step {step + 1}", counts, per_step)
        for k, v in counts.items():
            sc_counts[k] += v
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"self-conditioned step {step + 1}: {metrics}")
        log("34", f"self-conditioned Trainer step {step + 1} (b{TRAIN_BATCH} x "
                  f"{TRAIN_SECONDS:g} s): loss {metrics['loss']:.4f}, {wall * 1e3:.1f} ms")
    moved = (ns2.model.to_self_cond.weight - before).abs().max().item()
    if moved == 0.0:
        raise AssertionError("to_self_cond did not move")
    log("34", f"to_self_cond moved by up to {moved:.3e}")
    del trainer, ns2
    torch.cuda.empty_cache()

    teacher = flagship(SEED + 341, codec=False).cuda()
    distiller = ns2pkg.ProgressiveDistiller(teacher, lr=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 342)
    batches = iter([torch.randn(DISTILL_BATCH, LENGTH, DIM, generator=gen, device="cuda")
                    for _ in range(2 * DISTILL_UPDATES)])
    per_update = {**dict.fromkeys(PER_STEP, 0), "wavenet_body": 3, "attn_block": 3 * DEPTH,
                  "ff_block": 3 * DEPTH, "flash_forward": DEPTH, "flash_backward": DEPTH}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    student = distiller.distill_round(batches, num_student_steps=DISTILL_STUDENT_STEPS,
                                      n_updates=DISTILL_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    check_counts("34", f"distill_round, {DISTILL_UPDATES} updates (per update: the teacher's two "
                       "forwards and the student's, K2's backward on K4 and K5)",
                 ops.launch_counts(), {k: DISTILL_UPDATES * v for k, v in per_update.items()})
    if not math.isfinite(distiller.last_loss):
        raise AssertionError(f"distillation loss {distiller.last_loss}")
    distiller.teacher = teacher.model  # the timed updates go on against the first teacher
    optimizer = torch.optim.Adam(student.parameters(), lr=1e-4)
    torch.cuda.synchronize()
    begin = time.perf_counter()
    for _ in range(DISTILL_UPDATES):
        distiller.update(student, optimizer, next(batches),
                         num_student_steps=DISTILL_STUDENT_STEPS, generator=gen)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - begin) / DISTILL_UPDATES * 1e3
    log("34", f"distill_round b{DISTILL_BATCH} x n{LENGTH}, {DISTILL_STUDENT_STEPS} student steps, "
              f"{DISTILL_UPDATES} updates: last loss {distiller.last_loss:.5f}, wall {wall:.3f} s "
              f"with the student's copy; then {update_ms:.3f} ms per update (mean of "
              f"{DISTILL_UPDATES}, host clock, synchronised)")
    return {"self_cond_train": sc_counts, "distill": ops.launch_counts()}


def _grads_card_vs_cpu(phase: str, label: str, results) -> None:
    """A loss and its gradients [(loss, {name: grad}) on the card, on the
    CPU]: the loss within GRAD_RTOL relative, each gradient within
    GRAD_RTOL of its largest entry."""
    (loss_card, grads_card), (loss_cpu, grads_cpu) = results
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(phase, f"{label}: card {loss_card:.7f}, CPU {loss_cpu:.7f}, rel err {rel:.3e} "
               f"(tolerance {GRAD_RTOL:g})")
    if rel > GRAD_RTOL:
        raise AssertionError(f"{label}: loss card vs CPU rel err {rel:.3e}")
    if set(grads_card) != set(grads_cpu) or not grads_cpu:
        raise AssertionError(f"{label}: card and CPU differ in which parameters have gradients")
    worst, worst_name = 0.0, ""
    for name, g_cpu in grads_cpu.items():
        err = ((grads_card[name] - g_cpu).abs().max() / g_cpu.abs().max().clamp(min=1e-30)).item()
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    log(phase, f"{label}: {len(grads_cpu)} parameter gradients, card vs CPU: max err relative to "
               f"each tensor's largest entry {worst:.3e} at {worst_name} (tolerance {GRAD_RTOL:g})")
    if not worst <= GRAD_RTOL:
        raise AssertionError(f"{label}: gradient card vs CPU {worst:.3e} at {worst_name}")


def phase35_card_vs_cpu() -> None:
    """Card against CPU within GRAD_RTOL: the self-conditioned flagship's loss
    and gradients at b2 x 0.4 s with injected times, noise and bootstrap
    rows (one row bootstrapped, one not); the distillation loss and the
    student's gradients at b2 x n DISTILL_CHECK_FRAMES with injected grid
    index and noise."""
    import torch

    from naturalspeech2_tpu_torch.distill import distillation_loss

    g = torch.Generator().manual_seed(SEED + 350)
    samples = int(0.4 * 24000)
    audio = torch.tanh(torch.randn(2, samples, generator=g))
    times = torch.rand(2, generator=g)
    noise = torch.randn(2, samples // 320, DIM, generator=g)
    mask = torch.tensor([True, False])
    sc_cpu = flagship(SEED + 351, self_cond=True)
    results = []
    for model, device in ((copy.deepcopy(sc_cpu).cuda(), "cuda"), (sc_cpu, "cpu")):
        losses = model(audio.to(device), times=times.to(device), noise=noise.to(device),
                       self_cond_mask=mask.to(device))
        losses["loss"].backward()
        results.append((losses["loss"].item(), {n: p.grad.cpu() for n, p in
                                                model.named_parameters() if p.grad is not None}))
    if "model.to_self_cond.weight" not in results[1][1]:
        raise AssertionError("to_self_cond has no gradient")
    _grads_card_vs_cpu("35", "self-conditioned loss b2 x 0.4 s, rows [bootstrapped, not]",
                       results)

    student_ns2 = flagship(SEED + 352, codec=False)
    student_cpu = student_ns2.model
    teacher_cpu = flagship(SEED + 353, codec=False).model
    x = torch.randn(2, DISTILL_CHECK_FRAMES, DIM, generator=g)
    i = torch.tensor([1, DISTILL_STUDENT_STEPS])
    dnoise = torch.randn(x.shape, generator=g)
    results = []
    for device in ("cuda", "cpu"):
        student = copy.deepcopy(student_cpu).to(device)
        teacher = copy.deepcopy(teacher_cpu).to(device)
        loss = distillation_loss(student, teacher, x.to(device),
                                 num_student_steps=DISTILL_STUDENT_STEPS,
                                 gamma_schedule=student_ns2.gamma_schedule, i=i.to(device),
                                 noise=dnoise.to(device))
        loss.backward()
        results.append((loss.item(), {n: p.grad.cpu() for n, p in student.named_parameters()
                                      if p.grad is not None}))
    _grads_card_vs_cpu("35", f"distillation loss b2 x n{DISTILL_CHECK_FRAMES}, i = "
                             f"{i.tolist()} of {DISTILL_STUDENT_STEPS}", results)


def encodec_flagship(seed: int, **codec_kw):
    """The flagship denoiser on the 24-kHz Encodec() (or ``codec_kw``'s), on
    the CPU, seeded noise on every parameter (`flagship`'s)."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch.models.encodec import Encodec

    torch.manual_seed(seed)
    model = ns2pkg.Model(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD)
    ns2 = ns2pkg.NaturalSpeech2(model, Encodec(**codec_kw), timesteps=1000)
    return jitter_params(ns2, seed + 1)


def _seeded_audio(seed: int, *shape):
    import torch

    return torch.tanh(torch.randn(shape, generator=torch.Generator().manual_seed(seed))) * 0.5


def phase36_encodec_kernels(summary: list, codec) -> None:
    """K6 on the 24-kHz Encodec's latents (``codec`` on the card) against its
    plain version: b16 x 2 s (m 2400) and a 6.8-s prompt (m 510), against
    the codec's own codebooks (timings into the rvq entry of ``summary``)."""
    import torch

    entries = {e["name"]: e for e in summary}
    hop = codec.seq_len_multiple_of
    for b, frames, label in ((TRAIN_BATCH, int(TRAIN_SECONDS * 24000) // hop,
                              f"b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s"),
                             (1, ENC_PROMPT_FRAMES, "6.8-s prompt")):
        audio = _seeded_audio(SEED + 360 + b, b, frames * hop).cuda()
        with torch.no_grad():
            x = codec.encode_latents(audio).reshape(-1, codec.codebook_dim).contiguous()
            err, ms, plain_ms, work = _rvq_case(None, m=x.shape[0], phase="36", x=x,
                                                cb=codec.codebooks.detach())
        entries["rvq"]["by_shape"][f"m {x.shape[0]} (Encodec latents, {label})"] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **work}
        entries["rvq"]["max_abs_err"] = max(entries["rvq"]["max_abs_err"], err)


def phase37_encodec_ns2(ns2, ns2_cpu, work: Path) -> dict:
    """NaturalSpeech2 on the 24-kHz Encodec: encode, train, sample, decode,
    then card against CPU. Returns the launch counts of its paths."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    codec, hop = ns2.codec, ns2.codec.seq_len_multiple_of
    samples = int(TRAIN_SECONDS * 24000)
    audio = _seeded_audio(SEED + 370, TRAIN_BATCH, samples).cuda()
    counts = {}
    with torch.no_grad():
        ops.reset_launch_counts()
        latents, codes, _ = codec(audio, return_encoded=True)
        torch.cuda.synchronize()
        counts["encodec_encode"] = ops.launch_counts()
        encode_ms = cuda_ms(lambda: codec(audio, return_encoded=True), reps=10)
    expect = {k: int(k == "rvq") for k in PER_STEP}
    log("37", f"Encodec encode b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s: latents "
              f"{tuple(latents.shape)}, codes {tuple(codes.shape)}, {encode_ms:.3f} ms (median "
              f"of 10, CUDA events; encoder, LSTM on cuDNN, K6)")
    check_counts("37", "Encodec encode", counts["encodec_encode"], expect)

    batch = audio.cpu().numpy()
    trainer = ns2pkg.Trainer(ns2, batches=itertools.repeat(batch), train_batch_size=TRAIN_BATCH,
                             train_num_steps=ENC_TRAIN_STEPS, save_and_sample_every=10**9,
                             results_folder=str(work / "encodec_train"))
    ops.reset_launch_counts()
    trainer.train(log_every=1)
    torch.cuda.synchronize()
    counts["encodec_train"] = ops.launch_counts()
    rows = [json.loads(line) for line in
            (work / "encodec_train" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    if len(rows) != ENC_TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"Encodec training: losses {losses}")
    step_ms = statistics.median(r["step_time_s"] for r in rows[2:]) * 1e3
    expect = {k: ENC_TRAIN_STEPS * v for k, v in PER_STEP.items()}
    log("37", f"Trainer on Encodec b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s, {ENC_TRAIN_STEPS} "
              f"steps: losses {', '.join(f'{v:.4f}' for v in losses)}; {step_ms:.3f} ms per "
              f"optimizer step (median of steps 3-{ENC_TRAIN_STEPS}, host clock, synchronised)")
    check_counts("37", "Encodec training", counts["encodec_train"], expect)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 371)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    wave = ns2pkg.sample(ns2, batch_size=1, length=ENC_SAMPLE_FRAMES, timesteps=STEPS,
                         generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts["encodec_sample"] = ops.launch_counts()
    if tuple(wave.shape) != (1, ENC_SAMPLE_FRAMES * hop) or not torch.isfinite(wave).all():
        raise AssertionError(f"Encodec sample: shape {tuple(wave.shape)} or non-finite")
    expect = {k: STEPS * v for k, v in PER_DENOISE.items()}
    log("37", f"sample(length={ENC_SAMPLE_FRAMES}, timesteps={STEPS}) through Encodec decode: "
              f"waveform {tuple(wave.shape)} finite, wall {wall:.3f} s")
    check_counts("37", "Encodec sample", counts["encodec_sample"], expect)
    with torch.no_grad():
        x = torch.randn(1, ENC_PROMPT_FRAMES, DIM, generator=gen, device="cuda")
        decode_ms = cuda_ms(lambda: codec.decode(x), reps=10)
    log("37", f"Encodec decode of {ENC_PROMPT_FRAMES} frames ({ENC_PROMPT_FRAMES * hop / 24000:.2f}"
              f" s): {decode_ms:.3f} ms (median of 10, CUDA events)")

    # card against CPU, on a copy of the untrained weights
    card = copy.deepcopy(ns2_cpu).cuda()
    g = torch.Generator().manual_seed(SEED + 372)
    samples = int(0.4 * 24000)
    check = torch.tanh(torch.randn(2, samples, generator=g))
    with torch.no_grad():
        lat_card, codes_card, _ = card.codec(check.cuda(), return_encoded=True)
        lat_cpu, codes_cpu, _ = ns2_cpu.codec(check, return_encoded=True)
    compare("37", "Encodec latents b2 x 0.4 s, card vs CPU", lat_card, lat_cpu, PATH_TOL)
    codes_tie_tolerant("37", "Encodec codes, card vs CPU", lat_cpu.reshape(-1, DIM),
                       ns2_cpu.codec.codebooks, codes_card.reshape(-1, 8),
                       codes_cpu.reshape(-1, 8))
    times = torch.rand(2, generator=g)
    noise = torch.randn(2, samples // hop, DIM, generator=g)
    results = []
    for model, device in ((card, "cuda"), (ns2_cpu, "cpu")):
        losses = model(check.to(device), times=times.to(device), noise=noise.to(device))
        losses["loss"].backward()
        results.append((losses["loss"].item(), {n: p.grad.cpu() for n, p in
                                                model.named_parameters() if p.grad is not None}))
    _grads_card_vs_cpu("37", "loss on Encodec b2 x 0.4 s", results)
    short = dict(batch_size=1, length=50, timesteps=2)
    noise = torch.randn(1, 50, DIM, generator=g)
    compare("37", "sample 2 steps x 50 frames through Encodec decode, card vs CPU",
            ns2pkg.sample(card, noise=noise.cuda(), **short),
            ns2pkg.sample(ns2_cpu, noise=noise, **short), PATH_TOL)
    return counts


def _codec_trainer(codec, work: Path, **kw):
    from naturalspeech2_tpu_torch.codec_trainer import CodecTrainer

    return CodecTrainer(codec, batches=iter(()), adversarial_weight=1.0, results_folder=str(work),
                        **kw)


def _new_codec(kind: str, seed: int):
    """SoundStream() or Encodec() at their defaults, seeded, on the CPU."""
    import torch

    from naturalspeech2_tpu_torch.models.codec import SoundStream
    from naturalspeech2_tpu_torch.models.encodec import Encodec

    torch.manual_seed(seed)
    return jitter_params(SoundStream() if kind == "soundstream" else Encodec(), seed + 1)


def phase38_codec_train(work: Path) -> dict:
    """CodecTrainer on the card for both codecs; returns the launch counts
    of each codec's steps."""
    import torch

    from naturalspeech2_tpu_torch import ops

    counts = {}
    samples = int(CODEC_TRAIN_SECONDS * 24000)
    batches = [_seeded_audio(SEED + 380 + i, CODEC_TRAIN_BATCH, samples).numpy()
               for i in range(CODEC_TRAIN_STEPS + 1)]
    for kind in ("soundstream", "encodec"):
        codec = _new_codec(kind, SEED + 381).cuda()
        trainer = _codec_trainer(codec, work / kind)
        trainer.init_state()
        start = {n: p.detach().clone() for n, p in
                 [*codec.named_parameters(), *trainer.discriminator.named_parameters()]}
        walls, metrics = [], []
        ops.reset_launch_counts()
        for batch in batches[:CODEC_TRAIN_STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics.append(trainer.train_step(batch))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts[f"codec_train_{kind}"] = ops.launch_counts()
        if not all(math.isfinite(v) for m in metrics for v in m.values()):
            raise AssertionError(f"{kind} codec training: non-finite metrics {metrics}")
        # the logits convs' biases may not: their hinge gradient −P(real within
        # the margin) + P(fake within it) is 0 while every logit lies within ±1
        moved = dict([*codec.named_parameters(), *trainer.discriminator.named_parameters()])
        still = [n for n, p in moved.items()
                 if torch.equal(p, start[n]) and not n.endswith("convs.5.bias")]
        if still:
            raise AssertionError(f"{kind} codec training: parameters did not move: {still}")
        step_ms = statistics.median(walls[1:]) * 1e3
        expect = {k: CODEC_TRAIN_STEPS * int(k == "rvq") for k in PER_STEP}
        log("38", f"CodecTrainer({kind}) b{CODEC_TRAIN_BATCH} x {CODEC_TRAIN_SECONDS:g} s, "
                  f"adversarial: losses {', '.join(f'{m_['loss']:.4f}' for m_ in metrics)}, "
                  f"adv_d {metrics[-1]['adv_d']:.4f}, perplexity {metrics[-1]['perplexity']:.1f}; "
                  f"{step_ms:.3f} ms per step (median of steps 2-{CODEC_TRAIN_STEPS}, host clock, "
                  f"synchronised; first {walls[0] * 1e3:.1f})")
        check_counts("38", f"{kind} codec training", counts[f"codec_train_{kind}"], expect)

        path = trainer.save("smoke")
        fresh = _codec_trainer(_new_codec(kind, SEED + 382).cuda(), work / f"{kind}_fresh")
        fresh.load(path)
        pairs = [*zip(codec.state_dict().values(), fresh.codec.state_dict().values()),
                 *zip(trainer.discriminator.state_dict().values(),
                      fresh.discriminator.state_dict().values()),
                 (trainer.state.codebook_ema, fresh.state.codebook_ema),
                 (trainer.state.codebook_count, fresh.state.codebook_count)]
        for opt_a, opt_b in ((trainer.optimizer, fresh.optimizer),
                             (trainer.disc_optimizer, fresh.disc_optimizer)):
            for sa, sb in zip(opt_a.state.values(), opt_b.state.values()):
                pairs += [(sa[k].cpu(), sb[k].cpu()) for k in ("step", "exp_avg", "exp_avg_sq")]
        if (fresh.state.step, fresh.state.disc_updates) != (trainer.state.step,
                                                            trainer.state.disc_updates) \
                or not all(torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"{kind}: the loaded state differs from the saved one")
        # the next step of each: equal but for the card's atomics (index_add_
        # in the codebook statistics, cuDNN's weight gradients), which sum in
        # no fixed order
        nxt = batches[CODEC_TRAIN_STEPS]
        a, b = trainer.train_step(nxt), fresh.train_step(nxt)
        worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-6) for k in a)
        if set(a) != set(b) or worst > GRAD_RTOL:
            raise AssertionError(f"{kind}: the step after load: {b} against {a}")
        log("38", f"{kind}: save / load round trip: every tensor of the state equal bit for bit "
                  f"(codec, discriminator, both optimizers, codebook statistics); the next "
                  f"step's metrics within {worst:.2e} relative of the unbroken run's")
        del trainer, fresh, codec
        torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(SEED + 383)
    audio = torch.tanh(torch.randn(CODEC_CHECK_BATCH, int(CODEC_CHECK_SECONDS * 24000),
                                   generator=g)) * 0.5
    for kind in ("soundstream", "encodec"):
        cpu = _codec_trainer(_new_codec(kind, SEED + 384), work / f"{kind}_cpu", stft_weight=0.0)
        card = _codec_trainer(copy.deepcopy(cpu.codec).cuda(), work / f"{kind}_card",
                              stft_weight=0.0)
        card.discriminator.load_state_dict(cpu.discriminator.state_dict(), strict=True)
        pair, step_metrics = [], []
        for trainer in (card, cpu):
            trainer.init_state()
            device = trainer.device
            loss, metrics, _, _, _ = trainer._losses(audio.to(device), adv_on=True)
            params = dict(trainer.codec.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            pair.append((loss.item(), {n: gr.cpu() for n, gr in zip(params, grads)
                                       if gr is not None}))
            step_metrics.append(trainer.train_step(audio.numpy()))
        _grads_card_vs_cpu("38", f"{kind} codec loss b{CODEC_CHECK_BATCH} x "
                                 f"{CODEC_CHECK_SECONDS:g} s (STFT term off)", pair)
        for k in ("loss", "wav_l1", "stft", "commit", "adv_g", "feat", "adv_d"):
            (a, b) = (m[k] for m in step_metrics)
            if abs(a - b) > GRAD_RTOL * max(abs(b), 1e-6):
                raise AssertionError(f"{kind} codec step {k}: card {a} vs CPU {b}")
        log("38", f"{kind}: one train_step card vs CPU, losses within {GRAD_RTOL:g} relative: "
                  + ", ".join(f"{k} {m:.6f}" for k, m in step_metrics[1].items()))
    return counts


def phase39_encodec_48k() -> dict:
    """The 48-kHz knobs, chunked: card against CPU; returns the launch counts
    of the card's chunked encode and decode."""
    import torch

    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.models.encodec import Encodec

    torch.manual_seed(SEED + 390)
    cpu = jitter_params(Encodec(**ENC48), SEED + 391)
    card = copy.deepcopy(cpu).cuda()
    audio = _seeded_audio(SEED + 392, 1, 2, int(ENC48_SECONDS * 48000))
    with torch.no_grad():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes, scales, pad = card.encode_chunked(audio.cuda())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        wave = card.decode_chunked(codes, scales, pad)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = ops.launch_counts()
        frames = codes.shape[0]
        expect = {k: frames * int(k == "rvq") for k in PER_STEP}
        log("39", f"48-kHz stereo {ENC48_SECONDS:g} s in {frames} chunks of "
                  f"{card.chunk_length} at stride {card.chunk_stride} (last padded by {pad} "
                  f"frames): codes {tuple(codes.shape)}, audio {tuple(wave.shape)}; encode "
                  f"{(t1 - t0) * 1e3:.1f} ms, decode {(t2 - t1) * 1e3:.1f} ms (host clock, "
                  f"first call)")
        check_counts("39", "48-kHz chunked encode and decode", counts, expect)
        codes_cpu, scales_cpu, pad_cpu = cpu.encode_chunked(audio)
        if pad_cpu != pad or codes_cpu.shape != codes.shape:
            raise AssertionError(f"48 kHz: CPU frames {tuple(codes_cpu.shape)}, pad {pad_cpu}")
        for f in range(frames):
            compare("39", f"48-kHz chunk {f} scale, card vs CPU", scales[f], scales_cpu[f],
                    1e-5, relative=True)
            chunk = audio[..., f * card.chunk_stride: f * card.chunk_stride + card.chunk_length]
            lat = cpu.encode_latents(chunk / scales_cpu[f][:, :, None]).reshape(-1, cpu.codebook_dim)
            n = lat.shape[0]
            codes_tie_tolerant("39", f"48-kHz chunk {f} codes, card vs CPU", lat, cpu.codebooks,
                               codes[f, :, :n].reshape(-1, 8), codes_cpu[f, :, :n].reshape(-1, 8))
        compare("39", "48-kHz overlap-add decode of the card's codes, card vs CPU", wave,
                cpu.decode_chunked(codes.cpu(), [s.cpu() for s in scales], pad), PATH_TOL)
    return {"encodec_chunked_48k": counts}



# --------------------------------------------------------------------------- #
# The missing modules: the unfused WaveNet, the plain transformer, the native
# decoder and the trainers' dispatch options (phases 40-43)
# --------------------------------------------------------------------------- #


def phase40_unfused_wavenet() -> dict:
    """Model(use_fused_wavenet=False) at the flagship's widths: a 100-step
    DDIM sample at b4 x n1024 with exact launches (no K1; K2 and K3 in the
    transformer), its denoise step beside the fused flagship's in turns,
    and one forward card against CPU. Returns the sample's launch counts."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops

    ns2_cpu = flagship(SEED + 400, use_fused_wavenet=False)
    ns2 = copy.deepcopy(ns2_cpu).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 401)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    audio = ns2pkg.sample(ns2, batch_size=BATCH, length=LENGTH, timesteps=STEPS, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = ops.launch_counts()
    if tuple(audio.shape) != (BATCH, LENGTH * 320) or not torch.isfinite(audio).all():
        raise AssertionError(f"unfused sample: {tuple(audio.shape)}, finite "
                             f"{bool(torch.isfinite(audio).all())}")
    log("40", f"Model(use_fused_wavenet=False) sample(batch_size={BATCH}, length={LENGTH}, "
              f"timesteps={STEPS}): finite {tuple(audio.shape)}, wall {wall:.3f} s incl. codec "
              "decode")
    check_counts("40", f"{STEPS}-step unfused-WaveNet sample", counts,
                 {**{k: STEPS * v for k, v in PER_DENOISE.items()}, "wavenet_body": 0})

    fused = flagship(SEED + 400).cuda()
    with torch.no_grad():
        x = torch.randn(BATCH, LENGTH, DIM, generator=gen, device="cuda")
        times = torch.full((BATCH,), 0.5, device="cuda")
        turns = [("fused", fused), ("unfused", ns2), ("unfused", ns2), ("fused", fused)]
        step_ms = {"fused": [], "unfused": []}
        for label, model in turns:
            step_ms[label].append(cuda_ms(lambda: model.model(x, times), reps=10))
    log("40", f"denoise step at b{BATCH} x n{LENGTH}, CUDA events, median of 10, in turns "
              "fused, unfused, "
              f"unfused, fused: unfused {', '.join(f'{v:.3f}' for v in step_ms['unfused'])} ms; "
              f"fused (K1) {', '.join(f'{v:.3f}' for v in step_ms['fused'])} ms")
    del fused

    with torch.no_grad():
        x = torch.randn(BATCH, LENGTH, DIM, generator=torch.Generator().manual_seed(SEED + 402))
        times = torch.rand(BATCH, generator=torch.Generator().manual_seed(SEED + 403))
        compare("40", f"unfused-WaveNet denoiser b{BATCH} x n{LENGTH}, card vs CPU",
                ns2.model(x.cuda(), times.cuda()), ns2_cpu.model(x, times), PATH_TOL)
    return {"unfused_wavenet_sample": counts}


def phase41_plain_transformer() -> dict:
    """ConditionableTransformer(dim_cond_mult=None, ff_causal_conv=False) at
    the flagship's widths, b4 x n1024: the forward (K4 once a layer) and
    the backward (K5 once a layer) with exact launches, times, and the
    output and every gradient card against CPU. Returns the launch counts
    of one forward and backward."""
    import torch

    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.models.transformer import ConditionableTransformer

    torch.manual_seed(SEED + 410)
    ct_cpu = jitter_params(ConditionableTransformer(DIM, DEPTH, dim_head=DIM_HEAD, heads=HEADS,
                                                    dim_cond_mult=None, ff_causal_conv=False,
                                                    use_flash=True), SEED + 411)
    ct = copy.deepcopy(ct_cpu).cuda()
    x = torch.randn(BATCH, LENGTH, DIM, generator=torch.Generator().manual_seed(SEED + 412))
    zero = {k: 0 for k in ops.launch_counts()}
    results, outputs = [], []
    for module, device in ((ct, "cuda"), (ct_cpu, "cpu")):
        ops.reset_launch_counts()
        out = module(x.to(device))
        forward = ops.launch_counts()
        ops.reset_launch_counts()
        loss = out.square().mean()
        loss.backward()
        backward = ops.launch_counts()
        if device == "cuda":
            check_counts("41", "plain transformer forward", forward,
                         {**zero, "flash_forward": DEPTH})
            check_counts("41", "plain transformer backward", backward,
                         {**zero, "flash_backward": DEPTH})
            counts = {k: forward[k] + backward[k] for k in forward}
        outputs.append(out.detach())
        results.append((loss.item(), {n: p.grad.cpu() for n, p in module.named_parameters()}))
    compare("41", f"plain transformer b{BATCH} x n{LENGTH}, card vs CPU", outputs[0], outputs[1], PATH_TOL)
    _grads_card_vs_cpu("41", f"plain transformer mean(y²) b{BATCH} x n{LENGTH}", results)

    xc = x.cuda().requires_grad_()
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: ct(xc), reps=10)

    def fwd_bwd():
        ct(xc).square().mean().backward()

    both_ms = cuda_ms(fwd_bwd, reps=5)
    log("41", f"plain transformer (depth {DEPTH}, heads {HEADS} x {DIM_HEAD}) b{BATCH} x n{LENGTH}: "
              f"forward {fwd_ms:.3f} ms, forward + backward {both_ms:.3f} ms (CUDA events, "
              "medians of 10 and 5)")
    return {"plain_transformer": counts}


def flac_bytes(pcm, sr: int) -> bytes:
    """A one-frame FLAC stream holding ``pcm`` (16-bit mono, at most 65,535
    samples) in one verbatim subframe: the bytes tests/test_native_audioio.py's
    `encode_flac_verbatim` writes (STREAMINFO, a frame header with the
    24-kHz table rate and a 16-bit block size, the subframe header byte,
    the samples big-endian, a zero CRC-16), built with numpy."""
    import struct

    import numpy as np

    n = len(pcm)
    if not 0 < n <= 65535 or sr != 24000:
        raise ValueError(f"one verbatim frame at 24 kHz holds 1-65535 samples, got {n} at {sr}")
    info = bytearray(34)
    info[0:2] = struct.pack(">H", 16)
    info[2:4] = struct.pack(">H", max(n, 16))
    info[10:18] = ((sr << 44) | (15 << 36) | n).to_bytes(8, "big")
    header = bytes([0xFF, 0xF8, 0x77, 0x08, 0x00]) + struct.pack(">H", n - 1)
    crc = 0
    for byte in header:  # CRC-8, polynomial 0x07
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return (b"fLaC" + bytes([0x80, 0, 0, 34]) + bytes(info) + header + bytes([crc]) + b"\x02"
            + np.asarray(pcm, ">i2").tobytes() + b"\x00\x00")


def _write_flacs(folder: Path) -> list:
    """FLAC_FILES seeded tones (as `_write_wavs`) of FLAC_SECONDS as PCM16
    FLAC files; returns their PCM."""
    import numpy as np

    rng = np.random.default_rng(SEED + 420)
    t = np.arange(int(FLAC_SECONDS * 24000)) / 24000
    pcms = []
    for i in range(FLAC_FILES):
        f0 = rng.uniform(100.0, 400.0)
        phase = 2 * np.pi * f0 * t + 3.0 * np.sin(2 * np.pi * rng.uniform(2, 6) * t)
        audio = 0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase) + 0.05 * rng.standard_normal(t.size)
        pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
        (folder / f"clip{i:02d}.flac").write_bytes(flac_bytes(pcm, 24000))
        pcms.append(pcm)
    return pcms


def _rel_state_diff(a: dict, b: dict) -> tuple[float, str]:
    """The largest of max|a - b| / max|b| over the tensors of two states."""
    worst = (0.0, "")
    for name, y in b.items():
        err = ((a[name] - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()
        if not math.isfinite(err) or err > worst[0]:
            worst = (err, name)
    return worst


def phase42_flac_and_dispatch(work: Path) -> dict:
    """The native decoder and the trainers' options on the card: FLAC_FILES
    FLACs decoded exactly (PCM16 / 32768) and timed; the flagship Trainer on
    them at b16 x 2 s, DISPATCH_STEPS steps at steps_per_dispatch
    DISPATCH_K, then at 1 from the same seed with ``profile_steps``; the two
    states within GRAD_RTOL; one dispatch of DISPATCH_K steps against as
    many single steps in turns, with exact launches; a trace naming the
    port's kernels; CodecTrainer.train(CODEC_JIT_STEPS,
    steps_per_jit=CODEC_JIT_K); CodecTrainer(amp=True) card against CPU
    for both codecs. Returns launch counts by path."""
    import contextlib
    import io

    import numpy as np
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.data import load_audio
    from naturalspeech2_tpu_torch.native import audioio

    folder = work / "flacs"
    folder.mkdir()
    pcms = _write_flacs(folder)
    start = time.perf_counter()
    audioio.library()
    log("42", f"native decoder built or loaded in {time.perf_counter() - start:.2f} s (g++)")
    start = time.perf_counter()
    decoded = [load_audio(p) for p in sorted(folder.glob("*.flac"))]
    decode_s = time.perf_counter() - start
    for (audio, sr), pcm in zip(decoded, pcms):
        if sr != 24000 or not np.array_equal(audio, pcm.astype(np.float32) / 32768.0):
            raise AssertionError("a FLAC did not decode to its PCM16 / 32768")
    log("42", f"{FLAC_FILES} FLACs of {FLAC_SECONDS:g} s decoded exactly (PCM16 / 32768) in "
              f"{decode_s * 1e3:.1f} ms: {decode_s * 1e3 / (FLAC_FILES * FLAC_SECONDS):.3f} ms per "
              "second of audio (host clock, the card's host)")

    counts = {}
    kwargs = dict(folder=str(folder), train_batch_size=TRAIN_BATCH,
                  data_max_length_seconds=TRAIN_SECONDS, train_num_steps=DISPATCH_STEPS,
                  save_and_sample_every=10**9)
    trainers = {}
    for k in (DISPATCH_K, 1):
        trainer = ns2pkg.Trainer(flagship(SEED + 421).cuda(), steps_per_dispatch=k,
                                 results_folder=str(work / f"k{k}"), **kwargs)
        ops.reset_launch_counts()
        trainer.train(log_every=k, profile_steps=PROFILE_STEPS if k == 1 else None)
        torch.cuda.synchronize()
        counts[f"flac_train_k{k}"] = ops.launch_counts()
        check_counts("42", f"Trainer(steps_per_dispatch={k}) {DISPATCH_STEPS} steps on FLACs",
                     counts[f"flac_train_k{k}"], {n: DISPATCH_STEPS * v for n, v in PER_STEP.items()})
        trainers[k] = trainer
    rows = {k: [json.loads(line) for line in
                (t.results_folder / "metrics.jsonl").read_text().splitlines()]
            for k, t in trainers.items()}
    if [r["step"] for r in rows[DISPATCH_K]] != list(range(DISPATCH_K, DISPATCH_STEPS + 1,
                                                          DISPATCH_K)):
        raise AssertionError(f"dispatch metrics steps {[r['step'] for r in rows[DISPATCH_K]]}")
    for r in rows[DISPATCH_K]:
        mean = statistics.fmean(q["loss"] for q in rows[1]
                                if r["step"] - DISPATCH_K < q["step"] <= r["step"])
        if not abs(r["loss"] - mean) <= GRAD_RTOL * abs(mean):
            raise AssertionError(f"dispatch loss {r['loss']} at step {r['step']} vs mean {mean}")
    a, b = trainers[DISPATCH_K], trainers[1]
    params = _rel_state_diff(dict(a.ns2.named_parameters()), dict(b.ns2.named_parameters()))
    ema = _rel_state_diff(a.ema, b.ema)
    dispatch_losses = ", ".join(f"{r['loss']:.5f}" for r in rows[DISPATCH_K])
    log("42", f"K={DISPATCH_K} logs steps {[r['step'] for r in rows[DISPATCH_K]]} with the "
              f"dispatch's mean loss ({dispatch_losses}); "
              f"after {DISPATCH_STEPS} steps K={DISPATCH_K} against K=1: parameters within "
              f"{params[0]:.3e} ({params[1]}), EMA within {ema[0]:.3e} of each tensor's largest "
              f"entry (tolerance {GRAD_RTOL:g}: cuDNN and index_add_ sum in no fixed order)")
    if max(params[0], ema[0]) > GRAD_RTOL:
        raise AssertionError(f"K={DISPATCH_K} and K=1 states differ: {params}, {ema}")

    traces = sorted((b.results_folder / "profile").glob("*.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile_steps={PROFILE_STEPS} left {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    f32_kernels = [k for k in PORT_KERNELS if k not in BF16_CORE_KERNELS]
    missing = [k for k in f32_kernels
               if not any(all(part in name for part in k) for name in kernels)]
    log("42", f"profile_steps={PROFILE_STEPS}: {traces[0].name}, {len(events)} events, "
              f"{len(kernels)} kernel launches; the port's kernels named: "
              f"{[k[0] for k in f32_kernels if k not in missing]}")
    if missing:
        raise AssertionError(f"the trace does not name {missing}")

    batches = [next(a.batches) for _ in range(DISPATCH_K)]
    turns = {"dispatch": [], "single": []}
    for label in ("dispatch", "single", "single", "dispatch"):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        if label == "dispatch":
            a.train_chunk(batches)
        else:
            for batch in batches:
                b.train_step(batch)
        torch.cuda.synchronize()
        turns[label].append((time.perf_counter() - start) / DISPATCH_K * 1e3)
        if label == "dispatch" and "dispatch" not in counts:
            counts["dispatch"] = ops.launch_counts()
            check_counts("42", f"one dispatch of {DISPATCH_K} steps", counts["dispatch"],
                         {n: DISPATCH_K * v for n, v in PER_STEP.items()})
    log("42", f"ms per optimizer step at b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s (host clock, "
              f"synchronised), in turns dispatch, single, single, dispatch: steps_per_dispatch="
              f"{DISPATCH_K} {', '.join(f'{v:.2f}' for v in turns['dispatch'])}; one step a call "
              f"{', '.join(f'{v:.2f}' for v in turns['single'])}")
    del trainers, a, b
    torch.cuda.empty_cache()

    samples = int(CODEC_TRAIN_SECONDS * 24000)
    codec_batches = [_seeded_audio(SEED + 422 + i, CODEC_TRAIN_BATCH, samples).numpy()
                     for i in range(3)]
    trainer = _codec_trainer(_new_codec("soundstream", SEED + 425).cuda(), work / "codec_jit")
    trainer.batches = itertools.cycle(codec_batches)
    ops.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = trainer.train(CODEC_JIT_STEPS, log_every=CODEC_JIT_K, steps_per_jit=CODEC_JIT_K)
    counts["codec_train_jit"] = ops.launch_counts()
    logged = [line for line in out.getvalue().splitlines() if line.startswith("codec step")]
    log("42", f"CodecTrainer.train({CODEC_JIT_STEPS}, steps_per_jit={CODEC_JIT_K}): step "
              f"{state.step}; {logged}")
    # the JAX rule (step // k) % max(1, log_every // k) == 0 after the
    # chunks ending at 4 and 6
    if state.step != CODEC_JIT_STEPS or [int(x.split()[2].rstrip(":")) for x in logged] \
            != [CODEC_JIT_K, CODEC_JIT_STEPS]:
        raise AssertionError(f"codec chunks: step {state.step}, logged {logged}")
    check_counts("42", "codec chunks", counts["codec_train_jit"],
                 {n: CODEC_JIT_STEPS * int(n == "rvq") for n in PER_STEP})
    del trainer

    g = torch.Generator().manual_seed(SEED + 426)
    audio = torch.tanh(torch.randn(CODEC_CHECK_BATCH, int(CODEC_CHECK_SECONDS * 24000),
                                   generator=g)) * 0.5
    for kind in ("soundstream", "encodec"):
        cpu = _codec_trainer(_new_codec(kind, SEED + 427), work / f"{kind}_amp_cpu", amp=True,
                             stft_weight=0.0)
        card = _codec_trainer(copy.deepcopy(cpu.codec).cuda(), work / f"{kind}_amp_card",
                              amp=True, stft_weight=0.0)
        card.discriminator.load_state_dict(cpu.discriminator.state_dict(), strict=True)
        on = {"cuda": card, "cpu": cpu}
        for trainer in on.values():
            trainer.init_state()

        def run(device, moved, on=on):
            trainer = on[device]
            x = audio
            if moved:
                draw = torch.Generator().manual_seed(SEED + 428 + moved)
                sign = torch.randint(0, 2, x.shape, generator=draw)
                x = x * (1 + 2.0**-9 * (2 * sign - 1))
            loss, metrics, _, _, _ = trainer._losses(x.to(device), adv_on=True)
            params = dict(trainer.codec.named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            return ({k: v.item() for k, v in metrics.items()},
                    {n: gr.float().cpu() for n, gr in zip(params, grads) if gr is not None})

        _amp_grads("42", f"CodecTrainer(amp=True) {kind} b{CODEC_CHECK_BATCH} x "
                         f"{CODEC_CHECK_SECONDS:g} s (STFT term off)", run)
        ops.reset_launch_counts()
        steps = [card.train_step(audio.numpy()) for _ in range(2)]
        counts[f"codec_train_amp_{kind}"] = ops.launch_counts()
        masters = [*card.codec.parameters(), *card.discriminator.parameters()]
        if not all(math.isfinite(v) for m in steps for v in m.values()) or \
                any(p.dtype != torch.float32 for p in masters):
            raise AssertionError(f"{kind} AMP codec steps: {steps}")
        losses = ", ".join(f"{m['loss']:.4f}" for m in steps)
        log("42", f"{kind} CodecTrainer(amp=True): two steps on the card, losses {losses}, "
                  "f32 master parameters")
        del cpu, card, on
    return counts


def phase43_flac_prompt(engine) -> dict:
    """Phase 20's sentence at SERVE_SECONDS POSTed to /tts with a FLAC
    prompt (phase 20's prompt as PCM16 FLAC), FLAC_POSTS times: 200, a
    PCM16 WAV of the request's length, the wall time of each, and the
    launches of each request. Returns the launch counts."""
    import base64
    import io
    import threading
    import wave

    import numpy as np

    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.data import decode_audio_bytes
    from naturalspeech2_tpu_torch.serve import TTSServer

    pcm = (np.clip(_serving_prompt(), -1, 1) * 32767).astype(np.int16)
    flac = flac_bytes(pcm, 24000)
    decoded, sr = decode_audio_bytes(flac)
    if sr != 24000 or not np.array_equal(decoded, pcm.astype(np.float32) / 32768.0):
        raise AssertionError("the FLAC prompt did not decode to its PCM16 / 32768")
    samples = engine._prepare(SERVE_SENTENCE, decoded, SERVE_SECONDS, 0).frames * 320
    server = TTSServer(engine, ("127.0.0.1", 0))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    walls = []
    try:
        base = f"http://127.0.0.1:{server.port}"
        payload = {"text": SERVE_SENTENCE, "seconds": SERVE_SECONDS,
                   "prompt_wav_base64": base64.b64encode(flac).decode()}
        ops.reset_launch_counts()
        for _ in range(FLAC_POSTS):
            start = time.perf_counter()
            status, kind, body = _http(base, "/tts", payload)
            walls.append(time.perf_counter() - start)
            if status != 200:
                raise AssertionError(f"FLAC POST /tts: {status} {body[:200]!r}")
            with wave.open(io.BytesIO(body)) as w:
                if (kind, w.getframerate(), w.getsampwidth(), w.getnframes()) != (
                        "audio/wav", 24000, 2, samples):
                    raise AssertionError(f"FLAC POST /tts: {kind} {w.getnframes()} frames")
        counts = ops.launch_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    check_counts("43", f"{FLAC_POSTS} FLAC POST /tts", counts,
                 {k: FLAC_POSTS * v for k, v in PER_COND_SAMPLE.items()})
    log("43", f"POST /tts with a {len(flac)}-byte FLAC prompt ({len(pcm)} samples) x "
              f"{FLAC_POSTS}: 200 audio/wav, PCM16, {samples} samples at 24000 Hz; wall "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms")
    return {"serve_flac": counts}


def _dp_cond_model(seed: int):
    """README config 2 (as phase 18, scan_layers) with the conditioning
    stack's dropout off, seeded and jittered, on the CPU."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg

    torch.manual_seed(seed)
    model = ns2pkg.Model(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD,
                         dim_prompt=DIM_PROMPT, cond_drop_prob=0.25, condition_on_prompt=True,
                         scan_layers=True)
    ns2 = ns2pkg.NaturalSpeech2(model, ns2pkg.SoundStream(), timesteps=1000,
                                phoneme_enc_kwargs=dict(conv_dropout=0.0),
                                prompt_enc_kwargs=dict(dropout=0.0),
                                duration_pitch_kwargs=dict(dropout=0.0,
                                                           head_activation="softplus"))
    return jitter_params(ns2, seed + 1)


def _dp_cond_batch() -> dict:
    import numpy as np

    batch = next(_cond_train_batches(SEED + 442))
    batch["text_lens"] = np.asarray(DP_TEXT_LENS, np.int32)
    return batch


def _dp_snapshots(trainer, groups=None) -> list:
    """The (reduced) gradient of each parameter as the optimizer steps, on
    the CPU, gathered under FSDP (names starting with one of ``groups``)."""
    grads, step = [], trainer.optimizer.step

    def recording_step(*args, **kwargs):
        held = {n: p.grad.detach() for n, p in trainer.master.items()}
        grads.append({n: g.cpu().clone() for n, g in trainer.gather(held).items()
                      if groups is None or n.startswith(groups)})
        return step(*args, **kwargs)

    trainer.optimizer.step = recording_step
    return grads


def _dp_state(trainer, groups=None) -> dict:
    """Parameters, Adam's moments and the EMA, whole (gathered), on the CPU."""
    full = trainer.full_state()
    names = list(trainer.master)
    keep = lambda n: groups is None or n.startswith(groups)  # noqa: E731
    return {"params": {n: v.cpu() for n, v in full["params"].items() if keep(n)},
            "moments": {f"{names[i]}.{k}": v.cpu() for i, s in full["opt_state"]["state"].items()
                        for k, v in s.items() if k != "step" and keep(names[i])},
            "ema": {n: v.cpu() for n, v in full["ema_params"].items() if keep(n)}}


def _dp_timed_steps(trainer, batches: list) -> tuple:
    """(the metrics, the wall ms of each step, synchronised)."""
    import torch

    metrics, walls = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.append(trainer.train_step(batch))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return metrics, walls


def _dp_runs(phase: str, mesh, device, work: Path, label: str) -> dict:
    """Every phase-44 run on ``device`` (``mesh`` None: the plain trainers),
    each with exact launch counts; the states, gradients and metrics."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import ops
    from naturalspeech2_tpu_torch.codec_trainer import CodecTrainer

    samples = int(TRAIN_SECONDS * 24000)
    batches = [_seeded_audio(SEED + 443 + i, TRAIN_BATCH, samples).numpy()
               for i in range(DP_STEPS)]
    out = {"counts": {}, "ms": {}}
    shardings = ("plain",) if mesh is None else ("replicated", "fsdp")
    for sharding in shardings:
        ns2 = flagship(SEED + 440).to(device)
        kw = {} if mesh is None else dict(mesh=mesh, param_sharding=sharding)
        trainer = ns2pkg.Trainer(ns2, batches=iter(()), train_batch_size=TRAIN_BATCH,
                                 ema_update_every=1, save_and_sample_every=10**9,
                                 results_folder=str(work / f"{label}_{sharding}"), **kw)
        grads = _dp_snapshots(trainer)
        ops.reset_launch_counts()
        metrics, walls = _dp_timed_steps(trainer, batches)
        counts = ops.launch_counts()
        check_counts(phase, f"{label} {sharding}: {DP_STEPS} optimizer steps", counts,
                     {k: DP_STEPS * v for k, v in PER_STEP.items()})
        out[sharding] = {"state": _dp_state(trainer), "grads": grads, "metrics": metrics}
        out["counts"][sharding], out["ms"][sharding] = counts, walls
        del trainer, ns2
        torch.cuda.empty_cache()

    cond = _dp_cond_model(SEED + 441).to(device)
    kw = {} if mesh is None else dict(mesh=mesh)
    trainer = ns2pkg.Trainer(cond, batches=iter(()), train_batch_size=CT_BATCH,
                             save_and_sample_every=10**9, results_folder=str(work / f"{label}_c"),
                             **kw)
    grads = _dp_snapshots(trainer, DP_COND_GROUPS)
    ops.reset_launch_counts()
    metrics, walls = _dp_timed_steps(trainer, [_dp_cond_batch()])
    counts = ops.launch_counts()
    check_counts(phase, f"{label} conditional: one optimizer step", counts, PER_COND_TRAIN_STEP)
    params = {n: p.detach().cpu().clone() for n, p in trainer.full_state()["params"].items()
              if n.startswith(DP_COND_GROUPS)}
    out["conditional"] = {"grads": grads, "metrics": metrics, "params": params}
    out["counts"]["conditional"], out["ms"]["conditional"] = counts, walls
    del trainer, cond
    torch.cuda.empty_cache()

    codec = _new_codec("soundstream", SEED + 444).to(device)
    trainer = CodecTrainer(codec, batches=iter(()), adversarial_weight=1.0, stft_weight=0.0,
                           lr=DP_CODEC_LR, results_folder=str(work / f"{label}_codec"), **kw)
    grads, apply = [], trainer._apply

    def recording_apply(optimizer, params, step_grads, lr):
        # every step's (reduced) codec, then discriminator, gradients
        grads.append([g.detach().cpu().clone() for g in step_grads])
        return apply(optimizer, params, step_grads, lr)

    trainer._apply = recording_apply
    codec_batches = [_seeded_audio(SEED + 445 + i, CODEC_TRAIN_BATCH,
                                   int(CODEC_TRAIN_SECONDS * 24000)).numpy()
                     for i in range(DP_CODEC_STEPS)]
    # every step after the first starts from the plain run's state (its
    # checkpoint, which every rank loads), so Adam's sign flips from a
    # step's rounding do not carry into the next step's gradients
    ops.reset_launch_counts()
    metrics, walls = [], []
    for batch in codec_batches:
        if metrics:
            handoff = work.parent / f"codec_step{len(metrics)}.ckpt"
            if mesh is None:
                Path(trainer.save(len(metrics))).replace(handoff)
            trainer.load(handoff)
        step_metrics, step_walls = _dp_timed_steps(trainer, [batch])
        metrics += step_metrics
        walls += step_walls
    counts = ops.launch_counts()
    check_counts(phase, f"{label} CodecTrainer: {DP_CODEC_STEPS} steps", counts,
                 {k: DP_CODEC_STEPS * int(k == "rvq") for k in PER_STEP})
    if len(grads) != 2 * DP_CODEC_STEPS:
        raise AssertionError(f"{label} CodecTrainer: {len(grads)} updates in {DP_CODEC_STEPS} "
                             "adversarial steps")
    state = {"codebook_ema": trainer.state.codebook_ema.cpu(),
             "codebook_count": trainer.state.codebook_count.cpu()}
    by_step = [{f"{model}.{i}": g
                for model, update in zip(("codec", "disc"), grads[2 * k:2 * k + 2])
                for i, g in enumerate(update)} for k in range(DP_CODEC_STEPS)]
    out["codec"] = {"state": state, "metrics": metrics, "grads": by_step}
    out["counts"]["codec"], out["ms"]["codec"] = counts, walls
    return out


def _dp_hold(phase: str, label: str, got: dict, ref: dict, rtol: float) -> None:
    """One run of `_dp_runs` against another: each state part, gradient and
    parameter within ``rtol`` of each tensor's largest entry, each metric
    within ``rtol`` of itself."""
    checks = []  # (error / allowed, error, allowed, what)

    def hold(actual: dict, expected: dict, what: str) -> None:
        for name, e in expected.items():
            scale = e.abs().max().item() if e.numel() else 0.0
            err = (actual[name] - e).abs().max().item() if e.numel() else 0.0
            allowed = rtol * scale
            ratio = err / allowed if allowed > 0 else (0.0 if err == 0 else math.inf)
            checks.append((ratio, err, allowed, f"{what} {name}"))

    state = ref.get("state", {})
    for part, tensors in state.items():
        if isinstance(tensors, dict):
            hold(got["state"][part], tensors, part)
    flat = {k: v for k, v in state.items() if not isinstance(v, dict)}
    if flat:
        hold(got["state"], flat, "state")
    if "params" in ref:
        hold(got["params"], ref["params"], "params")
    for i, grads in enumerate(ref.get("grads", [])):
        hold(got["grads"][i], grads, f"step {i + 1} gradient")
    for i, metrics in enumerate(ref["metrics"]):
        for k, v in metrics.items():
            err, allowed = abs(got["metrics"][i][k] - v), rtol * abs(v)
            ratio = err / allowed if allowed > 0 else (0.0 if err == 0 else math.inf)
            checks.append((ratio, err, allowed, f"step {i + 1} metric {k}"))
    ratio, err, allowed, what = max(checks)
    log(phase, f"{label}: the closest to its bound is {what}, {err:.3e} against {allowed:.3e} "
               f"(rtol {rtol:g} of each tensor's largest entry, of each metric)")
    if not ratio <= 1.0:
        raise AssertionError(f"{label}: {what} differs by {err:.3e} > {allowed:.3e}")


def _dp_rank(rank: int, world: int, backend: str, init_method: str, work: str,
             per_card: bool) -> None:
    """One rank of phase 44's multi-process legs: every run over the group,
    rank 0's results to ``work``."""
    import torch
    import torch.distributed as dist

    from naturalspeech2_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank if per_card else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        mesh = make_mesh(n_data=world, device=device)
        label = f"{backend} rank {rank}/{world} on {device}"
        out = _dp_runs("44", mesh, device, Path(work) / f"rank{rank}", label)
        log("44", f"{label}: launch counts {out['counts']}")
        if rank == 0:
            torch.save(out, Path(work) / f"{backend}{world}.pt")
    finally:
        dist.destroy_process_group()


def _dp_spawn(world: int, backend: str, work: Path, per_card: bool) -> dict:
    """``world`` ranks of `_dp_rank`, each failure raising, killed past
    DP_LIMIT_S; rank 0's results."""
    import socket

    import torch
    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ranks = mp.start_processes(
        _dp_rank, args=(world, backend, f"tcp://127.0.0.1:{port}", str(work), per_card),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_LIMIT_S
    while not ranks.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.kill()
            raise AssertionError(f"the {world} {backend} ranks exceeded {DP_LIMIT_S} s")
    return torch.load(work / f"{backend}{world}.pt", weights_only=False)


def phase44_data_parallel(work: Path) -> dict:
    """Data-parallel and FSDP training; returns the launch counts by path."""
    import socket

    import torch
    import torch.distributed as dist

    from naturalspeech2_tpu_torch.parallel import make_mesh

    # cuDNN picks its algorithms deterministically here, so (a) can be held
    # to the plain trainer at f32 rounding
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        plain = _dp_runs("44", None, torch.device("cuda"), work / "plain", "single process")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                                rank=0)
        try:
            mesh = make_mesh(n_data=1, device="cuda:0")
            log("44", f"(a) mesh {mesh.shape} over {mesh.backend}, rank {mesh.rank}")
            one = _dp_runs("44", mesh, torch.device("cuda:0"), work / "nccl1", "(a) nccl 1")
        finally:
            dist.destroy_process_group()
        runs = {"replicated": "plain", "fsdp": "plain", "conditional": "conditional",
                "codec": "codec"}
        for run, ref in runs.items():  # the codec's index_add_ is not exact even at one rank
            rtol = GRAD_RTOL if run == "codec" else DP_STATE_RTOL
            _dp_hold("44", f"(a) NCCL world size 1, {run}", one[run], plain[ref], rtol)
        two = _dp_spawn(2, "gloo", work, per_card=False)
        for run, ref in runs.items():
            _dp_hold("44", f"(b) two gloo ranks on one card, {run}", two[run], plain[ref],
                     GRAD_RTOL)
        log("44", "(b) the two ranks share this one card and reduce through host memory "
                  "(gloo): its times are not a multi-card figure")
        counts = {"dp_nccl1_replicated": one["counts"]["replicated"],
                  "dp_nccl1_fsdp": one["counts"]["fsdp"],
                  **{f"dp_gloo2_rank0_{k}": v for k, v in two["counts"].items()}}
        cards = torch.cuda.device_count()
        if cards >= 2:
            multi = _dp_spawn(2, "nccl", work, per_card=True)
            for run, ref in runs.items():
                _dp_hold("44", f"two NCCL ranks, one card each, {run}", multi[run], plain[ref],
                         GRAD_RTOL)
            counts.update({f"dp_nccl2_rank0_{k}": v for k, v in multi["counts"].items()})
            log("44", f"two ranks over NCCL, one card each: ran ({cards} cards); ms per step "
                      + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                                  for k, v in multi["ms"].items()))
        else:
            log("44", f"two ranks over NCCL, one card each: not run (this host has {cards} "
                      "card); beyond world size 1, NCCL is held only by the CPU tests over gloo")
        for label, run in (("single process", plain), ("(a) NCCL world size 1", one),
                           ("(b) two gloo ranks on one card, rank 0", two)):
            log("44", f"{label}: ms per step (host clock, synchronised; the first includes "
                      "first-use costs): " + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                                                     for k, v in run["ms"].items()))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return counts


def _tp_cond_model(seed: int):
    """README config 2, unrolled, with its dropout on (the defaults), seeded
    and jittered, on the CPU."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg

    torch.manual_seed(seed)
    model = ns2pkg.Model(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD,
                         dim_prompt=DIM_PROMPT, cond_drop_prob=0.25, condition_on_prompt=True)
    ns2 = ns2pkg.NaturalSpeech2(model, ns2pkg.SoundStream(), timesteps=1000,
                                duration_pitch_kwargs=dict(head_activation="softplus"))
    return jitter_params(ns2, seed + 1)


def _sp_inputs():
    """q, k, v and dO at SP_SHAPE from a seeded generator, on the CPU."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 455)
    return [torch.randn(SP_SHAPE, generator=gen) for _ in range(4)]


def _tp_serve(phase: str, engine, lead: bool) -> dict:
    """Phase 45(c) on one engine: a batch of four requests from seeded
    noise (its launches exact), then one request whose length the duration
    predictor chooses; the waves and the launch counts of both. A follower
    runs rank 0's calls."""
    import torch

    from naturalspeech2_tpu_torch import ops

    ops.reset_launch_counts()
    if not lead:
        engine.follow()
        return {"counts": ops.launch_counts()}
    prompt = _serving_prompt()
    try:
        reqs = [engine._prepare(SERVE_SENTENCE, prompt, SERVE_SECONDS, i) for i in range(4)]
        noise = torch.randn((4, reqs[0].f_bucket, engine.ns2.dim),
                            generator=torch.Generator().manual_seed(SEED + 456))
        waves = engine._run_batch(reqs, noise=noise)
        check_counts(phase, f"a batch of four requests at {TP_SERVE_STEPS} steps",
                     ops.launch_counts(), cond_sample_counts(TP_SERVE_STEPS))
        predicted = engine._prepare("a shorter reply.", prompt, None, 9)
        waves += engine._run_batch([predicted], noise=torch.randn(
            (1, predicted.f_bucket, engine.ns2.dim),
            generator=torch.Generator().manual_seed(SEED + 457)))
    finally:
        if engine.mesh is not None:
            engine.stop_followers()
    return {"waves": waves, "counts": ops.launch_counts(), "frames": predicted.frames}


def _tp_runs(phase: str, mesh, device, work: Path, config: str, checkpoint: str,
             label: str) -> dict:
    """Every phase-45 run on ``device`` (``mesh`` None: the single process),
    each with exact launch counts: the states, gradients, metrics and
    outputs."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch import cli, ops
    from naturalspeech2_tpu_torch.ops.flash_attention import FlashAttention
    from naturalspeech2_tpu_torch.parallel import comm, ring_attend, sp_attend, tp

    samples = int(TRAIN_SECONDS * 24000)
    out = {"counts": {}, "ms": {}}
    kw = {} if mesh is None else dict(mesh=mesh, param_sharding="tp")
    # (a) the flagship
    ns2 = flagship(SEED + 450).to(device)
    trainer = ns2pkg.Trainer(ns2, batches=iter(()), train_batch_size=TRAIN_BATCH,
                             ema_update_every=1, save_and_sample_every=10**9,
                             results_folder=str(work / "flagship"), **kw)
    grads = _dp_snapshots(trainer)
    batches = [_seeded_audio(SEED + 451 + i, TRAIN_BATCH, samples).numpy()
               for i in range(TP_STEPS)]
    ops.reset_launch_counts()
    metrics, walls = _dp_timed_steps(trainer, batches)
    counts = ops.launch_counts()
    check_counts(phase, f"{label} flagship: {TP_STEPS} optimizer steps", counts,
                 {k: TP_STEPS * v for k, v in PER_STEP.items()})
    out["flagship"] = {"state": _dp_state(trainer), "grads": grads, "metrics": metrics}
    out["counts"]["tp_train"], out["ms"]["flagship"] = counts, walls
    del trainer, ns2
    torch.cuda.empty_cache()
    # (a) README config 2 with its dropout on
    cond = _tp_cond_model(SEED + 452).to(device)
    trainer = ns2pkg.Trainer(cond, batches=iter(()), train_batch_size=CT_BATCH,
                             save_and_sample_every=10**9, results_folder=str(work / "cond"), **kw)
    grads = _dp_snapshots(trainer, TP_COND_GROUPS)
    batch = next(_cond_train_batches(SEED + 453))
    torch.manual_seed(SEED + 454)  # the dropout's draws, alike in every process
    ops.reset_launch_counts()
    metrics, walls = _dp_timed_steps(trainer, [batch])
    counts = ops.launch_counts()
    check_counts(phase, f"{label} config 2 with dropout: one optimizer step", counts,
                 PER_COND_TRAIN_STEP)
    params = {n: p.detach().cpu().clone() for n, p in trainer.full_state()["params"].items()
              if n.startswith(TP_COND_GROUPS)}
    out["conditional"] = {"grads": grads, "metrics": metrics, "params": params}
    out["counts"]["tp_cond_train"], out["ms"]["conditional"] = counts, walls
    del trainer, cond
    torch.cuda.empty_cache()
    # (b) the scaled denoise step
    scaled = flagship(SEED + 458, codec=False, dim=SCALED_DIM, depth=SCALED_DEPTH).model
    scaled = scaled.to(device)
    if mesh is not None:
        tp.shard_model(scaled, mesh)
    gen = torch.Generator().manual_seed(SEED + 459)
    x = torch.randn(SCALED_BATCH, LENGTH, SCALED_DIM, generator=gen).to(device)
    times = torch.rand(SCALED_BATCH, generator=gen).to(device)
    with torch.no_grad():
        ops.reset_launch_counts()
        pred = scaled(x, times)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(phase, f"{label} scaled denoise step", counts,
                     denoise_counts(PER_SCALED_DENOISE, 1))
        out["scaled_ms"] = cuda_ms(lambda: scaled(x, times), reps=5, warmup=1)
    out["scaled"], out["counts"]["tp_scaled_denoise"] = pred.cpu(), counts
    del scaled, x, pred
    torch.cuda.empty_cache()
    # (c) serving
    engine = cli.build_engine(config, checkpoint, timesteps=TP_SERVE_STEPS,
                              cond_scale=SERVE_COND_SCALE, device=str(device),
                              prompt_samples=PROMPT_SAMPLES, tp=1 if mesh is None else 2)
    out["serve"] = _tp_serve(phase, engine, mesh is None or mesh.is_main)
    out["counts"]["tp_serve"] = out["serve"]["counts"]
    del engine
    torch.cuda.empty_cache()
    # (d) sequence parallelism
    q, k, v, do = (t.to(device) for t in _sp_inputs())
    ops.reset_launch_counts()
    if mesh is None:
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = FlashAttention.apply(*leaves, None, None, False, DIM_HEAD**-0.5, 0.0)
        (o * do).sum().backward()
        out["sp"] = {"o": o.detach().cpu(), "grads": [t.grad.cpu() for t in leaves]}
    else:
        n = SP_SHAPE[2] // mesh.n_model
        rows = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
        leaves = [t[:, :, rows].contiguous().requires_grad_(True) for t in (q, k, v)]
        o = sp_attend(*leaves, mesh=mesh, axis="model", backend="flash")
        (o * do[:, :, rows]).sum().backward()
        ring = ring_attend(*(t.detach() for t in leaves), mesh=mesh, axis="model",
                           backend="flash")

        def whole(t):
            return torch.cat(comm.all_gather(mesh, t.detach().contiguous(), "model"), 2).cpu()

        out["sp"] = {"o": whole(o), "grads": [whole(t.grad) for t in leaves],
                     "ring": whole(ring)}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_counts(phase, f"{label} sequence parallelism", counts,
                 {**dict.fromkeys(counts, 0), "flash_forward": 1 if mesh is None else 1 + 2,
                  "flash_backward": 1})
    out["counts"]["sp"] = counts
    return out


def _tp_rank(rank: int, world: int, backend: str, init_method: str, work: str, config: str,
             checkpoint: str) -> None:
    """One rank of phase 45's (data 1, model 2) mesh on card 0, rank 0's
    results to ``work``."""
    import torch
    import torch.distributed as dist

    from naturalspeech2_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    try:
        mesh = make_mesh(n_data=1, n_model=world, device=device)
        label = f"{backend} rank {rank}/{world} (model {mesh.model_index}) on {device}"
        out = _tp_runs("45", mesh, device, Path(work) / f"rank{rank}", config, checkpoint, label)
        log("45", f"{label}: launch counts {out['counts']}")
        if rank == 0:
            torch.save(out, Path(work) / f"tp{world}.pt")
    finally:
        dist.destroy_process_group()


def _partial_cases(phase: str) -> None:
    """(e): K2 and K2b with the residual off, on the 4 heads a rank holds at
    the flagship's and the conditional sampling shapes, and K4 / K5 with
    dropout keyed on rows 2.. and heads 4.. of a larger array, against
    their plain versions; K4's keep mask bit for bit."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 460)
    heads = HEADS // 2
    x, gamma, beta, wq, wkv, wo = attn_inputs(gen, BATCH, LENGTH, DIM, heads=heads)[:6]
    split = ak.split_heads(wq, wkv, wo, heads, DIM_HEAD)
    cfg = dict(heads=heads, dim_head=DIM_HEAD, scale=DIM_HEAD**-0.5)
    part = ak.attn_block(x, gamma, beta, wq, wkv, wo, residual=False, **cfg)
    plain = ak.attn_block_torch(x, gamma, beta, *split, scale=cfg["scale"], residual=False)
    compare(phase, f"attn_block residual off, {heads} heads, x [{BATCH},{LENGTH},{DIM}]", part,
            plain, BLOCK_TOL, relative=True)
    ms = cuda_ms(lambda: ak.attn_block(x, gamma, beta, wq, wkv, wo, residual=False, **cfg))
    log(phase, f"attn_block residual off, {heads} heads: {ms:.4f} ms (median of 20)")
    x, ctx, gamma, beta, wq, wkv, wo = cross_inputs(gen, 8, COND_LENGTH, DIM, NUM_LATENTS, DIM,
                                                    heads=heads)
    split = ak.split_heads(wq, wkv, wo, heads, DIM_HEAD)
    part = ak.cross_attn_block(x, ctx, gamma, beta, wq, wkv, wo, residual=False, **cfg)
    plain = ak.cross_attn_block_torch(x, ctx, gamma, beta, *split, scale=cfg["scale"],
                                      residual=False)
    compare(phase, f"cross_attn_block residual off, {heads} heads, x [8,{COND_LENGTH},{DIM}] "
                   f"ctx [8,{NUM_LATENTS},{DIM}]", part, plain, BLOCK_TOL, relative=True)
    rn = _randn(gen)
    b, h, n, d, rate, seed = 2, 4, 512, DIM_HEAD, 0.2, (SEED + 461, SEED + 462)
    q, k, v, do = (rn(b, h, n, d) for _ in range(4))
    offsets = dict(b_offset=2, h_offset=4)
    cfg = dict(causal=False, scale=d**-0.5, dropout_rate=rate, **offsets)
    o, lse = fa.flash_forward(q, k, v, None, seed, **cfg)
    o_ref, lse_ref = fa.flash_forward_torch(q, k, v, None, seed, **cfg)
    compare(phase, f"flash_forward with offsets {offsets} [{b},{h},{n},{d}] o", o, o_ref,
            FLASH_TOL)
    compare(phase, "flash_forward with offsets lse", lse, lse_ref, FLASH_TOL)
    grads = fa.flash_backward(q, k, v, None, seed, lse_ref, o_ref, do, **cfg)
    refs = fa.flash_backward_torch(q, k, v, None, seed, lse_ref, o_ref, do, **cfg)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        compare(phase, f"flash_backward with offsets {name}", g, r, FLASH_TOL, relative=True)
    zeros = torch.zeros(b, h, n, d, device="cuda")
    kept = []
    for w0 in range(0, n, d):
        onehot = torch.zeros(b, h, n, d, device="cuda")
        cols = torch.arange(w0, w0 + d, device="cuda")
        onehot[:, :, cols, cols - w0] = 1.0
        kept.append(fa.flash_forward(zeros, zeros, onehot, None, seed, **cfg)[0] != 0)
    kept = torch.cat(kept, dim=-1)
    keep = fa.dropout_keep_scaled(seed, 4, 8, n, n, rate, device="cuda")[2:, 4:] != 0
    if not torch.equal(kept, keep):
        raise AssertionError("flash_forward with offsets: the kernel's keep mask is not rows 2.. "
                             "and heads 4.. of the whole array's")
    log(phase, f"K4 keep mask with offsets {offsets}: equal bit for bit to rows 2-3, heads 4-7 "
               f"of the [4,8,{n},{n}] mask ({int(kept.sum())} of {kept.numel()} kept)")


def phase45_tensor_parallel(work: Path) -> dict:
    """Tensor and sequence parallelism; returns rank 0's launch counts by
    path."""
    import socket

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    _partial_cases("45")
    config, checkpoint = _serving_checkpoint(work)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = _tp_runs("45", None, torch.device("cuda"), work / "single", config, checkpoint,
                       "single process")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    start = time.perf_counter()
    ranks = mp.start_processes(
        _tp_rank, args=(2, "gloo", f"tcp://127.0.0.1:{port}", str(work), config, checkpoint),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_LIMIT_S
    while not ranks.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.kill()
            raise AssertionError(f"the two gloo ranks exceeded {TP_LIMIT_S} s")
    two = torch.load(work / "tp2.pt", weights_only=False)
    log("45", f"two gloo ranks on one card: {time.perf_counter() - start:.1f} s wall, start-up "
              "included; every figure of them is two processes sharing this card, reducing "
              "through host memory, not a multi-card one")
    _dp_hold("45", "(a) flagship, tensor-parallel over two ranks", two["flagship"],
             one["flagship"], GRAD_RTOL)
    _dp_hold("45", "(a) README config 2 with dropout, tensor-parallel", two["conditional"],
             one["conditional"], GRAD_RTOL)
    compare("45", f"(b) scaled denoise step, b{SCALED_BATCH} x n{LENGTH}", two["scaled"],
            one["scaled"], TP_SCALED_RTOL, relative=True)
    if two["serve"]["frames"] != one["serve"]["frames"]:
        raise AssertionError(f"(c) predicted frames {two['serve']['frames']} vs "
                             f"{one['serve']['frames']}")
    for i, (a, b) in enumerate(zip(two["serve"]["waves"], one["serve"]["waves"])):
        compare("45", f"(c) served request {i} ({len(b)} samples)", torch.from_numpy(a),
                torch.from_numpy(b), TP_SERVE_ATOL)
    compare("45", f"(d) sp_attend {list(SP_SHAPE)} o", two["sp"]["o"], one["sp"]["o"], FLASH_TOL)
    for name, g, r in zip(("dq", "dk", "dv"), two["sp"]["grads"], one["sp"]["grads"]):
        compare("45", f"(d) sp_attend {name}", g, r, FLASH_TOL, relative=True)
    compare("45", f"(d) flash ring_attend {list(SP_SHAPE)} o", two["sp"]["ring"], one["sp"]["o"],
            FLASH_TOL)
    for label, run in (("single process", one), ("two gloo ranks on one card, rank 0", two)):
        log("45", f"{label}: ms per step (host clock, synchronised; the first includes "
                  "first-use costs): " + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                                                 for k, v in run["ms"].items())
                  + f"; scaled denoise step {run['scaled_ms']:.3f} ms (CUDA events, median of 5)")
    log("45", f"(c) served waves: |wave| max {max(np.abs(w).max() for w in one['serve']['waves']):.4f}")
    return {f"tp_gloo2_rank0_{k}": v for k, v in two["counts"].items()}


# Phase 46, K4 and K5 in bf16 redesigned for Hopper's bf16 tensor cores
# (csrc/flash_fwd_bf16.cu, flash_bwd_bf16.cu): (b, h, n_q, n_kv, d, causal,
# masked, dropout rate, dropout offsets, with the backward). The shapes of
# their PERF rows: the served resampler's and guided step's, the long-form
# n 4500 and n 9000, AMP's prompt encoder (dropout), denoiser and causal
# masked probe (K5's rows too); then the edges: ragged keys, causal with
# n_q != n_kv, dropout keyed on batch and head offsets, heads 128 and 256
# wide (256: the chunked kernels). A masked case's last batch row has every
# key masked.
FLASH_BF16_CASES = (
    (2, HEADS, 32, 134, 64, False, False, 0.0, (0, 0), False),
    (8, HEADS, 32, 134, 64, False, False, 0.0, (0, 0), False),
    (2, HEADS, 510, 510, 64, False, False, 0.0, (0, 0), False),
    (2, HEADS, 510, 32, 64, False, False, 0.0, (0, 0), False),
    (1, HEADS, 4500, 4500, 64, False, False, 0.0, (0, 0), False),
    (1, HEADS, 9000, 9000, 64, False, False, 0.0, (0, 0), False),
    (16, HEADS, 102, 102, 64, False, False, 0.2, (0, 0), True),
    (16, HEADS, 150, 150, 64, False, False, 0.0, (0, 0), True),
    (4, HEADS, 1024, 1024, 64, True, True, 0.0, (0, 0), True),
    (2, HEADS, 1000, 1100, 64, False, True, 0.0, (0, 0), True),
    (2, HEADS, 300, 1100, 64, True, True, 0.0, (0, 0), True),
    (2, HEADS, 1100, 300, 64, True, False, 0.0, (0, 0), True),
    (4, HEADS, 150, 150, 64, False, True, 0.2, (1, 3), True),
    (2, HEADS, 520, 700, 128, False, True, 0.1, (0, 0), True),
    (2, 4, 300, 333, 256, True, False, 0.0, (0, 0), True),
)
FLASH_BF16_SEED = (0x5EED0046, 0xC0DE)


def _flash_bf16_entries(q, k, v, mask8, seed, lse, o, do, *, causal: bool, scale: float,
                        rate: float, offsets) -> tuple:
    """K4's and K5's C entry points at q's dtype called directly on buffers
    made here (no wrapper, no checks, no allocation per call): (forward
    call, backward call, the buffers)."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    o_out, lse_out = torch.empty_like(q), torch.empty(b, h, n_q, device="cuda")
    delta = (do.float() * o.float()).sum(-1)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    tail = (*fa._dropout_args(seed, rate, n_kv, *offsets), _build.stream(q))
    m = None if mask8 is None else mask8.data_ptr()
    fwd, bwd = (_build.entry(n, q.dtype) for n in ("ns2_flash_fwd", "ns2_flash_bwd"))
    fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m, o_out.data_ptr(), lse_out.data_ptr(),
                b, h, n_q, n_kv, d, int(causal), float(scale), *tail)
    bwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), m, lse.data_ptr(), delta.data_ptr(),
                do.data_ptr(), *(g.data_ptr() for g in grads), b, h, n_q, n_kv, d, int(causal),
                float(scale), *tail)
    return (lambda: fwd(*fwd_args)), (lambda: bwd(*bwd_args)), (o_out, lse_out, delta, grads)


def _flash_bf16_case(gen, b, h, n_q, n_kv, d, causal, masked, rate, offsets,
                     backward) -> dict:
    """One phase-46 case: K4 bf16 against its plain version (o within
    BF16_TOL of its largest entry, lse within FLASH_TOL where a key is
    visible, NEG_INF and o = 0 where none is), and with ``backward`` K5
    bf16 run twice on one input (bit for bit) against its plain version
    (each gradient within BF16_TOL); each timed through the wrapper and
    through its C entry point beside the plain version, SDPA in bf16 (its
    backward) and, for K5, the f32 kernel on the same values, with its
    bound and share of the bound. Returns {"flash_forward": (shape,
    timing), "flash_backward": ...}."""
    import torch
    import torch.nn.functional as F

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    q, do = (torch.randn(b, h, n_q, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h, n_kv, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
    mask = mask8 = None
    if masked:
        mask = torch.rand(b, n_kv, generator=gen, device="cuda") > 0.2
        mask[:, 0] = True
        mask[-1] = False
        mask8 = mask.to(torch.uint8)
    seed = FLASH_BF16_SEED if rate else None
    cfg = dict(causal=causal, scale=d**-0.5, dropout_rate=rate, b_offset=offsets[0],
               h_offset=offsets[1])
    shape = f"[{b},{h},{n_q},{d}]" if n_q == n_kv else f"[{b},{h},{n_q}|{n_kv},{d}]"
    shape += "".join([" causal" if causal else "", " masked" if masked else "",
                      f" dropout {rate:g}" if rate else "",
                      f" offsets {offsets[0]},{offsets[1]}" if any(offsets) else ""])
    o, lse = fa.flash_forward(q, k, v, mask, seed, **cfg)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_forward_torch(q, k, v, mask, seed, **cfg)
    err_f = compare("46", f"flash_forward bf16 {shape}", o, o_ref, BF16_TOL, relative=True)
    seen = lse_ref > fa.NEG_INF / 2
    compare("46", f"flash_forward bf16 {shape} lse", lse[seen], lse_ref[seen], FLASH_TOL)
    if not (torch.equal(lse[~seen], lse_ref[~seen]) and not o[~seen].float().any()):
        raise AssertionError(f"flash_forward bf16 {shape}: rows with every key masked")
    lib_mask = fa._valid(b, n_q, n_kv, mask, causal, "cuda") if causal or masked else None
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=lib_mask, scale=cfg["scale"],
                                           dropout_p=rate)
    fwd_entry, bwd_entry, buffers = _flash_bf16_entries(
        q, k, v, mask8, seed, lse_ref, o_ref, do, causal=causal, scale=cfg["scale"], rate=rate,
        offsets=offsets)
    reps = 10 if n_q * n_kv > 10**7 else 20
    moved = 2 * (2 * b * h * n_q * d + 2 * b * h * n_kv * d) + 4 * b * h * n_q
    pairs = attended_pairs(b, h, n_q, n_kv, causal, mask)
    work = bound_bf16(4 * pairs * d, moved)
    if rate:
        keep_ms = THREEFRY_OPS * pairs / PEAK_F32_FLOPS * 1e3
        if keep_ms > work["bound_ms"]:
            work = {"bound_ms": keep_ms, "bound_by": "operations"}
    times = {name: cuda_ms(fn, reps=reps) for name, fn in (
        ("ms", lambda: fa.flash_forward(q, k, v, mask, seed, **cfg)),
        ("c_entry_ms", fwd_entry),
        ("plain_ms", lambda: fa.flash_forward_torch(q, k, v, mask, seed, **cfg)),
        ("library_ms", lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask, scale=cfg["scale"], dropout_p=rate)))}
    share = work["bound_ms"] / times["c_entry_ms"]
    log("46", f"flash_forward bf16 {shape}: kernel {times['ms']:.4f} ms, C entry "
              f"{times['c_entry_ms']:.4f} ms, plain bf16 {times['plain_ms']:.4f} ms, SDPA bf16 "
              f"{times['library_ms']:.4f} ms (median of {reps}), bound {work['bound_ms']:.4f} ms "
              f"({work['bound_by']}), {100 * share:.1f} % of the bound")
    results = {"flash_forward": (shape, {"max_abs_err": err_f, **times, **work,
                                         "share_of_bound": share})}
    if backward:
        grads = fa.flash_backward(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)
        again = fa.flash_backward(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"flash_backward bf16 {shape}: two runs on one input differ")
        err_b = compare("46", f"flash_backward bf16 {shape}", grads,
                        fa.flash_backward_torch(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg),
                        BF16_TOL, relative=True)
        del grads, again
        f32 = [t.float() for t in (q, k, v, o_ref, do)]
        _, bwd32_entry, buffers32 = _flash_bf16_entries(
            f32[0], f32[1], f32[2], mask8, seed, lse_ref, f32[3], f32[4], causal=causal,
            scale=cfg["scale"], rate=rate, offsets=offsets)
        work = bound_amp_backward(b, h, n_q, n_kv, d, bool(rate), pairs)
        times = {name: cuda_ms(fn, reps=reps) for name, fn in (
            ("ms", lambda: fa.flash_backward(q, k, v, mask, seed, lse_ref, o_ref, do, **cfg)),
            ("c_entry_ms", bwd_entry),
            ("f32_ms", lambda: fa.flash_backward(f32[0], f32[1], f32[2], mask, seed, lse_ref,
                                                 f32[3], f32[4], **cfg)),
            ("f32_c_entry_ms", bwd32_entry),
            ("plain_ms", lambda: fa.flash_backward_torch(q, k, v, mask, seed, lse_ref, o_ref, do,
                                                         **cfg)),
            ("library_ms", lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                                       retain_graph=True)))}
        share = work["bound_ms"] / times["c_entry_ms"]
        log("46", f"flash_backward bf16 {shape}: bit for bit over two runs; kernel "
                  f"{times['ms']:.4f} ms, C entry {times['c_entry_ms']:.4f} ms, f32 kernel "
                  f"{times['f32_ms']:.4f} ms (C entry {times['f32_c_entry_ms']:.4f}), plain bf16 {times['plain_ms']:.4f} ms, SDPA bf16 "
                  f"backward {times['library_ms']:.4f} ms (median of {reps}), bound "
                  f"{work['bound_ms']:.4f} ms ({work['bound_by']}), {100 * share:.1f} % of the "
                  "bound")
        results["flash_backward"] = (shape, {"max_abs_err": err_b, **times, **work,
                                             "share_of_bound": share})
        del buffers32
    del buffers
    return results


def _bf16_keep_offsets_case(b, h, n, d, rate, offsets) -> None:
    """K4 bf16's keep mask with batch and head offsets, bit for bit against
    the plain version's and the Threefry mask of rows ``offsets[0] ..`` and
    heads ``offsets[1] ..`` (as `_flash_keep_case`: q = k = 0, v one-hot
    over a d-key window, so o[row, c] != 0 exactly where key window + c is
    kept)."""
    import torch

    from naturalspeech2_tpu_torch.ops import flash_attention as fa

    zeros = torch.zeros(b, h, n, d, device="cuda").bfloat16()
    cfg = dict(causal=False, scale=d**-0.5, dropout_rate=rate, b_offset=offsets[0],
               h_offset=offsets[1])
    kept, kept_ref = [], []
    for w0 in range(0, n, d):
        onehot = torch.zeros(b, h, n, d, device="cuda")
        cols = torch.arange(w0, min(w0 + d, n), device="cuda")
        onehot[:, :, cols, cols - w0] = 1.0
        onehot = onehot.bfloat16()
        kept.append(fa.flash_forward(zeros, zeros, onehot, None, FLASH_BF16_SEED, **cfg)[0] != 0)
        kept_ref.append(fa.flash_forward_torch(zeros, zeros, onehot, None, FLASH_BF16_SEED,
                                               **cfg)[0] != 0)
    kept, kept_ref = torch.cat(kept, dim=-1)[..., :n], torch.cat(kept_ref, dim=-1)[..., :n]
    keep = fa.dropout_keep_scaled(FLASH_BF16_SEED, b, h, n, n, rate, "cuda", *offsets) != 0
    if not (torch.equal(kept, kept_ref) and torch.equal(kept, keep)):
        raise AssertionError(f"flash_forward bf16 [{b},{h},{n},{d}] offsets {offsets}: the "
                             "kernel's keep mask differs")
    log("46", f"bf16 dropout keep mask with offsets {offsets} identical at [{b},{h},{n},{d}]: "
              f"{int(keep.sum())} of {keep.numel()} kept at rate {rate} (kernel, plain bf16 and "
              "the Threefry mask)")


def phase46_flash_bf16(bf16_summary: list) -> None:
    """K4 and K5 in bf16 at every FLASH_BF16_CASES shape against their plain
    versions, K5 bit for bit over two runs, each timed beside SDPA in bf16
    and its bound (`_flash_bf16_case`); the keep mask with offsets bit for
    bit. Adds each shape to the bf16 K4 and K5 rows of the summary."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 460)
    start = time.perf_counter()
    rows = {r["name"]: r for r in bf16_summary
            if r["name"] in ("flash_forward", "flash_backward") and r["dtype"] == "bfloat16"}
    for case in FLASH_BF16_CASES:
        for name, (shape, timing) in _flash_bf16_case(gen, *case).items():
            row = rows[name]
            row["by_shape"][f"46 {shape}"] = timing
            row["max_abs_err"] = max(row["max_abs_err"], timing["max_abs_err"])
        torch.cuda.empty_cache()
    _bf16_keep_offsets_case(2, 3, 200, 64, 0.3, (1, 5))
    log("46", f"bf16 flash kernels: {len(FLASH_BF16_CASES)} shapes in "
              f"{time.perf_counter() - start:.1f} s")


def profile_runs() -> int:
    """torch.profiler over 10 flagship denoise steps at b4 x n1024, over a
    10-step conditional sample of README config 2, over 10 guided denoise
    steps alone (then in bf16 and f32 again) and K2b's calls of those steps
    alone, over one RVQ call at
    the training shape, over one long-form denoise step at n 4500 and at n 9000,
    over one scaled denoise step at b16 x n1024 x dim 512, over one
    training loss and backward at b16 x 2 s and over one conditional one
    (README config 2, phase 18's batch), with the host time of its MAS, CTC
    and pitch loops, and over one served request (phase 20's engine and
    sentence) in f32 and in bf16; then the kernels SDPA runs."""
    import torch

    import naturalspeech2_tpu_torch as ns2pkg
    from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import rvq as rvq_ops

    phase1_card_and_build()
    ns2 = flagship(SEED).cuda().eval()
    with torch.no_grad():
        x = torch.randn(BATCH, LENGTH, DIM, device="cuda")
        times = torch.full((BATCH,), 0.5, device="cuda")

        def flagship_steps():
            for _ in range(10):
                ns2.model(x, times)

        _profile(f"10 flagship denoise steps at b{BATCH} x n{LENGTH}", flagship_steps)
    del ns2

    ns2 = flagship(SEED + 30, conditional=True).cuda().eval()
    prompt, text, text_lens = (t.cuda() for t in _conditional_inputs())
    kwargs = dict(length=COND_LENGTH, prompt=prompt, text=text, text_lens=text_lens,
                  cond_scale=COND_SCALE, timesteps=10)
    _profile("10-step conditional sample", lambda: ns2pkg.sample(ns2, **kwargs))
    with torch.no_grad():
        prompt_enc, cond, _ = ns2.conditioning_for_sample(prompt, text, text_lens, COND_LENGTH)
        x = torch.randn(COND_BATCH, COND_LENGTH, DIM, device="cuda")
        times = torch.full((COND_BATCH,), 0.5, device="cuda")

        def steps():
            for _ in range(10):
                forward_with_cond_scale(ns2.model, x, times, prompt=prompt_enc, cond=cond,
                                        cond_scale=COND_SCALE)

        _profile("10 guided denoise steps", steps)
        profile_bf16_guided(ns2, x, times, prompt_enc, cond)
        # K2b's kernels share their names with K2's (the GEMM core's q and
        # W_o launches, K4's core): its own device time, apart
        args = cross_inputs(torch.Generator(device="cuda").manual_seed(SEED + 9),
                            2 * COND_BATCH, COND_LENGTH, NUM_LATENTS, DIM, DIM)

        def cross_blocks():
            for _ in range(10 * DEPTH):
                ak.cross_attn_block(*args, heads=HEADS, dim_head=DIM_HEAD, scale=DIM_HEAD**-0.5)

        _profile(f"{10 * DEPTH} K2b calls (10 guided steps' worth)", cross_blocks)
    del ns2
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x = torch.randn(TRAIN_BATCH * int(TRAIN_SECONDS * 24000) // 320, 128, generator=g,
                    device="cuda")
    codebooks = torch.randn(8, 1024, 128, generator=g, device="cuda")
    _profile("1 RVQ call (K6) at m 2400, Q 8, K 1024, d 128", lambda: rvq_ops.rvq(x, codebooks))

    long_ns2 = flagship(SEED + 40, scan_layers=True).cuda().eval()
    for n in LONG_LENGTHS:
        with torch.no_grad():
            x = torch.randn(1, n, DIM, device="cuda")
            times = torch.full((1,), 0.5, device="cuda")
            _profile(f"1 long-form denoise step at n {n}", lambda: long_ns2.model(x, times))
    del long_ns2

    scaled = flagship(SEED + 50, codec=False, dim=SCALED_DIM, depth=SCALED_DEPTH,
                      scan_layers=True).cuda().eval()
    with torch.no_grad():
        x = torch.randn(SCALED_BATCH, LENGTH, SCALED_DIM, device="cuda")
        times = torch.full((SCALED_BATCH,), 0.5, device="cuda")
        _profile(f"1 scaled denoise step at b{SCALED_BATCH} x n{LENGTH} x dim {SCALED_DIM}",
                 lambda: scaled.model(x, times))
    del scaled
    torch.cuda.empty_cache()

    ns2 = flagship(SEED + 10).cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    audio = torch.tanh(torch.randn(TRAIN_BATCH, int(TRAIN_SECONDS * 24000), generator=g,
                                   device="cuda"))

    def train_step():
        ns2.zero_grad(set_to_none=True)
        ns2(audio, generator=g)["loss"].backward()

    _profile(f"1 training loss and backward at b{TRAIN_BATCH} x {TRAIN_SECONDS:g} s", train_step)
    del ns2
    torch.cuda.empty_cache()

    ns2 = flagship(SEED + 80, conditional=True, scan_layers=True).cuda()
    batch = {k: torch.as_tensor(v).cuda() for k, v in next(_cond_train_batches(SEED + 81)).items()}
    audio = batch.pop("audio")

    def cond_train_step():
        ns2.zero_grad(set_to_none=True)
        ns2(audio, **batch, generator=g)["loss"].backward()

    _profile(f"1 conditional training loss and backward at b{CT_BATCH} x "
             f"{CT_SAMPLES / 24000:g} s", cond_train_step)
    loop_times("profile", audio)
    del ns2, audio, batch
    torch.cuda.empty_cache()

    from naturalspeech2_tpu_torch import cli

    prompt = _serving_prompt()
    with tempfile.TemporaryDirectory() as work:
        checkpoint = _serving_checkpoint(Path(work))
        for dtype in (None, "bfloat16"):
            engine = cli.build_engine(*checkpoint, timesteps=STEPS, cond_scale=SERVE_COND_SCALE,
                                      device="cuda", prompt_samples=PROMPT_SAMPLES, dtype=dtype)
            engine.warmup([SERVE_BUCKET])
            _profile(f"1 served request, {dtype or 'float32'}, bucket {SERVE_BUCKET}, {STEPS} "
                     "guided steps (engine.tts)",
                     lambda: engine.tts(SERVE_SENTENCE, prompt, seconds=SERVE_SECONDS))
            del engine
    sdpa_kernel_names()
    return 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile flagship, conditional, long-form, scaled and training "
                             "steps instead of the smoke run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    if args.profile:
        return profile_runs()

    phase1_card_and_build()
    summary = phase2_sampling_kernels()
    bf16_summary = phase22_bf16_kernels()
    # K1b's bf16_matmul and the AMP entry points' profiles beside the bf16
    # kernels: early in the run, where short torch.profiler sessions keep
    # their device events (late in a whole run some came back without any,
    # PERF.md)
    check_amp_bf16_cores("27")
    bf16mm_entry = phase31_bf16_matmul()
    torch.cuda.empty_cache()
    ns2_cpu = flagship(SEED)
    ns2 = copy.deepcopy(ns2_cpu).cuda()
    sample_counts = phase3_sample(ns2)
    phase4_5_card_vs_cpu(ns2, ns2_cpu)
    few_counts = phase32_few_step(ns2, ns2_cpu)
    bf16_sample_counts = phase23_bf16_flagship(ns2, sample_counts)
    summary += phase6_training_kernels()
    with tempfile.TemporaryDirectory() as work:
        train_counts = phase7_train(Path(work))
    phase8_loss_card_vs_cpu(ns2, ns2_cpu)
    del ns2, ns2_cpu

    cross, flash_shapes = phase9_conditional_kernels(summary)
    summary += cross
    for entry in summary:
        if entry["name"] == "flash_forward":
            for shape, (err, timing) in flash_shapes.items():
                entry["by_shape"][shape] = timing
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
    cond_cpu = flagship(SEED + 30, conditional=True)
    cond = copy.deepcopy(cond_cpu).cuda()
    cond_counts = phase10_conditional_sample(cond)
    phase23_bf16_guided_step(cond)
    phase11_conditional_card_vs_cpu(cond, cond_cpu)
    del cond, cond_cpu

    summary.append(phase12_longform_scaled_kernels(summary))
    long_cpu = flagship(SEED + 40, scan_layers=True)
    long_ns2 = copy.deepcopy(long_cpu).cuda()
    long_counts = phase13_longform(long_ns2)
    scaled_cpu = flagship(SEED + 50, codec=False, dim=SCALED_DIM, depth=SCALED_DEPTH,
                          scan_layers=True)
    scaled = copy.deepcopy(scaled_cpu).cuda()
    scaled_counts = phase14_scaled(scaled)
    bf16_long_counts, bf16_scaled_counts = phase24_bf16_longform_scaled(
        long_ns2, long_counts, scaled, scaled_counts)
    phase15_card_vs_cpu(long_ns2, long_cpu, scaled, scaled_cpu)
    del long_ns2, long_cpu, scaled, scaled_cpu
    phase16_widths(summary)

    phase17_cond_train_kernels(summary)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        cond_train_counts = phase18_cond_train(Path(work))
    torch.cuda.empty_cache()
    phase19_cond_loss_card_vs_cpu(flagship(SEED + 90, conditional=True, scan_layers=True))
    torch.cuda.empty_cache()
    phase20_serving_kernels(summary)
    with tempfile.TemporaryDirectory() as work:
        serve_counts, engine, config, checkpoint = phase20_serving(Path(work))
        phase21_serving_card_vs_cpu(engine, config, checkpoint)
        bf16_engine, (serve_bf16_f32, serve_bf16_bf16) = phase25_bf16_serving(
            engine, config, checkpoint, Path(work))
        phase26_bf16_card_vs_cpu(bf16_engine, engine, config, checkpoint)
        serve_dpmpp_counts = phase33_few_step_serving(engine, config, checkpoint, Path(work))
        new_counts = phase43_flac_prompt(engine)
    del engine, bf16_engine
    torch.cuda.empty_cache()

    amp_rows = phase27_amp_kernels(bf16_summary)
    bf16_summary += [e for e in amp_rows if e["dtype"] == "bfloat16"]
    torch.cuda.empty_cache()
    phase46_flash_bf16(bf16_summary)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        amp_counts = phase28_amp_train(Path(work))
        torch.cuda.empty_cache()
        amp_counts.update(phase29_cond_amp_train(Path(work)))
    torch.cuda.empty_cache()
    phase30_amp_card_vs_cpu()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        few_train_counts = phase34_self_cond_train_and_distill(Path(work))
    torch.cuda.empty_cache()
    phase35_card_vs_cpu()
    torch.cuda.empty_cache()
    enc_cpu = encodec_flagship(SEED + 373)
    enc = copy.deepcopy(enc_cpu).cuda()
    phase36_encodec_kernels(summary, enc.codec)
    with tempfile.TemporaryDirectory() as work:
        codec_counts = phase37_encodec_ns2(enc, enc_cpu, Path(work))
    del enc, enc_cpu
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        codec_counts.update(phase38_codec_train(Path(work)))
    codec_counts.update(phase39_encodec_48k())
    torch.cuda.empty_cache()
    new_counts.update(phase40_unfused_wavenet())
    torch.cuda.empty_cache()
    new_counts.update(phase41_plain_transformer())
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        new_counts.update(phase42_flac_and_dispatch(Path(work)))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        new_counts.update(phase44_data_parallel(Path(work)))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        new_counts.update(phase45_tensor_parallel(Path(work)))

    for entry in summary:
        name = entry["name"]
        entry["dtype"] = "float32"
        by_path = {"sample": sample_counts[name], "train": train_counts[name],
                   "conditional_sample": cond_counts[name],
                   **{f"longform_{n}": c[name] for n, c in long_counts.items()},
                   "scaled_sample": scaled_counts[name],
                   "conditional_train": cond_train_counts[name], "serve": serve_counts[name],
                   "serve_bf16": serve_bf16_f32[name],
                   **{path: c["f32"][name] for path, c in amp_counts.items()},
                   "few_step_sample": few_counts[name], "serve_dpmpp": serve_dpmpp_counts[name],
                   **{path: c[name] for path, c in few_train_counts.items()},
                   **{path: c[name] for path, c in codec_counts.items()},
                   **{path: c[name] for path, c in new_counts.items()}}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        missing = [k for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
                   if k not in entry]
        if missing:
            raise AssertionError(f"{entry['name']}: summary lacks {missing}")
    for entry in bf16_summary:
        name = entry["name"]
        by_path = {"sample_bf16": bf16_sample_counts[name],
                   **{f"longform_{n}_bf16": c[name] for n, c in bf16_long_counts.items()},
                   "scaled_sample_bf16": bf16_scaled_counts[name],
                   "serve_bf16": serve_bf16_bf16[name],
                   **{path: c["bf16"][name] for path, c in amp_counts.items()}}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["launches"] == 0:
            raise AssertionError(f"bf16 {name}: no launch on the bf16 paths")
        missing = [k for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
                   if k not in entry]
        if missing:
            raise AssertionError(f"bf16 {entry['name']}: summary lacks {missing}")
    summary += bf16_summary
    for entry in amp_rows:
        if entry["dtype"] == "mixed":
            by_path = {path: c["mixed"][entry["name"]] for path, c in amp_counts.items()}
            entry["launches"] = sum(by_path.values())
            entry["launches_by_path"] = by_path
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['dtype']} {entry['name']}: no launch on the AMP paths")
        missing = [k for k in ("name", "route", "source", "replaces", "launches", "max_abs_err",
                               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
                   if k not in entry]
        if missing:
            raise AssertionError(f"{entry['dtype']} {entry['name']}: summary lacks {missing}")
    summary += [e for e in amp_rows if e["dtype"] == "mixed"]
    missing = [k for k in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                           "plain_ms", "bound_ms", "bound_by", "library_ms") if k not in bf16mm_entry]
    if missing or bf16mm_entry["launches"] == 0:
        raise AssertionError(f"bf16_matmul entry: lacks {missing} or never launched")
    summary.append(bf16mm_entry)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
