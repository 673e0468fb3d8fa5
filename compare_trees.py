#!/usr/bin/env python3
"""One source tree's end-to-end figures on one NVIDIA GPU, to hold two
versions of the port against each other within one machine.

    python3 compare_trees.py <tree root> <label> [--kernels[=<group>,...]]

Imports `chip_smoke.py` and the port from ``<tree root>`` (this checkout,
or another unpacked with ``git archive <commit> | tar -x -C <dir>``),
builds its kernels and prints one line ``RESULT {...}``: the flagship
denoise step at b4 x n1024 (CUDA events, median of 20), the flagship
training step at b16 x 2 s (host clock, synchronised, median of steps
3-8) and the served p50 of 12 sequential README config 2 requests at the
(64, 512) bucket and 100 steps (host clock). With ``--kernels`` instead:
K1 mixed at AMP_K1_SHAPES and K6 bf16 at AMP_RVQ_SHAPES, through the
wrapper and through the C entry point alone (each tree's own signature,
weights, codebooks and scratch; CUDA events, median of 20; K6's C entry
also on the card alone, its launches queued behind a sleep), the AMP
training steps that run them (`Trainer(amp=True)`: the flagship at b16 x
2 s and README config 2 at b16 x 2 s with text and prompt; host clock,
synchronised, median of steps 3-8 and 3-6), K1 and K1b in
bf16 at BF16_WAVENET_SHAPES, K3 and K2 in bf16 at
BF16_BLOCK_SHAPES (each also with its C entry's host time), K2b in bf16 at
BF16_CROSS_SHAPES (wrapper, C entry and its host time), K1b's
`bf16_matmul` at BF16MM_SHAPES (wrapper: the trees' C signatures differ)
and in the d-512 probe's 20-body chain (ms per body, best of three), K4 in
bf16 at the scaled K2's attention core [16, 8, 1024, 64], K4 and
K5 in bf16 at the shapes of their PERF rows (CUDA events, median of 20;
through the wrapper and through the C entry point alone, which both trees
export with one signature), the bf16 flagship (b4 x n1024) and scaled
(b16 x n1024, dim 512, depth 12) denoise steps, the f32 flagship step and
the long-form bf16 denoise step at n 4500 and n 9000 (CUDA events, median
of 10); first of all K2b mixed at AMP_CROSS_SHAPES and K1b mixed at
AMP_LANES_SHAPES, then K3 and K2 mixed at AMP_BLOCK_SHAPES (wrapper, C
entry and its host time, the f32 kernel's C entry on the same values).
``--kernels=<group>,...`` runs those groups alone (amp_cross_lanes,
amp_blocks, amp, amp_steps, wavenet, blocks, bf16mm, bf16). Run the two trees in turns in
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


# K3 and K2 in bf16 (b, n, dm, blocks): the scaled model's, the bf16
# flagship's, the served request's, and K3 on the n-9000 long form
BF16_BLOCK_SHAPES = ((16, 1024, 512, ("ff_block", "attn_block")),
                     (4, 1024, 128, ("ff_block", "attn_block")),
                     (2, 512, 128, ("ff_block", "attn_block")),
                     (1, 9000, 128, ("ff_block",)))


# K2b in bf16 (b, n, m): the served request's and the guided step's, dm =
# dc = 128, 8 heads of 64
BF16_CROSS_SHAPES = ((2, 512, 32), (8, 512, 32))
# K1b's `bf16_matmul` (b, n, d), 4 stacks x 8 layers: the d-512 probe's, the
# long form's lanes, a d off 64 (chip_smoke.BF16MM_SHAPES)
BF16MM_SHAPES = ((16, 1024, 512), (1, 9000, 128), (2, 1000, 96))


def device_ms(fn, args, reps: int = 20) -> float:
    """The device time of one call of a C entry point (the median of
    ``reps``, CUDA events): each call queued behind a sleep of the card's
    (a million cycles, about 0.5 ms), so that its launches run back to back
    whatever the host's time between them."""
    import torch

    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, args, calls: int = 50) -> float:
    """The host time of one call of a C entry point (the median of
    ``calls``, each after the card is idle): the call returns once its
    launches are queued."""
    import torch

    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn(*args)
        walls.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(walls)


# K1 and K1b in bf16 (route, b, n, d), 4 stacks x 8 layers: the bf16
# flagship's, the served request's and the n-4500 long form's K1, the n-9000
# long form's K1b
BF16_WAVENET_SHAPES = (("stack", 4, 1024, 128), ("stack", 2, 512, 128), ("stack", 1, 4500, 128),
                       ("lanes", 1, 9000, 128))


# AMP training's K1 mixed (b, n, d), 4 stacks x 8 layers: the flagship
# AMP step's and the 160-frame check step's; K6 bf16 (m, Q, K, d): the
# flagship AMP step's codec latents, README config 2's prompts, a 6.8-s
# prompt's and one 102-frame prompt's latents, and chip_smoke's
# AMP_RVQ_RAGGED and AMP_RVQ_COPIED
AMP_K1_SHAPES = ((16, 150, 128), (16, 160, 128))
AMP_RVQ_SHAPES = ((2400, 8, 1024, 128), (1632, 8, 1024, 128), (510, 8, 1024, 128),
                  (102, 8, 1024, 128), (510, 4, 1000, 72), (130, 4, 1000, 70))


def amp_kernels(cs, out: dict) -> None:
    """K1 mixed and K6 bf16 through their wrappers and their C entry points
    alone. A tree whose K1 mixed runs on the bf16 core packs its weights
    in the format ``gemm_cache.fmt_of`` gives it and takes x's planes in its
    scratch (``wavenet_kernel.scratch(..., fmt)``), an older one "tf32"
    and the f32 lanes; a tree with ``rvq.scratch`` takes K6 bf16's scratch
    from it (the codebooks packed by the tree's own ``pack_codebooks``),
    an older one best, the residual and the sum."""
    import inspect

    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import rvq as rvq_ops
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(14)
    stream = torch.cuda.current_stream().cuda_stream
    bf, f32 = torch.bfloat16, torch.float32
    S, L = cs.WAVENET_STACKS, cs.WAVENET_LAYERS
    from naturalspeech2_tpu_torch.ops import gemm_cache

    on_core = "fmt" in inspect.signature(wk.scratch).parameters
    # K1's entry point by name, or (an older fmt_of) by its route
    k1 = "wavenet_body" if "entry" in inspect.signature(gemm_cache.fmt_of).parameters else "stack"
    fmt = gemm_cache.fmt_of(f32, bf, k1) if on_core else "tf32"
    for b, n, d in AMP_K1_SHAPES:
        wn, _ = cs.wavenet_inputs(gen, b, n, d, S, L)
        x, weights, film = wn[0], cs._bf16(*wn[1:7]), wn[7]
        wt = wk._pack_checked(*weights, "stack", f32, fmt)
        state = wk.scratch(b, n, wt.d, L, "stack", f32, x.device, *([fmt] if on_core else []))
        y = torch.empty_like(x)
        fn = _build.entry("ns2_wavenet_body", f32, bf)
        args = (x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
                wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(),
                *(t.data_ptr() for t in state), y.data_ptr(), b, n, wt.d, S, L, stream)
        out.setdefault("k1_mixed", {})[f"[{b},{n},{d}]"] = {
            "wrapper_ms": cs.cuda_ms(lambda: wk._forward("stack", x, *weights, film)),
            "c_entry_ms": cs.cuda_ms(lambda: fn(*args)), "c_entry_host_ms": host_ms(fn, args)}
        del wn, x, weights, film, wt, state, y
    for m, num_q, size, d in AMP_RVQ_SHAPES:
        x = torch.randn(m, d, generator=gen, device="cuda").to(bf)
        cb = torch.randn(num_q, size, d, generator=gen, device="cuda").to(bf)
        packed, norms = rvq_ops.pack_codebooks(cb)
        if hasattr(rvq_ops, "scratch"):
            state = rvq_ops.scratch(m, d, num_q, bf, x.device)
        else:
            state = [torch.full((num_q, m), -1, dtype=torch.int64, device="cuda"),
                     torch.empty((m, d), device="cuda"), torch.empty((m, d), device="cuda")]
        q, codes = torch.empty_like(x), torch.empty((m, num_q), dtype=torch.int32, device="cuda")
        fn = _build.entry("ns2_rvq", bf)
        args = (x.data_ptr(), cb.data_ptr(), packed.data_ptr(), norms.data_ptr(),
                *(t.data_ptr() for t in state), q.data_ptr(), codes.data_ptr(), m, d, num_q,
                size, stream)
        out.setdefault("k6_bf16", {})[f"m {m} Q{num_q} K{size} d{d}"] = {
            "wrapper_ms": cs.cuda_ms(lambda: rvq_ops.rvq(x, cb)),
            "c_entry_ms": cs.cuda_ms(lambda: fn(*args)), "c_entry_host_ms": host_ms(fn, args),
            "c_entry_device_ms": device_ms(fn, args)}
        del x, cb, packed, norms, state, q, codes
    torch.cuda.empty_cache()


# AMP training's K3 and K2 mixed (block, b, n, dm, inner): the 160-frame
# step's, and chip_smoke's ragged AMP_K3_RAGGED and AMP_K2_RAGGED
AMP_BLOCK_SHAPES = (("ff_block", 16, 160, 128, 341), ("attn_block", 16, 160, 128, None),
                    ("ff_block", 4, 256, 96, 200), ("attn_block", 3, 1000, 128, None))


def mixed_block_kernels(cs, out: dict) -> None:
    """K3 and K2 mixed (f32 x, γ and β against bf16 weights) at
    AMP_BLOCK_SHAPES: the wrapper, the C entry point alone and its host
    time, through each tree's own ``ff_c_entry`` / ``attn_c_entry`` (its
    signature, weights and scratch), and the f32 kernel's C entry on the
    same values (CUDA events, median of 20)."""
    import torch

    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk

    gen = torch.Generator(device="cuda").manual_seed(15)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    heads, dh = cs.HEADS, cs.DIM_HEAD
    cfg = dict(heads=heads, dim_head=dh, scale=dh**-0.5)
    for name, b, n, dm, inner in AMP_BLOCK_SHAPES:
        acts = (rn(b, n, dm), 1 + rn(b, dm, scale=0.1), rn(b, dm, scale=0.1))
        if name == "ff_block":
            weights = cs._bf16(rn(dm, 2 * inner, scale=dm**-0.5), rn(2 * inner, scale=0.1),
                               rn(3, inner, inner, scale=(3 * inner) ** -0.5),
                               rn(inner, scale=0.1), rn(inner, dm, scale=inner**-0.5),
                               rn(dm, scale=0.1))
            wrapper = lambda a=acts, w=weights: fk.ff_block(*a, *w)  # noqa: E731
            entry, kw, key = cs.ff_c_entry, {}, "k3_mixed"
        else:
            hd = heads * dh
            weights = cs._bf16(rn(dm, hd, scale=dm**-0.5), rn(dm, 2 * hd, scale=dm**-0.5),
                               rn(hd, dm, scale=hd**-0.5))
            wrapper = lambda a=acts, w=weights: ak.attn_block(*a, *w, **cfg)  # noqa: E731
            entry, kw, key = cs.attn_c_entry, cfg, "k2_mixed"
        call = entry(*acts, *weights, **kw)
        f32_call = entry(*acts, *(w.float() for w in weights), **kw)
        out.setdefault(key, {})[f"[{b},{n},{dm}]" + (f" inner {inner}" if inner else "")] = {
            "wrapper_ms": cs.cuda_ms(wrapper), "c_entry_ms": cs.cuda_ms(call),
            "c_entry_host_ms": host_ms(call, ()), "f32_c_entry_ms": cs.cuda_ms(f32_call)}
        del acts, weights, call, f32_call
        torch.cuda.empty_cache()


# K2b mixed (b, n, dm, dc, heads, dim_head), context NUM_LATENTS rows: the
# 160-frame AMP step's and chip_smoke's AMP_K2B_RAGGED; K1b mixed (b, n, d),
# 4 stacks x 8 layers: chip_smoke's AMP_K1B_SHAPES
AMP_CROSS_SHAPES = ((16, 160, 128, 128, 8, 64), (3, 200, 96, 100, 2, 128))
AMP_LANES_SHAPES = ((1, 6733, 128), (2, 1000, 96))


def mixed_cross_lanes_kernels(cs, out: dict) -> None:
    """K2b mixed at AMP_CROSS_SHAPES (through each tree's own
    ``cross_c_entry``) and K1b mixed at AMP_LANES_SHAPES (weights packed in
    the format the tree's ``gemm_cache.fmt_of`` gives them, scratch from its
    ``wavenet_kernel.scratch``): the wrapper, the C entry point alone and
    its host time, and the f32 kernel's C entry on the same values (CUDA
    events, median of 20)."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import gemm_cache
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(16)
    bf, f32 = torch.bfloat16, torch.float32
    for b, n, dm, dc, heads, dim_head in AMP_CROSS_SHAPES:
        args = cs.cross_inputs(gen, b, n, cs.NUM_LATENTS, dm, dc, heads, dim_head)
        acts, weights = args[:4], cs._bf16(*args[4:])
        cfg = dict(heads=heads, dim_head=dim_head, scale=dim_head**-0.5)
        call = cs.cross_c_entry(*acts, *weights, **cfg)
        f32_call = cs.cross_c_entry(*acts, *(w.float() for w in weights), **cfg)
        key = f"[{b},{n},{dm}] ctx [{b},{cs.NUM_LATENTS},{dc}] {heads}x{dim_head}"
        out.setdefault("k2b_mixed", {})[key] = {
            "wrapper_ms": cs.cuda_ms(lambda: ak.cross_attn_block(*acts, *weights, **cfg)),
            "c_entry_ms": cs.cuda_ms(call), "c_entry_host_ms": host_ms(call, ()),
            "f32_c_entry_ms": cs.cuda_ms(f32_call)}
        del args, acts, weights, call, f32_call
        torch.cuda.empty_cache()
    stream = torch.cuda.current_stream().cuda_stream
    S, L = cs.WAVENET_STACKS, cs.WAVENET_LAYERS
    for b, n, d in AMP_LANES_SHAPES:
        wn, _ = cs.wavenet_inputs(gen, b, n, d, S, L)
        x, weights, film = wn[0], cs._bf16(*wn[1:7]), wn[7]
        entries = {}
        for name, ws, wdt in (("mixed", weights, bf), ("f32", [w.float() for w in weights], f32)):
            fmt = gemm_cache.fmt_of(f32, wdt, "wavenet_lanes")
            wt = wk._pack_checked(*ws, "lanes", f32, fmt)
            xp, filmp = wk.pad_wavenet_inputs(x, film, wt.d) if wt.d != d else (x, film)
            state = wk.scratch(b, n, wt.d, L, "lanes", f32, x.device, fmt)
            y = torch.empty((b, n, wt.d), device="cuda")
            fn = _build.entry("ns2_wavenet_lanes", f32, wdt)
            c_args = (xp.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(),
                      wt.res_b.data_ptr(), wt.skip.data_ptr(), wt.skip_b.data_ptr(),
                      filmp.data_ptr(), *(t.data_ptr() for t in state), y.data_ptr(), b, n,
                      wt.d, S, L, stream)
            entries[name] = (fn, c_args, (wt, xp, filmp, state, y))
        fn, c_args, _ = entries["mixed"]
        f32_fn, f32_args, _ = entries["f32"]
        out.setdefault("k1b_mixed", {})[f"[{b},{n},{d}]"] = {
            "wrapper_ms": cs.cuda_ms(lambda: wk.wavenet_body_lanes(x, *weights, film)),
            "c_entry_ms": cs.cuda_ms(lambda: fn(*c_args)), "c_entry_host_ms": host_ms(fn, c_args),
            "f32_c_entry_ms": cs.cuda_ms(lambda: f32_fn(*f32_args))}
        del wn, x, weights, film, entries
        torch.cuda.empty_cache()


def amp_steps(cs, out: dict) -> None:
    """ms per optimizer step of `Trainer(amp=True)` (host clock,
    synchronised): the flagship on phase 7's batches, median of steps 3-8,
    and README config 2 on phase 18's dict batches, median of steps 3-6."""
    import warnings

    import torch

    import naturalspeech2_tpu_torch as ns2pkg

    def median_step(trainer, batches, count):
        walls = []
        for batch in batches[:count]:
            torch.cuda.synchronize()
            start = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - start) * 1e3)
        return statistics.median(walls[2:])

    with tempfile.TemporaryDirectory() as work, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trainer = ns2pkg.Trainer(cs.flagship(cs.SEED).cuda(), batches=iter(()), amp=True,
                                 train_batch_size=cs.TRAIN_BATCH, results_folder=work)
        audio = [cs._seeded_audio(100 + i, cs.TRAIN_BATCH, int(cs.TRAIN_SECONDS * 24000)).numpy()
                 for i in range(8)]
        out["flagship_amp_train_ms"] = median_step(trainer, audio, 8)
        del trainer
        torch.cuda.empty_cache()
        trainer = ns2pkg.Trainer(cs.flagship(cs.SEED + 290, conditional=True,
                                             scan_layers=True).cuda(),
                                 batches=iter(()), amp=True, train_batch_size=cs.CT_BATCH,
                                 results_folder=work)
        cond = cs._cond_train_batches(cs.SEED + 291)
        out["config2_amp_train_ms"] = median_step(trainer, [next(cond) for _ in range(6)], 6)
        del trainer
        torch.cuda.empty_cache()


def wavenet_kernels(cs, out: dict) -> None:
    """K1 and K1b bf16 at BF16_WAVENET_SHAPES through the wrapper and through
    the C entry point alone (the weights packed once by the tree's own
    wrapper code). Each tree's entry gets the scratch of its own layout: the
    tree's ``wavenet_kernel.scratch`` where it has one (the bf16 planes),
    else the f32 lanes the older entry points take ([2, L, b, n, d] for K1,
    [3, b, n, d] for K1b)."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    S, L = cs.WAVENET_STACKS, cs.WAVENET_LAYERS
    for route, b, n, d in BF16_WAVENET_SHAPES:
        x, *weights, film = cs._bf16(*cs.wavenet_inputs(gen, b, n, d, S, L)[0])
        wt = wk._pack_checked(*weights, route, None)
        if hasattr(wk, "scratch"):
            state = wk.scratch(b, n, wt.d, L, route, torch.bfloat16, x.device)
        else:
            lead = (3, b) if route == "lanes" else (2, L, b)
            state = list(torch.empty((*lead, n, wt.d), device="cuda"))
        y = torch.empty_like(x)
        name = "ns2_wavenet_lanes" if route == "lanes" else "ns2_wavenet_body"
        fn = _build.entry(name, torch.bfloat16)
        args = (x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
                wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(),
                *(t.data_ptr() for t in state), y.data_ptr(), b, n, wt.d, S, L, stream)
        call = ((lambda: wk.wavenet_body_lanes(x, *weights, film)) if route == "lanes"
                else (lambda: wk._forward("stack", x, *weights, film)))
        key = "k1b_bf16" if route == "lanes" else "k1_bf16"
        out.setdefault(key, {})[f"[{b},{n},{d}]"] = {
            "wrapper_ms": cs.cuda_ms(call), "c_entry_ms": cs.cuda_ms(lambda: fn(*args)),
            "c_entry_host_ms": host_ms(fn, args)}
        del x, weights, film, wt, state, y
        torch.cuda.empty_cache()


def block_kernels(cs, out: dict) -> None:
    """K3, K2 and K2b bf16 through their wrappers and their C entry points
    alone (the weights packed and the scratch allocated once, by the tree's
    own wrapper code, the o scratch large enough for either tree),
    K4 bf16's C entry at [16, 8, 1024, 64], and the bf16 flagship and
    scaled denoise steps and the f32 flagship step, into ``out``."""
    import torch

    from naturalspeech2_tpu_torch import _build
    from naturalspeech2_tpu_torch.models.naturalspeech2 import cast_floating
    from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
    from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk

    gen = torch.Generator(device="cuda").manual_seed(11)
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(bf)

    heads, dh = cs.HEADS, cs.DIM_HEAD
    for b, n, dm, blocks in BF16_BLOCK_SHAPES:
        shape = f"[{b},{n},{dm}]"
        x, g, be = rn(b, n, dm, scale=1 / 16), 1 + rn(b, dm, scale=0.1), rn(b, dm, scale=0.1)
        if "ff_block" in blocks:
            inner = int(dm * 8 / 3)
            w = (rn(dm, 2 * inner, scale=dm**-0.5), rn(2 * inner, scale=0.1),
                 rn(3, inner, inner, scale=(3 * inner) ** -0.5), rn(inner, scale=0.1),
                 rn(inner, dm, scale=inner**-0.5))
            b2 = rn(dm, scale=0.1)
            wt = fk._pack_checked(*w, bf)
            # a, then c: in bf16 c first holds n(x) at dm padded to 64
            c_row = max(wt.ip, -(-dm // 64) * 64)
            scratch = torch.empty(b * n * (wt.ip + c_row), dtype=bf, device="cuda")
            y = torch.empty_like(x)
            fn = _build.entry("ns2_ff_block", bf)
            args = (x.data_ptr(), g.data_ptr(), be.data_ptr(), wt.geglu.data_ptr(),
                    wt.b_val.data_ptr(), wt.b_gate.data_ptr(), wt.conv.data_ptr(),
                    wt.bc.data_ptr(), wt.out.data_ptr(), b2.data_ptr(), scratch.data_ptr(),
                    scratch[b * n * wt.ip:].data_ptr(), y.data_ptr(), b, n, dm, wt.ip, stream)
            out.setdefault("k3_bf16", {})[shape] = {
                "wrapper_ms": cs.cuda_ms(lambda: fk.ff_block(x, g, be, *w, b2)),
                "c_entry_ms": cs.cuda_ms(lambda: fn(*args)), "c_entry_host_ms": host_ms(fn, args)}
            del w, wt, scratch
        if "attn_block" in blocks:
            hd = heads * dh
            wq, wkv = rn(dm, hd, scale=dm**-0.5), rn(dm, 2 * hd, scale=dm**-0.5)
            wo = rn(hd, dm, scale=hd**-0.5)
            bt_qkv, bt_out = ak._pack_checked(wq, wkv, wo, heads, dh, bf)
            qkv = torch.empty((3, b, heads, n, dh), dtype=bf, device="cuda")
            o = torch.empty(b * n * max(hd, -(-dm // 64) * 64), dtype=bf, device="cuda")
            y = torch.empty_like(x)
            fn = _build.entry("ns2_attn_block", bf)
            args = (x.data_ptr(), g.data_ptr(), be.data_ptr(), bt_qkv.data_ptr(),
                    bt_out.data_ptr(), qkv.data_ptr(), o.data_ptr(), y.data_ptr(), b, n, dm,
                    heads, dh, dh**-0.5, 1, stream)
            cfg = dict(heads=heads, dim_head=dh, scale=dh**-0.5)
            out.setdefault("k2_bf16", {})[shape] = {
                "wrapper_ms": cs.cuda_ms(lambda: ak.attn_block(x, g, be, wq, wkv, wo, **cfg)),
                "c_entry_ms": cs.cuda_ms(lambda: fn(*args)), "c_entry_host_ms": host_ms(fn, args)}
            del wq, wkv, wo, qkv, o
        torch.cuda.empty_cache()

    # K2b bf16 through its wrapper and its C entry alone (the weights packed
    # by the tree's own code, the scratch the tree's, else K4's layouts)
    hd, dm = heads * dh, cs.DIM
    for b, n, m in BF16_CROSS_SHAPES:
        x, g, be = rn(b, n, dm, scale=1 / 16), 1 + rn(b, dm, scale=0.1), rn(b, dm, scale=0.1)
        ctx = rn(b, m, dm)
        wq, wkv = rn(dm, hd, scale=dm**-0.5), rn(dm, 2 * hd, scale=dm**-0.5)
        wo = rn(hd, dm, scale=hd**-0.5)
        packed = ak._pack_cross_checked(wq, wkv, wo, heads, dh, bf)
        if hasattr(ak, "cross_scratch"):
            q, kv, o = ak.cross_scratch(b, n, m, dm, dm, heads, dh, bf, x.device)
        else:
            q = torch.empty((b, heads, n, dh), dtype=bf, device="cuda")
            kv, o = torch.empty((2, b, heads, m, dh), dtype=bf, device="cuda"), torch.empty_like(q)
        y = torch.empty_like(x)
        fn = _build.entry("ns2_cross_attn_block", bf)
        args = (x.data_ptr(), ctx.data_ptr(), g.data_ptr(), be.data_ptr(),
                *(p.data_ptr() for p in packed), q.data_ptr(), kv.data_ptr(), o.data_ptr(),
                y.data_ptr(), b, n, m, dm, dm, heads, dh, dh**-0.5, 1, stream)
        out.setdefault("k2b_bf16", {})[f"x [{b},{n},{dm}], ctx [{b},{m},{dm}]"] = {
            "wrapper_ms": cs.cuda_ms(lambda: ak.cross_attn_block(
                x, ctx, g, be, wq, wkv, wo, heads=heads, dim_head=dh, scale=dh**-0.5)),
            "c_entry_ms": cs.cuda_ms(lambda: fn(*args)), "c_entry_host_ms": host_ms(fn, args)}
        del packed, q, kv, o
    # K4 bf16 alone at the scaled K2's attention core
    q, k, v = (rn(16, heads, 1024, dh) for _ in range(3))
    o = torch.empty_like(q)
    fwd = _build.entry("ns2_flash_fwd", bf)
    fwd_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), None, o.data_ptr(), None, 16, heads,
                1024, 1024, dh, 0, dh**-0.5, 0, 0, 0.0, 0, 0, 1.0, 0, 0, stream)
    out["k4_bf16_in_k2_scaled_c_entry_ms"] = cs.cuda_ms(lambda: fwd(*fwd_args))
    del q, k, v, o

    with torch.no_grad():
        for label, kw, b in (("flagship", {}, cs.BATCH),
                             ("scaled", dict(codec=False, dim=cs.SCALED_DIM,
                                             depth=cs.SCALED_DEPTH, scan_layers=True),
                              cs.SCALED_BATCH)):
            ns2 = cs.flagship(cs.SEED + 40, **kw).cuda()
            model16 = cast_floating(ns2.model, bf)
            d = kw.get("dim", cs.DIM)
            x = torch.randn(b, cs.LENGTH, d, generator=gen, device="cuda")
            x16, times = x.to(bf), torch.full((b,), 0.5, device="cuda")
            out[f"{label}_bf16_step_ms"] = cs.cuda_ms(lambda: model16(x16, times), reps=10,
                                                       warmup=2)
            if label == "flagship":
                out["flagship_f32_step_ms"] = cs.cuda_ms(lambda: ns2.model(x, times), reps=10,
                                                          warmup=2)
            del ns2, model16, x, x16
            torch.cuda.empty_cache()


def bf16mm_kernels(cs, out: dict) -> None:
    """K1b's `bf16_matmul` through its wrapper at BF16MM_SHAPES (CUDA
    events, median of 10 at b16 x n1024 x d512, else 20) and the d-512
    probe's chain of 20 bodies (ms per body, the best of three chains)."""
    import torch

    from naturalspeech2_tpu_torch.examples import wavenet_d512_probe as probe
    from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

    gen = torch.Generator(device="cuda").manual_seed(13)
    with torch.no_grad():
        for b, n, d in BF16MM_SHAPES:
            wn, _ = cs.wavenet_inputs(gen, b, n, d)
            reps = 10 if b * n * d > 2**24 else 20
            out.setdefault("bf16mm_ms", {})[f"[{b},{n},{d}]"] = cs.cuda_ms(
                lambda: wk.wavenet_body_lanes(*wn, bf16_matmul=True), reps=reps)
            del wn
            torch.cuda.empty_cache()
    args = probe.make_args("cuda")
    out["bf16mm_probe_ms_per_body"] = probe.bench(
        "K1b bf16_matmul", lambda *a: wk.wavenet_body_lanes(*a, bf16_matmul=True), args)
    del args
    torch.cuda.empty_cache()


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
    kernels = [a for a in sys.argv[3:] if a.startswith("--kernels")]
    if kernels:
        groups = {"amp_cross_lanes": mixed_cross_lanes_kernels, "amp_blocks": mixed_block_kernels,
                  "amp": amp_kernels, "amp_steps": amp_steps,
                  "wavenet": wavenet_kernels, "blocks": block_kernels, "bf16mm": bf16mm_kernels,
                  "bf16": bf16_kernels}
        chosen = kernels[0].partition("=")[2]
        for name in chosen.split(",") if chosen else groups:
            groups[name](cs, out)
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
