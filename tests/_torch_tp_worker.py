"""The port's tensor-parallel runs, for tests/test_torch_tp.py.

Each ``run_*`` function trains (or serves) a seeded model from seeded
batches and returns what the test compares: with ``mesh=None`` in one
process (the reference the test computes, and with ``move`` its audio
moved by one ulp, to measure the reference's own noise floor), or as one
rank of a gloo group when this file runs as a script:

    python _torch_tp_worker.py <group> <rank> <world> <init method> <out_dir>

Group "model" is two ranks on a (1, 2) mesh, group "grid" four ranks on a
(2, 2) mesh. Every rank runs its group's scenarios in order; rank 0 writes
each result to ``<out_dir>/<name>.pt`` and every rank what it holds to
``<out_dir>/<name>-rank<r>.pt``. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import _torch_parallel_worker as dp  # noqa: E402
from _torch_parallel_worker import audio_stream, jittered, state_of, ulp_moved  # noqa: E402
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream  # noqa: E402
from naturalspeech2_tpu_torch.models import transformer  # noqa: E402
from naturalspeech2_tpu_torch.trainer import Trainer  # noqa: E402

# the unconditional model at tests/test_torch_trainer.py's widths, eight
# frames a row, so that the self-attention takes K2's route (n % 8 == 0)
MODEL_CFG = dp.MODEL_CFG
CODEC_CFG = dp.CODEC_CFG
FRAMES = 8
# the conditional model with every dropout on (the phoneme encoder's conv,
# the prompt encoder's flash attention, the duration / pitch trunks' plain
# attention) and eight prompt latents, so that the cross-attention takes
# K2b's route
COND_MODEL = {**dp.COND_MODEL, "num_latents_m": 8}
COND_NS2 = dp.COND_NS2_DROPOUT
BATCH = dp.BATCH
# tests/test_cli.py's conditional config, served
SERVE_CONFIG = {
    "codec": {"type": "soundstream", "codebook_dim": 16, "channels": 4, "num_quantizers": 2,
              "codebook_size": 16},
    "model": {"dim": 16, "depth": 1, "heads": 2, "dim_head": 8, "wavenet_layers": 1,
              "wavenet_stacks": 1, "use_flash_attn": False, "condition_on_prompt": True,
              "dim_prompt": 24, "num_latents_m": 4, "resampler_depth": 1},
    "ns2": {
        "timesteps": 4, "duration_pitch_dim": 24, "aligner_dim_in": 8, "aligner_dim_hidden": 24,
        "aligner_attn_channels": 8, "pitch_emb_dim": 32, "pitch_emb_pp_hidden_dim": 24,
        "phoneme_enc_kwargs": dict(dim=24, dim_hidden=24, kernel_size=3, depth=1, dim_head=8,
                                   heads=2, use_flash=False),
        "prompt_enc_kwargs": dict(dims=(24, 24), depth=1, heads=2, dim_head=8, kernel_size=3,
                                  use_flash_attn=False),
        "duration_pitch_kwargs": dict(dim_encoded_prompts=24, depth=1, kernel_size=3, heads=2,
                                      dim_head=8, dim_hidden=24, use_flash_attn=False,
                                      num_convolutions_per_block=1,
                                      num_convs_per_resnet_block=1),
    },
    "trainer": {"sample_length": 4},
}
ENGINE_CFG = dict(timesteps=2, cond_scale=1.5, text_buckets=(32,), frame_buckets=(8,),
                  prompt_samples=640)
TEXTS = ("hello world", "tensor parallel speech")


def uncond_model(seed: int) -> NaturalSpeech2:
    return dp.ns2_model(seed, MODEL_CFG, CODEC_CFG, timesteps=4)


def cond_model(seed: int) -> NaturalSpeech2:
    torch.manual_seed(seed)
    return jittered(NaturalSpeech2(Model(**COND_MODEL), SoundStream(**dp.COND_CODEC), **COND_NS2),
                    seed)


def cond_batch(seed: int, move=None, rows: int = BATCH) -> dict:
    rng = np.random.default_rng(seed)
    lens = np.resize(np.asarray(dp.TEXT_LENS, np.int32), rows)
    return {"audio": ulp_moved(dp.tones(rng, rows, FRAMES * 320), move),
            "prompt": rng.uniform(-1, 1, (rows, 2 * 320)).astype(np.float32),
            "text": rng.integers(0, 20, (rows, dp.T_X)).astype(np.int32),
            "text_lens": lens}


def held_by(trainer: Trainer) -> dict:
    """What this rank holds, by parameter name: the module's tensor's
    shape and the optimizer's part's, and the heads each attention runs."""
    out = {name: {"module": tuple(p.shape), "master": tuple(trainer.master[name].shape),
                  "ema": tuple(trainer.ema[name].shape)} for name, p in trainer.params.items()}
    out["heads"] = {name: (m.heads, m.head_offset) for name, m in trainer.ns2.named_modules()
                    if hasattr(m, "to_kv")}
    return out


def run_uncond(mesh, folder: Path, move=None) -> tuple:
    """Two clipped steps (EMA every step) and a held-out loss."""
    trainer = Trainer(uncond_model(0), batches=iter(()), mesh=mesh, train_batch_size=BATCH,
                      lr=1e-3, max_grad_norm=0.05, ema_decay=0.9, ema_update_every=1,
                      param_sharding="tp", results_folder=str(folder),
                      val_batches=audio_stream(14, BATCH, FRAMES * 320))
    grads = dp.with_grad_snapshots(trainer)
    stream = audio_stream(1, BATCH, FRAMES * 320, move=move)
    metrics = [trainer.train_step(next(stream)) for _ in range(2)] + [trainer.evaluate()]
    return {"state": state_of(trainer), "metrics": metrics, "grads": grads}, held_by(trainer)


ACTIVATIONS = ("phoneme_enc", "prompt_enc", "duration_pitch", "model.wavenet",
               "model.perceiver_resampler", "codec.encoder")


def run_cond(mesh, folder: Path, move=None) -> tuple:
    """One conditional step of two micro-batches with every dropout on; the
    outputs of replicated modules recorded."""
    trainer = Trainer(cond_model(4), batches=iter(()), mesh=mesh, train_batch_size=BATCH,
                      grad_accum_every=2, lr=1e-3, max_grad_norm=1e9, ema_update_every=1,
                      results_folder=str(folder))
    grads = dp.with_grad_snapshots(trainer)
    seen: dict = {}
    modules = dict(trainer.ns2.named_modules())
    hooks = [modules[name].register_forward_hook(
        lambda m, a, out, name=name: seen.setdefault(name, []).append(
            (out[0] if isinstance(out, tuple) else out).detach().clone()))
        for name in ACTIVATIONS if name in modules]
    first, second = cond_batch(5, move), cond_batch(6, move)
    batch = {k: np.concatenate([first[k], second[k]]) for k in first}
    metrics = trainer.train_step(batch)
    for h in hooks:
        h.remove()
    return ({"state": state_of(trainer), "metrics": [metrics], "grads": grads},
            {"activations": seen})


def run_jax_step(mesh, inputs: Path) -> dict:
    """One clipped step from the JAX tree's weights (the test's file), the
    JAX trainer's draws injected: the state after it."""
    data = torch.load(inputs, weights_only=False)
    ns2 = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), timesteps=4)
    ns2.load_state_dict(data["state"], strict=True)
    trainer = Trainer(ns2, batches=iter(()), mesh=mesh, train_batch_size=BATCH, lr=1e-3,
                      max_grad_norm=0.05, ema_decay=0.9, ema_update_every=1,
                      results_folder=str(inputs.parent / "jax_step"))
    trainer.draw = lambda audio: (data["times"], data["noise"])
    metrics = trainer.train_step(data["audio"])
    return {"state": state_of(trainer), "metrics": [metrics]}


def resume_trainer(mesh, folder: Path, seed: int, steps: int, start: int, sharding: str,
                   move=None) -> Trainer:
    stream = itertools.islice(audio_stream(9, BATCH, FRAMES * 320, move=move), start, None)
    return Trainer(uncond_model(seed), batches=stream, mesh=mesh, train_batch_size=BATCH,
                   lr=1e-3, ema_update_every=1, train_num_steps=steps, save_and_sample_every=2,
                   sample_length=2, param_sharding=sharding, results_folder=str(folder))


def run_resume(mesh, folder: Path, first: str, then: str, move=None) -> tuple:
    """Two steps under ``first`` with a checkpoint (and an EMA sample) at
    step 2; a trainer from other weights under ``then`` resumes from it and
    takes step 3 on the stream's third batch. With no mesh, the one-process
    run the others are held to."""
    resume_trainer(mesh, folder, 8, 2, 0, first, move).train(log_every=1)
    resumed = resume_trainer(mesh, folder, 99, 3, 2, then, move)
    resumed.train(log_every=1)
    return {"state": state_of(resumed)}, held_by(resumed)


def run_trap(mesh, folder: Path, trap: str) -> dict:
    """`run_uncond`'s first step with tensor parallelism done wrong: without
    *f* (``no_f``: what lies before the heads gets one rank's share of their
    gradient) or with the residual inside every rank's partial sum
    (``residual``: x counted once per rank, and once more)."""
    saved = {k: getattr(transformer, k) for k in ("tp_copy", "attn_block", "cross_attn_block")}
    if trap == "no_f":
        transformer.tp_copy = lambda mesh, t: t
    else:
        for k in ("attn_block", "cross_attn_block"):
            transformer.__dict__[k] = (lambda fn: lambda *a, residual, **kw: fn(
                *a, residual=True, **kw))(saved[k])
    try:
        result, _ = run_uncond(mesh, folder)
    finally:
        for k, v in saved.items():
            setattr(transformer, k, v)
    return {"grads": result["grads"][:1]}


def build_engine(root: Path, mesh, dtype=None):
    """`cli.build_engine` from the test's config and checkpoint; with a mesh,
    tensor-parallel over its model axis."""
    from naturalspeech2_tpu_torch import cli

    return cli.build_engine(str(root / "serve.json"), str(root / "serve.ckpt"), device="cpu",
                            tp=1 if mesh is None else mesh.n_model, dtype=dtype, **ENGINE_CFG)


def run_engine(mesh, root: Path) -> dict:
    """Three batches through ``_run_batch`` (of two requests, of one, and
    one whose length the duration predictor chooses), in f32 and in bf16;
    over a mesh rank 0 leads and the other ranks follow."""
    out = {}
    for dtype in (None, "bfloat16"):
        engine = build_engine(root, mesh, dtype)
        if mesh is not None and not mesh.is_main:
            engine.follow()
            continue
        waves = []
        try:
            for texts, seed, seconds in ((TEXTS, 3, 8 * 320 / 24000),
                                         (TEXTS[:1], 4, 8 * 320 / 24000), (("hi",), 5, None)):
                prompt = np.random.default_rng(seed).uniform(-0.5, 0.5, 640).astype(np.float32)
                reqs = [engine._prepare(t, prompt, seconds, seed) for t in texts]
                waves += engine._run_batch(reqs)
        finally:
            engine.stop_followers()
        out[dtype or "float32"] = waves
    return out


def write_serving_files(root: Path) -> None:
    """The served config and a checkpoint of seeded weights (EMA apart)."""
    from naturalspeech2_tpu_torch import cli

    (root / "serve.json").write_text(json.dumps(SERVE_CONFIG))
    torch.manual_seed(20)
    ns2 = jittered(cli.build_ns2(cli.load_config(str(root / "serve.json"))), 20)
    trainer = Trainer(ns2, batches=iter(()), train_batch_size=1, save_and_sample_every=10**9,
                      results_folder=str(root / "serve_results"))
    with torch.no_grad():
        for e in trainer.ema.values():
            e.add_(0.01)
    Path(trainer.save(0)).rename(root / "serve.ckpt")


def main() -> None:
    import torch.distributed as dist

    from naturalspeech2_tpu_torch.parallel import make_mesh

    group, rank, world, init, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                     sys.argv[4], Path(sys.argv[5]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    mesh = make_mesh(n_data=world // 2, n_model=2, device="cpu")
    if group == "model":
        scenarios = {
            "uncond12": lambda f: run_uncond(mesh, f),
            "cond12": lambda f: run_cond(mesh, f),
            "jax_step": lambda f: (run_jax_step(mesh, out / "jax_inputs.pt"), {}),
            "resume_tp_rep": lambda f: run_resume(mesh, f, "tp", "replicated"),
            "resume_rep_tp": lambda f: run_resume(mesh, f, "replicated", "tp"),
            "trap_no_f": lambda f: (run_trap(mesh, f, "no_f"), {}),
            "trap_residual": lambda f: (run_trap(mesh, f, "residual"), {}),
            "engine": lambda f: (run_engine(mesh, out), {}),
        }
    else:
        scenarios = {
            "uncond22": lambda f: run_uncond(mesh, f),
            "cond22": lambda f: run_cond(mesh, f),
        }
    for name, run in scenarios.items():
        result, held = run(out / name)
        torch.save(held, out / f"{name}-rank{rank}.pt")
        if rank == 0:
            torch.save(result, out / f"{name}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
