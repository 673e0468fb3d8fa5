"""The port's data-parallel runs, for tests/test_torch_parallel.py.

Each ``run_*`` function trains a seeded model from a seeded global batch
stream and returns what the test compares: with ``mesh=None`` in one
process (the reference the test computes, and with ``move`` its audio
moved by one ulp, to measure the reference's own noise floor), or as one
rank of a gloo group when this file runs as a script:

    python _torch_parallel_worker.py <rank> <world> <init method> <out_dir>

Every rank runs every scenario in order; rank 0 writes each result to
``<out_dir>/<name>.pt`` and every rank its layout at rest to
``<out_dir>/<name>-rank<r>.pt``. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import functools
import itertools
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from naturalspeech2_tpu_torch import CodecTrainer, Model, NaturalSpeech2, SoundStream  # noqa: E402
from naturalspeech2_tpu_torch.trainer import Trainer  # noqa: E402

# tests/test_torch_trainer.py's widths; FSDP at JAX's own FSDP test widths
# (tests/test_fsdp.py: dim 64, where several leaves pass MIN_WEIGHT_SIZE)
MODEL_CFG = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=2)
FSDP_MODEL = dict(dim=64, depth=2, heads=4, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                  use_flash_attn=False)
FSDP_CODEC = dict(codebook_dim=64, channels=4, num_quantizers=2, codebook_size=16)
# tests/test_torch_cond_train.py's widths with every dropout off
# (COND_NS2) and on (COND_NS2_DROPOUT: the phoneme encoder's conv, the
# prompt encoder's flash attention, the duration / pitch trunks' plain
# attention; each rank draws its rows of the global batch's masks)
COND_MODEL = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                  condition_on_prompt=True, dim_prompt=24, num_latents_m=4, resampler_depth=1,
                  cond_drop_prob=0.25)
COND_CODEC = dict(codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16)
COND_NS2 = dict(
    timesteps=4, num_phoneme_tokens=20, duration_pitch_dim=24, aligner_dim_in=8,
    aligner_dim_hidden=24, aligner_attn_channels=8, pitch_emb_pp_hidden_dim=24, mel_hop_length=160,
    phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, depth=1, heads=2, dim_head=8, conv_dropout=0.0),
    prompt_enc_kwargs=dict(dims=(24, 24), depth=1, heads=2, dim_head=8, dropout=0.0),
    duration_pitch_kwargs=dict(dim_hidden=24, depth=1, heads=2, dim_head=8,
                               dim_encoded_prompts=24, dropout=0.0,
                               head_activation="softplus"),
)
COND_NS2_DROPOUT = {
    **COND_NS2,
    "phoneme_enc_kwargs": {**COND_NS2["phoneme_enc_kwargs"], "conv_dropout": 0.2},
    "prompt_enc_kwargs": {**COND_NS2["prompt_enc_kwargs"], "dropout": 0.2},
    "duration_pitch_kwargs": {**COND_NS2["duration_pitch_kwargs"], "dropout": 0.2},
}
# the global micro-batch: two rows a rank on two ranks
BATCH, FRAMES, T_X = 4, 5, 5
# phoneme counts 10 and 3 in the two halves: local masked means weigh them
# 1:1, the global one 10:3
TEXT_LENS = (5, 5, 1, 2)
# tests/test_torch_codec_trainer.py's discriminator, adversarial from step 0,
# with the STFT term off, as that test holds the trainer strictly (its
# log-magnitude gradient is ill-conditioned in f32); the loss itself over
# the ranks is held by the "losses" scenario. A code unused in a step
# (count 0.99 < 1) is re-seeded from the batch.
CODEC_RECIPE = dict(lr=1e-3, adversarial_weight=1.0, feature_weight=1.0, adversarial_warmup=0,
                    mel_weight=2.0, stft_weight=0.0, disc_channels=8,
                    disc_scales=((256, 64), (128, 32)), dead_code_threshold=1.0)


def ulp_moved(x: np.ndarray, seed) -> np.ndarray:
    """``x`` moved by one f32 ulp up or down at random in every entry (None:
    ``x`` as it is)."""
    if seed is None:
        return x
    up = np.random.default_rng(seed).random(x.shape) < 0.5
    return np.where(up, np.nextafter(x, np.inf), np.nextafter(x, -np.inf)).astype(np.float32)


def audio_stream(seed: int, rows: int, samples: int = FRAMES * 320, move=None):
    rng = np.random.default_rng(seed)
    for i in itertools.count():
        audio = np.tanh(rng.standard_normal((rows, samples))).astype(np.float32)
        yield ulp_moved(audio, None if move is None else (move, i))


def tones(rng, rows: int, samples: int, sr: int = 24000) -> np.ndarray:
    """Voiced rows (two partials, vibrato, noise), so pitch is non-zero."""
    time = np.arange(samples) / sr
    out = []
    for _ in range(rows):
        phase = 2 * np.pi * rng.uniform(100, 300) * time + 2 * np.sin(2 * np.pi * 4 * time)
        out.append(0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase)
                   + 0.05 * rng.standard_normal(samples))
    return np.stack(out).astype(np.float32)


def cond_batch(seed: int, move=None) -> dict:
    rng = np.random.default_rng(seed)
    return {"audio": ulp_moved(tones(rng, BATCH, 4 * 320), move),
            "prompt": rng.uniform(-1, 1, (BATCH, 2 * 320)).astype(np.float32),
            "text": rng.integers(0, 20, (BATCH, T_X)).astype(np.int32),
            "text_lens": np.asarray(TEXT_LENS, np.int32)}


def jittered(module, seed: int):
    """Seeded noise (std 0.1) on every parameter, as the port's parity tests
    jitter theirs: no zero-initialised entry, whose first Adam steps are
    lr-sized whatever its gradient, stands in for a real one."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return module


def ns2_model(seed: int, model=MODEL_CFG, codec=CODEC_CFG, **kw) -> NaturalSpeech2:
    torch.manual_seed(seed)
    return jittered(NaturalSpeech2(Model(**model), SoundStream(**codec), **kw), seed)


def cond_model(seed: int, ns2=COND_NS2) -> NaturalSpeech2:
    torch.manual_seed(seed)
    return jittered(NaturalSpeech2(Model(**COND_MODEL), SoundStream(**COND_CODEC), **ns2), seed)


def state_of(trainer: Trainer) -> dict:
    """The whole state as plain CPU tensors: parameters, Adam's moments by
    parameter name, the EMA and the step."""
    full = trainer.full_state()
    names = list(trainer.master)
    moments = {f"{names[i]}.{k}": v for i, s in full["opt_state"]["state"].items()
               for k, v in s.items() if k != "step"}
    return {"step": full["step"], "params": {k: v.cpu() for k, v in full["params"].items()},
            "moments": {k: v.cpu() for k, v in moments.items()},
            "ema": {k: v.cpu() for k, v in full["ema_params"].items()}}


def layout_of(trainer: Trainer) -> dict:
    """What this rank holds at rest, by parameter name: elements of the
    module's tensor, of the optimizer's (its part), of each moment and of
    the EMA."""
    out = {}
    for name, p in trainer.params.items():
        held = trainer.master[name]
        moments = trainer.optimizer.state[held]
        out[name] = {"module": p.numel(), "master": held.numel(), "ema": trainer.ema[name].numel(),
                     "exp_avg": moments["exp_avg"].numel(),
                     "exp_avg_sq": moments["exp_avg_sq"].numel()}
    return out


def with_grad_snapshots(trainer: Trainer) -> list:
    """Record the (reduced, clipped) gradient of each parameter as the
    optimizer steps."""
    grads, step = [], trainer.optimizer.step

    def recording_step(*args, **kwargs):  # under FSDP each rank's parts, gathered
        held = {n: p.grad.detach() for n, p in trainer.master.items()}
        grads.append({n: g.cpu().clone() for n, g in trainer.gather(held).items()})
        return step(*args, **kwargs)

    trainer.optimizer.step = recording_step
    return grads


def run_replicated(mesh, folder: Path, move=None) -> tuple:
    """Two steps at the global batch, clipped (the norm limit is far below
    the gradients' norm), EMA every step, then the held-out loss of a
    batch (each rank its rows)."""
    trainer = Trainer(ns2_model(0, timesteps=4), batches=iter(()), mesh=mesh,
                      train_batch_size=BATCH, lr=1e-3, max_grad_norm=0.05, ema_decay=0.9,
                      ema_update_every=1, param_sharding="replicated", results_folder=str(folder),
                      val_batches=audio_stream(14, BATCH))
    grads = with_grad_snapshots(trainer)
    stream = audio_stream(1, BATCH, move=move)
    metrics = [trainer.train_step(next(stream)) for _ in range(2)] + [trainer.evaluate()]
    return {"state": state_of(trainer), "metrics": metrics, "grads": grads}, layout_of(trainer)


def run_fsdp(mesh, folder: Path, sharding: str, move=None) -> tuple:
    """Two clipped steps of the dim-64 model under ``sharding``."""
    trainer = Trainer(ns2_model(2, FSDP_MODEL, FSDP_CODEC, timesteps=4), batches=iter(()),
                      mesh=mesh, train_batch_size=BATCH, lr=1e-3, max_grad_norm=0.05,
                      ema_decay=0.9, ema_update_every=1, param_sharding=sharding,
                      results_folder=str(folder))
    grads = with_grad_snapshots(trainer)
    stream = audio_stream(3, BATCH, move=move)
    metrics = [trainer.train_step(next(stream)) for _ in range(2)]
    return {"state": state_of(trainer), "metrics": metrics, "grads": grads}, layout_of(trainer)


def run_conditional(mesh, folder: Path, move=None, ns2=COND_NS2) -> tuple:
    """One conditional step whose halves hold 10 and 3 phonemes: the
    reduced gradient, the metrics and the state."""
    trainer = Trainer(cond_model(4, ns2), batches=iter(()), mesh=mesh, train_batch_size=BATCH,
                      lr=1e-3, max_grad_norm=1e9, ema_update_every=1,
                      results_folder=str(folder))
    grads = with_grad_snapshots(trainer)
    metrics = trainer.train_step(cond_batch(5, move))
    return {"state": state_of(trainer), "metrics": [metrics], "grads": grads}, {}


def run_accum_dispatch(mesh, folder: Path, move=None) -> tuple:
    """``train()`` of two steps in one dispatch of ``steps_per_dispatch=2``,
    each step two micro-batches (``grad_accum_every=2``), with the
    non-finite skip on."""
    trainer = Trainer(ns2_model(6, timesteps=4), batches=audio_stream(7, 2 * BATCH, move=move),
                      mesh=mesh,
                      train_batch_size=BATCH, grad_accum_every=2, steps_per_dispatch=2,
                      train_num_steps=2, save_and_sample_every=10**9, lr=1e-3,
                      ema_update_every=1, skip_nonfinite_updates=True,
                      results_folder=str(folder))
    grads = with_grad_snapshots(trainer)
    trainer.train(log_every=1)
    return {"state": state_of(trainer), "grads": grads}, {}


def resume_trainer(mesh, folder: Path, seed: int, steps: int, start_batch: int,
                   move=None) -> Trainer:
    stream = itertools.islice(audio_stream(9, BATCH, move=move), start_batch, None)
    return Trainer(ns2_model(seed, FSDP_MODEL, FSDP_CODEC, timesteps=4), batches=stream,
                   mesh=mesh, train_batch_size=BATCH, lr=1e-3, ema_update_every=1,
                   train_num_steps=steps, save_and_sample_every=2, sample_length=2,
                   param_sharding="fsdp", results_folder=str(folder))


def run_resume(mesh, folder: Path) -> tuple:
    """FSDP: two steps with a checkpoint (and an EMA sample) at step 2 from
    rank 0; a fresh trainer from other weights resumes from it on every
    rank, re-sharded, and takes step 3 on the stream's third batch."""
    first = resume_trainer(mesh, folder, 8, 2, 0)
    first.train(log_every=1)
    resumed = resume_trainer(mesh, folder, 99, 3, 2)
    resumed.train(log_every=1)
    return {"state": state_of(resumed)}, layout_of(resumed)


def run_codec(mesh, folder: Path, move=None) -> tuple:
    """Two adversarial `CodecTrainer` steps whose dead-code threshold re-seeds
    codes from the batch every step."""
    torch.manual_seed(10)
    trainer = CodecTrainer(jittered(SoundStream(**COND_CODEC), 10),
                           batches=audio_stream(11, BATCH, 1280, move),
                           mesh=mesh, results_folder=str(folder), **CODEC_RECIPE)
    trainer.train(2, log_every=1, steps_per_jit=1)
    metrics = trainer.train_step(next(trainer.batches))
    state = {"codec": {k: v.cpu() for k, v in trainer.codec.state_dict().items()},
             "disc": {k: v.cpu() for k, v in trainer.discriminator.state_dict().items()},
             "codebook_ema": trainer.state.codebook_ema.cpu(),
             "codebook_count": trainer.state.codebook_count.cpu(), "step": trainer.state.step}
    return {"state": state, "metrics": [metrics]}, {}


def run_losses(mesh, move=None) -> dict:
    """The multi-resolution STFT loss and the feature-matching loss over the
    global batch: their values and the gradient towards the whole
    prediction (each rank's rows gathered)."""
    from naturalspeech2_tpu_torch.models.discriminator import feature_matching_loss
    from naturalspeech2_tpu_torch.ops.stft_loss import multi_resolution_stft_loss
    from naturalspeech2_tpu_torch.parallel import comm, make_mesh, shard_batch

    rng = np.random.default_rng(13)
    pred, target = (ulp_moved(np.tanh(rng.standard_normal((BATCH, 2400))).astype(np.float32), m)
                    for m in (move, None))
    real = [[rng.standard_normal((BATCH, 4, 30)).astype(np.float32) for _ in range(2)]
            for _ in range(2)]
    fake = [[ulp_moved(rng.standard_normal((BATCH, 4, 30)).astype(np.float32), move)
             for _ in range(2)] for _ in range(2)]
    mesh = make_mesh(device="cpu") if mesh is None else mesh  # one process: one rank
    rows = functools.partial(shard_batch, mesh)
    batch_sum = functools.partial(comm.global_sum, mesh)
    out = {}
    x = torch.tensor(rows(pred), requires_grad=True)
    loss = multi_resolution_stft_loss(x, torch.tensor(rows(target)), batch_sum=batch_sum)
    fs = [[torch.tensor(rows(f), requires_grad=True) for f in scale] for scale in fake]
    feat = feature_matching_loss([[torch.tensor(rows(r)) for r in scale] for scale in real], fs,
                                 batch_sum=batch_sum)
    (loss + feat).backward()
    grads = {"stft": x.grad, **{f"feat{i}{j}": f.grad for i, scale in enumerate(fs)
                                for j, f in enumerate(scale)}}
    grads = {k: torch.cat(comm.all_gather(mesh, g)) for k, g in grads.items()}
    out["metrics"] = [{"stft": loss.item(), "feat": feat.item()}]
    out["grads"] = [grads]
    return out


def run_dropout(mesh, folder: Path) -> dict:
    """The dropout masks of a global batch of two rows, drawn once a
    `Trainer` is made, the ranks seeded alike (as the CLI seeds them): each
    rank draws its row of the global mask, and the masks come back in row
    order (one process: both rows)."""
    from naturalspeech2_tpu_torch.ops.dropout import Dropout, batch_rows
    from naturalspeech2_tpu_torch.parallel import comm

    Trainer(ns2_model(0, timesteps=4), batches=iter(()), mesh=mesh, train_batch_size=BATCH,
            results_folder=str(folder))
    if mesh is None:
        return {"masks": list(Dropout(0.5)(torch.ones(2, 256)))}
    with batch_rows(mesh.data_index, mesh.n_data):
        mask = Dropout(0.5)(torch.ones(1, 256))
    return {"masks": [m[0] for m in comm.all_gather(mesh, mask)]}


def main() -> None:
    import torch.distributed as dist

    from naturalspeech2_tpu_torch.parallel import make_mesh

    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    mesh = make_mesh(n_data=world, device="cpu")
    scenarios = {
        "replicated": lambda f: run_replicated(mesh, f),
        "fsdp64_replicated": lambda f: run_fsdp(mesh, f, "replicated"),
        "fsdp64_fsdp": lambda f: run_fsdp(mesh, f, "fsdp"),
        "conditional": lambda f: run_conditional(mesh, f),
        "conditional_dropout": lambda f: run_conditional(mesh, f, ns2=COND_NS2_DROPOUT),
        "accum_dispatch": lambda f: run_accum_dispatch(mesh, f),
        "resume": lambda f: run_resume(mesh, f),
        "codec": lambda f: run_codec(mesh, f),
        "losses": lambda f: (run_losses(mesh), {}),
        "dropout": lambda f: (run_dropout(mesh, f), {}),
    }
    for name, run in scenarios.items():
        result, layout = run(out / name)
        torch.save(layout, out / f"{name}-rank{rank}.pt")
        if rank == 0:
            torch.save(result, out / f"{name}.pt")

    # a rank whose results_folder lacks rank 0's checkpoint raises
    folder = out / "unshared" / f"rank{rank}"
    folder.mkdir(parents=True)
    if rank == 0:
        shutil.copy(out / "resume" / "model-1.ckpt", folder / "model-1.ckpt")
    try:
        resume_trainer(mesh, folder, 12, 2, 0).train()
        outcome = "resumed"
    except FileNotFoundError as err:
        outcome = f"FileNotFoundError: {err}"
    torch.save(outcome, out / f"unshared-rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
