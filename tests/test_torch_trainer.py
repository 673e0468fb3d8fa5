"""Port parity for the `Trainer`: two optimizer steps (grad accumulation 2,
global-norm clipping, Adam, EMA every 2 steps, an lr schedule) against the
same steps computed with `jax.value_and_grad` and the JAX `Trainer`'s own
optax optimizer on the same draws; torch's Adam against optax's; the lr
schedules; a save / load / resume round trip from a folder of WAVs; and
the guards and options."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.parallel.mesh import make_mesh
from naturalspeech2_tpu.trainer import Trainer as JTrainer
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, Trainer, load_jax_params
from naturalspeech2_tpu_torch.data import write_wav
from naturalspeech2_tpu_torch.parallel import Mesh
from naturalspeech2_tpu_torch.parallel import make_mesh as make_torch_mesh
from naturalspeech2_tpu_torch.trainer import make_lr_schedule

from torch_parity import assert_close, jitter, normal, numpy_tree, t

MODEL_CFG = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=2)
MICRO, ACCUM, FRAMES = 2, 2, 5


@pytest.fixture(scope="module")
def params():
    tree = {
        "model": JModel(**MODEL_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                                          jnp.zeros((1,)))["params"],
        "codec": JSoundStream(**CODEC_CFG).init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"],
    }
    return jitter(numpy_tree(tree), 3, scale=0.1)


def _port(params, **kwargs):
    ns2 = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), **kwargs)
    ns2.load_state_dict(load_jax_params(params), strict=True)
    return ns2


# clipped (the norm limit is far below the gradients' norm) with a warmup
# whose first lr is 0, and unclipped with a linear decay
@pytest.mark.parametrize("knobs", [
    dict(max_grad_norm=0.05, lr_schedule="cosine", warmup_steps=1),
    dict(max_grad_norm=100.0, lr_schedule="linear", warmup_steps=0),
], ids=["clipped_cosine", "unclipped_linear"])
def test_two_steps_match_jax_and_optax(params, tmp_path, knobs):
    rng = np.random.default_rng(0)
    steps = 2
    batches = [np.tanh(normal(rng, ACCUM * MICRO, FRAMES * 320)) for _ in range(steps)]
    draws = [(rng.uniform(0.05, 0.95, MICRO).astype(np.float32), normal(rng, MICRO, FRAMES, 16))
             for _ in range(steps * ACCUM)]
    common = dict(train_batch_size=MICRO, grad_accum_every=ACCUM, lr=1e-3, ema_decay=0.9,
                  ema_update_every=2, train_num_steps=4, **knobs)

    # JAX: value_and_grad of the module, the JAX Trainer's own optimizer
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=JSoundStream(**CODEC_CFG))
    jtrainer = JTrainer(ns2_j, batches=iter([]), results_folder=str(tmp_path / "jax"),
                        mesh=make_mesh(n_data=1, devices=jax.devices()[:1]), **common)

    def loss_j(p, audio, times, noise):
        return ns2_j.apply({"params": p}, audio, times=times, noise=noise)["loss"]

    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state, ema, losses_j = jtrainer.optimizer.init(p), p, []
    ill = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, bool), params)
    grad_fn = jax.value_and_grad(loss_j)
    for step in range(steps):
        micros = batches[step].reshape(ACCUM, MICRO, -1)
        acc, loss_sum = None, 0.0
        for m in range(ACCUM):
            times, noise = draws[step * ACCUM + m]
            loss, g = grad_fn(p, jnp.asarray(micros[m]), jnp.asarray(times), jnp.asarray(noise))
            acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
            loss_sum += float(loss)
        grads = jax.tree_util.tree_map(lambda g: g / ACCUM, acc)
        ill = jax.tree_util.tree_map(
            lambda m, g: m | (np.abs(g) < 1e-3 * np.abs(g).max()), ill, numpy_tree(grads))
        updates, opt_state = jtrainer.optimizer.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        if (step + 1) % 2 == 0:
            ema = jax.tree_util.tree_map(lambda e, q: e * 0.9 + q * (1 - 0.9), ema, p)
        losses_j.append(loss_sum / ACCUM)

    # the port, on the same batches and draws
    ns2_t = _port(params)
    trainer = Trainer(ns2_t, batches=iter(batches), results_folder=str(tmp_path / "port"),
                      **common)
    queue = [(t(a), t(b)) for a, b in draws]
    trainer.draw = lambda audio: queue.pop(0)
    for step in range(steps):
        metrics = trainer.train_step(batches[step])
        assert metrics["loss"] == pytest.approx(losses_j[step], rel=1e-5)
    assert trainer.step == steps and not queue

    # parameters move by lr·O(1) per step; f32 differences in the gradients
    # (~1e-6 of a tensor's largest entry) reach them through Adam's m/√v,
    # at ~1e-7 where a gradient is well above that rounding. An entry whose
    # gradient fell below 1e-3 of its tensor's largest in some step is
    # partly rounding there, and Adam's normalisation turns it into an
    # O(lr) step of either sign: there Adam's own bound, lr per step, holds.
    ill = {k: v.numpy().astype(bool) for k, v in load_jax_params(ill).items()}
    for got, tree in ((dict(ns2_t.named_parameters()), p), (trainer.ema, ema)):
        for name, want in load_jax_params(numpy_tree(tree)).items():
            diff = np.abs(got[name].detach().numpy() - want.numpy())
            assert diff[~ill[name]].max(initial=0.0) <= 2e-6, name
            assert diff[ill[name]].max(initial=0.0) <= 1e-3 * steps, name
    adam = opt_state[1][0]
    named = dict(ns2_t.named_parameters())
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        for name, want in load_jax_params(numpy_tree(tree)).items():
            got = trainer.optimizer.state[named[name]][key]
            scale = max(float(np.abs(want.numpy()).max()), 1e-12)
            assert_close(got / scale, want.numpy() / scale, atol=1e-4)


def test_torch_adam_equals_optax_adam():
    rng = np.random.default_rng(1)
    p0 = normal(rng, 50)
    grads = [normal(rng, 50, scale=10.0 ** -i) for i in range(4)]
    opt = optax.adam(3e-3, b1=0.9, b2=0.99)
    pj, state = jnp.asarray(p0), None
    state = opt.init(pj)
    pt = t(p0).requires_grad_()
    topt = torch.optim.Adam([pt], lr=3e-3, betas=(0.9, 0.99), eps=1e-8)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, updates)
        pt.grad = t(g)
        topt.step()
        assert_close(pt, pj, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("schedule, warmup", [(None, 0), (None, 3), ("cosine", 0),
                                              ("cosine", 3), ("linear", 0), ("linear", 3)])
def test_lr_schedules_match_optax(schedule, warmup):
    lr, total = 1e-3, 12
    if schedule == "cosine":
        ref = optax.warmup_cosine_decay_schedule(init_value=0.0, peak_value=lr, warmup_steps=warmup,
                                                 decay_steps=total, end_value=0.1 * lr)
    elif schedule == "linear":
        ref = optax.join_schedules([optax.linear_schedule(0.0, lr, max(warmup, 1)),
                                    optax.linear_schedule(lr, 0.0, max(total - warmup, 1))],
                                   [warmup])
    elif warmup > 0:
        ref = optax.linear_schedule(0.0, lr, warmup)
    else:
        ref = lambda count: lr  # noqa: E731
    ours = make_lr_schedule(lr, schedule, warmup, total)
    for count in range(total + 3):
        assert ours(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12)


def _wav_folder(path, n_files=4, seconds=0.2, sr=24000):
    path.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n_files):
        tt = np.arange(int(seconds * sr)) / sr
        audio = 0.5 * np.sin(2 * np.pi * (200 + 50 * i) * tt) + 0.05 * rng.standard_normal(tt.size)
        write_wav(path / f"tone{i}.wav", audio.astype(np.float32), sr)
    return path


def test_save_load_resume_round_trip(params, tmp_path):
    folder = _wav_folder(tmp_path / "wavs")
    kwargs = dict(folder=str(folder), train_batch_size=2, data_max_length_seconds=0.1,
                  save_and_sample_every=2, sample_length=2, ema_update_every=2,
                  results_folder=str(tmp_path / "results"))
    first = Trainer(_port(params, timesteps=4), train_num_steps=2, **kwargs)
    first.train(log_every=1)
    results = tmp_path / "results"
    assert (results / "model-1.ckpt").exists() and (results / "sample-1.wav").exists()
    rows = [json.loads(line) for line in (results / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)

    second = Trainer(_port(params, timesteps=4), train_num_steps=3, **kwargs)
    assert second.latest_checkpoint() == str(results / "model-1.ckpt")
    second.load(second.latest_checkpoint())
    assert second.step == 2
    for (name, a), b in zip(first.ns2.named_parameters(), second.ns2.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(first.ema[name], second.ema[name]), name
        sa, sb = first.optimizer.state[a], second.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq")), name
    second.train(log_every=1)
    assert second.step == 3

    resumed = Trainer(_port(params, timesteps=4), train_num_steps=3, **kwargs)
    resumed.train(log_every=1)  # finds model-1.ckpt at step 2, runs one step
    assert resumed.step == 3


def test_remat_gives_the_same_step(params, tmp_path):
    rng = np.random.default_rng(2)
    batch = np.tanh(normal(rng, 2, FRAMES * 320))
    draw = (t(rng.uniform(0.1, 0.9, 2).astype(np.float32)), t(normal(rng, 2, FRAMES, 16)))
    out = []
    for remat in (False, True):
        trainer = Trainer(_port(params), batches=iter([]), train_batch_size=2, remat=remat,
                          results_folder=str(tmp_path))
        trainer.draw = lambda audio: draw
        trainer.train_step(batch)
        out.append(dict(trainer.ns2.named_parameters()))
    for name, p in out[0].items():
        assert torch.equal(p, out[1][name]), name


def test_nonfinite_step_is_skipped(params, tmp_path):
    trainer = Trainer(_port(params), batches=iter([]), train_batch_size=2,
                      skip_nonfinite_updates=True, results_folder=str(tmp_path))
    before = {k: v.clone() for k, v in trainer.ns2.state_dict().items()}
    batch = np.full((2, FRAMES * 320), np.nan, np.float32)
    metrics = trainer.train_step(batch)
    assert metrics["skipped"] == 1.0 and trainer.step == 1
    assert all(torch.equal(v, before[k]) for k, v in trainer.ns2.state_dict().items())
    assert not trainer.optimizer.state  # no update applied
    ok = trainer.train_step(np.tanh(normal(np.random.default_rng(3), 2, FRAMES * 320)))
    assert ok["skipped"] == 0.0


def test_evaluate_uses_fixed_draws(params, tmp_path):
    val = np.tanh(normal(np.random.default_rng(4), 2, FRAMES * 320))
    trainer = Trainer(_port(params), batches=iter([]), train_batch_size=2,
                      val_batches=iter([val, val]), results_folder=str(tmp_path))
    a, b = trainer.evaluate(), trainer.evaluate()
    assert set(a) == {"val_loss", "val_diffusion"} and a == b


def _trainer(**kwargs):
    return lambda ns2, folder: Trainer(ns2, batches=iter([]), results_folder=folder, **kwargs)


@pytest.mark.parametrize("kwargs", [
    (_trainer(mesh=object()), TypeError, "parallel.Mesh"),
    # a model axis needs as many ranks (tests/test_torch_tp.py)
    (lambda ns2, folder: make_torch_mesh(n_model=2), ValueError,
     "1×2 mesh does not cover 1 ranks"),
    (_trainer(checkpoint_backend="orbax"), NotImplementedError, "ROADMAP.*item 22"),
    (_trainer(mesh=Mesh(n_data=2, n_model=1, rank=0, group=None, device=torch.device("cpu")),
              train_batch_size=3), ValueError,
     re.escape("train_batch_size (3) must be divisible by the mesh's data axis (2 devices)")),
])
def test_options_outside_the_slice_raise(params, tmp_path, kwargs):
    """What is refused, by name: a mesh that is not the port's, a model axis
    without the ranks for it, orbax (#22, no orbax on the card's host) and
    a batch the data axis does not split (JAX's message); data-parallel,
    FSDP and tensor-parallel training run (tests/test_torch_parallel.py,
    tests/test_torch_tp.py), as does ``steps_per_dispatch``
    (tests/test_torch_dispatch.py)."""
    build, error, match = kwargs
    with pytest.raises(error, match=match):
        build(_port(params), str(tmp_path))


def test_steps_per_dispatch_must_divide_the_steps(params, tmp_path):
    for k in (0, 3):
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            Trainer(_port(params), batches=iter([]), results_folder=str(tmp_path),
                    train_num_steps=4, steps_per_dispatch=k)


def test_amp_trainer_builds_and_keeps_f32_state(params, tmp_path):
    """`Trainer(amp=True)` builds and steps: the master parameters, Adam's
    moments, the EMA and the checkpoint stay f32 (tests/test_torch_amp.py
    holds its losses and gradients against JAX)."""
    trainer = Trainer(_port(params), batches=iter([]), train_batch_size=2, amp=True,
                      ema_update_every=1, results_folder=str(tmp_path))
    assert trainer.amp
    metrics = trainer.train_step(np.tanh(normal(np.random.default_rng(7), 2, 640)))
    assert np.isfinite(metrics["loss"])
    named = dict(trainer.ns2.named_parameters())
    assert all(p.dtype == torch.float32 for p in named.values())
    assert all(e.dtype == torch.float32 for e in trainer.ema.values())
    state = trainer.optimizer.state[named["model.to_time_hidden.weight"]]
    assert state["exp_avg"].dtype == torch.float32
    payload = torch.load(trainer.save(1), weights_only=True)
    assert all(v.dtype == torch.float32 for v in payload["params"].values()
               if v.is_floating_point())


def test_conditional_batches_and_profiling_raise(params, tmp_path):
    """A dict batch holding only "audio" trains as the bare array does
    (conditional dict batches: tests/test_torch_cond_train.py);
    ``profile_steps`` traces steps 2-3 of train() into
    results_folder/profile as a Chrome trace naming the step's ops."""
    audio = np.tanh(normal(np.random.default_rng(5), 2, 640))
    metrics = []
    for batch in (audio, {"audio": audio}):
        trainer = Trainer(_port(params), batches=iter([]), train_batch_size=2,
                          results_folder=str(tmp_path))
        metrics.append(trainer.train_step(batch))
    assert metrics[0] == metrics[1]
    trainer = Trainer(_port(params), batches=iter([audio] * 8), train_batch_size=2,
                      train_num_steps=4, save_and_sample_every=100,
                      results_folder=str(tmp_path / "profiled"))
    trainer.train(log_every=1, profile_steps=(1, 3))
    traces = list((tmp_path / "profiled" / "profile").glob("*.json"))
    assert trainer.step == 4 and [p.name for p in traces] == ["trace-step3.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
