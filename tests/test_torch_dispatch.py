"""Port parity for the trainers' dispatch options: `Trainer(steps_per_dispatch=K)`
(K optimizer steps per dispatch, the JAX trainer's `_train_chunk`, a
`lax.scan` over K `_train_step`s) against the JAX chunk on the same
parameters, batches and injected draws; K = 2 against K = 1 bit for bit
through `train()`, with the periodic actions firing where their boundary
falls inside a dispatch; and `CodecTrainer.train(steps_per_jit=k)`, whose
last chunk the port cuts at ``num_steps`` (JAX pads it with repeated
batches), against k = 1."""

import itertools
import json

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
from naturalspeech2_tpu.trainer import TrainState
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, Trainer, load_jax_params
from naturalspeech2_tpu_torch.codec_trainer import CodecTrainer

from torch_parity import jitter, normal, numpy_tree, t

MODEL_CFG = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=2)
MICRO, ACCUM, FRAMES, K = 2, 2, 5, 2


@pytest.fixture(scope="module")
def params():
    tree = {
        "model": JModel(**MODEL_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                                          jnp.zeros((1,)))["params"],
        "codec": JSoundStream(**CODEC_CFG).init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"],
    }
    return jitter(numpy_tree(tree), 3, scale=0.1)


def _port(params):
    ns2 = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG))
    ns2.load_state_dict(load_jax_params(params), strict=True)
    return ns2


def test_dispatch_matches_jax_train_chunk(params, tmp_path):
    """One dispatch of K = 2 steps (grad accumulation 2, clipping, Adam, EMA
    at step 2): the chunk's mean metrics and the parameters after it
    against the JAX `_train_chunk`, the draws injected on both sides (JAX:
    ``times`` / ``noise`` in the batch dict, which `_loss_fn` hands to the
    module). Parameters are held as tests/test_torch_trainer.py holds them:
    2e-6, or Adam's own lr per step where a gradient entry fell below 1e-3
    of its tensor's largest (there f32 rounding picks the sign of m/√v)."""
    rng = np.random.default_rng(0)
    audio = np.stack([np.tanh(normal(rng, ACCUM * MICRO, FRAMES * 320)) for _ in range(K)])
    times = rng.uniform(0.05, 0.95, (K, ACCUM, MICRO)).astype(np.float32)
    noise = normal(rng, K, ACCUM, MICRO, FRAMES, 16)
    common = dict(train_batch_size=MICRO, grad_accum_every=ACCUM, lr=1e-3, ema_decay=0.9,
                  ema_update_every=2, train_num_steps=K, steps_per_dispatch=K,
                  max_grad_norm=0.05)

    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=JSoundStream(**CODEC_CFG))
    jtrainer = JTrainer(ns2_j, batches=iter([]), results_folder=str(tmp_path / "jax"),
                        mesh=make_mesh(n_data=1, devices=jax.devices()[:1]), **common)
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p0,
                       opt_state=jtrainer.optimizer.init(p0), ema_params=p0)
    batches = {"audio": audio.reshape(K, ACCUM, MICRO, -1), "times": times, "noise": noise}
    state, metrics_j = jax.jit(jtrainer._train_chunk)(
        state, jax.tree_util.tree_map(jnp.asarray, batches), jax.random.PRNGKey(0))
    assert int(state.step) == K

    # the ill-conditioned entries, from the gradients along the same trajectory
    def loss_j(p, a, tm, nz):
        return ns2_j.apply({"params": p}, a, times=tm, noise=nz)["loss"]

    grad_fn, p, opt_state = jax.jit(jax.grad(loss_j)), p0, jtrainer.optimizer.init(p0)
    ill = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, bool), params)
    for step in range(K):
        grads = [grad_fn(p, jnp.asarray(audio[step, m * MICRO:(m + 1) * MICRO]),
                         jnp.asarray(times[step, m]), jnp.asarray(noise[step, m]))
                 for m in range(ACCUM)]
        g = jax.tree_util.tree_map(lambda *gs: sum(gs) / ACCUM, *grads)
        ill = jax.tree_util.tree_map(
            lambda m, x: m | (np.abs(x) < 1e-3 * np.abs(x).max()), ill, numpy_tree(g))
        updates, opt_state = jtrainer.optimizer.update(g, opt_state, p)
        p = optax.apply_updates(p, updates)

    trainer = Trainer(_port(params), batches=iter([]), results_folder=str(tmp_path / "port"),
                      **common)
    queue = [(t(times[s, m]), t(noise[s, m])) for s in range(K) for m in range(ACCUM)]
    trainer.draw = lambda a: queue.pop(0)
    metrics = trainer.train_chunk(list(audio))
    assert trainer.step == K and not queue
    assert set(metrics) == set(metrics_j)
    for key, value in metrics.items():
        assert value == pytest.approx(float(metrics_j[key]), rel=1e-5), key

    ill = {k: v.numpy().astype(bool) for k, v in load_jax_params(ill).items()}
    named = dict(trainer.ns2.named_parameters())
    for got, tree in ((named, state.params), (trainer.ema, state.ema_params)):
        for name, want in load_jax_params(numpy_tree(tree)).items():
            diff = np.abs(got[name].detach().numpy() - want.numpy())
            assert diff[~ill[name]].max(initial=0.0) <= 2e-6, name
            assert diff[ill[name]].max(initial=0.0) <= 1e-3 * K, name


def _trained(params, tmp_path, k: int, steps: int = 4, **kw):
    rng = np.random.default_rng(7)
    data = [np.tanh(normal(rng, MICRO, FRAMES * 320)) for _ in range(steps + 2)]
    trainer = Trainer(_port(params), batches=iter(data), train_batch_size=MICRO, lr=1e-3,
                      ema_update_every=1, train_num_steps=steps, steps_per_dispatch=k,
                      save_and_sample_every=3, sample_length=2, results_folder=str(tmp_path),
                      **kw)
    trainer.train(log_every=1)
    return trainer


def test_dispatch_k2_equals_k1_bit_for_bit(params, tmp_path):
    """`train()` at K = 2 and at K = 1 over 4 steps draw the same times and
    noise in the same order and reach the same parameters, Adam state and
    EMA bit for bit. K = 2 logs once a dispatch (steps 2 and 4) the means
    of its two steps, with ``step_time_s`` per step; the milestone at step
    3 fires in the dispatch that crosses it (its checkpoint holds step 4)
    and so does the validation every 3 steps."""
    val = np.tanh(normal(np.random.default_rng(8), MICRO, FRAMES * 320))
    one = _trained(params, tmp_path / "k1", 1, val_batches=itertools.repeat(val),
                   validate_every=3)
    two = _trained(params, tmp_path / "k2", 2, val_batches=itertools.repeat(val),
                   validate_every=3)
    assert one.step == two.step == 4
    for (name, a), b in zip(one.ns2.named_parameters(), two.ns2.parameters()):
        assert torch.equal(a, b) and torch.equal(one.ema[name], two.ema[name]), name
        sa, sb = one.optimizer.state[a], two.optimizer.state[b]
        assert all(torch.equal(sa[key], sb[key]) for key in ("exp_avg", "exp_avg_sq")), name

    def rows(trainer):
        lines = (trainer.results_folder / "metrics.jsonl").read_text().splitlines()
        return [json.loads(line) for line in lines]

    logged = [r for r in rows(two) if "loss" in r]
    per_step = [r for r in rows(one) if "loss" in r]
    assert [r["step"] for r in logged] == [2, 4] and [r["step"] for r in per_step] == [1, 2, 3, 4]
    for r in logged:
        pair = [q for q in per_step if r["step"] - 2 < q["step"] <= r["step"]]
        for key in ("loss", "diffusion"):
            assert r[key] == pytest.approx(np.mean([q[key] for q in pair]), rel=1e-6), key
        assert r["step_time_s"] > 0
    assert [r["step"] for r in rows(two) if "val_loss" in r] == [4]
    assert [r["step"] for r in rows(one) if "val_loss" in r] == [3]
    assert torch.load(two.results_folder / "model-1.ckpt", weights_only=True)["step"] == 4
    assert torch.load(one.results_folder / "model-1.ckpt", weights_only=True)["step"] == 3


CODEC_TRAIN = dict(codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16)


def _codec_trainer(tmp_path, seed: int = 0):
    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    data = [np.tanh(normal(rng, 2, 1280)) for _ in range(12)]
    codec = SoundStream(use_pallas_rvq=False, **CODEC_TRAIN)
    return CodecTrainer(codec, batches=iter(data), results_folder=str(tmp_path), lr=1e-3,
                        adversarial_weight=1.0, adversarial_warmup=2, disc_channels=8,
                        disc_scales=((256, 64), (128, 32)))


@pytest.mark.parametrize("k,log_every,logged", [(4, 4, [4, 6]), (2, 4, [4]), (1, 4, [4]),
                                                (8, 50, [6])])
def test_codec_steps_per_jit(tmp_path, capsys, k, log_every, logged):
    """`CodecTrainer.train(6, steps_per_jit=k)` ends at step 6 (the last
    chunk cut, not padded), logs after the chunks the JAX rule
    ``(step // k) % max(1, log_every // k) == 0`` picks, and reaches the
    state of k = 1 bit for bit (the same batches, restart rows and steps)."""
    ref = _codec_trainer(tmp_path / "ref")
    ref.train(6, log_every=10**6, steps_per_jit=1)
    capsys.readouterr()
    trainer = _codec_trainer(tmp_path / "k")
    state = trainer.train(6, log_every=log_every, steps_per_jit=k)
    out = capsys.readouterr().out
    assert state.step == 6 and state.disc_updates == ref.state.disc_updates == 4
    assert [int(line.split()[2].rstrip(":")) for line in out.splitlines()
            if line.startswith("codec step")] == logged
    for a, b in zip([*trainer.codec.state_dict().values(),
                     *trainer.discriminator.state_dict().values(),
                     trainer.state.codebook_ema, trainer.state.codebook_count],
                    [*ref.codec.state_dict().values(), *ref.discriminator.state_dict().values(),
                     ref.state.codebook_ema, ref.state.codebook_count]):
        assert torch.equal(a, b)
    # the next call goes on from step 6 and cuts at its own count
    assert trainer.train(7, log_every=1, steps_per_jit=k).step == 7


def test_dispatch_returns_floats_and_clears_grads(params, tmp_path):
    """`train_chunk` takes one step per batch, returns the chunk's means as
    floats and leaves no gradient behind."""
    trainer = Trainer(_port(params), batches=iter([]), train_batch_size=MICRO,
                      train_num_steps=4, steps_per_dispatch=2, results_folder=str(tmp_path))
    rng = np.random.default_rng(9)
    metrics = trainer.train_chunk([np.tanh(normal(rng, MICRO, FRAMES * 320)) for _ in range(2)])
    assert trainer.step == 2 and all(isinstance(v, float) for v in metrics.values())
    assert set(metrics) == {"loss", "diffusion"}
    assert all(p.grad is None for p in trainer.ns2.parameters())
