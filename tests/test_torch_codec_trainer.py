"""Port parity for codec training: `ops/stft_loss.py`,
`models/discriminator.py` and `codec_trainer.py` against the JAX package's,
on the same parameters, batch and dead-code restart rows (JAX draws them
from `fold_in(PRNGKey(seed ^ 0x5EED), step)`; the port takes them as
``restart_idx``).

The multi-resolution STFT loss's log-magnitude term is ill-conditioned in
f32: a bin whose magnitude sits near the FFT's rounding (5e-5 against
values of 50) has a gradient of 1/|S| along a direction that rounding
decides, so JAX's own gradients move by ~7 % of their largest entries when
the audio moves by one f32 ulp. The trainer's steps are therefore held
twice: with the STFT term weighted 0, everything (losses, parameters,
Adam, the codebook EMA and restarts, the discriminator) within 1e-5; with
the default weights (and under AMP), within FLOOR_FACTOR times JAX's own
change when the audio moves by one ulp (the largest over FLOOR_DRAWS
draws), as tests/test_torch_amp.py holds bf16 chains.

Adam's step on an element is lr·m̂/(√v̂ + 1e-8): where the element's
gradients stay below ADAM_NOISE (JAX's own √v̂, from its optimizer state),
their f32 rounding (~1e-7 here) decides the step, up to ±lr, in either
framework. Such elements (a few among thousands; the logits convs' biases,
whose hinge gradient −P(real within the margin) + P(fake within it) is 0
while every logit lies within ±1) are held to within 2·lr per update.

Under AMP, XLA's CPU bf16 convolutions and the port's round at different
points, so the gradients, and from the first Adam step on the
trajectories, part by more than JAX's own one-ulp floor: AMP is held at
its first step (before any update) within AMP_LOSS_RTOL, as
tests/test_torch_amp.py holds AMP losses, and for finite steps with f32
master state after it."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from naturalspeech2_tpu.codec_trainer import CodecTrainer as JCodecTrainer
from naturalspeech2_tpu.codec_trainer import CodecTrainState as JState
from naturalspeech2_tpu.models import discriminator as jdisc
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.encodec import Encodec as JEncodec
from naturalspeech2_tpu.ops.stft_loss import multi_resolution_stft_loss as jstft_loss
from naturalspeech2_tpu.parallel.mesh import make_mesh
from naturalspeech2_tpu_torch import load_jax_params
from naturalspeech2_tpu_torch.codec_trainer import CodecTrainer
from naturalspeech2_tpu_torch.models import discriminator as pdisc
from naturalspeech2_tpu_torch.models.codec import SoundStream
from naturalspeech2_tpu_torch.models.encodec import Encodec
from naturalspeech2_tpu_torch.ops.stft_loss import multi_resolution_stft_loss

from torch_parity import assert_close, jitter, normal, numpy_tree, t

CODECS = {
    "soundstream": (JSoundStream, SoundStream,
                    dict(codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16)),
    "encodec": (JEncodec, Encodec,
                dict(codebook_dim=16, num_filters=4, upsampling_ratios=(4, 2), num_quantizers=2,
                     codebook_size=32, num_lstm_layers=1)),
}
DISC = dict(disc_channels=8, disc_scales=((256, 64), (128, 32)))
# adversarial from step 2 on: steps 0 and 1 run neither discriminator pass,
# step 2 the generator's terms and the discriminator's first update
RECIPE = dict(lr=1e-3, adversarial_weight=1.0, feature_weight=1.0, adversarial_warmup=2,
              mel_weight=2.0, lr_schedule="cosine", decay_steps=10, **DISC)
B, T, STEPS = 2, 1280, 3
RTOL = 1e-5
FLOOR_DRAWS, FLOOR_FACTOR = 2, 6.0
ADAM_NOISE = 1e-6
AMP_LOSS_RTOL = 2e-2


def _audio(seed: int = 0) -> np.ndarray:
    return (0.5 * np.tanh(normal(np.random.default_rng(seed), B, T))).astype(np.float32)


def _ulp_move(audio: np.ndarray, seed: int, bf16: bool = False) -> np.ndarray:
    """``audio`` moved by one ulp (of bf16 with ``bf16``) up or down at
    random in every entry."""
    up = np.random.default_rng(seed).random(audio.shape) < 0.5
    if bf16:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(audio).clip(1e-30))) - 7)
        return (audio + np.where(up, ulp, -ulp)).astype(np.float32)
    return np.nextafter(audio, np.where(up, np.float32(np.inf), np.float32(-np.inf)))


@pytest.fixture(scope="module")
def trees():
    """Per codec: the jittered JAX parameter tree and the discriminator's."""
    audio = jnp.asarray(_audio())
    disc = jdisc.MultiScaleSTFTDiscriminator(scales=DISC["disc_scales"],
                                             channels=DISC["disc_channels"])
    disc_tree = jitter(numpy_tree(jax.jit(disc.init)(jax.random.PRNGKey(1), audio)["params"]),
                       2, scale=0.05)
    out = {}
    for name, (jcls, _, cfg) in CODECS.items():
        tree = jax.jit(jcls(**cfg).init)(jax.random.PRNGKey(0), audio)["params"]
        out[name] = (jitter(numpy_tree(tree), 1, scale=0.05), disc_tree)
    return out


def _jax_run(name, trees, tmp_path, kw, audios, zero_counts):
    """JAX metrics after each step and the state after steps 1 and STEPS,
    one trajectory per batch in ``audios`` (the same batch every step)."""
    jcls, _, cfg = CODECS[name]
    params, disc = trees[name]
    trainer = JCodecTrainer(jcls(use_pallas_rvq=False, **cfg), batches=iter(()),
                            mesh=make_mesh(n_data=1, devices=jax.devices()[:1]),
                            results_folder=str(tmp_path / "jax"), **kw)
    to_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    counts = jnp.zeros if zero_counts else jnp.ones
    start = JState(
        step=jnp.zeros((), jnp.int32), params=to_jnp(params),
        opt_state=trainer.optimizer.init(to_jnp(params)),
        codebook_ema=jnp.asarray(params["codebooks"]),
        codebook_count=counts(params["codebooks"].shape[:2], jnp.float32),
        disc_params=to_jnp(disc) if trainer.discriminator else None,
        disc_opt_state=trainer.disc_optimizer.init(to_jnp(disc)) if trainer.discriminator
        else None)
    step = jax.jit(trainer._train_step)
    runs = []
    for audio in audios:
        state, metrics, states = start, [], {}
        for i in range(STEPS):
            state, m = step(state, jnp.asarray(audio))
            metrics.append({k: float(v) for k, v in m.items()})
            if i + 1 in (1, STEPS):
                states[i + 1] = _jax_state_dict(state)
        runs.append((metrics, states))
    return runs


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _jax_state_dict(state) -> dict:
    """A JAX CodecTrainState as the port's names: codec.*, disc.*, ema,
    count; and per parameter its elements whose gradients stayed below
    ADAM_NOISE (√v̂ of JAX's Adam state) with the number of updates, under
    "noisy"."""
    out, noisy = {}, {}
    for prefix, params, opt in (("codec", state.params, state.opt_state),
                                ("disc", state.disc_params, state.disc_opt_state)):
        if params is None:
            continue
        adam = _adam(opt)
        count = int(adam.count)
        out.update({f"{prefix}.{k}": v for k, v in load_jax_params(numpy_tree(params)).items()})
        if count:
            nu = load_jax_params(numpy_tree(adam.nu))
            noisy.update({f"{prefix}.{k}": (torch.sqrt(v / (1 - 0.999**count)) < ADAM_NOISE, count)
                          for k, v in nu.items()})
    out["ema"] = t(state.codebook_ema)
    out["count"] = t(state.codebook_count)
    out["noisy"] = noisy
    return out


def _restart_rows(step: int, num_q: int, size: int, m: int) -> torch.Tensor:
    """JAX's dead-code restart rows of ``step`` (seed 0)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0 ^ 0x5EED), step)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.randint(jax.random.fold_in(key, q), (size,), 0, m))
        for q in range(num_q)]))


def _port_run(name, trees, tmp_path, kw, audio, zero_counts):
    _, pcls, cfg = CODECS[name]
    params, disc = trees[name]
    codec = pcls(use_pallas_rvq=False, **cfg)
    codec.load_state_dict(load_jax_params(params), strict=True)
    trainer = CodecTrainer(codec, batches=iter(()), results_folder=str(tmp_path / "port"), **kw)
    if trainer.discriminator is not None:
        trainer.discriminator.load_state_dict(load_jax_params(disc), strict=True)
    trainer.init_state()
    if zero_counts:
        trainer.state.codebook_count.zero_()
    num_q, size = codec.codebooks.shape[:2]
    m = B * T // codec.seq_len_multiple_of
    metrics, states = [], {}
    for i in range(STEPS):
        metrics.append(trainer.train_step(audio, restart_idx=_restart_rows(i, num_q, size, m)))
        if i + 1 in (1, STEPS):
            states[i + 1] = _port_state_dict(trainer)
    return metrics, states


def _port_state_dict(trainer) -> dict:
    out = {f"codec.{k}": v.clone() for k, v in trainer.codec.state_dict().items()}
    if trainer.discriminator is not None:
        out.update({f"disc.{k}": v.clone() for k, v in trainer.discriminator.state_dict().items()})
    out["ema"] = trainer.state.codebook_ema.clone()
    out["count"] = trainer.state.codebook_count.clone()
    return out


def _hold(port, runs, floor_factor=None):
    """The port's metrics and states against the first JAX run: metrics
    within RTOL relative, each tensor within RTOL of its largest entry, or
    (with ``floor_factor``) within that many times the largest change of
    the other runs from the first, where that is higher."""
    (metrics_p, states_p), (metrics_j, states_j) = port, runs[0]
    for i, (mp, mj) in enumerate(zip(metrics_p, metrics_j)):
        assert set(mp) == set(mj), (set(mp), set(mj))
        for k in mj:
            floor = max((abs(r[0][i][k] - mj[k]) for r in runs[1:]), default=0.0)
            tol = max(RTOL * abs(mj[k]), (floor_factor or 0.0) * floor, 1e-7)
            assert abs(mp[k] - mj[k]) <= tol, (i, k, mp[k], mj[k], tol)
    for step, want in states_j.items():
        got, noisy = states_p[step], want["noisy"]
        assert set(got) == set(want) - {"noisy"}
        for k, w in want.items():
            if k == "noisy":
                continue
            floor = max(((r[1][step][k] - w).abs().max().item() for r in runs[1:]), default=0.0)
            tol = max(RTOL * w.abs().max().item(), (floor_factor or 0.0) * floor)
            err = (got[k] - w).abs()
            if k in noisy and k != "codec.codebooks":  # the codebooks move by their EMA
                mask, updates = noisy[k]
                err = torch.where(mask, (err - 2 * RECIPE["lr"] * updates).clamp(min=0), err)
            assert err.max().item() <= tol, (step, k, err.max().item(), tol)


# ------------------------------------------------------------------ #


def test_stft_loss_matches_jax():
    """The value within 1e-6 relative; the gradient within FLOOR_FACTOR
    times JAX's own change when the prediction moves by one ulp."""
    pred, target = _audio(1), _audio(2)
    value_j, grad_j = jax.value_and_grad(jstft_loss)(jnp.asarray(pred), jnp.asarray(target))
    floor = max(np.abs(np.asarray(jax.grad(jstft_loss)(jnp.asarray(_ulp_move(pred, s)),
                                                       jnp.asarray(target))) - grad_j).max()
                for s in range(FLOOR_DRAWS))
    x = t(pred).requires_grad_()
    value = multi_resolution_stft_loss(x, t(target))
    value.backward()
    assert_close(value, value_j, atol=0, rtol=1e-6)
    err = np.abs(x.grad.numpy() - np.asarray(grad_j)).max()
    assert err <= max(FLOOR_FACTOR * floor, RTOL * np.abs(grad_j).max()), (err, floor)
    assert float(multi_resolution_stft_loss(t(pred), t(pred))) < 1e-5
    # 960 samples: the 2048-point frames reflect-pad past the audio's length
    short = pred[:, :960], target[:, :960]
    assert_close(multi_resolution_stft_loss(*map(t, short)),
                 jstft_loss(*map(jnp.asarray, short)), atol=0, rtol=1e-6)


def test_discriminator_and_losses_match_jax(trees):
    """Logits and every feature map (flax's asymmetric SAME padding at
    stride (1, 2)), then the hinge and feature-matching losses on them."""
    disc_tree = trees["soundstream"][1]
    disc = jdisc.MultiScaleSTFTDiscriminator(scales=DISC["disc_scales"],
                                             channels=DISC["disc_channels"])
    port = pdisc.MultiScaleSTFTDiscriminator(scales=DISC["disc_scales"],
                                             channels=DISC["disc_channels"])
    port.load_state_dict(load_jax_params(disc_tree), strict=True)
    real, fake = _audio(3), _audio(4)
    out_j = [disc.apply({"params": disc_tree}, jnp.asarray(a)) for a in (real, fake)]
    with torch.no_grad():
        out_p = [port(t(a)) for a in (real, fake)]
    for (lj, fj), (lp, fp) in zip(out_j, out_p):
        for a, b in zip(lp, lj):  # [b, 1, f, w] against [b, f, w, 1]
            scale = float(np.abs(b).max())
            assert_close(a.permute(0, 2, 3, 1), b, atol=RTOL * scale)
        for fs_p, fs_j in zip(fp, fj):
            for a, b in zip(fs_p, fs_j):
                assert_close(a.permute(0, 2, 3, 1), b, atol=RTOL * float(np.abs(b).max()))
    (lr_j, fr_j), (lf_j, ff_j) = out_j
    (lr_p, fr_p), (lf_p, ff_p) = out_p
    assert_close(pdisc.discriminator_hinge_loss(lr_p, lf_p),
                 jdisc.discriminator_hinge_loss(lr_j, lf_j), atol=0, rtol=RTOL)
    assert_close(pdisc.generator_hinge_loss(lf_p), jdisc.generator_hinge_loss(lf_j), atol=0,
                 rtol=RTOL)
    assert_close(pdisc.feature_matching_loss(fr_p, ff_p),
                 jdisc.feature_matching_loss(fr_j, ff_j), atol=0, rtol=RTOL)


def test_hinge_losses_math():
    real, fake = [torch.full((1, 1, 4, 4), 2.0)], [torch.full((1, 1, 4, 4), -2.0)]
    # perfectly separated: no D loss; G pays for being called fake
    assert float(pdisc.discriminator_hinge_loss(real, fake)) == 0.0
    assert float(pdisc.generator_hinge_loss(fake)) == 3.0
    assert float(pdisc.feature_matching_loss([real], [real])) == 0.0


@pytest.mark.parametrize("name", list(CODECS))
def test_steps_match_jax(trees, tmp_path, name):
    """Three steps without the STFT term, every codebook count zeroed first
    (so step 0 restarts every code from the injected rows): steps 0 and 1
    without the adversarial terms (warmup 2), step 2 with them and the
    discriminator's first update; log-mel L1 and the cosine schedule on
    both optimizers. Metrics, codec and discriminator parameters, the codebook
    EMA and counts after steps 1 and 3."""
    kw = dict(RECIPE, stft_weight=0.0)
    audio = _audio()
    runs = _jax_run(name, trees, tmp_path, kw, [audio], zero_counts=True)
    port = _port_run(name, trees, tmp_path, kw, audio, zero_counts=True)
    assert port[0][0]["restarts"] > 0 and port[0][1]["adv_d"] == 0.0 < port[0][2]["adv_d"]
    _hold(port, runs)


def test_full_recipe_within_jax_floor(trees, tmp_path):
    """The default loss weights (the STFT term on), held to FLOOR_FACTOR
    times JAX's own change under a one-ulp move of the batch. The
    discriminator stays in its warmup: its first Adam step takes the sign
    of gradients that the STFT term's noise has already moved, element by
    element, which no per-tensor floor bounds (test_steps_match_jax holds
    its update)."""
    kw = dict(RECIPE, adversarial_warmup=STEPS)
    audio = _audio()
    moved = [_ulp_move(audio, 10 + s) for s in range(FLOOR_DRAWS)]
    runs = _jax_run("soundstream", trees, tmp_path, kw, [audio, *moved], zero_counts=False)
    port = _port_run("soundstream", trees, tmp_path, kw, audio, zero_counts=False)
    _hold(port, runs, floor_factor=FLOOR_FACTOR)


def test_amp_matches_jax(trees, tmp_path):
    """AMP (bf16 codec and discriminator, f32 codebooks, quantizer, losses
    and statistics): the first step's losses within AMP_LOSS_RTOL of JAX's,
    then finite steps, f32 master parameters, moments and statistics."""
    kw = dict(RECIPE, amp=True)
    audio = _audio()
    (metrics_j, _), = _jax_run("soundstream", trees, tmp_path, kw, [audio], zero_counts=False)
    metrics_p, states_p = _port_run("soundstream", trees, tmp_path, kw, audio, zero_counts=False)
    for k, v in metrics_j[0].items():
        assert abs(metrics_p[0][k] - v) <= AMP_LOSS_RTOL * max(abs(v), 1e-6), (k, metrics_p[0][k], v)
    assert all(np.isfinite(list(m.values())).all() for m in metrics_p)
    assert all(v.dtype == torch.float32 for v in states_p[STEPS].values()
               if torch.is_tensor(v) and v.is_floating_point())


def _port_trainer(tmp_path, **kw):
    codec = SoundStream(use_pallas_rvq=False, **CODECS["soundstream"][2])
    return CodecTrainer(codec, batches=itertools.repeat(_audio()), results_folder=str(tmp_path),
                        **{**RECIPE, **kw})


def test_resume_is_bit_for_bit(tmp_path):
    """save() after 3 steps, 2 more; a fresh trainer loads and takes the same
    2: codec and discriminator parameters, both optimizers' moments, the
    codebook statistics and the drawn restart rows equal bit for bit."""
    torch.manual_seed(0)
    a = _port_trainer(tmp_path / "a")
    a.init_state()
    a.state.codebook_count.mul_(0.3)  # some codes die: restarts drawn by step
    for _ in range(3):
        a.train_step(_audio())
    ckpt = a.save("mid")
    for _ in range(2):
        a.train_step(_audio())
    b = _port_trainer(tmp_path / "b")
    b.load(ckpt)
    assert b.state.step == 3
    for _ in range(2):
        b.train_step(_audio())
    for x, y in zip([*a.codec.state_dict().values(), *a.discriminator.state_dict().values(),
                     a.state.codebook_ema, a.state.codebook_count],
                    [*b.codec.state_dict().values(), *b.discriminator.state_dict().values(),
                     b.state.codebook_ema, b.state.codebook_count]):
        assert torch.equal(x, y)
    for opt_a, opt_b in ((a.optimizer, b.optimizer), (a.disc_optimizer, b.disc_optimizer)):
        for sa, sb in zip(opt_a.state.values(), opt_b.state.values()):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert (b.state.step, b.state.disc_updates) == (a.state.step, a.state.disc_updates) == (5, 3)
    assert a.latest_checkpoint().endswith("codec-mid.ckpt") and b.latest_checkpoint() is None


def test_train_loop_restarts_and_refusals(tmp_path, capsys):
    """train() steps to its count and logs; codes with collapsed counts are
    re-seeded from the batch and their counts reset; no restarts with a 0
    threshold; a ``mesh=`` that is not the port's `parallel.Mesh` is refused
    by name (data-parallel codec training: tests/test_torch_parallel.py)."""
    torch.manual_seed(1)
    trainer = _port_trainer(tmp_path / "loop")
    state = trainer.train(3, log_every=1)
    assert state.step == 3 and "codec step 3" in capsys.readouterr().out
    trainer.state.codebook_count.zero_()
    with torch.no_grad():
        trainer.codec.codebooks[0, 8:] = 1e3  # never assigned
    metrics = trainer.train_step(_audio())
    assert metrics["restarts"] > 0 and metrics["perplexity"] >= 1.0 and 0 < metrics["usage"] <= 1
    assert trainer.codec.codebooks[0, 8:].abs().max() < 100 and trainer.state.codebook_count.min() > 0
    quiet = _port_trainer(tmp_path / "quiet", dead_code_threshold=0.0, adversarial_weight=0.0)
    metrics = quiet.train_step(_audio())
    assert "restarts" not in metrics and "adv_d" not in metrics and "perplexity" in metrics
    with pytest.raises(TypeError, match="parallel.Mesh"):
        _port_trainer(tmp_path / "mesh", mesh=object())
