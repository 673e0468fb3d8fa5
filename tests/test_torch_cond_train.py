"""Port parity for conditional training: `NaturalSpeech2.forward` of a
conditional model (the frozen codec on audio and prompt, mel and pitch
from the audio, the aligner with MAS and the forward-sum loss, the
duration / pitch losses, the denoiser on the aligned frame condition)
against `jax.value_and_grad` of `NaturalSpeech2.__call__(deterministic=
True)` with the same injected times and noise: every loss component and
the gradient of every parameter, at the widths of the JAX package's
conditional tests (tests/test_conditional.py) with flash attention on,
under the options that change no parameter; then `Trainer.train_step` on
dict batches against the same step in JAX, and the trainer's conditional
extras."""

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

from torch_parity import jitter, normal, numpy_tree, t

DIM, B, T_X, FRAMES, PROMPT_FRAMES = 16, 2, 5, 4, 2
MODEL_CFG = dict(dim=DIM, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                 condition_on_prompt=True, dim_prompt=24, num_latents_m=4, resampler_depth=1,
                 cond_drop_prob=0.25)
CODEC_CFG = dict(codebook_dim=DIM, channels=4, num_quantizers=2, codebook_size=16)
NS2_CFG = dict(
    timesteps=4, num_phoneme_tokens=20, duration_pitch_dim=24, aligner_dim_in=8,
    aligner_dim_hidden=24, aligner_attn_channels=8, pitch_emb_pp_hidden_dim=24, mel_hop_length=160,
    phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, depth=1, heads=2, dim_head=8),
    prompt_enc_kwargs=dict(dims=(24, 24), depth=1, heads=2, dim_head=8),
    duration_pitch_kwargs=dict(dim_hidden=24, depth=1, heads=2, dim_head=8,
                               dim_encoded_prompts=24),
)
# Each loss is a mean through up to ~15 f32 layers (mel in dB, the aligner's
# distances, the encoders, the denoiser), summed in other orders: ~1e-6
# relative. Gradients are compared per tensor against its largest entry.
LOSS_RTOL = 2e-5
GRAD_RTOL = 2e-4

# the options under test: flash attention on (the JAX default) with the
# masked duration / pitch loss and the ACF pitch; the reference's unmasked
# loss with the NCCF + Viterbi pitch and the binarization loss; the JAX
# conditional tests' own config (plain attention in the denoiser and the
# prompt encoder) with exact GELU
CASES = {
    "flash_masked_acf": ({}, {}, {}),
    "unmasked_nccf_bin": ({}, dict(mask_duration_pitch_loss=False, calc_pitch_with_pyworld=False,
                                   aligner_bin_loss_weight=0.5), {}),
    "plain_attention_exact_gelu": (dict(use_flash_attn=False, gelu_approximate=False), {},
                                   dict(use_flash_attn=False)),
}


def _tones(rng, b, samples, sr=24000):
    """Voiced rows (two partials, vibrato, noise), so pitch is non-zero."""
    time = np.arange(samples) / sr
    rows = []
    for _ in range(b):
        phase = 2 * np.pi * rng.uniform(100, 300) * time + 2 * np.sin(2 * np.pi * 4 * time)
        rows.append(0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase)
                    + 0.05 * rng.standard_normal(samples))
    return np.stack(rows).astype(np.float32)


def _jax_ns2(model_over=None, ns2_over=None, prompt_over=None):
    kwargs = dict(NS2_CFG, **(ns2_over or {}))
    kwargs["prompt_enc_kwargs"] = dict(NS2_CFG["prompt_enc_kwargs"], **(prompt_over or {}))
    return jns2.NaturalSpeech2(model=JModel(**MODEL_CFG, **(model_over or {})),
                               codec=JSoundStream(**CODEC_CFG, use_pallas_rvq=False), **kwargs)


def _port(params, model_over=None, ns2_over=None, prompt_over=None):
    kwargs = dict(NS2_CFG, **(ns2_over or {}))
    kwargs["prompt_enc_kwargs"] = dict(NS2_CFG["prompt_enc_kwargs"], **(prompt_over or {}))
    ns2 = NaturalSpeech2(Model(**MODEL_CFG, **(model_over or {})), SoundStream(**CODEC_CFG),
                         **kwargs)
    ns2.load_state_dict(load_jax_params(params), strict=True)
    return ns2.eval()  # the JAX side runs deterministic=True


def _batch(seed, text_lens):
    rng = np.random.default_rng(seed)
    return {"audio": _tones(rng, B, FRAMES * 320),
            "prompt": rng.uniform(-1, 1, (B, PROMPT_FRAMES * 320)).astype(np.float32),
            "text": rng.integers(0, 20, (B, T_X)).astype(np.int32),
            "text_lens": np.asarray(text_lens, np.int32)}


@pytest.fixture(scope="module")
def params():
    """The conditional tree (the JAX Trainer's: the module's init, the full
    codec merged in), every leaf jittered."""
    ns2_j = _jax_ns2()
    batch = {k: jnp.asarray(v) for k, v in _batch(0, [T_X, T_X - 1]).items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "times", "noise", "cfg",
                                                             "dropout"))}
    variables = jax.jit(lambda b: ns2_j.init(rngs, b.pop("audio"), **b))(dict(batch))
    tree = dict(variables["params"])
    tree["codec"] = ns2_j.codec.init(jax.random.PRNGKey(5), batch["audio"])["params"]
    return jitter(numpy_tree(tree), 7, scale=0.05)


def _jax_value_and_grad(ns2_j):
    def loss(p, batch, times, noise):
        audio = batch.pop("audio")
        losses = ns2_j.apply({"params": p}, audio, **batch, deterministic=True, times=times,
                             noise=noise)
        return losses["loss"], losses

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _draws(seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.95, B).astype(np.float32), normal(rng, B, FRAMES, DIM)


def _compare_grads(ns2_t, grads_j):
    named = dict(ns2_t.named_parameters())
    expected = load_jax_params(numpy_tree(grads_j))
    assert set(expected) == set(named)
    reached = set()
    for name, want in expected.items():
        got, want = named[name].grad, want.numpy()
        if name.startswith("codec."):  # frozen: zero in JAX, untouched in the port
            assert got is None and not np.any(want), name
            continue
        scale = max(float(np.abs(want).max()), 1e-6)
        assert got is not None, name
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=GRAD_RTOL, err_msg=name)
        if np.abs(want).max() > 0:
            reached.add(name.split(".")[0])
    return reached


@pytest.mark.parametrize("case", list(CASES))
def test_conditional_loss_and_gradients_match_jax(params, case):
    model_over, ns2_over, prompt_over = CASES[case]
    batch = _batch(1, [T_X, T_X - 2])
    times, noise = _draws(2)
    (_, losses_j), grads_j = _jax_value_and_grad(_jax_ns2(model_over, ns2_over, prompt_over))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(times),
        jnp.asarray(noise))

    ns2_t = _port(params, model_over, ns2_over, prompt_over)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = ns2_t(tensors.pop("audio"), **tensors, times=t(times), noise=t(noise))
    assert set(losses) == set(losses_j) == {"loss", "diffusion", "duration", "pitch", "align"}
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(losses_j[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert float(losses["pitch"]) > 0 and float(losses["align"]) > 0
    losses["loss"].backward()
    reached = _compare_grads(ns2_t, grads_j)
    assert reached == {"model", "phoneme_enc", "prompt_enc", "duration_pitch", "aligner",
                       "pitch_emb"}


def test_trainer_step_on_dict_batches_matches_jax(params, tmp_path):
    """One optimizer step (clip, Adam) on a dict batch with uneven
    text_lens, the module in eval mode (no dropout, no CFG drop), against
    the JAX Trainer's optimizer on `jax.value_and_grad`'s gradients."""
    batch = _batch(3, [T_X, 2])
    times, noise = _draws(4)
    common = dict(train_batch_size=B, lr=1e-3, max_grad_norm=0.5, train_num_steps=2)
    ns2_j = _jax_ns2()
    (loss_j, _), grads_j = _jax_value_and_grad(ns2_j)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(times),
        jnp.asarray(noise))
    jtrainer = JTrainer(ns2_j, batches=iter([]), results_folder=str(tmp_path / "jax"),
                        mesh=make_mesh(n_data=1, devices=jax.devices()[:1]), **common)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    updates, _ = jtrainer.optimizer.update(grads_j, jtrainer.optimizer.init(p), p)
    p = numpy_tree(optax.apply_updates(p, updates))

    ns2_t = _port(params)
    with pytest.warns(UserWarning, match="head_activation='relu'"):
        trainer = Trainer(ns2_t, batches=iter([]), results_folder=str(tmp_path / "port"),
                          **common)
    trainer.draw = lambda audio: (t(times), t(noise))
    assert trainer.draw_cond_drop(B) is None  # eval mode: no CFG drop
    metrics = trainer.train_step(batch)
    assert set(metrics) == {"loss", "diffusion", "duration", "pitch", "align"}
    assert metrics["loss"] == pytest.approx(float(loss_j), rel=LOSS_RTOL)
    # Adam moves a parameter by ≈ lr·sign(g) on its first step, so an entry
    # whose gradient is rounding noise may step either way: those (below
    # 1e-3 of their tensor's largest) are held to lr, the rest to 1e-6
    noisy = load_jax_params(jax.tree_util.tree_map(
        lambda g: (np.abs(g) < 1e-3 * np.abs(g).max()).astype(np.float32), numpy_tree(grads_j)))
    named = dict(ns2_t.named_parameters())
    for name, want in load_jax_params(p).items():
        diff = np.abs(named[name].detach().numpy() - want.numpy())
        ill = noisy[name].numpy().astype(bool)
        assert diff[~ill].max(initial=0.0) <= 1e-6, name
        assert diff[ill].max(initial=0.0) <= 1e-3, name


def test_trainer_trains_and_samples_the_held_back_pair(params, tmp_path):
    """train() on dict batches in training mode (dropout, the random CFG
    drop): finite losses, a checkpoint, and a milestone sample speaking
    the (prompt, text) pair held back from the first batch."""
    ns2_t = _port(params).train()
    batches = iter([_batch(5, [T_X, 3]), _batch(6, [4, T_X])])
    with pytest.warns(UserWarning, match="PARITY"):
        trainer = Trainer(ns2_t, batches=batches, train_batch_size=B, train_num_steps=1,
                          save_and_sample_every=1, sample_length=6,
                          results_folder=str(tmp_path))
    masks = trainer.draw_cond_drop(64)
    assert masks is not None and len(masks) == 2 and not torch.equal(*masks)
    trainer.train(log_every=1)
    first = _batch(5, [T_X, 3])
    assert set(trainer._holdback) == {"text", "text_lens", "prompt"}
    assert np.array_equal(trainer._holdback["prompt"], first["prompt"][:1])
    assert (tmp_path / "model-1.ckpt").exists()
    from naturalspeech2_tpu_torch.data import load_audio

    wav, sr = load_audio(tmp_path / "sample-1.wav")
    assert sr == 24000 and wav.shape == (6 * 320,) and np.isfinite(wav).all()


def test_evaluate_dict_batches_is_repeatable(params, tmp_path):
    """evaluate() on a dict batch in training mode: the loss's draws and
    the dropout are fixed per call, so two calls agree."""
    ns2_t = _port(params).train()
    batch = _batch(7, [T_X, 4])
    trainer = Trainer(ns2_t, batches=iter([]), train_batch_size=B,
                      val_batches=iter([batch, batch]), results_folder=str(tmp_path))
    first, second = trainer.evaluate(), trainer.evaluate()
    assert set(first) == {"val_loss", "val_diffusion", "val_duration", "val_pitch", "val_align"}
    assert first == second and np.isfinite(list(first.values())).all()
