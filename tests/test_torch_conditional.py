"""Port parity for conditional zero-shot TTS sampling, against the JAX
package on the same weights (every leaf jittered) and numpy inputs:
`Model(condition_on_prompt=True)` with both forms of the drop mask, the
batch-doubled CFG forward with and without its std rescale,
`conditioning_for_sample` (explicit durations and pitch, and the float
predictions), and a 3-step conditional `sample()` with and without
`cfg_interval`, from JAX's starting noise.

The denoiser's resampled prompt has 8 latents and the sample 16 frames,
so the JAX side takes its Pallas kernels (interpret mode) for the cross
block (K2b), which it gates on multiples of 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.aligner import AlignerNet as JAlignerNet
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.models.denoiser import forward_with_cond_scale as j_forward_with_cond_scale
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params, sample
from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale

from torch_parity import assert_close, jitter, normal, numpy_tree, t

DIM, B, T_X, LENGTH, STEPS = 16, 2, 6, 16, 3
KEY = jax.random.PRNGKey(7)
MODEL_CFG = dict(dim=DIM, depth=2, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                 condition_on_prompt=True, dim_prompt=24, num_latents_m=8, resampler_depth=1,
                 cond_drop_prob=0.25)
CODEC_CFG = dict(codebook_dim=DIM, channels=4, num_quantizers=2, codebook_size=16)
NS2_CFG = dict(
    timesteps=1000, num_phoneme_tokens=20, duration_pitch_dim=24, aligner_dim_in=8,
    aligner_dim_hidden=24, aligner_attn_channels=8, pitch_emb_pp_hidden_dim=24,
    phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, depth=1, heads=2, dim_head=8),
    prompt_enc_kwargs=dict(dims=(24, 24), depth=1, heads=2, dim_head=8),
    duration_pitch_kwargs=dict(dim_hidden=24, depth=1, heads=2, dim_head=8,
                               dim_encoded_prompts=24),
)
# the denoiser and the conditioning stack: f32 products of ≤ 96 terms in
# another order, through two transformer layers and a resampler
ATOL = 1e-4
# three guided network evaluations chained through the DDIM update (its
# 1/σ factors amplify per-step differences), then the codec decode
SAMPLE_ATOL = 1e-3


@pytest.fixture(scope="module")
def pair():
    """(JAX ns2, its jittered variables, the port loaded from them, inputs)."""
    rng = np.random.default_rng(0)
    prompt = rng.uniform(-1, 1, (B, 4 * 320)).astype(np.float32)
    text = rng.integers(0, 20, (B, T_X)).astype(np.int32)
    text[1, -1] = -1  # a pad id
    # explicit durations of 1-6 frames (fractions truncate) and pitch of
    # 80-300 Hz: the ReLU duration head of random weights gives mostly 0
    duration = (rng.integers(1, 7, (B, T_X)) + rng.uniform(0, 0.9, (B, T_X))).astype(np.float32)
    pitch = rng.uniform(80, 300, (B, T_X)).astype(np.float32)

    jcodec = JSoundStream(**CODEC_CFG, use_pallas_rvq=False)
    jmodel = JModel(**MODEL_CFG)
    ns2_j = jns2.NaturalSpeech2(model=jmodel, codec=jcodec, **NS2_CFG)
    cond_vars = ns2_j.init(KEY, jnp.asarray(prompt), jnp.asarray(text), None, LENGTH,
                           jnp.asarray(pitch), jnp.asarray(duration),
                           method=ns2_j.conditioning_for_sample)
    params = dict(cond_vars["params"])
    prompt_enc, cond, _ = ns2_j.apply(cond_vars, jnp.asarray(prompt), jnp.asarray(text), None,
                                      LENGTH, jnp.asarray(pitch), jnp.asarray(duration),
                                      method=ns2_j.conditioning_for_sample)
    params["model"] = jmodel.init(KEY, jnp.zeros((1, LENGTH, DIM)), jnp.zeros((1,)),
                                  prompt=prompt_enc[:1], cond=cond[:1])["params"]
    params["codec"] = jcodec.init(KEY, jnp.zeros((1, 640)))["params"]
    params["aligner"] = {"aligner": JAlignerNet(dim_in=8, dim_hidden=24, attn_channels=8).init(
        KEY, jnp.zeros((1, 5, 8)), jnp.zeros((1, 3, 24)))["params"]}
    params = jitter(numpy_tree(params), 3)

    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), **NS2_CFG)
    ns2_t.load_state_dict(load_jax_params(params), strict=True)
    ns2_t.eval()  # as inference runs it; sample() itself needs no eval()
    inputs = dict(prompt=prompt, text=text, duration=duration, pitch=pitch)
    return ns2_j, {"params": params}, ns2_t, inputs


def _denoiser_inputs(seed, n_cond=20):
    rng = np.random.default_rng(seed)
    return (normal(rng, B, LENGTH, DIM), rng.uniform(0, 1, B).astype(np.float32),
            normal(rng, B, 5, 24), normal(rng, B, n_cond, 24))


DROPS = {"mask": np.array([True, False]),
         "pair": (np.array([False, True]), np.array([True, False]))}


@pytest.mark.parametrize("drop", DROPS.values(), ids=DROPS.keys())
def test_model_forward_matches_jax(pair, drop):
    ns2_j, variables, ns2_t, _ = pair
    x, times, prompt, cond = _denoiser_inputs(1, n_cond=20 if isinstance(drop, tuple) else 11)
    jdrop = tuple(map(jnp.asarray, drop)) if isinstance(drop, tuple) else jnp.asarray(drop)
    tdrop = tuple(map(torch.from_numpy, drop)) if isinstance(drop, tuple) else torch.from_numpy(drop)
    expected = ns2_j.model.apply({"params": variables["params"]["model"]}, jnp.asarray(x),
                                 jnp.asarray(times), prompt=jnp.asarray(prompt),
                                 cond=jnp.asarray(cond), cond_drop_mask=jdrop)
    with torch.no_grad():
        actual = ns2_t.model(t(x), t(times), prompt=t(prompt), cond=t(cond), cond_drop_mask=tdrop)
    assert_close(actual, expected, atol=ATOL)


@pytest.mark.parametrize("cond_scale, cfg_rescale", [(1.0, 0.0), (3.0, 0.0), (3.0, 0.7)])
def test_forward_with_cond_scale_matches_jax(pair, cond_scale, cfg_rescale):
    ns2_j, variables, ns2_t, _ = pair
    x, times, prompt, cond = _denoiser_inputs(2)
    expected = j_forward_with_cond_scale(
        ns2_j.model, {"params": variables["params"]["model"]}, jnp.asarray(x), jnp.asarray(times),
        prompt=jnp.asarray(prompt), cond=jnp.asarray(cond), cond_scale=cond_scale,
        cfg_rescale=cfg_rescale)
    with torch.no_grad():
        actual = forward_with_cond_scale(ns2_t.model, t(x), t(times), prompt=t(prompt),
                                         cond=t(cond), cond_scale=cond_scale,
                                         cfg_rescale=cfg_rescale)
    assert_close(actual, expected, atol=ATOL)


def test_conditioning_for_sample_matches_jax(pair):
    ns2_j, variables, ns2_t, inputs = pair
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    # explicit durations and pitch: the same integer frame layout
    expected = ns2_j.apply(variables, jin["prompt"], jin["text"], None, LENGTH, jin["pitch"],
                           jin["duration"], method=ns2_j.conditioning_for_sample)
    actual = ns2_t.conditioning_for_sample(
        t(inputs["prompt"]), torch.from_numpy(inputs["text"]).long(), None, LENGTH,
        t(inputs["pitch"]), t(inputs["duration"]))
    for got, want in zip(actual, expected):
        assert_close(got, want, atol=ATOL)
    assert np.abs(np.asarray(expected[1])).max() > 0.1  # the frames carry text

    # the float predictions, compared before they become integers
    def predict(mdl, prompt, text):
        prompt_enc = mdl.prompt_enc(mdl.process_prompt(prompt), deterministic=True)
        return mdl.duration_pitch(mdl.phoneme_enc(text, deterministic=True), prompt_enc,
                                  deterministic=True)

    want = ns2_j.apply(variables, jin["prompt"], jin["text"], method=predict)
    with torch.no_grad():
        prompt_enc = ns2_t.prompt_enc(ns2_t.process_prompt(t(inputs["prompt"])))
        got = ns2_t.duration_pitch(
            ns2_t.phoneme_enc(torch.from_numpy(inputs["text"]).long()), prompt_enc)
    for g, w in zip(got, want):
        assert_close(g, w, atol=ATOL)
    _, _, duration = ns2_t.conditioning_for_sample(t(inputs["prompt"]),
                                                   torch.from_numpy(inputs["text"]).long())
    assert_close(duration, want[0], atol=ATOL)


@pytest.mark.parametrize("options", [{"mask_phoneme_encoder": True}, {"pitch_space": "hz"}],
                         ids=["masked_phoneme_encoder", "pitch_in_hz"])
def test_conditioning_options_match_jax(pair, options):
    """The same weights under the options that change no parameter: the
    phoneme encoder masked by text_lens (clamped to the width), and a pitch
    trunk read in Hz rather than log1p(Hz)."""
    ns2_j, variables, ns2_t, inputs = pair
    ns2_j = ns2_j.clone(**options)
    port = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), **NS2_CFG, **options)
    port.load_state_dict(ns2_t.state_dict(), strict=True)
    text_lens = np.array([4, T_X + 3], np.int32)
    expected = ns2_j.apply(variables, jnp.asarray(inputs["prompt"]), jnp.asarray(inputs["text"]),
                           jnp.asarray(text_lens), LENGTH, None, jnp.asarray(inputs["duration"]),
                           method=ns2_j.conditioning_for_sample)
    actual = port.conditioning_for_sample(
        t(inputs["prompt"]), torch.from_numpy(inputs["text"]).long(),
        torch.from_numpy(text_lens), LENGTH, None, t(inputs["duration"]))
    for got, want in zip(actual, expected):
        assert_close(got, want, atol=ATOL)


@pytest.mark.parametrize("interval", [None, (0.5, 0.9)], ids=["every_step", "cfg_interval"])
def test_conditional_sample_matches_jax(pair, interval):
    ns2_j, variables, ns2_t, inputs = pair
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    kwargs = dict(length=LENGTH, timesteps=STEPS, cond_scale=3.0, cfg_rescale=0.5,
                  cfg_interval=interval)
    expected = jns2.sample(ns2_j, variables, KEY, prompt=jin["prompt"], text=jin["text"],
                           pitch=jin["pitch"], duration=jin["duration"], **kwargs)
    noise = t(jax.random.normal(KEY, (B, LENGTH, DIM)))
    audio = sample(ns2_t, prompt=t(inputs["prompt"]), text=torch.from_numpy(inputs["text"]).long(),
                   pitch=t(inputs["pitch"]), duration=t(inputs["duration"]), noise=noise, **kwargs)
    assert audio.shape == (B, LENGTH * 320) and torch.isfinite(audio).all()
    assert_close(audio, expected, atol=SAMPLE_ATOL)


def test_conditional_sample_bf16_matches_jax(pair):
    """The guided conditional `sample(dtype=torch.bfloat16)` against JAX's
    `sample(dtype=jnp.bfloat16)`: the conditioning in f32, prompt_enc and
    cond cast once, the denoiser (K1, K2, K2b, K3, the resampler's K4) in
    bf16 on both sides. Correlation ≥ 0.99 with JAX's bf16 sample, ≥ 0.98
    with the port's f32 one."""
    ns2_j, variables, ns2_t, inputs = pair
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    kwargs = dict(length=LENGTH, timesteps=STEPS, cond_scale=3.0)
    expected = np.asarray(jns2.sample(ns2_j, variables, KEY, prompt=jin["prompt"],
                                      text=jin["text"], pitch=jin["pitch"],
                                      duration=jin["duration"], dtype=jnp.bfloat16, **kwargs))
    tin = dict(prompt=t(inputs["prompt"]), text=torch.from_numpy(inputs["text"]).long(),
               pitch=t(inputs["pitch"]), duration=t(inputs["duration"]),
               noise=t(jax.random.normal(KEY, (B, LENGTH, DIM))), **kwargs)
    audio = sample(ns2_t, dtype=torch.bfloat16, **tin)
    assert audio.dtype == torch.float32 and audio.shape == (B, LENGTH * 320)
    assert torch.isfinite(audio).all()
    f32 = sample(ns2_t, **tin)
    corr = lambda a, b: np.corrcoef(np.ravel(a), np.ravel(b))[0, 1]  # noqa: E731
    assert corr(audio.numpy(), expected) >= 0.99
    assert corr(audio.numpy(), f32.numpy()) >= 0.98


def test_sample_runs_without_dropout_in_training_mode(pair):
    ns2_t, inputs = pair[2], pair[3]
    args = dict(prompt=t(inputs["prompt"]), text=torch.from_numpy(inputs["text"]).long(),
                length=8, timesteps=2, cond_scale=2.0)
    ns2_t.train()
    try:
        a = sample(ns2_t, generator=torch.Generator().manual_seed(0), **args)
        assert all(m.training for m in ns2_t.modules())  # each mode restored
    finally:
        ns2_t.eval()
    b = sample(ns2_t, generator=torch.Generator().manual_seed(0), **args)
    assert torch.equal(a, b)


def test_outside_the_slice_raises(pair):
    ns2_t, inputs = pair[2], pair[3]
    with pytest.raises(AssertionError, match="tokenizer="):  # strings need ns2.tokenizer
        sample(ns2_t, length=8, prompt=t(inputs["prompt"]), text=["hello world"])
    with pytest.raises(ValueError, match="prompt= and text="):  # conditional training's inputs
        ns2_t(torch.zeros(B, 640))
    with pytest.raises(ValueError, match="prompt= and text="):
        sample(ns2_t, length=8, text=torch.zeros(B, 3, dtype=torch.long))
