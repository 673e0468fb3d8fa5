"""Port parity for the whole slice: DDIM over the tiny denoiser, and
unconditional `sample()` through the codec decode, with the starting noise
drawn by JAX (`jax.random.normal(key, shape)`, as `ddim_sample` draws it)
and injected into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu_torch import (
    Model,
    NaturalSpeech2,
    SoundStream,
    ddim_sample,
    load_jax_params,
    sample,
)
from naturalspeech2_tpu_torch.models.naturalspeech2 import get_sampling_time_pairs

from torch_parity import assert_close, jitter, numpy_tree, t

MODEL_CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16)
B, LENGTH, STEPS = 2, 4, 3
KEY = jax.random.PRNGKey(7)
# three network evaluations chained through the DDIM update, whose
# 1/σ factors amplify the per-step f32 differences (1e-5 in the
# denoiser), then the codec for the waveform
ATOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    """(JAX ns2, its jittered variables, the port loaded from them)."""
    jmodel, jcodec = JModel(**MODEL_CFG), JSoundStream(**CODEC_CFG)
    params = {
        "model": jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), jnp.zeros((1,)))["params"],
        "codec": jcodec.init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"],
    }
    params = jitter(numpy_tree(params), 3, scale=0.1)
    ns2_j = jns2.NaturalSpeech2(model=jmodel, codec=jcodec, timesteps=1000)
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), timesteps=1000)
    ns2_t.load_state_dict(load_jax_params(params), strict=True)
    return ns2_j, {"params": params}, ns2_t


def _jax_noise():
    return t(jax.random.normal(KEY, (B, LENGTH, 16)))


def test_time_pairs_match_jax():
    assert_close(get_sampling_time_pairs(STEPS), jns2.get_sampling_time_pairs(STEPS), atol=1e-7)


def test_ddim_latents_match_jax(pair):
    ns2_j, variables, ns2_t = pair

    def denoise_j(audio, times):
        return ns2_j.model.apply({"params": variables["params"]["model"]}, audio, times)

    expected = jns2.ddim_sample(
        denoise_j, KEY, (B, LENGTH, 16), timesteps=STEPS, gamma_schedule=ns2_j.gamma_schedule,
    )
    actual = ddim_sample(
        ns2_t.model, (B, LENGTH, 16), timesteps=STEPS, gamma_schedule=ns2_t.gamma_schedule,
        noise=_jax_noise(), device="cpu",
    )
    assert_close(actual, expected, atol=ATOL)


def test_sample_waveform_matches_jax(pair):
    ns2_j, variables, ns2_t = pair
    expected = jns2.sample(ns2_j, variables, KEY, length=LENGTH, batch_size=B, timesteps=STEPS)
    audio = sample(ns2_t, length=LENGTH, batch_size=B, timesteps=STEPS, noise=_jax_noise())
    assert audio.shape == (B, LENGTH * 320)
    assert torch.isfinite(audio).all()
    assert_close(audio, expected, atol=ATOL)


def test_sample_from_generator_is_seeded(pair):
    ns2_t = pair[2]
    draw = lambda seed: sample(  # noqa: E731
        ns2_t, length=LENGTH, batch_size=1, timesteps=2, generator=torch.Generator().manual_seed(seed)
    )
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize(
    "kwargs, error",
    [
        ({"sampler": "ddpm"}, None),
        ({"sampler": "dpmpp"}, None),
        ({"use_ddim": False}, None),
        ({"sampler": "euler"}, ValueError),
        ({"noise_schedule": "quadratic"}, ValueError),
    ],
)
def test_samplers_outside_the_slice_raise(kwargs, error):
    """An unknown sampler or schedule raises; DDPM and DPM++ (ported since,
    held against JAX in tests/test_torch_samplers.py) are selected as the
    JAX module selects them."""
    if error is None:
        ns2 = NaturalSpeech2(Model(**MODEL_CFG), **kwargs)
        assert ns2.sampler_name == kwargs.get("sampler", "ddpm")
        return
    with pytest.raises(error):
        NaturalSpeech2(Model(**MODEL_CFG), **kwargs)


@pytest.mark.parametrize(
    "kwargs", [{"text": ["hi"]}, {"dtype": torch.float16}]
)
def test_sample_options_outside_the_slice_raise(pair, kwargs):
    # text as strings needs ns2.tokenizer, which this model lacks (the JAX
    # package asserts it); the denoiser runs in f32 or bf16 only
    error, match = ((AssertionError, "tokenizer=") if "text" in kwargs
                    else (ValueError, "dtype"))
    with pytest.raises(error, match=match):
        sample(pair[2], length=LENGTH, **kwargs)


def test_sample_bf16_matches_jax(pair):
    """`sample(dtype=torch.bfloat16)` against the JAX package's
    `sample(dtype=jnp.bfloat16)` from the same starting noise: the denoiser
    in bf16 on both sides (the JAX kernels in interpret mode), the DDIM
    update and the codec decode in f32. bf16 rounds at other places in XLA
    on the CPU (excess precision), so the bound is a correlation, ≥ 0.99;
    against the port's f32 sample ≥ 0.98, JAX's own bound
    (tests/test_naturalspeech2.py)."""
    ns2_j, variables, ns2_t = pair
    expected = np.asarray(jns2.sample(ns2_j, variables, KEY, length=LENGTH, batch_size=B,
                                      timesteps=STEPS, dtype=jnp.bfloat16))
    kwargs = dict(length=LENGTH, batch_size=B, timesteps=STEPS, noise=_jax_noise())
    audio = sample(ns2_t, dtype=torch.bfloat16, **kwargs)
    assert audio.dtype == torch.float32 and audio.shape == (B, LENGTH * 320)
    assert torch.isfinite(audio).all()
    assert all(p.dtype == torch.float32 for p in ns2_t.parameters())  # not cast in place
    f32 = sample(ns2_t, **kwargs)
    corr = lambda a, b: np.corrcoef(np.ravel(a), np.ravel(b))[0, 1]  # noqa: E731
    assert corr(audio.numpy(), expected) >= 0.99
    assert corr(audio.numpy(), f32.numpy()) >= 0.98
    assert not torch.equal(audio, f32)  # the bf16 path ran
