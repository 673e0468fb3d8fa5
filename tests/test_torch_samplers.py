"""Port parity for the few-step samplers: `dpmpp_sample` (DPM-Solver++(2M))
and `ddpm_sample` against the JAX package's, from the same starting noise
(drawn by JAX, `jax.random.normal(key, shape)`) and, for DDPM, the same
noise at every step (rebuilt from `split(key)` / `split(key, T)` as
`ddpm_sample` draws it).

The samplers' arithmetic is held on an analytic denoiser, the same
function in both frameworks, over objectives, time shifts, step counts
and a schedule that trips each of DPM++'s first-order fallbacks; then
`sample()` with each sampler on the tiny denoiser and codec."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.ops import schedules as jsched
from naturalspeech2_tpu_torch import (
    Model,
    NaturalSpeech2,
    SoundStream,
    ddpm_sample,
    dpmpp_sample,
    load_jax_params,
    sample,
)
from naturalspeech2_tpu_torch.ops import schedules as tsched

from torch_parity import assert_close, jitter, numpy_tree, t

SHAPE = (2, 6, 4)
KEY = jax.random.PRNGKey(11)
# as tests/test_torch_sample.py holds DDIM: the same f32 arithmetic in
# another order, chained through up to 8 steps whose 1/σ and 1/α factors
# amplify the differences
ATOL = 2e-4
W = np.linspace(-1.5, 1.5, SHAPE[-1]).astype(np.float32)


def _denoiser(xp, objective, gamma, x0_of):
    """The model output under ``objective`` of a denoiser whose clean
    estimate is x̂₀ = ``x0_of(audio, times)`` (bounded), in the framework
    ``xp`` (jnp or torch), so that every objective's sample stays O(1)."""

    def fn(audio, times, x_self_cond=None):
        x0 = x0_of(audio, times)
        if x_self_cond is not None:
            x0 = x0 + 0.3 * xp.sin(x_self_cond)
        g = gamma(times)[:, None, None]
        alpha, sigma = xp.sqrt(g), xp.sqrt(1.0 - g)
        if objective == "x0":
            return x0
        if objective == "eps":
            return (audio - alpha * x0) / sigma
        return (alpha * audio - x0) / sigma  # v

    return fn


def _x0_jax(audio, times):
    return jnp.tanh(audio * W + 0.5 * times[:, None, None])


def _x0_torch(audio, times):
    return torch.tanh(audio * torch.from_numpy(W) + 0.5 * times[:, None, None])


def _denoise_torch(audio, times, x_self_cond=None):
    return _denoiser(torch, "v", tsched.sigmoid_schedule, _x0_torch)(audio, times, x_self_cond)


def _ddpm_noise(key, steps, shape):
    """(starting noise, step noise [steps, *shape]) as `ddpm_sample` draws them."""
    key, init_key = jax.random.split(key)
    step_keys = jax.random.split(key, steps)
    return (t(jax.random.normal(init_key, shape)),
            t(np.stack([np.asarray(jax.random.normal(k, shape)) for k in step_keys])))


def _run(name, steps, objective, time_difference, schedule=("sigmoid", {}), self_cond=False):
    sched, kwargs = schedule
    jgamma = lambda x: jsched.get_schedule(sched)(x, **kwargs)  # noqa: E731
    tgamma = lambda x: tsched.get_schedule(sched)(x, **kwargs)  # noqa: E731
    cfg = dict(timesteps=steps, objective=objective, time_difference=time_difference,
               self_cond=self_cond)
    jfn = {"dpmpp": jns2.dpmpp_sample, "ddpm": jns2.ddpm_sample}[name]
    expected = jfn(_denoiser(jnp, objective, jgamma, _x0_jax), KEY, SHAPE,
                   gamma_schedule=jgamma, **cfg)
    denoise = _denoiser(torch, objective, tgamma, _x0_torch)
    if name == "ddpm":
        noise, step_noise = _ddpm_noise(KEY, steps, SHAPE)
        actual = ddpm_sample(denoise, SHAPE, gamma_schedule=tgamma, noise=noise,
                             step_noise=step_noise, device="cpu", **cfg)
    else:
        actual = dpmpp_sample(denoise, SHAPE, gamma_schedule=tgamma,
                              noise=t(jax.random.normal(KEY, SHAPE)), device="cpu", **cfg)
    assert actual.shape == SHAPE and torch.isfinite(actual).all()
    assert_close(actual, expected, atol=ATOL)
    return actual


CASES = [(steps, "v", 0.0) for steps in (1, 2, 3, 8)] + [
    (3, "eps", 0.0), (3, "x0", 0.0), (8, "eps", 0.0), (8, "x0", 0.0),
    (3, "v", 0.05), (8, "v", 0.05), (8, "eps", 0.05), (8, "x0", 0.05)]


@pytest.mark.parametrize("name", ["dpmpp", "ddpm"])
@pytest.mark.parametrize("steps, objective, time_difference", CASES)
def test_sampler_matches_jax(name, steps, objective, time_difference):
    _run(name, steps, objective, time_difference)


@pytest.mark.parametrize("name", ["dpmpp", "ddpm"])
def test_sampler_fallback_schedule_matches_jax(name):
    """γ = max(1 − t, 0.2): λ is flat for t ≥ 0.8, so DPM++'s step at t =
    0.875 has h_prev = 0 (the 1e-8 fallback), and γ(0) = 1 makes the last
    step's h infinite (the isfinite fallback) and DDPM's last noise zero."""
    schedule = ("linear", {"clip_min": 0.2})
    gamma = tsched.simple_linear_schedule(torch.tensor([1.0, 0.875, 0.0]), clip_min=0.2)
    lam = 0.5 * tsched.gamma_to_log_snr(gamma)
    assert lam[1] - lam[0] <= 1e-8 and not torch.isfinite(lam[2])
    _run(name, 8, "v", 0.0, schedule)


@pytest.mark.parametrize("name", ["dpmpp", "ddpm"])
def test_sampler_self_cond_matches_jax(name):
    """x_self_cond is the previous step's x̂₀, zeros at the first step."""
    _run(name, 3, "v", 0.0, self_cond=True)


def test_dpmpp_one_step_is_ddim():
    """Without history DPM++ takes the first-order step, which is DDIM's."""
    from naturalspeech2_tpu_torch import ddim_sample

    noise = t(jax.random.normal(KEY, SHAPE))
    cfg = dict(timesteps=1, gamma_schedule=tsched.sigmoid_schedule, noise=noise, device="cpu")
    assert_close(dpmpp_sample(_denoise_torch, SHAPE, **cfg),
                 ddim_sample(_denoise_torch, SHAPE, **cfg).numpy(), atol=1e-6)


def test_ddpm_step_noise_shape_is_checked():
    with pytest.raises(ValueError, match="step_noise"):
        ddpm_sample(_denoise_torch, SHAPE, timesteps=2, gamma_schedule=tsched.sigmoid_schedule,
                    noise=torch.zeros(SHAPE), step_noise=torch.zeros(3, *SHAPE), device="cpu")


def test_ddpm_draws_from_the_generator():
    cfg = dict(timesteps=3, gamma_schedule=tsched.sigmoid_schedule, device="cpu")
    draw = lambda seed: ddpm_sample(_denoise_torch, SHAPE,  # noqa: E731
                                    generator=torch.Generator().manual_seed(seed), **cfg)
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


# sample() with each sampler on the tiny denoiser and codec of
# tests/test_torch_sample.py
MODEL_CFG = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16)
B, LENGTH, STEPS = 2, 4, 3


@pytest.fixture(scope="module")
def params():
    jmodel, jcodec = JModel(**MODEL_CFG), JSoundStream(**CODEC_CFG)
    tree = {
        "model": jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                             jnp.zeros((1,)))["params"],
        "codec": jcodec.init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"],
    }
    return jitter(numpy_tree(tree), 3, scale=0.1)


@pytest.mark.parametrize("kwargs", [{"sampler": "dpmpp"}, {"sampler": "ddpm"},
                                    {"use_ddim": False}])
def test_sample_with_sampler_matches_jax(params, kwargs):
    """`NaturalSpeech2(sampler=)` / `use_ddim=False` select the sampler, as
    the JAX `sample` does; the waveform through the codec matches."""
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=JSoundStream(**CODEC_CFG),
                                timesteps=1000, **kwargs)
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), timesteps=1000, **kwargs)
    ns2_t.load_state_dict(load_jax_params(params), strict=True)
    expected = jns2.sample(ns2_j, {"params": params}, KEY, length=LENGTH, batch_size=B,
                           timesteps=STEPS)
    shape = (B, LENGTH, 16)
    if ns2_t.sampler_name == "ddpm":
        noise, step_noise = _ddpm_noise(KEY, STEPS, shape)
        extra = {"noise": noise, "step_noise": step_noise}
    else:
        extra = {"noise": t(jax.random.normal(KEY, shape))}
    audio = sample(ns2_t, length=LENGTH, batch_size=B, timesteps=STEPS, **extra)
    assert audio.shape == (B, LENGTH * 320) and torch.isfinite(audio).all()
    assert_close(audio, expected, atol=ATOL)


def test_step_noise_is_ddpm_only(params):
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), sampler="dpmpp")
    with pytest.raises(ValueError, match="step_noise"):
        sample(ns2_t, length=LENGTH, timesteps=2, step_noise=torch.zeros(2, 1, LENGTH, 16))
