"""Port parity for self-conditioning: `Model(self_cond=True)` (the
zero-initialised `to_self_cond` projection of the previous x̂₀, here
jittered off zero) with and without ``x_self_cond``, through
`forward_with_cond_scale`'s doubled batch; the `NaturalSpeech2` loss and
its gradients with the bootstrap forward at ``train_prob_self_cond`` 0 and
1 and on the deterministic path (where JAX's Bernoulli draw is known), and
with mixed rows composed row by row from JAX; `sample()` under each
sampler; and the trainer's draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.models.denoiser import forward_with_cond_scale as jforward_with_cond_scale
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, Trainer, load_jax_params
from naturalspeech2_tpu_torch import sample
from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale

from torch_parity import assert_close, jitter, normal, numpy_tree, t

MODEL_CFG = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                 self_cond=True)
COND_CFG = dict(MODEL_CFG, condition_on_prompt=True, dim_prompt=24, num_latents_m=4,
                resampler_depth=1)
CODEC_CFG = dict(channels=4, codebook_dim=16)
B, N = 2, 8
# the network's f32 sums in another order (tests/test_torch_denoiser.py)
ATOL = 1e-4
# the loss and gradients, as tests/test_torch_cond_train.py holds them
LOSS_RTOL, GRAD_RTOL = 2e-5, 2e-4
# the samplers, as tests/test_torch_sample.py holds DDIM
SAMPLE_ATOL = 2e-4


def _init(cfg, seed, **inputs):
    model = JModel(**cfg)
    x = jnp.zeros((1, N, 16))
    params = model.init(jax.random.PRNGKey(seed), x, jnp.zeros((1,)), **inputs)["params"]
    tree = jitter(numpy_tree(params), seed + 1, scale=0.1)
    assert np.abs(tree["to_self_cond"]["kernel"]).max() > 0
    return model, tree


@pytest.fixture(scope="module")
def uncond():
    return _init(MODEL_CFG, 0)


def _port(cfg, tree):
    port = Model(**cfg)
    port.load_state_dict(load_jax_params(tree), strict=True)
    return port


def test_to_self_cond_starts_at_zero():
    port = Model(**MODEL_CFG)
    assert not port.to_self_cond.weight.any() and not port.to_self_cond.bias.any()


@pytest.mark.parametrize("given", [True, False], ids=["x_self_cond", "none"])
def test_model_matches_jax(uncond, given):
    model, tree = uncond
    rng = np.random.default_rng(1)
    x, sc = normal(rng, B, N, 16), normal(rng, B, N, 16)
    times = rng.uniform(size=B).astype(np.float32)
    kwargs = {"x_self_cond": jnp.asarray(sc)} if given else {}
    expected = model.apply({"params": tree}, jnp.asarray(x), jnp.asarray(times), **kwargs)
    port = _port(MODEL_CFG, tree)
    with torch.no_grad():
        out = port(t(x), t(times), x_self_cond=t(sc) if given else None)
    assert_close(out, expected, atol=ATOL)


def test_guided_forward_doubles_x_self_cond():
    rng = np.random.default_rng(2)
    prompt, cond = normal(rng, B, 5, 24), normal(rng, B, N, 24)
    model, tree = _init(COND_CFG, 4, prompt=jnp.zeros((1, 5, 24)), cond=jnp.zeros((1, N, 24)))
    x, sc = normal(rng, B, N, 16), normal(rng, B, N, 16)
    times = rng.uniform(size=B).astype(np.float32)
    expected = jforward_with_cond_scale(
        model, {"params": tree}, jnp.asarray(x), jnp.asarray(times), prompt=jnp.asarray(prompt),
        cond=jnp.asarray(cond), cond_scale=3.0, x_self_cond=jnp.asarray(sc))
    port = _port(COND_CFG, tree).eval()
    with torch.no_grad():
        out = forward_with_cond_scale(port, t(x), t(times), prompt=t(prompt), cond=t(cond),
                                      cond_scale=3.0, x_self_cond=t(sc))
    assert_close(out, expected, atol=ATOL)


def _jax_loss_grads(tree, latents, times, noise, p, deterministic):
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=None, timesteps=1000,
                                train_prob_self_cond=p)

    def loss_j(params):
        losses = ns2_j.apply({"params": params}, jnp.asarray(latents), times=jnp.asarray(times),
                             noise=jnp.asarray(noise), deterministic=deterministic,
                             rngs={"self_cond": jax.random.PRNGKey(5)})
        return losses["loss"], losses

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))({"model": tree})
    return float(loss), load_jax_params(numpy_tree(grads))


def _inputs(seed, b=B):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, N, 16), rng.uniform(0.05, 0.95, b).astype(np.float32),
            normal(rng, b, N, 16))


def _port_loss_grads(tree, latents, times, noise, p, training, mask=None):
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), timesteps=1000, train_prob_self_cond=p)
    ns2_t.load_state_dict(load_jax_params({"model": tree}), strict=True)
    ns2_t.train(training)
    loss = ns2_t(t(latents), times=t(times), noise=t(noise),
                 self_cond_mask=None if mask is None else torch.tensor(mask))["loss"]
    loss.backward()
    return loss, {n: p.grad for n, p in ns2_t.named_parameters()}


def _hold(loss, grads, loss_j, grads_j):
    assert_close(loss, loss_j, atol=0, rtol=LOSS_RTOL)
    assert set(grads_j) == set(grads)
    for name, want in grads_j.items():
        scale = max(float(np.abs(want.numpy()).max()), 1e-6)
        assert_close(grads[name] / scale, want.numpy() / scale, atol=GRAD_RTOL)


@pytest.mark.parametrize("p, training", [(0.0, True), (1.0, True), (0.9, False)],
                         ids=["p0", "p1", "deterministic"])
def test_loss_and_gradients_match_jax(uncond, p, training):
    """p 0 draws no bootstrap row, p 1 every row; eval mode (JAX's
    deterministic path) conditions every row whatever p."""
    tree = uncond[1]
    latents, times, noise = _inputs(6)
    _hold(*_port_loss_grads(tree, latents, times, noise, p, training),
          *_jax_loss_grads(tree, latents, times, noise, p, deterministic=not training))


def test_mixed_rows_compose_row_by_row(uncond):
    """Row 0 bootstrapped, row 1 not: the per-row mean of JAX's p = 1 loss on
    row 0 and p = 0 loss on row 1 (rows are independent), and so the
    gradients."""
    tree = uncond[1]
    latents, times, noise = _inputs(7)
    loss, grads = _port_loss_grads(tree, latents, times, noise, 0.5, True, mask=[True, False])
    rows = [_jax_loss_grads(tree, latents[i:i + 1], times[i:i + 1], noise[i:i + 1], p, False)
            for i, p in ((0, 1.0), (1, 0.0))]
    loss_j = (rows[0][0] + rows[1][0]) / 2
    grads_j = {k: (rows[0][1][k] + rows[1][1][k]) / 2 for k in rows[0][1]}
    _hold(loss, grads, loss_j, grads_j)


def test_bootstrap_carries_no_gradient(uncond):
    """With every row bootstrapped and `to_self_cond` zeroed, the loss and
    gradients equal those of the model without self-conditioning: no
    gradient flows through the bootstrap x̂₀."""
    tree = dict(uncond[1])
    tree["to_self_cond"] = {k: np.zeros_like(v) for k, v in tree["to_self_cond"].items()}
    latents, times, noise = _inputs(8)
    loss, grads = _port_loss_grads(tree, latents, times, noise, 1.0, True)
    plain = NaturalSpeech2(Model(**{**MODEL_CFG, "self_cond": False}), timesteps=1000)
    plain.load_state_dict({k: v for k, v in load_jax_params({"model": tree}).items()
                           if "to_self_cond" not in k})
    plain_loss = plain(t(latents), times=t(times), noise=t(noise))["loss"]
    plain_loss.backward()
    assert_close(loss, plain_loss.detach().numpy(), atol=1e-6)
    for name, p in plain.named_parameters():
        assert_close(grads[name], p.grad.numpy(), atol=1e-6)


@pytest.fixture(scope="module")
def sample_tree(uncond):
    codec = JSoundStream(**CODEC_CFG).init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"]
    return {"model": uncond[1], "codec": jitter(numpy_tree(codec), 9, scale=0.1)}


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp", "ddpm"])
def test_sample_matches_jax(sample_tree, sampler):
    key, steps, length = jax.random.PRNGKey(3), 3, 4
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=JSoundStream(**CODEC_CFG),
                                timesteps=1000, sampler=sampler)
    expected = jns2.sample(ns2_j, {"params": sample_tree}, key, length=length, batch_size=B,
                           timesteps=steps)
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), timesteps=1000,
                           sampler=sampler)
    ns2_t.load_state_dict(load_jax_params(sample_tree), strict=True)
    shape = (B, length, 16)
    if sampler == "ddpm":
        key, init_key = jax.random.split(key)
        extra = {"noise": t(jax.random.normal(init_key, shape)),
                 "step_noise": t(np.stack([np.asarray(jax.random.normal(k, shape))
                                           for k in jax.random.split(key, steps)]))}
    else:
        extra = {"noise": t(jax.random.normal(key, shape))}
    audio = sample(ns2_t, length=length, batch_size=B, timesteps=steps, **extra)
    assert_close(audio, expected, atol=SAMPLE_ATOL)


def test_trainer_draws_the_bootstrap_rows(tmp_path):
    """The trainer hands the loss a Bernoulli(train_prob_self_cond) row mask
    drawn after the times and noise (none in eval mode), and a step moves
    `to_self_cond`."""
    torch.manual_seed(0)
    ns2 = NaturalSpeech2(Model(**MODEL_CFG), timesteps=1000, train_prob_self_cond=0.5)
    trainer = Trainer(ns2, batches=iter([]), train_batch_size=4, results_folder=str(tmp_path),
                      lr=1e-2, data_max_length_seconds=None)
    audio = torch.zeros(4, N, 16)
    draws = trainer._draws(audio, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(0)
    torch.rand(4, generator=g), torch.randn(4, N, 16, generator=g)
    assert torch.equal(draws["self_cond_mask"], torch.rand(4, generator=g) < 0.5)
    with torch.no_grad():  # off zero, so that its input reaches the loss
        ns2.model.to_self_cond.weight.normal_(0, 0.1)
    before = ns2.model.to_self_cond.weight.detach().clone()
    metrics = trainer.train_step(np.random.default_rng(1).standard_normal((4, N, 16))
                                 .astype(np.float32))
    assert np.isfinite(metrics["loss"])
    assert not torch.equal(before, ns2.model.to_self_cond.weight)
    ns2.eval()
    assert "self_cond_mask" not in trainer._draws(audio)
