"""Port parity for the training loss: `NaturalSpeech2.forward` on raw audio
(frozen codec encode, K6's plain version) against
`jax.value_and_grad(ns2.apply)` with the same injected times and noise:
the loss and the gradient of every parameter. At n = 8 frames the JAX
module routes through its fused Pallas blocks, at n = 5 through
`ada_rmsnorm` → flash attention and the unfused feed-forward; the port
takes the same route at each n (tests/test_torch_routes.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params

from torch_parity import assert_close, jitter, normal, numpy_tree, t

MODEL_CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=3)
B = 2
# the loss is a mean of O(1) squares through ~20 f32 layers; gradients are
# O(1e-3) to O(1), compared per tensor against its own largest entry
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4


@pytest.fixture(scope="module")
def params():
    jmodel, jcodec = JModel(**MODEL_CFG), JSoundStream(**CODEC_CFG)
    tree = {
        "model": jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), jnp.zeros((1,)))["params"],
        "codec": jcodec.init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"],
    }
    return jitter(numpy_tree(tree), 3, scale=0.1)


@pytest.mark.parametrize(
    "frames, objective, ce_weight",
    [(8, "v", 0.0), (5, "v", 0.0), (5, "eps", 0.0), (8, "x0", 0.0), (5, "v", 0.5)],
    ids=["n8_v", "n5_v", "n5_eps", "n8_x0", "n5_v_rvq_ce"],
)
def test_loss_and_gradients_match_jax(params, frames, objective, ce_weight):
    rng = np.random.default_rng(frames)
    audio = np.tanh(normal(rng, B, frames * 320 + 13))  # trimmed to whole frames
    times = rng.uniform(0.05, 0.95, B).astype(np.float32)
    noise = normal(rng, B, frames, 16)
    knobs = dict(objective=objective, rvq_cross_entropy_loss_weight=ce_weight)

    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=JSoundStream(**CODEC_CFG),
                                timesteps=1000, **knobs)

    def loss_j(p):
        losses = ns2_j.apply({"params": p}, jnp.asarray(audio), times=jnp.asarray(times),
                             noise=jnp.asarray(noise))
        return losses["loss"], losses

    (loss_value, losses_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(params)

    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), timesteps=1000, **knobs)
    ns2_t.load_state_dict(load_jax_params(params), strict=True)
    losses = ns2_t(t(audio), times=t(times), noise=t(noise))
    assert set(losses) == set(losses_j)
    for k in losses:
        assert_close(losses[k], losses_j[k], atol=0, rtol=LOSS_RTOL)
    losses["loss"].backward()

    # the gradient tree maps onto the port's layouts as the param tree does
    expected = load_jax_params(numpy_tree(grads_j))
    named = dict(ns2_t.named_parameters())
    for name, want in expected.items():
        got = named[name].grad
        if name.startswith("model.") or (name == "codec.codebooks" and ce_weight > 0):
            scale = max(float(np.abs(want.numpy()).max()), 1e-6)
            assert got is not None, name
            assert_close(got / scale, want.numpy() / scale, atol=GRAD_RTOL)
        else:  # the frozen codec: zero in JAX, untouched in the port
            assert got is None and not np.any(want.numpy()), name
