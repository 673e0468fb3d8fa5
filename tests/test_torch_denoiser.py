"""Port parity: the tiny denoiser `Model` with the JAX package's default
flags (fused WaveNet, fused attention and feed-forward blocks, whose
Pallas kernels run in interpret mode on the CPU), loaded from the JAX
tree through `load_jax_params`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu_torch import Model, load_jax_params
from naturalspeech2_tpu_torch.models.denoiser import forward_with_cond_scale

from torch_parity import assert_close, jitter, normal, numpy_tree, t

CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2)
B, N = 2, 16
# the whole network, WaveNet (6 blocks) then 2 transformer layers, each
# step an f32 matmul whose sums XLA, Pallas and torch order differently;
# outputs are O(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(0)
    x, times = normal(rng, B, N, CFG["dim"]), rng.uniform(size=(B,)).astype(np.float32)
    model = JModel(**CFG)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(times))["params"]
    return model, jitter(numpy_tree(params), 1, scale=0.1), x, times


def test_forward_matches_jax(jax_model):
    model, params, x, times = jax_model
    expected = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(times))

    port = Model(**CFG)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        out = port(t(x), t(times))
        guided = forward_with_cond_scale(port, t(x), t(times), cond_scale=3.0)
    assert out.shape == (B, N, CFG["dim"])
    assert_close(out, expected, atol=ATOL)
    # unconditional: guidance has nothing to drop, as in the JAX package
    assert torch.equal(guided, out)


def test_scalar_time_broadcasts(jax_model):
    model, params, x, _ = jax_model
    expected = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(0.3, jnp.float32))
    port = Model(**CFG)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        assert_close(port(t(x), torch.tensor(0.3)), expected, atol=ATOL)


@pytest.mark.parametrize(
    "option",
    [
        {"self_cond": True},
        {"use_fused_wavenet": False},
        {"use_flash_attn": False},
        {"gelu_approximate": False},
    ],
)
def test_options_outside_the_slice_raise(jax_model, option):
    """Each option gives the JAX module's output with the same option: ``use_flash_attn=False`` (K2, K2b, K3 off, plain
    attention) and ``gelu_approximate=False`` (exact GELU, unfused
    feed-forward) on the same weights, ``self_cond=True`` on the JAX tree
    with its `to_self_cond` (jittered off its zero init; x_self_cond None,
    so zeros), and ``use_fused_wavenet=False`` on the JAX unfused tree,
    mapped one to one onto the port's `Wavenet`."""
    _, params, x, times = jax_model
    if "self_cond" in option or "use_fused_wavenet" in option:
        params = jitter(numpy_tree(JModel(**CFG, **option).init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(times))["params"]), 2, scale=0.1)
    expected = JModel(**CFG, **option).apply({"params": params}, jnp.asarray(x),
                                             jnp.asarray(times))
    port = Model(**CFG, **option)
    port.load_state_dict(load_jax_params(params, fused_wavenet=option.get("use_fused_wavenet",
                                                                          True)), strict=True)
    with torch.no_grad():
        assert_close(port(t(x), t(times)), expected, atol=ATOL)
