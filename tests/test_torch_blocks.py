"""Port parity: the sinusoidal time embedding, RMSNorm, adaptive RMSNorm
and CausalConv1d against the flax modules of `naturalspeech2_tpu/models/blocks.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import blocks as jb
from naturalspeech2_tpu_torch.models import blocks as tb

from torch_parity import assert_close, jitter, normal, numpy_tree, t

# one f32 matmul or reduction of a few dozen terms, summed in another order
ATOL = 1e-5


def test_sinusoidal_pos_emb():
    rng = np.random.default_rng(0)
    times = rng.uniform(size=(5,)).astype(np.float32)
    mod = jb.LearnedSinusoidalPosEmb(16)
    params = jitter(numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(times))["params"]), 1)
    expected = mod.apply({"params": params}, jnp.asarray(times))

    port = tb.LearnedSinusoidalPosEmb(16)
    port.load_state_dict({"weights": t(params["weights"])})
    out = port(t(times))
    assert out.shape == (5, 17)
    assert_close(out, expected, atol=ATOL)


def test_rmsnorm():
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 7, 24)
    mod = jb.RMSNorm(24)
    params = jitter(numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 2)
    expected = mod.apply({"params": params}, jnp.asarray(x))

    port = tb.RMSNorm(24)
    port.load_state_dict({"gamma": t(params["gamma"])})
    assert_close(port(t(x)), expected, atol=ATOL)
    # including an all-zero row: the 1e-12 floor, not a NaN
    zeros = np.zeros((1, 3, 24), np.float32)
    assert_close(port(t(zeros)), mod.apply({"params": params}, jnp.asarray(zeros)), atol=0)


def test_ada_rmsnorm():
    rng = np.random.default_rng(2)
    x, gamma, beta = normal(rng, 3, 9, 32), 1 + normal(rng, 3, 32, scale=0.1), normal(rng, 3, 32, scale=0.1)
    expected = jb.ada_rmsnorm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 32)
    assert_close(tb.ada_rmsnorm(t(x), t(gamma), t(beta), 32), expected, atol=ATOL)


@pytest.mark.parametrize("kernel_size, dilation", [(3, 1), (3, 4), (1, 1)])
def test_causal_conv1d(kernel_size, dilation):
    rng = np.random.default_rng(3)
    x = normal(rng, 2, 19, 12)
    mod = jb.CausalConv1d(10, kernel_size, dilation=dilation)
    params = jitter(numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 3)
    expected = mod.apply({"params": params}, jnp.asarray(x))

    port = tb.CausalConv1d(12, 10, kernel_size, dilation=dilation)
    port.load_state_dict({
        "conv.weight": t(params["Conv_0"]["kernel"]).permute(2, 1, 0),
        "conv.bias": t(params["Conv_0"]["bias"]),
    })
    out = port(t(x))
    assert out.shape == (2, 19, 10)
    assert_close(out, expected, atol=ATOL)
    # causal: the first output frames do not see a change at the end
    x2 = x.copy()
    x2[:, -1] += 1.0
    assert torch.equal(port(t(x2))[:, :-1], out[:, :-1])


@pytest.mark.parametrize("kwargs", [{"gelu_approximate": False}])
def test_feedforward_options_outside_the_slice_raise(kwargs):
    """Once refused, now ported: the causal-conv block with exact GELU
    runs unfused (the JAX package fuses only the tanh GELU), and matches
    the JAX block at a shape whose gate would take K3."""
    rng = np.random.default_rng(11)
    x, gamma, beta = normal(rng, 2, 16, 16), 1 + normal(rng, 2, 16, scale=0.1), normal(rng, 2, 16)
    mod = jb.FeedForward(16, causal_conv=True, use_fused=True, **kwargs)
    pre = (jnp.asarray(gamma), jnp.asarray(beta))
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), pre_norm=pre, residual=True)
    params = jitter(numpy_tree(params["params"]), 4)
    expected = mod.apply({"params": params}, jnp.asarray(x), pre_norm=pre, residual=True)

    port = tb.FeedForward(16, causal_conv=True, **kwargs)
    port.load_state_dict({
        "w1": t(params["Dense_0"]["kernel"]), "b1": t(params["Dense_0"]["bias"]),
        "wc": t(params["CausalConv1d_0"]["Conv_0"]["kernel"]),
        "bc": t(params["CausalConv1d_0"]["Conv_0"]["bias"]),
        "w2": t(params["Dense_1"]["kernel"]), "b2": t(params["Dense_1"]["bias"]),
    })
    assert not port.fused
    with torch.no_grad():
        assert_close(port(t(x), t(gamma), t(beta)), expected, atol=ATOL)
