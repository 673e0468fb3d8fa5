"""Port parity for kernel K3: the plain feed-forward block against the JAX
XLA twin and the Pallas kernel (interpret mode on the CPU), and the port's
`FeedForward` against the flax module's fused pre-norm residual route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.blocks import FeedForward as JFeedForward
from naturalspeech2_tpu.ops.ff_block_kernel import ff_block_xla, fused_ff_block
from naturalspeech2_tpu_torch.models.blocks import FeedForward
from naturalspeech2_tpu_torch.ops.ff_block_kernel import ff_block, ff_block_torch

from torch_parity import assert_close, jitter, normal, numpy_tree, t

B, N, DM = 2, 64, 32
INNER = int(DM * 4 * 2 / 3)  # 85, as the flagship's 341 is not a round width
# f32 matmuls over up to 3 x 85 terms, summed in another order; outputs O(1)
ATOL = 2e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (
        normal(rng, B, N, DM),
        1 + normal(rng, B, DM, scale=0.1),
        normal(rng, B, DM, scale=0.1),
        normal(rng, DM, 2 * INNER, scale=DM**-0.5),
        normal(rng, 2 * INNER, scale=0.1),
        normal(rng, 3, INNER, INNER, scale=(3 * INNER) ** -0.5),
        normal(rng, INNER, scale=0.1),
        normal(rng, INNER, DM, scale=INNER**-0.5),
        normal(rng, DM, scale=0.1),
    )


def test_plain_block_matches_xla_twin():
    x, g, b, w1, b1, wc, bc, w2, b2 = _inputs()
    split = (w1[:, :INNER], b1[:INNER], w1[:, INNER:], b1[INNER:])
    expected = ff_block_xla(
        *(jnp.asarray(a) for a in (x, g, b, *split, wc, bc, w2, b2)), approximate=True
    )
    actual = ff_block_torch(*(t(a) for a in (x, g, b, *split, wc, bc, w2, b2)))
    assert_close(actual, expected, atol=ATOL)


def test_wrapper_matches_pallas_kernel():
    args = _inputs(1)
    expected = fused_ff_block(*(jnp.asarray(a) for a in args), approximate=True)
    assert_close(ff_block(*(t(a) for a in args)), expected, atol=ATOL)
    assert ff_block.launches == 0


def test_wrapper_never_falls_back_off_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        ff_block(*(t(a).to("meta") for a in _inputs()))


def test_feedforward_module_matches_flax_fused_route():
    x, g, b = _inputs(2)[:3]
    mod = JFeedForward(DM, causal_conv=True, use_fused=True)
    pre_norm = (jnp.asarray(g), jnp.asarray(b))
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), pre_norm=pre_norm, residual=True)
    params = jitter(numpy_tree(params["params"]), 3)
    expected = mod.apply({"params": params}, jnp.asarray(x), pre_norm=pre_norm, residual=True)

    port = FeedForward(DM)
    port.load_state_dict({
        "w1": t(params["Dense_0"]["kernel"]), "b1": t(params["Dense_0"]["bias"]),
        "wc": t(params["CausalConv1d_0"]["Conv_0"]["kernel"]),
        "bc": t(params["CausalConv1d_0"]["Conv_0"]["bias"]),
        "w2": t(params["Dense_1"]["kernel"]), "b2": t(params["Dense_1"]["bias"]),
    })
    with torch.no_grad():
        assert_close(port(t(x), t(g), t(b)), expected, atol=ATOL)
