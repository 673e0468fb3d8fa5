"""Port parity for kernel K2: the plain attention block against the JAX XLA
twin and the Pallas kernel (interpret mode on the CPU), and the port's
`Attention` against the flax module's fused pre-norm residual route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.transformer import Attention as JAttention
from naturalspeech2_tpu.ops.attn_block_kernel import attn_block_xla, fused_attn_block
from naturalspeech2_tpu_torch.models.transformer import Attention
from naturalspeech2_tpu_torch.ops.attn_block_kernel import (
    attn_block,
    attn_block_torch,
    split_heads,
)

from torch_parity import assert_close, jitter, normal, numpy_tree, t

B, N, DM, H, DH = 2, 64, 32, 4, 16
SCALE = DH**-0.5
# f32 projections (32 terms) and a softmax over 64 keys, summed in another
# order; outputs are O(1)
ATOL = 2e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (
        normal(rng, B, N, DM),
        1 + normal(rng, B, DM, scale=0.1),
        normal(rng, B, DM, scale=0.1),
        normal(rng, DM, H * DH, scale=DM**-0.5),
        normal(rng, DM, 2 * H * DH, scale=DM**-0.5),
        normal(rng, H * DH, DM, scale=(H * DH) ** -0.5),
    )


def test_plain_block_matches_xla_twin():
    x, g, b, wq, wkv, wo = _inputs()
    heads_j = (
        jnp.asarray(wq).reshape(DM, H, DH).transpose(1, 0, 2),
        *(jnp.asarray(w).reshape(DM, H, DH).transpose(1, 0, 2) for w in np.split(wkv, 2, axis=-1)),
        jnp.asarray(wo).reshape(H, DH, DM),
    )
    expected = attn_block_xla(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), *heads_j, scale=SCALE)
    heads_t = split_heads(t(wq), t(wkv), t(wo), H, DH)
    assert_close(attn_block_torch(t(x), t(g), t(b), *heads_t, scale=SCALE), expected, atol=ATOL)


def test_wrapper_matches_pallas_kernel():
    args = _inputs(1)
    expected = fused_attn_block(*(jnp.asarray(a) for a in args), heads=H, dim_head=DH, scale=SCALE)
    actual = attn_block(*(t(a) for a in args), heads=H, dim_head=DH, scale=SCALE)
    assert_close(actual, expected, atol=ATOL)
    assert attn_block.launches == 0


def test_wrapper_never_falls_back_off_the_cpu():
    args = [t(a).to("meta") for a in _inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        attn_block(*args, heads=H, dim_head=DH, scale=SCALE)


def test_attention_module_matches_flax_fused_route():
    x, g, b = _inputs(2)[:3]
    mod = JAttention(dim=DM, dim_head=DH, heads=H, use_flash=True)
    pre_norm = (jnp.asarray(g), jnp.asarray(b))
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), pre_norm=pre_norm, residual=True)
    params = jitter(numpy_tree(params["params"]), 3)
    expected = mod.apply({"params": params}, jnp.asarray(x), pre_norm=pre_norm, residual=True)

    port = Attention(DM, dim_head=DH, heads=H, use_flash=True)
    port.load_state_dict({k: t(params[k]["kernel"]) for k in ("to_q", "to_kv", "to_out")})
    with torch.no_grad():
        assert_close(port(t(x), t(g), t(b)), expected, atol=ATOL)
