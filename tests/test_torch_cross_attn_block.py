"""Port parity for kernel K2b: the plain cross-attention block against the
JAX package's Pallas kernel (interpret mode on the CPU) at ragged shapes,
its gradients against `jax.vjp`, and the port's `Attention` cross route
against the flax module's fused pre-norm residual route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.transformer import Attention as JAttention
from naturalspeech2_tpu.ops.attn_block_kernel import cross_attn_block_xla, fused_cross_attn_block
from naturalspeech2_tpu_torch.models.transformer import Attention
from naturalspeech2_tpu_torch.ops.attn_block_kernel import (
    cross_attn_block,
    cross_attn_block_torch,
)

from torch_parity import assert_close, jitter, normal, numpy_tree, t

H, DH = 4, 16
SCALE = DH**-0.5
# f32 projections over 32 or 24 terms and a softmax over at most 13 keys,
# summed in another order; outputs are O(1)
ATOL = 1e-5
# gradients: the same products through the softmax jacobian, relative to
# each gradient's largest entry
GRAD_RTOL = 1e-4
# (b, n, m, dm, dc): the conditional denoiser's widths shrunk, with n and m
# off every tile (n 37 and m 5, 13) as well as on the 8-multiples the JAX
# package's gate asks for
SHAPES = {"aligned": (2, 24, 8, 32, 32), "ragged": (3, 37, 5, 32, 24),
          "ragged_long_ctx": (2, 19, 13, 24, 32)}


def _inputs(b, n, m, dm, dc, seed=0):
    rng = np.random.default_rng(seed)
    return (
        normal(rng, b, n, dm),
        normal(rng, b, m, dc),
        1 + normal(rng, b, dm, scale=0.1),
        normal(rng, b, dm, scale=0.1),
        normal(rng, dm, H * DH, scale=dm**-0.5),
        normal(rng, dc, 2 * H * DH, scale=dc**-0.5),
        normal(rng, H * DH, dm, scale=(H * DH) ** -0.5),
    )


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_wrapper_matches_pallas_kernel(shape):
    args = _inputs(*shape)
    expected = fused_cross_attn_block(*(jnp.asarray(a) for a in args), heads=H, dim_head=DH,
                                      scale=SCALE)
    actual = cross_attn_block(*(t(a) for a in args), heads=H, dim_head=DH, scale=SCALE)
    assert_close(actual, expected, atol=ATOL)
    assert cross_attn_block.launches == 0


def test_plain_block_matches_xla_twin():
    x, ctx, g, b, wq, wkv, wo = _inputs(*SHAPES["ragged"], seed=1)
    dm, dc = wq.shape[0], wkv.shape[0]
    wk, wv = np.split(wkv, 2, axis=-1)
    heads_j = (jnp.asarray(wq).reshape(dm, H, DH).transpose(1, 0, 2),
               jnp.asarray(wk).reshape(dc, H, DH).transpose(1, 0, 2),
               jnp.asarray(wv).reshape(dc, H, DH).transpose(1, 0, 2),
               jnp.asarray(wo).reshape(H, DH, dm))
    expected = cross_attn_block_xla(*(jnp.asarray(a) for a in (x, ctx, g, b)), *heads_j,
                                    scale=SCALE)
    actual = cross_attn_block_torch(t(x), t(ctx), t(g), t(b),
                                    *(t(w) for w in heads_j),
                                    scale=SCALE)
    assert_close(actual, expected, atol=ATOL)


@pytest.mark.parametrize("shape", [SHAPES["aligned"], SHAPES["ragged"]], ids=["aligned", "ragged"])
def test_gradients_match_jax_vjp(shape):
    args = _inputs(*shape, seed=2)
    cot = normal(np.random.default_rng(3), *args[0].shape)
    _, vjp = jax.vjp(lambda *a: fused_cross_attn_block(*a, heads=H, dim_head=DH, scale=SCALE),
                     *(jnp.asarray(a) for a in args))
    expected = vjp(jnp.asarray(cot))
    leaves = [t(a).requires_grad_() for a in args]
    cross_attn_block(*leaves, heads=H, dim_head=DH, scale=SCALE).backward(t(cot))
    for leaf, want in zip(leaves, expected):
        want = np.asarray(want)
        assert_close(leaf.grad, want, atol=GRAD_RTOL * np.abs(want).max())


def test_wrapper_never_falls_back_off_the_cpu():
    args = [t(a).to("meta") for a in _inputs(*SHAPES["aligned"])]
    with pytest.raises(ValueError, match="CUDA"):
        cross_attn_block(*args, heads=H, dim_head=DH, scale=SCALE)


def test_attention_cross_route_matches_flax_fused_route():
    x, ctx, g, b = _inputs(*SHAPES["aligned"], seed=4)[:4]
    dm = x.shape[-1]
    mod = JAttention(dim=dm, dim_head=DH, heads=H, use_flash=True)
    pre_norm = (jnp.asarray(g), jnp.asarray(b))
    kwargs = dict(context=jnp.asarray(ctx), pre_norm=pre_norm, residual=True)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs)
    params = jitter(numpy_tree(params["params"]), 5)
    expected = mod.apply({"params": params}, jnp.asarray(x), **kwargs)

    port = Attention(dm, dim_head=DH, heads=H, dim_context=ctx.shape[-1], use_flash=True)
    port.load_state_dict({k: t(params[k]["kernel"]) for k in ("to_q", "to_kv", "to_out")})
    with torch.no_grad():
        assert_close(port(t(x), t(g), t(b), context=t(ctx)), expected, atol=ATOL)
