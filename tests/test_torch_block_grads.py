"""Port parity for the kernels' backward passes: the gradients of
`attn_block` (norm and projections recomputed, the core through flash
attention's K4/K5 path), `wavenet_body` and `ff_block` (vjps of their plain
versions), for every input, against `jax.grad` through the JAX package's
`fused_attn_block`, `fused_wavenet_body` and `fused_ff_block` (Pallas
kernels in interpret mode, custom_vjps as on the TPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops.attn_block_kernel import fused_attn_block
from naturalspeech2_tpu.ops.ff_block_kernel import fused_ff_block
from naturalspeech2_tpu.ops.wavenet_kernel import fused_wavenet_body
from naturalspeech2_tpu_torch.ops import flash_attention as fa
from naturalspeech2_tpu_torch.ops.attn_block_kernel import attn_block
from naturalspeech2_tpu_torch.ops.ff_block_kernel import ff_block
from naturalspeech2_tpu_torch.ops.wavenet_kernel import wavenet_body

from torch_parity import assert_close, normal, t

# gradients through f32 products of at most ~100 terms and a softmax over
# 64 keys, summed in another order; gradients are O(1) to O(10)
ATOL = 1e-4
RTOL = 1e-4


def _attn_inputs(rng, b=2, n=40, dm=32, h=4, dh=16):
    return [
        normal(rng, b, n, dm), 1 + normal(rng, b, dm, scale=0.1), normal(rng, b, dm, scale=0.1),
        normal(rng, dm, h * dh, scale=dm**-0.5), normal(rng, dm, 2 * h * dh, scale=dm**-0.5),
        normal(rng, h * dh, dm, scale=(h * dh) ** -0.5),
    ]


def _wavenet_inputs(rng, b=2, n=24, d=16, s=2, layers=3):
    return [
        normal(rng, b, n, d), normal(rng, s, layers, 3 * d, d, scale=0.1),
        normal(rng, s, layers, d, scale=0.1), normal(rng, s, layers, d, d, scale=0.1),
        normal(rng, s, layers, d, scale=0.1), normal(rng, layers, d, d, scale=0.1),
        normal(rng, layers, d, scale=0.1), normal(rng, b, s, layers, 2 * d, scale=0.5),
    ]


def _ff_inputs(rng, b=2, n=24, dm=32):
    inner = int(dm * 4 * 2 / 3)
    return [
        normal(rng, b, n, dm), 1 + normal(rng, b, dm, scale=0.1), normal(rng, b, dm, scale=0.1),
        normal(rng, dm, 2 * inner, scale=dm**-0.5), normal(rng, 2 * inner, scale=0.1),
        normal(rng, 3, inner, inner, scale=(3 * inner) ** -0.5), normal(rng, inner, scale=0.1),
        normal(rng, inner, dm, scale=inner**-0.5), normal(rng, dm, scale=0.1),
    ]


BLOCKS = {
    # n = 40: a multiple of 8, as the Pallas kernel's tiling needs
    "attn_block": (_attn_inputs,
                   lambda *a: fused_attn_block(*a, heads=4, dim_head=16, scale=0.25),
                   lambda *a: attn_block(*a, heads=4, dim_head=16, scale=0.25)),
    "wavenet_body": (_wavenet_inputs, fused_wavenet_body, wavenet_body),
    "ff_block": (_ff_inputs, lambda *a: fused_ff_block(*a, approximate=True), ff_block),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_gradients_of_every_input_match_jax(name):
    make, jax_fn, port_fn = BLOCKS[name]
    rng = np.random.default_rng(0)
    args = make(rng)
    out_shape = args[0].shape
    w = normal(rng, *out_shape)
    expected = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * w), argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    leaves = [t(a).requires_grad_() for a in args]
    (port_fn(*leaves) * t(w)).sum().backward()
    for i, (leaf, want) in enumerate(zip(leaves, expected)):
        assert leaf.grad is not None, i
        assert_close(leaf.grad, want, atol=ATOL, rtol=RTOL)


def test_attn_block_backward_runs_through_flash_attention(monkeypatch):
    """The block's backward recomputes the core with the flash forward and
    differentiates it with the flash backward, as `_fused_bwd` does."""
    calls = []
    for name in ("flash_forward", "flash_backward"):
        original = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _f=original, _n=name, **k: (calls.append(_n), _f(*a, **k))[1])
    leaves = [t(a).requires_grad_() for a in _attn_inputs(np.random.default_rng(1))]
    out = attn_block(*leaves, heads=4, dim_head=16, scale=0.25)
    assert calls == []
    out.sum().backward()
    assert calls == ["flash_forward", "flash_backward"]


def test_forward_without_grad_saves_nothing_extra():
    args = [t(a) for a in _ff_inputs(np.random.default_rng(2))]
    with torch.no_grad():
        out = ff_block(*args)
    assert out.grad_fn is None
