"""The port's bf16 kernels on the CPU, against the JAX package's Pallas
kernels at bf16 (interpret mode, as tests/test_attn_block.py runs them):
the plain bf16 versions of K1, K1b, K2, K2b, K3 and K4 forward, and the
plain WaveNet route against `wavenet_body_xla` at bf16. Inputs are made
with numpy from a seed and rounded to bf16 alike on both sides.

XLA on the CPU may keep excess precision where a bf16 kernel rounds
(`xla_allow_excess_precision`), so these hold the algorithm to a
bf16-sized tolerance, relative to the output's largest entry; the rounding
points themselves are held on the card, each kernel against its plain
version, by chip_smoke.py. JAX's own bf16 bound is 5e-2
(tests/test_attn_block.py); every case here is held to BF16_TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import attn_block_kernel as jattn
from naturalspeech2_tpu.ops import ff_block_kernel as jff
from naturalspeech2_tpu.ops import flash_attention as jflash
from naturalspeech2_tpu.ops import wavenet_kernel as jwn
from naturalspeech2_tpu_torch.ops import attn_block_kernel, ff_block_kernel, flash_attention
from naturalspeech2_tpu_torch.ops import wavenet_kernel

from torch_parity import normal

# The outputs are bf16: one rounding of the output is 2^-9 of its
# magnitude (2e-3), and the products' inputs are rounded at the same
# points on both sides but summed in another order. 1e-2 of the output's
# largest entry passes that with room; a dropped rounding point of an
# operand or a wrong layout does not (JAX's own bound: 5e-2).
BF16_TOL = 1e-2


def _pair(*arrays):
    """Each numpy array as a bf16 JAX array and a bf16 torch tensor."""
    return ([jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrays])


def _hold(actual: torch.Tensor, expected, tol: float = BF16_TOL) -> None:
    assert actual.dtype == torch.bfloat16
    got = actual.float().numpy()
    want = np.asarray(jnp.asarray(expected, dtype=jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max error {err:.3e} of the largest entry, above {tol}"


def _wavenet_arrays(seed, b, n, d, S, L):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, n, d), normal(rng, S, L, 3 * d, d, scale=(3 * d) ** -0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, S, L, d, d, scale=d**-0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, L, d, d, scale=d**-0.5),
            normal(rng, L, d, scale=0.1), 1 + normal(rng, b, S, L, 2 * d, scale=0.1))


@pytest.mark.parametrize("route", ["stack", "lanes"])
def test_wavenet_kernels_bf16_match_jax(route):
    """K1 (`_wavenet_kernel`) and K1b (`_lane_kernel`) at bf16: f32 lanes,
    the output rounded once."""
    jargs, targs = _pair(*_wavenet_arrays(0, 2, 16, 16, 2, 3))
    jax_fn = jwn._fused_forward if route == "stack" else jwn._fused_forward_per_lane
    expected = jax_fn(*jargs)
    assert expected.dtype == jnp.bfloat16
    actual = (wavenet_kernel._forward(route, *targs) if route == "stack"
              else wavenet_kernel.wavenet_body_lanes(*targs))
    _hold(actual, expected)


def test_wavenet_plain_route_bf16_matches_xla():
    """The plain route (d 512 in the models) against `wavenet_body_xla` at
    bf16, which rounds every lane to bf16."""
    jargs, targs = _pair(*_wavenet_arrays(1, 2, 16, 32, 2, 2))
    expected = jwn.wavenet_body_xla(*jargs)
    _hold(wavenet_kernel.wavenet_body_torch(*targs), expected)


def _attn_arrays(seed, b, n, dm, heads, dh, dc=None):
    rng = np.random.default_rng(seed)
    hd = heads * dh
    dc = dc or dm
    return (normal(rng, b, n, dm), 1 + normal(rng, b, dm, scale=0.1),
            normal(rng, b, dm, scale=0.1), normal(rng, dm, hd, scale=dm**-0.5),
            normal(rng, dc, 2 * hd, scale=dc**-0.5), normal(rng, hd, dm, scale=hd**-0.5),
            normal(rng, b, 8, dc))


def _jax_heads(wq, wkv, wo, heads, dh):
    dm, dc = wq.shape[0], wkv.shape[0]
    wk, wv = jnp.split(wkv, 2, axis=-1)
    to_heads = lambda w, rows: w.reshape(rows, heads, dh).transpose(1, 0, 2)  # noqa: E731
    return to_heads(wq, dm), to_heads(wk, dc), to_heads(wv, dc), wo.reshape(heads, dh, dm)


def test_attn_block_bf16_matches_jax():
    """K2 (`_attn_block_kernel` at bf16)."""
    heads, dh = 2, 8
    (x, g, b, wq, wkv, wo, _), targs = _pair(*_attn_arrays(2, 2, 16, 16, heads, dh))
    expected = jattn._fused_forward(x, g, b, *_jax_heads(wq, wkv, wo, heads, dh),
                                    scale=dh**-0.5)
    actual = attn_block_kernel.attn_block(*targs[:6], heads=heads, dim_head=dh, scale=dh**-0.5)
    _hold(actual, expected)


def test_cross_attn_block_bf16_matches_jax():
    """K2b (`_cross_attn_block_kernel` at bf16), an 8-token context 24 wide."""
    heads, dh = 2, 8
    (x, g, b, wq, wkv, wo, ctx), targs = _pair(*_attn_arrays(3, 2, 16, 16, heads, dh, dc=24))
    expected = jattn._cross_fused_forward(x, ctx, g, b, *_jax_heads(wq, wkv, wo, heads, dh),
                                          scale=dh**-0.5)
    tx, tg, tb, twq, twkv, two, tctx = targs
    with torch.no_grad():
        actual = attn_block_kernel.cross_attn_block(tx, tctx, tg, tb, twq, twkv, two,
                                                    heads=heads, dim_head=dh, scale=dh**-0.5)
    _hold(actual, expected)


def test_ff_block_bf16_matches_jax():
    """K3 (`_ff_block_kernel` at bf16), inner 42."""
    dm = 16
    inner = int(dm * 4 * 2 / 3)
    rng = np.random.default_rng(4)
    arrays = (normal(rng, 2, 16, dm), 1 + normal(rng, 2, dm, scale=0.1),
              normal(rng, 2, dm, scale=0.1), normal(rng, dm, 2 * inner, scale=dm**-0.5),
              normal(rng, 2 * inner, scale=0.1), normal(rng, 3, inner, inner, scale=inner**-0.5),
              normal(rng, inner, scale=0.1), normal(rng, inner, dm, scale=inner**-0.5),
              normal(rng, dm, scale=0.1))
    (x, g, b, w1, b1, wc, bc, w2, b2), targs = _pair(*arrays)
    expected = jff._fused_forward(x, g, b, w1[:, :inner], b1[:inner], w1[:, inner:], b1[inner:],
                                  wc, bc, w2, b2, approximate=True)
    _hold(ff_block_kernel.ff_block(*targs), expected)


@pytest.mark.parametrize("n_q, n_kv, causal, masked", [(16, 40, False, False),
                                                       (24, 24, True, True)],
                         ids=["cross", "causal_masked"])
def test_flash_forward_bf16_matches_jax(n_q, n_kv, causal, masked):
    """K4's forward at bf16 (`_flash_oneshot_kernel`): o in bf16, lse in f32."""
    rng = np.random.default_rng(5)
    (q, k, v), (tq, tk, tv) = _pair(normal(rng, 2, 2, n_q, 8), normal(rng, 2, 2, n_kv, 8),
                                    normal(rng, 2, 2, n_kv, 8))
    mask = rng.uniform(size=(2, n_kv)) > 0.3 if masked else None
    o, lse = jflash._flash_forward(q, k, v, None if mask is None else jnp.asarray(mask),
                                   causal=causal, scale=8**-0.5)
    actual, actual_lse = flash_attention.flash_forward(
        tq, tk, tv, None if mask is None else torch.from_numpy(mask), causal=causal,
        scale=8**-0.5)
    _hold(actual, o)
    assert actual_lse.dtype == torch.float32
    # JAX's lse stays padded [b, h, n_q padded, 1]
    np.testing.assert_allclose(actual_lse.numpy(), np.asarray(lse)[:, :, :n_q, 0], atol=1e-5)


def test_bf16_dropout_and_backward_run():
    """Dropout and the backward in bf16 (AMP training): the forward keeps
    the f32 kernel's elements (its keep mask), the backward returns bf16
    gradients. tests/test_torch_amp.py holds both against JAX."""
    q = torch.from_numpy(normal(np.random.default_rng(6), 1, 2, 8, 8)).to(torch.bfloat16)
    seed = (1, 2)
    o, lse = flash_attention.flash_forward(q, q, q, scale=1.0, dropout_rate=0.5, seed=seed)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _, lse_plain = flash_attention.flash_forward(q, q, q, scale=1.0)
    assert torch.equal(lse, lse_plain)  # the normaliser ignores dropout
    keep = flash_attention.dropout_keep_scaled(seed, 1, 2, 8, 8, 0.5)
    p = torch.exp(torch.einsum("bhid,bhjd->bhij", q.float(), q.float()) - lse[..., None])
    want = torch.einsum("bhij,bhjd->bhid", (p * keep).to(torch.bfloat16).float(), q.float())
    _hold(o, want.numpy())
    grads = flash_attention.flash_backward(q, q, q, None, seed, lse, o, q, scale=1.0,
                                           dropout_rate=0.5)
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all() for g in grads)
