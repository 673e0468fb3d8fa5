"""Port parity for kernels K4 and K5: Threefry and the dropout keep mask bit
for bit, the plain flash forward and backward against the JAX package's
`_flash_forward` / `_flash_backward` (Pallas kernels in interpret mode on
the CPU), and `FlashAttention`'s autograd against `jax.grad` of
`flash_attention`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import flash_attention as jfa
from naturalspeech2_tpu_torch.ops import flash_attention as fa

from torch_parity import assert_close, normal, t

# softmax over at most 150 keys and products over d = 16, f32 in another
# order; outputs and gradients are O(1)
ATOL = 2e-5

# (b, h, n_q, n_kv, causal, masked, dropout): plain; ragged n with a padding
# mask that fully masks rows (batch 1's first keys under causal masking,
# batch 2 entirely); the mask with dropout; n_q != n_kv. JAX runs its
# one-shot kernel here; test_multi_block_forward_matches_jax reaches the
# online one. Causal masking with dropout is held in the forward only: the
# JAX backward kernels then call `pl.program_id` inside a traced `pl.when`,
# which has no CPU lowering in interpret mode.
CASES = {
    "plain": (2, 2, 64, 64, False, False, 0.0),
    "masked_causal": (3, 2, 37, 37, True, True, 0.0),
    "masked_dropout": (3, 2, 37, 37, False, True, 0.2),
    "cross_lengths_dropout": (2, 3, 20, 150, False, True, 0.5),
}
FORWARD_CASES = {**CASES, "masked_causal_dropout": (3, 2, 37, 37, True, True, 0.2)}
SEED = (0x12345678, 0x9ABCDEF0)


def _inputs(b, h, n_q, n_kv, masked, seed=0, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = normal(rng, b, h, n_q, d), normal(rng, b, h, n_kv, d), normal(rng, b, h, n_kv, d)
    do = normal(rng, b, h, n_q, d)
    mask = None
    if masked:
        mask = rng.random((b, n_kv)) > 0.2
        mask[1, :3] = False
        if b > 2:
            mask[2] = False
    return q, k, v, do, mask


def _jseed(dropout):
    return jnp.asarray([SEED], dtype=jnp.uint32) if dropout > 0 else None


def _tmask(mask):
    return None if mask is None else torch.from_numpy(mask)


def test_threefry_matches_jax():
    rng = np.random.default_rng(0)
    k0, k1 = (int(v) for v in rng.integers(0, 2**32, 2, dtype=np.uint64))
    x0 = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    x1 = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    expected, _ = jfa._threefry2x32(np.uint32(k0), np.uint32(k1), x0.astype(np.uint32),
                                    x1.astype(np.uint32))
    actual = fa.threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                             torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected).astype(np.int64))


@pytest.mark.parametrize("n_kv", [50, 150, 1100])
def test_dropout_keep_mask_matches_jax_exactly(n_kv):
    """The counter strides by the padded key length (128 at 50, 256 at 150,
    2048 at 1100), as `_flash_forward` pads it."""
    b, h, n_q, rate = 2, 3, 9, 0.3
    seed = jnp.asarray([SEED], dtype=jnp.uint32)
    expected = np.stack([
        np.stack([np.asarray(jfa._dropout_keep_scaled(seed, bi, hi, 0, 0, (n_q, n_kv), rate,
                                                       fa.dropout_stride(n_kv)))
                  for hi in range(h)])
        for bi in range(b)])
    actual = fa.dropout_keep_scaled(SEED, b, h, n_q, n_kv, rate)
    np.testing.assert_array_equal(actual.numpy(), expected)
    assert fa.dropout_stride(n_kv) == {50: 128, 150: 256, 1100: 2048}[n_kv]


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(case):
    b, h, n_q, n_kv, causal, masked, dropout = FORWARD_CASES[case]
    q, k, v, _, mask = _inputs(b, h, n_q, n_kv, masked)
    o_j, lse_j = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None if mask is None else jnp.asarray(mask),
        _jseed(dropout), causal=causal, scale=0.3, dropout_rate=dropout)
    o, lse = fa.flash_forward(t(q), t(k), t(v), _tmask(mask), SEED, causal=causal, scale=0.3,
                              dropout_rate=dropout)
    assert_close(o, o_j, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :n_q, 0], atol=ATOL, rtol=1e-6)
    if masked and b > 2:  # fully masked rows: o = 0, lse = NEG_INF
        assert torch.all(o[2] == 0) and torch.all(lse[2] == np.float32(fa.NEG_INF))


def test_multi_block_forward_matches_jax():
    """JAX's online-softmax kernel (`_flash_kernel`, here three kv blocks of
    128) computes the function of the plain version. (With dropout that
    kernel does not run in interpret mode: `pl.program_id` inside its
    `pl.when` has no CPU lowering; its counter is the one
    test_dropout_keep_mask_matches_jax_exactly holds at n_kv 1100.)"""
    b, h, n_q, n_kv = 3, 2, 300, 300
    q, k, v, _, mask = _inputs(b, h, n_q, n_kv, True, seed=1)
    o_j, lse_j = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), None, causal=True,
        scale=0.3, block_q=128, block_kv=128)
    o, lse = fa.flash_forward(t(q), t(k), t(v), _tmask(mask), None, causal=True, scale=0.3)
    assert_close(o, o_j, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :n_q, 0], atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax(case):
    b, h, n_q, n_kv, causal, masked, dropout = CASES[case]
    q, k, v, do, mask = _inputs(b, h, n_q, n_kv, masked, seed=2)
    jmask = None if mask is None else jnp.asarray(mask)
    o_j, lse_j = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                                    _jseed(dropout), causal=causal, scale=0.3,
                                    dropout_rate=dropout)
    expected = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                                   _jseed(dropout), lse_j, o_j, jnp.asarray(do), causal=causal,
                                   scale=0.3, dropout_rate=dropout)
    o, lse = fa.flash_forward(t(q), t(k), t(v), _tmask(mask), SEED, causal=causal, scale=0.3,
                              dropout_rate=dropout)
    actual = fa.flash_backward(t(q), t(k), t(v), _tmask(mask), SEED, lse, o, t(do),
                               causal=causal, scale=0.3, dropout_rate=dropout)
    for got, want in zip(actual, expected):
        assert_close(got, want, atol=ATOL)
    if masked:  # nothing leaks into masked keys
        masked_keys = torch.from_numpy(~mask)
        for grad in actual[1:]:
            assert torch.all(grad.permute(0, 2, 1, 3)[masked_keys] == 0)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_matches_jax_grad(case):
    b, h, n_q, n_kv, causal, masked, dropout = CASES[case]
    q, k, v, w, mask = _inputs(b, h, n_q, n_kv, masked, seed=3)
    key = jax.random.PRNGKey(5)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss_j(q, k, v):
        o = jfa.flash_attention(q, k, v, mask=jmask, causal=causal, scale=0.3, dropout=dropout,
                                dropout_key=key if dropout > 0 else None)
        return jnp.sum(o * jnp.asarray(w))

    expected = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # flash_attention draws its seed words with jax.random.bits from the key
    seed = tuple(int(s) for s in np.asarray(jax.random.bits(key, (1, 2), jnp.uint32))[0])
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    o = fa.FlashAttention.apply(*leaves, _tmask(mask), seed, causal, 0.3, dropout)
    (o * t(w)).sum().backward()
    for leaf, want in zip(leaves, expected):
        assert_close(leaf.grad, want, atol=ATOL)


def test_flash_attention_seeds_dropout_from_the_generator():
    q, k, v, _, _ = _inputs(1, 2, 16, 16, False)
    draw = lambda seed: fa.flash_attention(  # noqa: E731
        t(q), t(k), t(v), dropout=0.5, generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(fa.flash_attention(t(q), t(k), t(v)),
                       fa.flash_forward_torch(t(q), t(k), t(v), None, None, causal=False,
                                              scale=16**-0.5)[0])


def test_with_lse_matches_jax():
    q, k, v, _, mask = _inputs(3, 2, 12, 12, True, seed=4)
    o_j, lse_j = jfa.flash_attention_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              mask=jnp.asarray(mask))
    o, lse = fa.flash_attention_with_lse(t(q), t(k), t(v), mask=torch.from_numpy(mask))
    assert_close(o, o_j, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL, rtol=1e-6)
    assert torch.all(lse[2] == np.float32(fa.NEG_INF))


@pytest.mark.parametrize("wrapper", ["flash_forward", "flash_backward"])
def test_wrappers_never_fall_back_off_the_cpu(wrapper):
    q, k, v, do, _ = _inputs(1, 2, 8, 8, False)
    q, k, v, do = (t(a).to("meta") for a in (q, k, v, do))
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "flash_forward":
            fa.flash_forward(q, k, v, scale=0.3)
        else:
            fa.flash_backward(q, k, v, None, None, q[..., 0], q, do, scale=0.3)
