"""Port parity for kernel K6: the plain RVQ against the JAX package's Pallas
kernel (interpret mode on the CPU) and `rvq_xla`, tie-tolerantly; the
straight-through gradient; and `rvq_cross_entropy` with its gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import rvq as jrvq
from naturalspeech2_tpu_torch.ops.rvq import (
    rvq,
    rvq_cross_entropy,
    rvq_quantize,
    rvq_reference,
    rvq_torch,
)

from torch_parity import assert_close, assert_codes_match, normal, t

M, Q, K, D = 200, 3, 40, 16
# distances of O(D) summed in f32 in another order: candidates closer than
# this may swap; sums of Q codebook rows compare at f32 rounding
TIE_TOL = 1e-4
ATOL = 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return normal(rng, M, D), normal(rng, Q, K, D)


@pytest.mark.parametrize("plain, reference", [(rvq_torch, jrvq.rvq_quantize),
                                              (rvq_reference, jrvq.rvq_xla)],
                         ids=["kernel_function_vs_pallas", "reference_vs_rvq_xla"])
def test_plain_rvq_matches_jax(plain, reference):
    x, cb = _inputs()
    q_j, codes_j = reference(jnp.asarray(x), jnp.asarray(cb))
    q_t, codes_t = plain(t(x), t(cb))
    assert codes_t.dtype == torch.int32 and codes_t.shape == (M, Q)
    same = assert_codes_match(x, cb, codes_t.numpy(), np.asarray(codes_j), TIE_TOL)
    assert same.mean() > 0.95
    np.testing.assert_allclose(q_t.numpy()[same], np.asarray(q_j)[same], atol=ATOL)


def test_kernel_function_keeps_the_first_minimum():
    x, cb = _inputs(1)
    cb[0, 7] = cb[0, 3]  # an exact tie: the lower index wins
    x[:5] = cb[0, 3] + 0.01 * x[:5]
    _, codes = rvq_torch(t(x), t(cb))
    assert torch.all(codes[:5, 0] == 3)
    _, codes_j = jrvq.rvq_quantize(jnp.asarray(x), jnp.asarray(cb))
    assert np.all(np.asarray(codes_j)[:5, 0] == 3)


def test_wrapper_runs_plain_version_on_cpu():
    x, cb = _inputs(2)
    for got, want in zip(rvq(t(x), t(cb)), rvq_torch(t(x), t(cb))):
        assert torch.equal(got, want)
    assert rvq.launches == 0


def test_straight_through_gradient_matches_jax():
    x, cb = _inputs(3)
    w = normal(np.random.default_rng(4), M, D)
    expected = jax.grad(lambda a: jnp.sum(jrvq.rvq_quantize(a, jnp.asarray(cb))[0] * w))(
        jnp.asarray(x))
    xt, cbt = t(x).requires_grad_(), t(cb).requires_grad_()
    quantized, codes = rvq_quantize(xt, cbt)
    assert not codes.requires_grad
    (quantized * t(w)).sum().backward()
    assert_close(xt.grad, expected, atol=0)
    assert cbt.grad is None


def test_cross_entropy_and_its_gradient_match_jax():
    x, cb = _inputs(5)
    codes = np.array(jrvq.rvq_xla(jnp.asarray(x), jnp.asarray(cb))[1])
    loss_j, grad_j = jax.value_and_grad(
        lambda a, c: jrvq.rvq_cross_entropy(a, c, jnp.asarray(codes)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(cb))
    xt, cbt = t(x).requires_grad_(), t(cb).requires_grad_()
    loss = rvq_cross_entropy(xt, cbt, torch.from_numpy(codes))
    loss.backward()
    assert_close(loss, loss_j, atol=1e-5, rtol=1e-5)
    assert_close(xt.grad, grad_j[0], atol=1e-6)
    assert_close(cbt.grad, grad_j[1], atol=1e-6)


def test_wrapper_never_falls_back_off_the_cpu():
    x, cb = _inputs()
    with pytest.raises(ValueError, match="CUDA"):
        rvq(t(x).to("meta"), t(cb).to("meta"))
