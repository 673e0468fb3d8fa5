"""Port parity for kernel K1b: the lane-major plain WaveNet body against the
JAX package's per-lane Pallas kernel (interpret mode on the CPU) and
against the stack-major plain body, the wrapper's CPU route, and the K1 /
K1b route on the card's L2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import wavenet_kernel as jwk
from naturalspeech2_tpu_torch.ops.wavenet_kernel import (
    wavenet_body_lanes,
    wavenet_body_lanes_torch,
    wavenet_body_torch,
    wavenet_route,
)

from torch_parity import assert_close, normal, t

B, N, D = 2, 40, 16
# S stacks x L layers of f32 matmuls over 3d = 48 terms, summed in another
# order by Pallas (three tap matmuls) and torch (one over the concatenated
# taps); outputs are O(1)
ATOL = 1e-4
L2_H100 = 50 * 2**20  # torch.cuda.get_device_properties(0).L2_cache_size on an H100


def _inputs(S, L, seed):
    rng = np.random.default_rng(seed)
    return [
        normal(rng, B, N, D),
        normal(rng, S, L, 3 * D, D, scale=0.1),
        normal(rng, S, L, D, scale=0.1),
        normal(rng, S, L, D, D, scale=0.1),
        normal(rng, S, L, D, scale=0.1),
        normal(rng, L, D, D, scale=0.1),
        normal(rng, L, D, scale=0.1),
        normal(rng, B, S, L, 2 * D, scale=0.5),
    ]


# (S4, L8): dilations up to 128, beyond n; (S3, L5): the JAX package's
# own per-lane test shape, a 32-row causal pad
@pytest.mark.parametrize("S, L", [(4, 8), (3, 5)])
def test_lanes_plain_matches_pallas_per_lane_kernel(S, L):
    args = _inputs(S, L, seed=S * 10 + L)
    expected = jwk._fused_forward_per_lane(*(jnp.asarray(a) for a in args))
    actual = wavenet_body_lanes_torch(*(t(a) for a in args))
    assert actual.shape == (B, N, D)
    assert_close(actual, expected, atol=ATOL)


@pytest.mark.parametrize("S, L", [(4, 8), (2, 3)])
def test_lanes_plain_matches_stack_plain(S, L):
    args = [t(a) for a in _inputs(S, L, seed=S + L)]
    assert_close(wavenet_body_lanes_torch(*args), wavenet_body_torch(*args), atol=1e-5)


def test_lanes_wrapper_runs_plain_version_on_cpu():
    args = [t(a) for a in _inputs(2, 3, seed=5)]
    wavenet_body_lanes.launches = 0
    assert torch.equal(wavenet_body_lanes(*args), wavenet_body_lanes_torch(*args))
    assert wavenet_body_lanes.launches == 0


def test_lanes_wrapper_gradients_are_the_plain_vjp():
    """As for K1, the backward is the vjp of the plain body in f32."""
    args = [t(a).requires_grad_() for a in _inputs(2, 3, seed=6)]
    g = torch.randn(B, N, D, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(wavenet_body_lanes(*args), args, g)
    expected = torch.autograd.grad(wavenet_body_torch(*args), args, g)
    for a, e in zip(grads, expected):
        assert_close(a, e.detach(), atol=1e-5)


def test_lanes_wrapper_never_falls_back_off_the_cpu():
    args = [t(a).to("meta") for a in _inputs(2, 3, seed=7)]
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_body_lanes(*args)


def _jax_route(n, d, L):
    """The JAX package's choice (`_forward_dispatch`): K1 within the VMEM
    budget, K1b past it at d <= 256, the XLA twin otherwise."""
    if jwk._kernel_vmem_bytes(n, d, L) <= jwk.VMEM_SCRATCH_LIMIT_BYTES:
        return "stack"
    if d <= jwk.LANE_MAX_DIM and jwk._lane_vmem_bytes(n, d, L) <= jwk.LANE_VMEM_LIMIT_BYTES:
        return "lanes"
    return "xla"


@pytest.mark.parametrize(
    "b, n, d, port, jax_route",
    [
        (4, 1024, 128, "stack", "stack"),  # flagship sampling
        (8, 512, 128, "stack", "stack"),   # guided conditional sampling
        (8, 1024, 128, "stack", "stack"),  # the flagship under CFG, batch 4 doubled
        (16, 150, 128, "stack", "stack"),  # training, b16 x 2 s
        (1, 4500, 128, "stack", "stack"),  # long-form 60 s
        (1, 9000, 128, "lanes", "lanes"),  # long-form 120 s
        (16, 1024, 512, "stack", "xla"),   # scaled dim 512
    ],
    ids=["flagship", "guided", "flagship_cfg", "training", "longform_60s", "longform_120s", "scaled"],
)
def test_route_on_an_h100_l2(b, n, d, port, jax_route):
    """The route is per batch row, as the JAX package's gate: b never
    moves a shape from K1 to K1b."""
    assert wavenet_route(n, d, 8, L2_H100) == port
    assert _jax_route(n, d, 8) == jax_route


def test_route_edges():
    """K1b from the first n whose K1 scratch passes the L2 to the last one
    whose own state fits it; the ragged n 6501 of the chip run is inside."""
    assert wavenet_route(6400, 128, 8, L2_H100) == "stack"
    assert wavenet_route(6401, 128, 8, L2_H100) == "lanes"
    assert wavenet_route(6501, 128, 8, L2_H100) == "lanes"
    assert wavenet_route(34133, 128, 8, L2_H100) == "lanes"
    assert wavenet_route(34134, 128, 8, L2_H100) == "stack"
