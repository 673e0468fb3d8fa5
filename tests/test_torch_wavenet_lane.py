"""Port parity for kernel K1b: the lane-major plain WaveNet body against the
JAX package's per-lane Pallas kernel (interpret mode on the CPU) and
against the stack-major plain body, the wrapper's CPU route, and the
route rule (K1, K1b or the plain body) against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import wavenet_kernel as jwk
from naturalspeech2_tpu_torch.ops.wavenet_kernel import (
    wavenet_body,
    wavenet_body_lanes,
    wavenet_body_lanes_bf16mm_torch,
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
    return "plain"


@pytest.mark.parametrize(
    "b, n, d, route",
    [
        (4, 1024, 128, "stack"),  # flagship sampling
        (8, 512, 128, "stack"),   # guided conditional sampling
        (8, 1024, 128, "stack"),  # the flagship under CFG, batch 4 doubled
        (16, 150, 128, "stack"),  # training, b16 x 2 s
        (1, 4500, 128, "stack"),  # long-form 60 s
        (1, 9000, 128, "lanes"),  # long-form 120 s
        (16, 1024, 512, "plain"),  # scaled dim 512: the JAX package's XLA twin
    ],
    ids=["flagship", "guided", "flagship_cfg", "training", "longform_60s", "longform_120s", "scaled"],
)
def test_route_on_an_h100_l2(b, n, d, route):
    """The route is the JAX package's at every shape, whatever the card:
    the rule reads neither the batch nor a cache size."""
    assert wavenet_route(n, d, 8) == route
    assert _jax_route(n, d, 8) == route


def test_route_edges():
    """K1b from the first n past the whole-stack budget to the last one in
    the per-lane budget, then the plain body; the ragged n 6733 of the chip
    run is inside; past the whole-stack budget, every d above 256 takes
    the plain body."""
    edges = {6712: "stack", 6713: "lanes", 6733: "lanes", 21589: "lanes", 21590: "plain"}
    for n, route in edges.items():
        assert wavenet_route(n, 128, 8) == route == _jax_route(n, 128, 8), n
    assert wavenet_route(64, 320, 8) == "stack" == _jax_route(64, 320, 8)
    assert wavenet_route(4096, 320, 8) == "plain" == _jax_route(4096, 320, 8)


def test_plain_route_runs_the_plain_body_on_any_device():
    """Past both budgets (here n 8000 past the whole-stack one at d 320 >
    256) the body is the plain one, as the JAX dispatch calls its XLA twin
    there: on a tensor off the CPU it neither launches a kernel nor raises,
    while a kernel route raises."""
    b, n, d, S, L = 1, 8000, 320, 2, 3
    shapes = [(b, n, d), (S, L, 3 * d, d), (S, L, d), (S, L, d, d), (S, L, d), (L, d, d), (L, d),
              (b, S, L, 2 * d)]
    args = [torch.empty(s, device="meta") for s in shapes]
    wavenet_body.launches = 0
    assert wavenet_body(*args).shape == (b, n, d)
    assert wavenet_body.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_body_lanes(*args)


# K1b's `bf16_matmul` option: XLA on the CPU may keep excess precision in
# bf16, so the plain version is held to the JAX kernel's algorithm within
# 1e-2 of the output's largest entry and a correlation (the card holds the
# rounding points, chip_smoke.py phase 31); the rounding itself shows as a
# difference from the f32 body far above f32 noise (ATOL's 1e-4 at O(1)).
BF16MM_TOL, BF16MM_CORR = 1e-2, 0.9999


@pytest.mark.parametrize("S, L", [(4, 8), (3, 5)])
def test_bf16_matmul_plain_matches_pallas_option(S, L):
    args = _inputs(S, L, seed=S * 10 + L + 1)
    expected = np.asarray(jwk._fused_forward_per_lane(*(jnp.asarray(a) for a in args),
                                                      bf16_matmul=True))
    actual = wavenet_body_lanes_bf16mm_torch(*(t(a) for a in args))
    assert actual.dtype == torch.float32 and actual.shape == (B, N, D)
    peak = np.abs(expected).max()
    assert np.abs(actual.numpy() - expected).max() <= BF16MM_TOL * peak
    assert np.corrcoef(actual.numpy().ravel(), expected.ravel())[0, 1] >= BF16MM_CORR
    f32 = wavenet_body_lanes_torch(*(t(a) for a in args)).numpy()
    assert np.abs(actual.numpy() - f32).max() > 10 * ATOL


def test_bf16_matmul_wrapper_runs_plain_version_on_cpu():
    args = [t(a) for a in _inputs(2, 3, seed=8)]
    wavenet_body_lanes.launches_bf16mm = 0
    out = wavenet_body_lanes(*args, bf16_matmul=True)
    assert torch.equal(out, wavenet_body_lanes_bf16mm_torch(*args))
    assert wavenet_body_lanes.launches_bf16mm == 0
    grads = torch.autograd.grad(
        wavenet_body_lanes(*[a.requires_grad_() for a in args], bf16_matmul=True).sum(), args)
    assert all(torch.isfinite(g).all() for g in grads)


def test_bf16_matmul_takes_f32_only_and_never_falls_back():
    args = [t(a) for a in _inputs(2, 3, seed=9)]
    with pytest.raises(TypeError, match="bf16_matmul"):
        wavenet_body_lanes(*[a.bfloat16() for a in args], bf16_matmul=True)
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_body_lanes(*[a.to("meta") for a in args], bf16_matmul=True)
