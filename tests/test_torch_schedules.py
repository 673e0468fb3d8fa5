"""Port parity: noise schedules, γ→α/σ and γ→log-SNR, and the math
helpers, against the JAX package over a grid of t."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import schedules as jsched
from naturalspeech2_tpu.utils import helpers as jhelpers
from naturalspeech2_tpu_torch.ops import schedules as tsched
from naturalspeech2_tpu_torch.utils import helpers as thelpers

from torch_parity import assert_close, t

GRID = np.linspace(0.0, 1.0, 101, dtype=np.float32)

# elementwise f32 math on both sides; the transcendental functions of XLA
# and of torch may differ in the last ulp or two
ATOL = 1e-6


@pytest.mark.parametrize(
    "name, kwargs",
    [
        ("linear", {}),
        ("cosine", {}),
        ("cosine", {"start": 0.2, "end": 0.9, "tau": 2.0}),
        ("sigmoid", {}),
        ("sigmoid", {"start": -2.0, "end": 4.0, "tau": 0.5}),
    ],
)
def test_schedule_matches_jax(name, kwargs):
    expected = jsched.get_schedule(name)(jnp.asarray(GRID), **kwargs)
    actual = tsched.get_schedule(name)(torch.from_numpy(GRID), **kwargs)
    assert actual.dtype == torch.float32
    assert_close(actual, expected, atol=ATOL)


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_gamma_conversions_match_jax(scale):
    gamma = jsched.sigmoid_schedule(jnp.asarray(GRID))
    gamma_t = t(gamma)
    ja, js = jsched.gamma_to_alpha_sigma(gamma, scale)
    ta, ts = tsched.gamma_to_alpha_sigma(gamma_t, scale)
    assert_close(ta, ja, atol=ATOL)
    assert_close(ts, js, atol=ATOL)
    # log-SNR runs to ±log(1e9) at the grid ends: compare relatively
    assert_close(
        tsched.gamma_to_log_snr(gamma_t, scale),
        jsched.gamma_to_log_snr(gamma, scale),
        atol=1e-5, rtol=1e-5,
    )


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="quadratic"):
        tsched.get_schedule("quadratic")


def test_safe_div_and_log_match_jax():
    x = np.array([-2.0, 0.0, 1e-30, 1e-12, 0.5, 3.0], np.float32)
    assert_close(thelpers.safe_log(torch.from_numpy(x)), jhelpers.safe_log(jnp.asarray(x)), atol=1e-5)
    assert_close(
        thelpers.safe_div(torch.ones(6), torch.from_numpy(x)),
        jhelpers.safe_div(jnp.ones(6), jnp.asarray(x)),
        atol=0, rtol=1e-6,
    )
