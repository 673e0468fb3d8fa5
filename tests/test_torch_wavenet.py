"""Port parity for kernel K1: the plain WaveNet body against the JAX XLA
twin and against the Pallas kernel (interpret mode on the CPU), and the
`FusedWavenet` module against its flax counterpart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.wavenet import FusedWavenet as JFusedWavenet
from naturalspeech2_tpu.ops.wavenet_kernel import fused_wavenet_body, wavenet_body_xla
from naturalspeech2_tpu_torch.models.wavenet import FusedWavenet
from naturalspeech2_tpu_torch.ops.wavenet_kernel import wavenet_body, wavenet_body_torch

from torch_parity import assert_close, jitter, normal, numpy_tree, t

B, N, D, S, L = 2, 64, 16, 2, 3
# 2 stacks x 3 layers of f32 matmuls over 3d = 48 terms, summed in another
# order by XLA, Pallas and torch; outputs are O(1)
ATOL = 1e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=normal(rng, B, N, D),
        conv_w=normal(rng, S, L, 3 * D, D, scale=0.1),
        conv_b=normal(rng, S, L, D, scale=0.1),
        res_w=normal(rng, S, L, D, D, scale=0.1),
        res_b=normal(rng, S, L, D, scale=0.1),
        skip_w=normal(rng, L, D, D, scale=0.1),
        skip_b=normal(rng, L, D, scale=0.1),
        film=normal(rng, B, S, L, 2 * D, scale=0.5),
    )


@pytest.mark.parametrize("reference", [wavenet_body_xla, fused_wavenet_body],
                         ids=["xla_twin", "pallas_interpret"])
def test_plain_body_matches_jax(reference):
    args = _inputs()
    expected = reference(*(jnp.asarray(a) for a in args.values()))
    actual = wavenet_body_torch(*(t(a) for a in args.values()))
    assert actual.shape == (B, N, D)
    assert_close(actual, expected, atol=ATOL)


def test_wrapper_runs_plain_version_on_cpu():
    args = [t(a) for a in _inputs(1).values()]
    assert torch.equal(wavenet_body(*args), wavenet_body_torch(*args))
    assert wavenet_body.launches == 0


def test_wrapper_never_falls_back_off_the_cpu():
    args = [a.to("meta") for a in (t(a) for a in _inputs(1).values())]
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_body(*args)


def test_wrapper_refuses_autograd_off_the_cpu():
    """The wrapper is differentiable now (tests/test_torch_block_grads.py);
    with gradients asked for, as without, a tensor neither on the CPU nor
    on a CUDA device is refused rather than run through the plain version."""
    args = [t(a).to("meta").requires_grad_() for a in _inputs(1).values()]
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_body(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        wavenet_body(*args)


def test_fused_wavenet_module_matches_flax():
    rng = np.random.default_rng(2)
    x, cond = normal(rng, B, N, D), normal(rng, B, 4 * D)
    mod = JFusedWavenet(dim=D, stacks=S, layers=L, dim_cond_mult=4)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond))["params"]
    params = jitter(numpy_tree(params), 3)
    expected = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(cond))

    port = FusedWavenet(D, S, L, dim_cond_mult=4)
    state = {k: t(params[k]) for k in
             ("conv_w", "conv_b", "res_w", "res_b", "skip_w", "skip_b", "film_w", "film_b")}
    for conv in ("init_conv", "final_conv"):
        state[f"{conv}.conv.weight"] = t(params[conv]["Conv_0"]["kernel"]).permute(2, 1, 0)
        state[f"{conv}.conv.bias"] = t(params[conv]["Conv_0"]["bias"])
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        assert_close(port(t(x), t(cond)), expected, atol=ATOL)
