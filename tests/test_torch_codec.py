"""Port parity: `SoundStream.decode` (stem, four decoder blocks with strides
8, 5, 4, 2, head) and flax's SAME-padded transposed conv, against
`naturalspeech2_tpu/models/codec.py` (the encode path is in
tests/test_torch_codec_encode.py)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu_torch import SoundStream, load_jax_params
from naturalspeech2_tpu_torch.models.codec import SameConvTranspose1d

from torch_parity import assert_close, jitter, normal, numpy_tree, t

CFG = dict(channels=4, codebook_dim=16)
# convs of at most 7·32 terms per output through 4 blocks, f32 sums in
# another order; waveform values are O(1)
ATOL = 1e-4


@pytest.mark.parametrize("stride", [2, 4, 5, 8])
def test_same_conv_transpose_matches_flax(stride):
    rng = np.random.default_rng(stride)
    x = normal(rng, 2, 7, 6)
    mod = fnn.ConvTranspose(5, (2 * stride,), strides=(stride,), padding="SAME")
    params = jitter(numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 1)
    expected = mod.apply({"params": params}, jnp.asarray(x))

    port = SameConvTranspose1d(6, 5, stride)
    # the converter's rule: flax [k, in, out] → reversed taps, [in, out, k]
    port.load_state_dict({"weight": t(params["kernel"]).flip(0).permute(1, 2, 0),
                          "bias": t(params["bias"])})
    with torch.no_grad():
        out = port(t(x).transpose(1, 2)).transpose(1, 2)
    assert out.shape == (2, 7 * stride, 5)
    assert_close(out, expected, atol=1e-5)


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    codec = JSoundStream(**CFG)
    params = codec.init(jax.random.PRNGKey(0), jnp.zeros((1, 2 * 320)))["params"]
    params = jitter(numpy_tree(params), 2)
    latents = normal(rng, 2, 5, CFG["codebook_dim"])
    expected = codec.apply({"params": params}, jnp.asarray(latents), method=codec.decode)

    port = SoundStream(**CFG)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        audio = port.decode(t(latents))
    assert audio.shape == (2, 5 * 320)
    assert_close(audio, expected, atol=ATOL)


def test_encode_is_outside_the_slice():
    """Encode and quantize are ported (tests/test_torch_codec_encode.py
    holds them against flax), and so is the codec's own training loss now:
    `codec_loss` (waveform L1 of the straight-through decode, commitment)
    against the JAX module's, values and gradients (codec training itself:
    tests/test_torch_codec_trainer.py)."""
    codec = JSoundStream(**CFG, use_pallas_rvq=False)
    audio = np.tanh(normal(np.random.default_rng(4), 2, 2 * 320))
    params = jitter(numpy_tree(codec.init(jax.random.PRNGKey(0), jnp.asarray(audio))["params"]), 3)

    def loss_j(p):
        losses = codec.apply({"params": p}, jnp.asarray(audio), method=codec.codec_loss)
        return losses["recon"] + losses["commitment"], losses

    (_, expected), grads = jax.value_and_grad(loss_j, has_aux=True)(params)
    port = SoundStream(**CFG, use_pallas_rvq=False)
    port.load_state_dict(load_jax_params(params), strict=True)
    losses = port.codec_loss(t(audio))
    assert set(losses) == set(expected)
    for k in losses:
        assert_close(losses[k], expected[k], atol=0, rtol=1e-5)
    (losses["recon"] + losses["commitment"]).backward()
    named = dict(port.named_parameters())
    for name, want in load_jax_params(numpy_tree(grads)).items():
        got = named[name].grad
        if got is None:  # the codebooks: no gradient through the straight-through
            assert name == "codebooks" and not np.any(want.numpy())
            continue
        scale = float(want.abs().max())
        assert_close(got, want, atol=1e-5 * scale)
