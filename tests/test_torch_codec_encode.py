"""Port parity for the codec's encode path: flax's asymmetric SAME padding
on the strided convs, `encode_latents`, `SoundStream.forward` (trim,
encode, quantize through K6's plain version; encoded or decoded), and
`dequantize` / `rq`, against `naturalspeech2_tpu/models/codec.py`."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu_torch import SoundStream, load_jax_params
from naturalspeech2_tpu_torch.models.codec import StridedSameConv1d

from torch_parity import assert_close, assert_codes_match, jitter, normal, numpy_tree, t

CFG = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=3)
# convs of at most 7·32 terms per output through 4 blocks, f32 sums in
# another order; latents and waveforms are O(1)
ATOL = 1e-4
TIE_TOL = 1e-3


@pytest.fixture(scope="module")
def codecs():
    codec = JSoundStream(**CFG)
    params = codec.init(jax.random.PRNGKey(0), jnp.zeros((1, 2 * 320)))["params"]
    params = jitter(numpy_tree(params), 2)
    port = SoundStream(**CFG)
    port.load_state_dict(load_jax_params(params), strict=True)
    return codec, params, port


def _audio(b, samples, seed=0):
    return np.tanh(normal(np.random.default_rng(seed), b, samples))


@pytest.mark.parametrize("stride", [2, 4, 5, 8])
def test_strided_conv_matches_flax(stride):
    rng = np.random.default_rng(stride)
    x = normal(rng, 2, 6 * stride, 5)
    mod = fnn.Conv(3, (2 * stride,), strides=(stride,), padding="SAME")
    params = jitter(numpy_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 1)
    expected = mod.apply({"params": params}, jnp.asarray(x))

    port = StridedSameConv1d(5, 3, stride)
    port.load_state_dict({"weight": t(params["kernel"]).permute(2, 1, 0),
                          "bias": t(params["bias"])})
    with torch.no_grad():
        out = port(t(x).transpose(1, 2)).transpose(1, 2)
    assert out.shape == (2, 6, 3)
    assert_close(out, expected, atol=1e-5)


def test_encode_latents_matches_jax(codecs):
    codec, params, port = codecs
    audio = _audio(2, 6 * 320)
    expected = codec.apply({"params": params}, jnp.asarray(audio), method=codec.encode_latents)
    with torch.no_grad():
        latents = port.encode_latents(t(audio))
    assert latents.shape == (2, 6, CFG["codebook_dim"])
    assert_close(latents, expected, atol=ATOL)


@pytest.mark.parametrize("curtail_from_left", [False, True])
def test_forward_encoded_matches_jax(codecs, curtail_from_left):
    """T = 5·320 + 77 is trimmed to 5 frames, from the right or the left."""
    codec, params, port = codecs
    audio = _audio(3, 5 * 320 + 77, seed=1)
    lat_j, codes_j, _ = codec.apply({"params": params}, jnp.asarray(audio), return_encoded=True,
                                    curtail_from_left=curtail_from_left)
    with torch.no_grad():
        latents, codes, none = port(t(audio), return_encoded=True,
                                    curtail_from_left=curtail_from_left)
    assert none is None and codes.shape == (3, 5, CFG["num_quantizers"])
    assert_close(latents, lat_j, atol=ATOL)
    flat = latents.reshape(15, -1).numpy()
    assert_codes_match(flat, params["codebooks"], codes.reshape(15, -1).numpy(),
                       np.asarray(codes_j).reshape(15, -1), TIE_TOL)


def test_forward_decodes_the_quantized_latents(codecs):
    codec, params, port = codecs
    audio = _audio(2, 4 * 320, seed=2)
    expected = codec.apply({"params": params}, jnp.asarray(audio))
    with torch.no_grad():
        recon = port(t(audio))
    assert recon.shape == (2, 4 * 320)
    assert_close(recon, expected, atol=ATOL)


def test_dequantize_and_rq_match_jax(codecs):
    codec, params, port = codecs
    rng = np.random.default_rng(3)
    codes = rng.integers(0, CFG["codebook_size"], (2, 5, CFG["num_quantizers"])).astype(np.int32)
    latents = normal(rng, 2, 5, CFG["codebook_dim"])
    quant_j, ce_j = codec.apply({"params": params}, jnp.asarray(latents), jnp.asarray(codes),
                                method=codec.rq)
    audio_j = codec.apply({"params": params}, jnp.asarray(codes), method=codec.decode_from_codes)
    with torch.no_grad():
        quant, ce = port.rq(t(latents), torch.from_numpy(codes))
        audio = port.decode_from_codes(torch.from_numpy(codes))
    assert_close(quant, quant_j, atol=1e-6)
    assert_close(ce, ce_j, atol=1e-4, rtol=1e-5)
    assert_close(audio, audio_j, atol=ATOL)
