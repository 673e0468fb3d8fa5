"""Port parity: `Encodec` (`naturalspeech2_tpu_torch/models/encodec.py`)
against `naturalspeech2_tpu/models/encodec.py` on the same parameters: the
reflect-pad guard, the causal / split-padded conv with and without its
GroupNorm, the trimmed transposed conv, the residual LSTM, the 24-kHz
codec's encode, quantize, decode and reference contract, the 48-kHz
knobs' chunked encode (a partial last chunk) and overlap-add decode, and
`NaturalSpeech2(codec=Encodec)`'s loss, gradients and sample."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import encodec as jenc
from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, load_jax_params, sample
from naturalspeech2_tpu_torch.models import encodec as penc

from torch_parity import assert_close, assert_codes_match, jitter, normal, numpy_tree, t

# small widths: 4 filters, ratios (4, 2) (hop 8), Q 2, K 32,
# one LSTM layer
CFG_24K = dict(codebook_dim=16, num_filters=4, upsampling_ratios=(4, 2), num_quantizers=2,
               codebook_size=32, num_lstm_layers=1)
# the 48-kHz model's knobs at the same widths (tests/test_golden_encodec.py)
CFG_48K = dict(CFG_24K, target_sample_hz=1600, causal=False, norm_type="time_group_norm",
               audio_channels=2, normalize=True, chunk_length_s=0.1, overlap=0.25)
# f32 convs and an LSTM in another summation order: ~1e-7 of the largest
# entry; a layout or padding fault is O(1)
RTOL_OF_MAX = 1e-5
# squared distances are O(10) at d 16: two codes closer than this may swap
TIE_TOL = 1e-4


def _close(actual, expected, rtol=RTOL_OF_MAX):
    expected = np.asarray(expected)
    scale = max(float(np.abs(expected).max()), 1e-30)
    assert_close(actual, expected, atol=rtol * scale)


def _init(module, *args):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *args)["params"]
    return jitter(numpy_tree(params), 1, scale=0.05)


@pytest.mark.parametrize("t_len, left, right, mode", [
    (3, 6, 0, "reflect"),  # t ≤ pad: zeros, reflection, trim
    (6, 6, 1, "reflect"),  # t == pad
    (10, 3, 2, "reflect"),
    (4, 2, 5, "constant"),
])
def test_pad1d_matches_jax(t_len, left, right, mode):
    x = normal(np.random.default_rng(t_len), 2, t_len, 3)
    expected = jenc._pad1d(jnp.asarray(x), left, right, mode)
    got = penc._pad1d(t(x).transpose(1, 2), left, right, mode).transpose(1, 2)
    assert_close(got, expected, atol=0)


@pytest.mark.parametrize("k, stride, dilation, causal, norm, t_len", [
    (7, 1, 1, True, "weight_norm", 93),
    (4, 2, 1, True, "weight_norm", 93),  # t not a stride multiple
    (3, 1, 2, False, "time_group_norm", 11),
    (8, 4, 1, False, "time_group_norm", 3),  # the reflect guard
])
def test_conv_matches_jax(k, stride, dilation, causal, norm, t_len):
    x = normal(np.random.default_rng(k), 2, t_len, 5)
    mod = jenc.EncodecConv(6, k, stride=stride, dilation=dilation, causal=causal, norm_type=norm)
    params = _init(mod, jnp.asarray(x))
    expected = mod.apply({"params": params}, jnp.asarray(x))
    port = penc.EncodecConv(5, 6, k, stride=stride, dilation=dilation, causal=causal,
                            norm_type=norm)
    state = {"conv.weight": t(params["conv"]["kernel"]).permute(2, 1, 0),
             "conv.bias": t(params["conv"]["bias"])}
    if norm == "time_group_norm":
        state.update({"norm.weight": t(params["norm"]["scale"]),
                      "norm.bias": t(params["norm"]["bias"])})
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(t(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == expected.shape == (2, -(-t_len // stride), 6)
    _close(got, expected)


@pytest.mark.parametrize("k, stride, causal, ratio, norm", [
    (8, 4, True, 1.0, "weight_norm"),
    (8, 4, True, 0.5, "weight_norm"),
    (4, 2, False, 1.0, "time_group_norm"),
])
def test_conv_transpose_matches_jax(k, stride, causal, ratio, norm):
    x = normal(np.random.default_rng(k + stride), 2, 7, 5)
    mod = jenc.EncodecConvTranspose(3, k, stride=stride, causal=causal, trim_right_ratio=ratio,
                                    norm_type=norm)
    params = _init(mod, jnp.asarray(x))
    expected = mod.apply({"params": params}, jnp.asarray(x))
    port = penc.EncodecConvTranspose(5, 3, k, stride=stride, causal=causal,
                                     trim_right_ratio=ratio, norm_type=norm)
    # the converter's rule: flax [k, in, out] → reversed taps, [in, out, k]
    state = {"conv.weight": t(params["conv"]["kernel"]).flip(0).permute(1, 2, 0),
             "conv.bias": t(params["conv"]["bias"])}
    if norm == "time_group_norm":
        state.update({"norm.weight": t(params["norm"]["scale"]),
                      "norm.bias": t(params["norm"]["bias"])})
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(t(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == expected.shape == (2, 7 * stride, 3)
    _close(got, expected)


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_matches_jax(layers):
    x = normal(np.random.default_rng(layers), 2, 9, 8)
    mod = jenc.EncodecLSTM(8, layers)
    params = _init(mod, jnp.asarray(x))
    expected = mod.apply({"params": params}, jnp.asarray(x))
    port = penc.EncodecLSTM(8, layers)
    state = {}
    for layer in range(layers):
        for w in ("ih", "hh"):
            state[f"lstm.weight_{w}_l{layer}"] = t(params[f"w_{w}_{layer}"]).T
            state[f"lstm.bias_{w}_l{layer}"] = t(params[f"b_{w}_{layer}"])
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(t(x).transpose(1, 2)).transpose(1, 2)
    _close(got, expected)


@pytest.fixture(scope="module")
def codec_24k():
    """(JAX Encodec, its jittered params, the port on them)."""
    codec = jenc.Encodec(use_pallas_rvq=False, **CFG_24K)
    params = _init(codec, jnp.zeros((1, 64)))
    port = penc.Encodec(use_pallas_rvq=False, **CFG_24K)
    port.load_state_dict(load_jax_params(params), strict=True)
    return codec, params, port


@pytest.mark.parametrize("t_len", [5, 93, 96])
def test_encode_latents_matches_jax(codec_24k, t_len):
    """T ≤ the first conv's pad (the reflect guard in every conv), T not a
    hop multiple, T a hop multiple."""
    codec, params, port = codec_24k
    audio = normal(np.random.default_rng(t_len), 2, t_len, scale=0.3)
    expected = codec.apply({"params": params}, jnp.asarray(audio), method=codec.encode_latents)
    with torch.no_grad():
        got = port.encode_latents(t(audio))
    assert got.shape == expected.shape == (2, -(-t_len // 8), 16)
    _close(got, expected)


@pytest.mark.parametrize("use_pallas_rvq", [False, True])
def test_quantize_and_contract_match_jax(codec_24k, use_pallas_rvq):
    """quantize (K6's plain version, or the twin of `rvq_xla`) against JAX's
    `rvq_xla`, codes tie-tolerantly; dequantize, rq, decode, decode with
    quantize, decode_from_codes and the reference call with
    curtail_from_left."""
    codec, params, port = codec_24k
    port.use_pallas_rvq = use_pallas_rvq
    variables = {"params": params}
    rng = np.random.default_rng(3)
    latents = normal(rng, 2, 11, 16)
    quantized_j, codes_j = codec.apply(variables, jnp.asarray(latents), method=codec.quantize)
    with torch.no_grad():
        quantized, codes = port.quantize(t(latents))
    same = assert_codes_match(latents.reshape(-1, 16), params["codebooks"],
                              codes.reshape(-1, 2).numpy(), np.asarray(codes_j).reshape(-1, 2),
                              TIE_TOL)
    assert same.mean() > 0.9
    _close(quantized.reshape(-1, 16)[torch.from_numpy(same)],
           np.asarray(quantized_j).reshape(-1, 16)[same])
    codes_np = np.array(codes_j)
    deq_j = codec.apply(variables, jnp.asarray(codes_np), method=codec.dequantize)
    _, ce_j = codec.apply(variables, jnp.asarray(latents), jnp.asarray(codes_np), method=codec.rq)
    with torch.no_grad():
        codes_t = torch.from_numpy(codes_np)
        deq, ce = port.rq(t(latents), codes_t)
        _close(deq, deq_j)
        _close(port.dequantize(codes_t), deq_j)
        assert_close(ce, ce_j, atol=0, rtol=1e-5)
        _close(port.decode(t(latents)),
               codec.apply(variables, jnp.asarray(latents), method=codec.decode))
        _close(port.decode_from_codes(codes_t),
               codec.apply(variables, jnp.asarray(codes_np), method=codec.decode_from_codes))
        if same.all():
            _close(port.decode(t(latents), quantize=True),
                   codec.apply(variables, jnp.asarray(latents), True, method=codec.decode))

    audio = normal(rng, 2, 8 * 12 + 5, scale=0.2)
    lat_j, codes_j, _ = codec.apply(variables, jnp.asarray(audio), return_encoded=True,
                                    curtail_from_left=True)
    with torch.no_grad():
        lat, codes, none = port(t(audio), return_encoded=True, curtail_from_left=True)
        assert none is None and lat.shape == (2, 12, 16) and codes.shape == (2, 12, 2)
        _close(lat, lat_j)
        # the curtailed input is the last 96 samples
        _close(port.encode_latents(t(audio[:, 5:])), lat_j)
        assert_codes_match(lat_j.reshape(-1, 16), params["codebooks"],
                           codes.reshape(-1, 2).numpy(), np.asarray(codes_j).reshape(-1, 2),
                           TIE_TOL)


def test_48k_chunked_encode_decode_matches_jax():
    """time_group_norm, split padding, stereo, per-chunk loudness scale;
    160-sample chunks at stride 120 over 477 samples: four chunks, the last
    partial (codes zero-padded), then the triangular overlap-add."""
    codec = jenc.Encodec(use_pallas_rvq=False, **CFG_48K)
    params = _init(codec, jnp.zeros((1, 2, 64)))
    port = penc.Encodec(use_pallas_rvq=False, **CFG_48K)
    port.load_state_dict(load_jax_params(params), strict=True)
    variables = {"params": params}
    audio = normal(np.random.default_rng(11), 2, 2, 160 + 2 * 120 + 77, scale=0.3)

    codes_j, scales_j, pad_j = codec.apply(variables, jnp.asarray(audio),
                                           method=codec.encode_chunked)
    with torch.no_grad():
        codes, scales, pad = port.encode_chunked(t(audio))
    assert codes.shape == codes_j.shape == (4, 2, 20, 2) and pad == pad_j > 0
    for f, (s, s_j) in enumerate(zip(scales, scales_j)):
        assert_close(s, s_j, atol=0, rtol=1e-6)
    # the frames' latents decide the codes; hold them tie-tolerantly
    for f in range(4):
        frame = t(audio)[..., f * 120: f * 120 + 160]
        frame = frame / scales[f][:, :, None]
        with torch.no_grad():
            lat = port.encode_latents(frame)
        n = lat.shape[1]
        assert_codes_match(lat.reshape(-1, 16), params["codebooks"],
                           codes[f, :, :n].reshape(-1, 2).numpy(),
                           np.asarray(codes_j)[f, :, :n].reshape(-1, 2), TIE_TOL)
    assert not codes[-1, :, 20 - pad:].any()

    expected = codec.apply(variables, codes_j, scales_j, pad_j, method=codec.decode_chunked)
    with torch.no_grad():
        got = port.decode_chunked(torch.from_numpy(np.array(codes_j)),
                                  [t(s) for s in scales_j], pad_j)
    assert got.shape == expected.shape == (2, 2, 3 * 120 + 15 * 8)  # the last frame's 15 hops
    _close(got, expected)


# ------------------------------------------------------------------ #
# NaturalSpeech2 with the Encodec codec
# ------------------------------------------------------------------ #

MODEL_CFG = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=1)
B, FRAMES, STEPS = 2, 12, 3
# the loss a mean of O(1) squares; gradients per tensor against their own
# largest entry, through the fused WaveNet's twin and the transformer
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def ns2_pair():
    jmodel = JModel(**MODEL_CFG)
    jcodec = jenc.Encodec(use_pallas_rvq=False, **CFG_24K)
    tree = {"model": jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                                          jnp.zeros((1,)))["params"],
            "codec": jax.jit(jcodec.init)(jax.random.PRNGKey(1), jnp.zeros((1, 64)))["params"]}
    tree = jitter(numpy_tree(tree), 3, scale=0.05)
    return jmodel, jcodec, tree


@pytest.mark.parametrize("ce_weight", [0.0, 0.5], ids=["loss", "rvq_ce"])
def test_ns2_encodec_loss_and_gradients_match_jax(ns2_pair, ce_weight):
    jmodel, jcodec, tree = ns2_pair
    rng = np.random.default_rng(5)
    audio = np.tanh(normal(rng, B, FRAMES * 8 + 3))  # trimmed to whole frames
    times = rng.uniform(0.05, 0.95, B).astype(np.float32)
    noise = normal(rng, B, FRAMES, 16)
    ns2_j = jns2.NaturalSpeech2(model=jmodel, codec=jcodec, timesteps=1000,
                                rvq_cross_entropy_loss_weight=ce_weight)

    def loss_j(p):
        losses = ns2_j.apply({"params": p}, jnp.asarray(audio), times=jnp.asarray(times),
                             noise=jnp.asarray(noise))
        return losses["loss"], losses

    (_, losses_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(tree)
    port = NaturalSpeech2(Model(**MODEL_CFG),
                          penc.Encodec(use_pallas_rvq=False, **CFG_24K), timesteps=1000,
                          rvq_cross_entropy_loss_weight=ce_weight)
    port.load_state_dict(load_jax_params(tree), strict=True)
    losses = port(t(audio), times=t(times), noise=t(noise))
    assert set(losses) == set(losses_j)
    for k in losses:
        assert_close(losses[k], losses_j[k], atol=0, rtol=LOSS_RTOL)
    losses["loss"].backward()
    named = dict(port.named_parameters())
    for name, want in load_jax_params(numpy_tree(grads_j)).items():
        got = named[name].grad
        if name.startswith("model.") or (name == "codec.codebooks" and ce_weight > 0):
            assert got is not None, name
            _close(got, want.numpy(), GRAD_RTOL)
        else:  # the frozen codec: zero in JAX, untouched in the port
            assert got is None and not np.any(want.numpy()), name


def test_ns2_encodec_sample_and_prompt_match_jax(ns2_pair):
    """`sample` (DDIM, then `Encodec.decode`) from JAX's starting noise, and
    the prompt path (`process_prompt`: the codec with curtail_from_left)."""
    jmodel, jcodec, tree = ns2_pair
    key = jax.random.PRNGKey(7)
    ns2_j = jns2.NaturalSpeech2(model=jmodel, codec=jcodec, timesteps=1000)
    expected = jns2.sample(ns2_j, {"params": tree}, key, length=FRAMES, batch_size=B,
                           timesteps=STEPS)
    port = NaturalSpeech2(Model(**MODEL_CFG), penc.Encodec(use_pallas_rvq=False, **CFG_24K),
                          timesteps=1000)
    port.load_state_dict(load_jax_params(tree), strict=True)
    audio = sample(port, length=FRAMES, batch_size=B, timesteps=STEPS,
                   noise=t(jax.random.normal(key, (B, FRAMES, 16))))
    assert audio.shape == expected.shape == (B, FRAMES * 8)
    assert torch.isfinite(audio).all()
    # three DDIM steps amplify the denoiser's f32 differences by their 1/σ
    _close(audio, expected, 2e-4)

    prompt = normal(np.random.default_rng(8), B, 8 * 10 + 6, scale=0.3)
    lat_j, _, _ = jcodec.apply({"params": tree["codec"]}, jnp.asarray(prompt),
                               return_encoded=True, curtail_from_left=True)
    with torch.no_grad():
        _close(port.process_prompt(t(prompt)), lat_j)
