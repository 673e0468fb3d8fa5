"""Port parity for the conditioning stack's modules, each against its JAX
twin on the same numpy inputs and jittered weights: the mask helpers,
`f0_to_coarse`, the plain `FeedForward`, `ResnetBlock` and `ConvBlock`,
masked, causal and queries-included `Attention` (plain and flash), the
Perceiver resampler, the phoneme and speech-prompt encoders, the duration
/ pitch predictor and the aligner's network."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import blocks as jb
from naturalspeech2_tpu.models import encoders as je
from naturalspeech2_tpu.models.aligner import AlignerNet as JAlignerNet
from naturalspeech2_tpu.models.transformer import Attention as JAttention
from naturalspeech2_tpu.ops.pitch import f0_to_coarse as j_f0_to_coarse
from naturalspeech2_tpu.utils import helpers as jh
from naturalspeech2_tpu_torch import params as tparams
from naturalspeech2_tpu_torch.models import blocks as tb
from naturalspeech2_tpu_torch.models import encoders as te
from naturalspeech2_tpu_torch.models.aligner import AlignerNet
from naturalspeech2_tpu_torch.models.transformer import Attention
from naturalspeech2_tpu_torch.ops.pitch import f0_to_coarse
from naturalspeech2_tpu_torch.utils import helpers as th

from torch_parity import assert_close, jitter, normal, numpy_tree, t

# f32 convs, projections and softmaxes over ≤ 64 terms, summed in another
# order, through at most two residual layers; activations are O(1)
ATOL = 5e-5
B, N, D = 2, 13, 16
KEY = jax.random.PRNGKey(0)


def _init(mod, *args, seed, **kwargs):
    """Jittered numpy params of a flax module and its output on them."""
    jargs = [jnp.asarray(a) for a in args]
    params = jitter(numpy_tree(mod.init(KEY, *jargs, **kwargs)["params"]), seed)
    out = mod.apply({"params": params}, *jargs, **kwargs)
    return params, tuple(map(np.asarray, out)) if isinstance(out, tuple) else np.asarray(out)


def _load(module, tree, mapper):
    """Load a JAX subtree through the param loader's own mapper."""
    conv = tparams._Converter({"m": tree})
    mapper(conv, "m", "m")
    module.load_state_dict({k[2:]: v for k, v in conv.finish().items()}, strict=True)
    return module


def _mask(rng, b, n):
    mask = rng.random((b, n)) > 0.3
    mask[:, 0] = True
    return mask


def test_mask_helpers_match_jax():
    rng = np.random.default_rng(0)
    lengths = np.array([0, 3, 7, 9], np.int32)
    assert torch.equal(th.create_mask(torch.from_numpy(lengths), 7),
                       torch.from_numpy(np.array(jh.create_mask(jnp.asarray(lengths), 7))))
    x = normal(rng, 2, 5, 3)
    for length, axis in ((8, 1), (3, 1), (5, 1), (6, -1), (2, -1)):
        assert_close(th.pad_or_curtail_to_length(t(x), length, axis=axis),
                     jh.pad_or_curtail_to_length(jnp.asarray(x), length, axis=axis), atol=0)
    # float durations are truncated; frames past the total stay False
    repeats = rng.uniform(0, 4, (3, 6)).astype(np.float32)
    for frames in (4, 12, 30):
        expected = np.array(jh.generate_mask_from_repeats(jnp.asarray(repeats), frames))
        assert torch.equal(th.generate_mask_from_repeats(t(repeats), frames),
                           torch.from_numpy(expected))


def test_f0_to_coarse_matches_jax():
    rng = np.random.default_rng(1)
    f0 = np.concatenate([[0.0, 50.0, 1100.0, 2000.0],
                         rng.uniform(0, 1200, 4000)]).astype(np.float32)
    got = f0_to_coarse(t(f0)).numpy()
    want = np.asarray(j_f0_to_coarse(jnp.asarray(f0)))
    assert got.dtype == want.dtype == np.int32
    # a bin may differ only where the scaled mel value + 0.5 lies within
    # 1e-4 of an integer (f32 log rounding at a boundary)
    mel = 1127.0 * np.log1p(f0.astype(np.float64) / 700.0)
    lo, hi = (1127.0 * np.log(1 + f / 700.0) for f in (50.0, 1100.0))
    frac = ((mel - lo) * 254 / (hi - lo) + 1.5) % 1.0
    near = np.minimum(frac, 1 - frac) < 1e-4
    assert np.array_equal(got[~near], want[~near])
    assert np.all(np.abs(got - want) <= 1)


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_plain_feedforward_matches_jax(approximate):
    x = normal(np.random.default_rng(2), B, N, D)
    params, expected = _init(jb.FeedForward(D, gelu_approximate=approximate), x, seed=3)
    port = tb.FeedForward(D, causal_conv=False, gelu_approximate=approximate)
    _load(port, params, tparams._Converter.plain_ff)
    with torch.no_grad():
        assert_close(port(t(x)), expected, atol=ATOL)


@pytest.mark.parametrize("dim_out", [16, 24], ids=["same_width", "projected"])
def test_resnet_and_conv_blocks_match_jax(dim_out):
    x = normal(np.random.default_rng(4), B, N, D)
    params, expected = _init(jb.ResnetBlock(dim_out, 3), x, seed=5)
    port = tb.ResnetBlock(D, dim_out, 3)
    state = {}
    for j in range(2):
        unit = params[f"ConvUnit_{j}"]
        state[f"units.{j}.conv.weight"] = t(unit["Conv_0"]["kernel"]).permute(2, 1, 0)
        state[f"units.{j}.conv.bias"] = t(unit["Conv_0"]["bias"])
        state[f"units.{j}.norm.weight"] = t(unit["GroupNorm_0"]["scale"])
        state[f"units.{j}.norm.bias"] = t(unit["GroupNorm_0"]["bias"])
    if dim_out != D:
        state["res_conv.weight"] = t(params["Conv_0"]["kernel"]).permute(2, 1, 0)
        state["res_conv.bias"] = t(params["Conv_0"]["bias"])
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        assert_close(port(t(x)), expected, atol=ATOL)

    params, expected = _init(jb.ConvBlock(dim_out, 5), x, seed=6)
    port = tb.ConvBlock(D, dim_out, 5)
    port.load_state_dict({"conv.weight": t(params["Conv_0"]["kernel"]).permute(2, 1, 0),
                          "conv.bias": t(params["Conv_0"]["bias"])})
    with torch.no_grad():
        assert_close(port(t(x)), expected, atol=ATOL)


# (use_flash, causal, masked, context width or None, include queries)
ATTENTION = {
    "plain_masked": (False, False, True, None, False),
    "plain_causal": (False, True, False, None, False),
    "flash_masked_causal": (True, True, True, None, False),
    "plain_cross_include_queries": (False, False, True, D, True),
    "flash_cross_include_queries": (True, False, True, D, True),
    "flash_cross_wider_context": (True, False, True, 24, False),
}


@pytest.mark.parametrize("case", ATTENTION.values(), ids=ATTENTION.keys())
def test_attention_matches_jax(case):
    use_flash, causal, masked, dc, include = case
    rng = np.random.default_rng(7)
    x = normal(rng, B, N, D)
    ctx = normal(rng, B, 9, dc) if dc else None
    mask = _mask(rng, B, 9 if dc else N) if masked else None
    mod = JAttention(dim=D, dim_head=8, heads=2, causal=causal, use_flash=use_flash,
                     cross_attn_include_queries=include)
    kwargs = {} if ctx is None else {"context": jnp.asarray(ctx)}
    if mask is not None:
        kwargs["mask"] = jnp.asarray(mask)
    params, expected = _init(mod, x, seed=8, **kwargs)
    port = Attention(D, 8, 2, dim_context=dc, causal=causal, use_flash=use_flash,
                     cross_attn_include_queries=include)
    _load(port, params, tparams._Converter.attention)
    with torch.no_grad():
        out = port(t(x), context=None if ctx is None else t(ctx),
                   mask=None if mask is None else torch.from_numpy(mask))
    assert out.shape == (B, N, D)
    assert_close(out, expected, atol=ATOL)


def test_plain_attention_dropout_in_training_raises():
    """Once refused, now ported: in training mode the plain route drops
    attention probabilities (drawn from torch's default generator, so a
    seed repeats them); in eval mode it runs without dropout. The keep
    rate and the JAX keep rule: tests/test_torch_aligner.py."""
    port = Attention(D, 8, 2, dropout=0.1)
    x = t(normal(np.random.default_rng(12), 1, 4, D))
    torch.manual_seed(0)
    a = port(x)
    torch.manual_seed(0)
    b = port(x)
    port.eval()
    c = port(x)
    assert a.shape == c.shape == (1, 4, D) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module")
def encoders():
    """Each encoder's JAX params (jittered) and output on seeded inputs."""
    rng = np.random.default_rng(9)
    prompt = normal(rng, B, 11, 24)
    prompt_mask = _mask(rng, B, 11)
    text = rng.integers(-1, 20, (B, N)).astype(np.int32)
    latents = normal(rng, B, 10, D)
    phonemes = normal(rng, B, N, 24)
    mel = normal(rng, B, 17, 8)
    out = {}
    out["resampler"] = (
        _init(je.PerceiverResampler(dim=D, depth=2, dim_context=24, num_latents=8, dim_head=8,
                                    heads=2, use_flash_attn=True),
              prompt, seed=10, mask=jnp.asarray(prompt_mask)),
        (t(prompt),), {"mask": torch.from_numpy(prompt_mask)})
    out["phoneme"] = (
        _init(je.PhonemeEncoder(num_tokens=20, dim=24, dim_hidden=16, depth=2, heads=2,
                                dim_head=8), text, seed=11, mask=jnp.asarray(text >= 0)),
        (torch.from_numpy(text).long(),), {"mask": torch.from_numpy(text >= 0)})
    out["prompt"] = (
        _init(je.SpeechPromptEncoder(dim_codebook=D, dims=(24, 32, 24), depth=2, heads=2,
                                     dim_head=8), latents, seed=12),
        (t(latents),), {})
    for act in ("relu", "softplus"):
        out[f"duration_pitch_{act}"] = (
            _init(je.DurationPitchPredictor(dim=24, dim_encoded_prompts=24, depth=2, heads=2,
                                            dim_head=8, dim_hidden=24, head_activation=act),
                  phonemes, prompt, seed=13, prompt_mask=jnp.asarray(prompt_mask)),
            (t(phonemes), t(prompt)), {"prompt_mask": torch.from_numpy(prompt_mask)})
    out["aligner"] = (
        _init(JAlignerNet(dim_in=8, dim_hidden=24, attn_channels=8), mel, phonemes, seed=14,
              mask=jnp.asarray(_mask(np.random.default_rng(15), B, N))),
        (t(mel), t(phonemes)), {"mask": torch.from_numpy(_mask(np.random.default_rng(15), B, N))})
    return out


PORTS = {
    "resampler": (lambda: te.PerceiverResampler(D, 2, dim_context=24, num_latents=8,
                                                dim_head=8, heads=2, use_flash_attn=True),
                  tparams._resampler),
    "phoneme": (lambda: te.PhonemeEncoder(20, dim=24, dim_hidden=16, depth=2, heads=2,
                                          dim_head=8), tparams._phoneme_enc),
    "prompt": (lambda: te.SpeechPromptEncoder(D, dims=(24, 32, 24), depth=2, heads=2,
                                              dim_head=8), tparams._prompt_enc),
    "duration_pitch_relu": (lambda: te.DurationPitchPredictor(
        24, dim_encoded_prompts=24, depth=2, heads=2, dim_head=8, dim_hidden=24),
        tparams._duration_pitch),
    "duration_pitch_softplus": (lambda: te.DurationPitchPredictor(
        24, dim_encoded_prompts=24, depth=2, heads=2, dim_head=8, dim_hidden=24,
        head_activation="softplus"), tparams._duration_pitch),
    "aligner": (lambda: AlignerNet(dim_in=8, dim_hidden=24, attn_channels=8),
                tparams._aligner_net),
}


@pytest.mark.parametrize("name", PORTS)
def test_encoder_matches_jax(encoders, name):
    (params, expected), args, kwargs = encoders[name]
    make, mapper = PORTS[name]
    port = _load(make(), params, mapper).eval()
    with torch.no_grad():
        out = port(*args, **kwargs)
    if name.startswith("duration_pitch") or name == "aligner":
        for got, want in zip(out, expected):
            assert_close(got, want, atol=ATOL)
    else:
        assert_close(out, expected, atol=ATOL)
