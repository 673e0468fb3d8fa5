"""Constructor fields of the JAX modules, held in the port against the JAX
package: `NaturalSpeech2(schedule_kwargs=, target_sample_hz=)`,
`SoundStream(use_pallas_rvq=, target_sample_hz=)`, `Model(remat=)` and
`Transformer(causal=, final_norm=)` give the JAX module's results with the
same field; conditional training's and self-conditioning's fields are
kept as given, with the JAX module's defaults; no field of the JAX module
is refused any longer, and an unknown one is a TypeError."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.models.transformer import Transformer as JTransformer
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params
from naturalspeech2_tpu_torch import params as tparams
from naturalspeech2_tpu_torch.models import naturalspeech2 as tns2
from naturalspeech2_tpu_torch.models.transformer import Transformer
from naturalspeech2_tpu_torch.utils.tokenizer import Tokenizer

from torch_parity import assert_close, assert_codes_match, jitter, normal, numpy_tree, t

MODEL_CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=3)
# γ(t) and sample rates: elementwise f32 functions, the same formulas
ATOL = 1e-6
# the loss and gradients through ~20 f32 layers, as tests/test_torch_loss.py
LOSS_RTOL, GRAD_RTOL = 1e-5, 2e-4
# two pre-norm layers of f32 attention and MLP, outputs O(1)
TRANSFORMER_ATOL = 5e-5

SCHEDULES = {"sigmoid": dict(start=-2.0, end=4.0, tau=0.7),
             "cosine": dict(start=0.1, end=0.9, tau=1.5),
             "linear": dict(clip_min=0.2)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_kwargs_shape_gamma_as_in_jax(name):
    kwargs = SCHEDULES[name]
    times = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), noise_schedule=name,
                                schedule_kwargs=kwargs)
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), noise_schedule=name, schedule_kwargs=kwargs)
    expected = ns2_j.gamma_schedule(jnp.asarray(times))
    assert_close(ns2_t.gamma_schedule(t(times)), expected, atol=ATOL)
    default = NaturalSpeech2(Model(**MODEL_CFG), noise_schedule=name).gamma_schedule(t(times))
    assert not torch.allclose(default, ns2_t.gamma_schedule(t(times)))


def test_target_sample_hz_as_in_jax():
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), target_sample_hz=16000)
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), target_sample_hz=16000)
    assert ns2_t.sample_hz == ns2_j.sample_hz == 16000
    codec_j, codec_t = (JSoundStream(**CODEC_CFG, target_sample_hz=22050),
                        SoundStream(**CODEC_CFG, target_sample_hz=22050))
    with_codec_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=codec_j,
                                       target_sample_hz=16000)
    with_codec_t = NaturalSpeech2(Model(**MODEL_CFG), codec_t, target_sample_hz=16000)
    assert with_codec_t.sample_hz == with_codec_j.sample_hz == 22050
    assert SoundStream(**CODEC_CFG).target_sample_hz == JSoundStream(**CODEC_CFG).target_sample_hz


@pytest.mark.parametrize("use_pallas_rvq", [False, True], ids=["rvq_xla", "pallas_rvq"])
def test_use_pallas_rvq_codes_and_straight_through_as_in_jax(use_pallas_rvq):
    rng = np.random.default_rng(3)
    latents = normal(rng, 2, 20, CODEC_CFG["codebook_dim"])
    codebooks = normal(rng, CODEC_CFG["num_quantizers"], CODEC_CFG["codebook_size"],
                       CODEC_CFG["codebook_dim"])
    w = normal(rng, *latents.shape)
    codec_j = JSoundStream(**CODEC_CFG, use_pallas_rvq=use_pallas_rvq)
    variables = {"params": {"codebooks": jnp.asarray(codebooks)}}

    def loss_j(x):
        quantized, codes = codec_j.apply(variables, x, method=codec_j.quantize)
        return jnp.sum(quantized * jnp.asarray(w)), (quantized, codes)

    grad_j, (quantized_j, codes_j) = jax.grad(loss_j, has_aux=True)(jnp.asarray(latents))

    codec_t = SoundStream(**CODEC_CFG, use_pallas_rvq=use_pallas_rvq)
    with torch.no_grad():
        codec_t.codebooks.copy_(t(codebooks))
    x = t(latents).requires_grad_()
    quantized, codes = codec_t.quantize(x)
    flat = latents.reshape(-1, latents.shape[-1])
    same = assert_codes_match(flat, codebooks, codes.reshape(flat.shape[0], -1).numpy(),
                              np.asarray(codes_j).reshape(flat.shape[0], -1), 1e-4)
    assert same.all()
    assert_close(quantized, quantized_j, atol=1e-5)
    (quantized * t(w)).sum().backward()
    assert_close(x.grad, grad_j, atol=0)  # straight through: exactly w
    assert codec_t.codebooks.grad is None


@pytest.fixture(scope="module")
def scan_params():
    jmodel = JModel(**MODEL_CFG, scan_layers=True)
    tree = {
        "model": jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                             jnp.zeros((1,)))["params"],
        "codec": JSoundStream(**CODEC_CFG).init(jax.random.PRNGKey(1),
                                                jnp.zeros((1, 640)))["params"],
    }
    return jitter(numpy_tree(tree), 5, scale=0.1)


def test_remat_loss_and_gradients_as_in_jax(scan_params):
    """`Model(remat=True)` (JAX: `nn.remat` around each scanned layer) gives
    the loss and gradients of JAX's remat model, and of the port without
    remat."""
    rng = np.random.default_rng(8)
    frames = 8
    audio = np.tanh(normal(rng, 2, frames * 320))
    times = rng.uniform(0.05, 0.95, 2).astype(np.float32)
    noise = normal(rng, 2, frames, 16)
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG, scan_layers=True, remat=True),
                                codec=JSoundStream(**CODEC_CFG), timesteps=1000)

    def loss_j(p):
        return ns2_j.apply({"params": p}, jnp.asarray(audio), times=jnp.asarray(times),
                           noise=jnp.asarray(noise))["loss"]

    loss_value, grads_j = jax.value_and_grad(loss_j)(scan_params)
    expected = load_jax_params(numpy_tree(grads_j))

    results = []
    for remat in (True, False):
        ns2_t = NaturalSpeech2(Model(**MODEL_CFG, scan_layers=True, remat=remat),
                               SoundStream(**CODEC_CFG), timesteps=1000)
        ns2_t.load_state_dict(load_jax_params(scan_params), strict=True)
        loss = ns2_t(t(audio), times=t(times), noise=t(noise))["loss"]
        loss.backward()
        results.append((loss, {n: p.grad for n, p in ns2_t.named_parameters()}))
    (loss_remat, grads_remat), (loss_plain, grads_plain) = results
    assert ns2_t.model.transformer.remat is False
    assert_close(loss_remat, loss_value, atol=0, rtol=LOSS_RTOL)
    assert torch.equal(loss_remat, loss_plain)
    for name, want in expected.items():
        if not name.startswith("model."):
            continue
        scale = max(float(np.abs(want.numpy()).max()), 1e-6)
        assert_close(grads_remat[name] / scale, want.numpy() / scale, atol=GRAD_RTOL)
        assert torch.allclose(grads_remat[name], grads_plain[name], atol=1e-6 * scale, rtol=0)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_transformer_causal_final_norm_as_in_jax(use_flash, masked):
    rng = np.random.default_rng(9)
    b, n, dim = 2, 13, 16
    x = normal(rng, b, n, dim)
    mask = None
    if masked:
        mask = rng.random((b, n)) > 0.3
        mask[:, 0] = True
    cfg = dict(dim=dim, depth=2, causal=True, dim_head=8, heads=2, use_flash=use_flash,
               final_norm=True)
    mod = JTransformer(**cfg)
    kwargs = {} if mask is None else {"mask": jnp.asarray(mask)}
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs)["params"]
    params = jitter(numpy_tree(params), 10)
    assert "final_norm" in params
    expected = mod.apply({"params": params}, jnp.asarray(x), **kwargs)

    port = Transformer(**cfg)
    conv = tparams._Converter({"m": params})
    tparams._transformer(conv, "m", "m")
    port.load_state_dict({k[2:]: v for k, v in conv.finish().items()}, strict=True)
    with torch.no_grad():
        out = port(t(x), mask=None if mask is None else torch.from_numpy(mask))
    assert_close(out, expected, atol=TRANSFORMER_ATOL)


# The JAX module's fields that the port once refused for later slices, with
# a value other than the default: conditional training's (pitch, mel, the
# loss weights and masking), the text frontend's tokenizer and
# self-conditioning's share of bootstrapped rows are ported now and kept as
# given, with the JAX module's defaults.
ONCE_LATER = {"tokenizer": Tokenizer(), "calc_pitch_with_pyworld": False,
              "train_prob_self_cond": 0.5,
              "mel_hop_length": 200, "audio_to_mel_kwargs": {"f_max": 7000.0},
              "duration_loss_weight": 0.5, "pitch_loss_weight": 2.0, "aligner_loss_weight": 0.3,
              "aligner_bin_loss_weight": 0.1, "mask_duration_pitch_loss": False}


@pytest.mark.parametrize("field", list(ONCE_LATER))
def test_later_slice_fields_raise_not_implemented(field):
    assert field in jns2.NaturalSpeech2.__dataclass_fields__
    ns2 = NaturalSpeech2(Model(**MODEL_CFG), **{field: ONCE_LATER[field]})
    assert getattr(ns2, field) == ONCE_LATER[field]
    default = jns2.NaturalSpeech2.__dataclass_fields__[field].default
    assert getattr(NaturalSpeech2(Model(**MODEL_CFG)), field) == (
        {} if default is None and field != "tokenizer" else default)


def test_later_fields_name_their_items():
    """No field of the JAX module is left for a later slice: the table of
    refused fields is gone, and every field the JAX module has is a
    constructor argument of the port's."""
    import inspect

    assert not hasattr(tns2, "_LATER_FIELDS")
    params = inspect.signature(NaturalSpeech2).parameters
    assert not any(p.kind is p.VAR_KEYWORD for p in params.values())
    jax_fields = set(jns2.NaturalSpeech2.__dataclass_fields__) - {"parent", "name"}
    assert jax_fields <= set(params)


def test_unknown_field_is_still_a_type_error():
    with pytest.raises(TypeError, match="no_such_field"):
        NaturalSpeech2(Model(**MODEL_CFG), no_such_field=1)
