"""The port's checkpoint importer (`naturalspeech2_tpu_torch/utils/
torch_import.py`, `cli.py import-torch`): array for array equal to the JAX
package's `naturalspeech2_tpu.utils.torch_import` on the same state dicts;
a small hand-built reference `Model` state dict imported and run against
the JAX module it came from; HuggingFace `EncodecModel` (random init)
imported and run against HF's own forward; the `torch.save` reader (bf16
widened, nested dicts flattened, arbitrary globals refused); and
`import-torch` output loading with ``strict=True``."""

import collections
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.utils import torch_import as jti
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, cli, load_jax_params
from naturalspeech2_tpu_torch.models.encodec import Encodec
from naturalspeech2_tpu_torch.utils import torch_import as pti

from torch_parity import assert_close, jitter, numpy_tree, t

MODEL_CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2)
# the reference runs exact GELU and the unfused WaveNet
JAX_REF_CFG = dict(MODEL_CFG, use_fused_wavenet=False, gelu_approximate=False)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _reference_model_sd(tree) -> dict:
    """A reference `Model` (naturalspeech2_pytorch.py:811-1000) state dict
    built by hand from an unfused JAX `Model` tree: the inverse of the
    importer's layout rules."""
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = p["kernel"].T.copy()
        if "bias" in p:
            sd[f"{name}.bias"] = p["bias"]

    def conv(name, p):
        sd[f"{name}.weight"] = p["kernel"].transpose(2, 1, 0).copy()
        sd[f"{name}.bias"] = p["bias"]

    sd["to_time_cond.0.weights"] = tree["time_pos_emb"]["weights"]
    lin("to_time_cond.1", tree["to_time_hidden"])
    wn = tree["wavenet"]
    conv("wavenet.init_conv", wn["init_conv"]["Conv_0"])
    conv("wavenet.final_conv", wn["final_conv"]["Conv_0"])
    for s in range(MODEL_CFG["wavenet_stacks"]):
        for layer, block in wn[f"stack_{s}"].items():
            base = f"wavenet.stacks.{s}.blocks.{layer.split('_')[1]}"
            lin(f"{base}.to_time_cond", block["to_time_cond"])
            for c in ("conv", "res_conv", "skip_conv"):
                if c in block:
                    conv(f"{base}.{c}", block[c]["Conv_0"])
    tr = tree["transformer"]
    for i in range(MODEL_CFG["depth"]):
        for j, slot in enumerate((0, 4)):  # attn, ff (no cross-attention)
            k = 2 * i + j
            sd[f"transformer.layers.{i}.{slot}.to_gamma_beta.weight"] = tr["ada_norm_w"][k].T.copy()
            sd[f"transformer.layers.{i}.{slot}.to_gamma_beta.bias"] = tr["ada_norm_b"][k]
        for proj in ("to_q", "to_kv", "to_out"):
            lin(f"transformer.layers.{i}.1.{proj}", tr[f"attn_{i}"][proj])
        ff = tr[f"ff_{i}"]
        lin(f"transformer.layers.{i}.5.0", ff["Dense_0"])
        conv(f"transformer.layers.{i}.5.2.1", ff["CausalConv1d_0"]["Conv_0"])
        lin(f"transformer.layers.{i}.5.3", ff["Dense_1"])
    sd["transformer.to_pred.0.gamma"] = tr["pred_norm"]["gamma"]
    sd["transformer.to_pred.1.weight"] = tr["to_pred"]["kernel"].T.copy()
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _conditional_sd(rng) -> dict:
    """Keys of the reference's conditional modules (prompt conditioning in
    `Model`, phoneme and prompt encoders, duration / pitch trunks, aligner,
    pitch embedding) with random arrays of the right rank: enough for the
    two importers to be compared array for array."""
    sd = {}

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def lin(name, bias=True):
        sd[f"{name}.weight"] = arr(5, 4)
        if bias:
            sd[f"{name}.bias"] = arr(5)

    def conv(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = arr(5, 4, 3), arr(5)

    def attn(name):
        for proj in ("to_q", "to_kv", "to_out"):
            lin(f"{name}.{proj}", bias=False)

    def plain_transformer(prefix):
        for i in range(2):
            sd[f"{prefix}layers.{i}.0.gamma"] = arr(4)
            attn(f"{prefix}layers.{i}.1")
            sd[f"{prefix}layers.{i}.2.gamma"] = arr(4)
            lin(f"{prefix}layers.{i}.3.0")
            lin(f"{prefix}layers.{i}.3.2")

    m = "model."
    sd[f"{m}to_time_cond.0.weights"] = arr(4)
    lin(f"{m}to_time_cond.1")
    for c in ("init_conv", "final_conv"):
        conv(f"{m}wavenet.{c}")
    for s in range(2):
        for layer in range(2):
            base = f"{m}wavenet.stacks.{s}.blocks.{layer}"
            lin(f"{base}.to_time_cond")
            conv(f"{base}.conv")
            conv(f"{base}.res_conv")
            if s == 1:
                conv(f"{base}.skip_conv")
    for slot in (0, 2, 4):
        lin(f"{m}transformer.layers.0.{slot}.to_gamma_beta")
    attn(f"{m}transformer.layers.0.1")
    attn(f"{m}transformer.layers.0.3")
    lin(f"{m}transformer.layers.0.5.0")
    conv(f"{m}transformer.layers.0.5.2.1")
    lin(f"{m}transformer.layers.0.5.3")
    sd[f"{m}transformer.to_pred.0.gamma"] = arr(4)
    sd[f"{m}transformer.to_pred.1.weight"] = arr(4, 4)
    sd[f"{m}null_prompt_cond"], sd[f"{m}null_prompt_tokens"] = arr(4), arr(3, 4)
    sd[f"{m}null_cond"] = arr(1, 4)
    lin(f"{m}to_prompt_cond.1")
    sd[f"{m}perceiver_resampler.latents"] = arr(3, 4)
    lin(f"{m}perceiver_resampler.proj_context")
    sd[f"{m}perceiver_resampler.norm.gamma"] = arr(4)
    attn(f"{m}perceiver_resampler.layers.0.0")
    lin(f"{m}perceiver_resampler.layers.0.1.0")
    lin(f"{m}perceiver_resampler.layers.0.1.2")
    sd[f"{m}cond_to_model_dim.weight"], sd[f"{m}cond_to_model_dim.bias"] = arr(5, 4, 1), arr(5)
    sd["phoneme_enc.token_emb.weight"] = arr(7, 4)
    conv("phoneme_enc.conv.1")
    plain_transformer("phoneme_enc.transformer.")
    conv("prompt_enc.conv.0")
    conv("prompt_enc.conv.2")
    plain_transformer("prompt_enc.transformer.")
    for trunk in ("to_duration_pred", "to_pitch_pred"):
        p = f"duration_pitch.{trunk}."
        for i in range(2):
            for j in range(2):
                for u in range(2):
                    conv(f"{p}layers.{i}.0.{j}.blocks.{u}.proj")
                    sd[f"{p}layers.{i}.0.{j}.blocks.{u}.norm.weight"] = arr(5)
                    sd[f"{p}layers.{i}.0.{j}.blocks.{u}.norm.bias"] = arr(5)
            sd[f"{p}layers.{i}.1.gamma"] = arr(4)
            attn(f"{p}layers.{i}.2")
        lin(f"{p}to_pred.0")
    for name in ("key_layers.0", "key_layers.2", "query_layers.0", "query_layers.2",
                 "query_layers.4"):
        conv(f"aligner.aligner.{name}")
    sd["pitch_emb.weight"] = arr(6, 4)
    return sd


@pytest.fixture(scope="module")
def reference():
    """(unfused JAX Model tree, the reference Model state dict built from it)."""
    x, times = jnp.zeros((1, 8, 16)), jnp.zeros((1,))
    tree = jitter(numpy_tree(jax.jit(JModel(**JAX_REF_CFG).init)(jax.random.PRNGKey(0), x,
                                                                     times)["params"]), 1)
    return tree, _reference_model_sd(tree)


def test_mappers_equal_jax_bit_for_bit(reference):
    """Every mapper of the port returns JAX's arrays (dtype and bits) on the
    same state dicts: the hand-built Model, a conditional NaturalSpeech2's
    keys, and an Encodec with weight-normed convs (parametrized and
    legacy weight_g / weight_v), numpy or torch tensors."""
    _, sd = reference
    _assert_trees_equal(pti.model_params_from_torch(sd), jti.model_params_from_torch(sd))
    cond = _conditional_sd(np.random.default_rng(0))
    _assert_trees_equal(pti.naturalspeech2_params_from_torch(cond),
                        jti.naturalspeech2_params_from_torch(cond))
    as_torch = {k: torch.from_numpy(v) for k, v in cond.items()}
    _assert_trees_equal(pti.naturalspeech2_params_from_torch(as_torch),
                        jti.naturalspeech2_params_from_torch(cond))
    for name in ("phoneme_encoder", "speech_prompt_encoder", "duration_pitch_predictor",
                 "aligner_net"):
        prefix = {"phoneme_encoder": "phoneme_enc.", "speech_prompt_encoder": "prompt_enc.",
                  "duration_pitch_predictor": "duration_pitch.",
                  "aligner_net": "aligner.aligner."}[name]
        sub = {k[len(prefix):]: v for k, v in cond.items() if k.startswith(prefix)}
        fn = f"{name}_params_from_torch"
        _assert_trees_equal(getattr(pti, fn)(sub), getattr(jti, fn)(sub))

    rng = np.random.default_rng(1)
    enc = {}
    for mod, layers in (("encoder", (0, 1, 3, 4, 6)), ("decoder", (0, 1, 3, 4, 6))):
        for i in layers:
            base = f"encodec.{mod}.layers.{i}"
            if i == 1:
                enc[f"{base}.block.1.conv.weight"] = rng.standard_normal((2, 4, 3)).astype(np.float32)
                enc[f"{base}.block.1.conv.bias"] = rng.standard_normal(2).astype(np.float32)
                enc[f"{base}.block.3.conv.parametrizations.weight.original0"] = \
                    rng.random((4, 1, 1)).astype(np.float32)
                enc[f"{base}.block.3.conv.parametrizations.weight.original1"] = \
                    rng.standard_normal((4, 2, 1)).astype(np.float32)
                enc[f"{base}.block.3.conv.bias"] = rng.standard_normal(4).astype(np.float32)
            elif i == 4:
                for w in ("ih", "hh"):
                    enc[f"{base}.lstm.weight_{w}_l0"] = rng.standard_normal((16, 4)).astype(np.float32)
                    enc[f"{base}.lstm.bias_{w}_l0"] = rng.standard_normal(16).astype(np.float32)
            else:
                enc[f"{base}.conv.weight_g"] = rng.random((4, 1, 1)).astype(np.float32)
                enc[f"{base}.conv.weight_v"] = rng.standard_normal((4, 4, 3)).astype(np.float32)
                enc[f"{base}.conv.bias"] = rng.standard_normal(4).astype(np.float32)
                enc[f"{base}.norm.weight"] = rng.standard_normal(4).astype(np.float32)
                enc[f"{base}.norm.bias"] = rng.standard_normal(4).astype(np.float32)
    for q in range(3):
        enc[f"encodec.quantizer.layers.{q}.codebook.embed"] = rng.standard_normal((8, 4)).astype(
            np.float32)
    kw = dict(num_quantizers=2, upsampling_ratios=(2,), num_residual_layers=1)
    _assert_trees_equal(pti.encodec_params_from_hf(enc, **kw), jti.encodec_params_from_hf(enc, **kw))


def test_reference_model_runs_as_jax(reference):
    """The hand-built reference state dict through the port's importer and
    loader (the unfused WaveNet stacked into the fused layout), strict, and
    the port's forward against the JAX module the state dict came from."""
    tree, sd = reference
    port = Model(**MODEL_CFG, gelu_approximate=False)
    port.load_state_dict(load_jax_params(pti.model_params_from_torch(sd)), strict=True)
    rng = np.random.default_rng(2)
    x, times = rng.standard_normal((2, 8, 16)).astype(np.float32), np.array([0.2, 0.8], np.float32)
    expected = JModel(**JAX_REF_CFG).apply({"params": tree}, jnp.asarray(x), jnp.asarray(times))
    with torch.no_grad():
        got = port(t(x), t(times))
    assert_close(got, expected, atol=1e-5 * float(np.abs(expected).max()))


def test_torch_save_reader(tmp_path):
    """bf16 widened to f32 exactly, nested dicts flattened, the same arrays
    as the JAX package's torch-free reader; a pickled global other than a
    tensor's or a plain container's is refused."""
    g = torch.Generator().manual_seed(0)
    payload = {"model": collections.OrderedDict(
        w=torch.randn(3, 4, generator=g), h=torch.randn(5, generator=g).to(torch.bfloat16),
        i=torch.arange(6).reshape(2, 3)), "ema": {"w": torch.randn(2, generator=g)}}
    path = tmp_path / "ckpt.pt"
    torch.save(payload, path)
    got, want = pti.load_torch_checkpoint(path), jti.load_torch_checkpoint(path)
    assert set(got) == set(want) == {"model.w", "model.h", "model.i", "ema.w"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["model.h"].dtype == np.float32
    assert np.array_equal(got["model.h"], payload["model"]["h"].float().numpy())

    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    bad = tmp_path / "bad.pt"
    torch.save({"w": torch.zeros(2), "x": Evil()}, bad)
    with pytest.raises(pickle.UnpicklingError):
        pti.load_torch_checkpoint(bad)


def _hf_pair(seed, **overrides):
    transformers = pytest.importorskip("transformers")
    cfg = dict(target_bandwidths=[0.75, 1.5], sampling_rate=1600, num_filters=4,
               upsampling_ratios=[4, 2], hidden_size=16, codebook_size=32, codebook_dim=16,
               num_lstm_layers=2, kernel_size=7, last_kernel_size=7, residual_kernel_size=3,
               num_residual_layers=1, use_causal_conv=True, pad_mode="reflect", compress=2,
               use_conv_shortcut=True)
    cfg.update(overrides)
    torch.manual_seed(seed)
    ref = transformers.EncodecModel(transformers.EncodecConfig(**cfg)).eval()
    with torch.no_grad():  # HF zero-initialises the codebooks
        for layer in ref.quantizer.layers:
            layer.codebook.embed.normal_()
    nq = ref.quantizer.get_num_quantizers_for_bandwidth(cfg["target_bandwidths"][-1])
    return ref, nq, cfg


def test_hf_encodec_matches_hf_forward(tmp_path):
    """A random `transformers.EncodecModel` saved with ``torch.save``, through
    ``import-torch --encodec``'s reader and mapper into the port's Encodec
    (strict): latents and decoded audio within 1e-4 of HF's
    (tests/test_golden_encodec.py's tolerance), codes equal."""
    ref, nq, cfg = _hf_pair(0)
    path = tmp_path / "hf.pt"
    torch.save(ref.state_dict(), path)
    tree = pti.encodec_params_from_hf(pti.load_torch_checkpoint(path), num_quantizers=nq,
                                      upsampling_ratios=cfg["upsampling_ratios"])
    port = Encodec(codebook_dim=16, num_filters=4, upsampling_ratios=(4, 2), num_quantizers=nq,
                   codebook_size=32, num_lstm_layers=2, use_pallas_rvq=False)
    port.load_state_dict(load_jax_params(tree), strict=True)
    wav = (np.random.RandomState(1).randn(2, 8 * 12).astype(np.float32) * 0.3)
    with torch.no_grad():
        latents, codes, _ = port(t(wav), return_encoded=True)
        got_lat = ref.encoder(t(wav)[:, None, :]).transpose(1, 2)
        assert (latents - got_lat).abs().max() < 1e-4
        ref_codes = ref.quantizer.encode(got_lat.transpose(1, 2), bandwidth=1.5)  # [Q, b, n]
        assert torch.equal(codes.long(), ref_codes.permute(1, 2, 0))
        audio = port.decode(latents, quantize=True)
        ref_audio = ref.decode(ref_codes.transpose(0, 1)[None], [None],
                               return_dict=True).audio_values[:, 0]
        assert audio.shape == ref_audio.shape and (audio - ref_audio).abs().max() < 1e-4


def test_import_torch_cli_outputs_load_strict(reference, tmp_path):
    """`import-torch` of a reference NaturalSpeech2 checkpoint (``model.*``)
    and `import-torch --encodec` of an HF state dict; `load_for_inference`
    reads the first with the second as ``codec_checkpoint`` (strict), the
    second loads into an Encodec (strict); without the codec the strict
    load names the missing keys."""
    _, sd = reference
    ref_ckpt, ns2_out = tmp_path / "ref.pt", tmp_path / "ns2.ckpt"
    torch.save({f"model.{k}": torch.from_numpy(v) for k, v in sd.items()}, ref_ckpt)
    assert cli.main(["import-torch", "--input", str(ref_ckpt), "--output", str(ns2_out)]) == 0

    ref, nq, cfg = _hf_pair(3, target_bandwidths=[6.0], upsampling_ratios=[8, 5, 4, 2],
                            num_filters=32, hidden_size=16, codebook_dim=16, sampling_rate=24000)
    hf = tmp_path / "hf.pt"
    torch.save(ref.state_dict(), hf)
    enc_out = tmp_path / "encodec.ckpt"
    assert cli.main(["import-torch", "--encodec", "--input", str(hf), "--output", str(enc_out)]) == 0
    codec = Encodec(codebook_dim=16, codebook_size=32, use_pallas_rvq=False)
    codec.load_state_dict(torch.load(enc_out, weights_only=True)["params"], strict=True)

    ns2 = NaturalSpeech2(Model(**MODEL_CFG, gelu_approximate=False),
                         Encodec(codebook_dim=16, codebook_size=32, use_pallas_rvq=False),
                         timesteps=1000)
    cli.load_for_inference(ns2, str(ns2_out), codec_checkpoint=str(enc_out))
    assert torch.equal(ns2.codec.codebooks, codec.codebooks)
    with pytest.raises(RuntimeError, match="Missing key"):
        cli.load_for_inference(ns2, str(ns2_out))
