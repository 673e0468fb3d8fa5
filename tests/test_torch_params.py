"""`load_jax_params`: consumes every leaf of the JAX `Model`, `SoundStream`
and `NaturalSpeech2` trees into the port's modules (strict load), and
raises on a missing or an extra leaf."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params

from torch_parity import numpy_tree, t

MODEL_CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2)
CODEC_CFG = dict(channels=4, codebook_dim=16)


@pytest.fixture(scope="module")
def trees():
    model = JModel(**MODEL_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), jnp.zeros((1,)))
    codec = JSoundStream(**CODEC_CFG).init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))
    return numpy_tree(model["params"]), numpy_tree(codec["params"])


def _n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_model_tree_loads_whole(trees):
    state = load_jax_params(trees[0])
    assert len(state) == _n_leaves(trees[0])
    port = Model(**MODEL_CFG)
    port.load_state_dict(state, strict=True)
    # the kernel-owned weights keep their JAX layouts
    np.testing.assert_array_equal(port.wavenet.conv_w.detach().numpy(), trees[0]["wavenet"]["conv_w"])
    np.testing.assert_array_equal(
        port.transformer.ff[1].wc.detach().numpy(),
        trees[0]["transformer"]["ff_1"]["CausalConv1d_0"]["Conv_0"]["kernel"],
    )
    # Dense kernels [in, out] become Linear weights [out, in]
    np.testing.assert_array_equal(
        port.to_time_hidden.weight.detach().numpy(), trees[0]["to_time_hidden"]["kernel"].T
    )


def test_codec_tree_loads_whole(trees):
    state = load_jax_params(trees[1])
    assert len(state) == _n_leaves(trees[1])  # the encoder's leaves included
    port = SoundStream(**CODEC_CFG)
    port.load_state_dict(state, strict=True)
    # the strided encoder conv: flax [k, in, out] becomes [out, in, k]
    np.testing.assert_array_equal(
        port.encoder_blocks[2].down.weight.detach().numpy(),
        trees[1]["encoder_blocks_2"]["Conv_0"]["kernel"].transpose(2, 1, 0),
    )


def test_naturalspeech2_tree_loads_whole(trees):
    ns2 = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG))
    ns2.load_state_dict(load_jax_params({"model": trees[0], "codec": trees[1]}), strict=True)
    assert torch.equal(ns2.codec.codebooks, t(trees[1]["codebooks"]))


@pytest.mark.parametrize("which", [0, 1])
def test_missing_leaf_raises(trees, which):
    tree = copy.deepcopy(trees[which])
    if which == 0:
        del tree["transformer"]["attn_1"]["to_kv"]
    else:
        del tree["decoder_blocks_2"]["ResidualUnit_1"]["Conv_0"]["bias"]
    with pytest.raises(KeyError, match="lacks the leaf"):
        load_jax_params(tree)


@pytest.mark.parametrize("which", [0, 1])
def test_extra_leaf_raises(trees, which):
    tree = copy.deepcopy(trees[which])
    if which == 0:
        tree["wavenet"]["gate_w"] = np.zeros((2,), np.float32)
    else:
        tree["decoder_head"]["scale"] = np.zeros((1,), np.float32)
    with pytest.raises(ValueError, match="does not take"):
        load_jax_params(tree)


def test_unknown_tree_raises():
    with pytest.raises(ValueError, match="not a Model"):
        load_jax_params({"params": {}})


COND_MODEL_CFG = dict(MODEL_CFG, condition_on_prompt=True, dim_prompt=24, num_latents_m=4,
                      resampler_depth=1)
COND_NS2_CFG = dict(
    dim_codebook=16, num_phoneme_tokens=20, duration_pitch_dim=24, aligner_dim_in=8,
    aligner_dim_hidden=24, aligner_attn_channels=8, pitch_emb_pp_hidden_dim=24,
    phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, depth=2, heads=2, dim_head=8),
    prompt_enc_kwargs=dict(dims=(24, 32, 24), depth=1, heads=2, dim_head=8,
                           use_flash_attn=False),
    duration_pitch_kwargs=dict(dim_hidden=24, depth=2, heads=2, dim_head=8,
                               dim_encoded_prompts=24, num_convolutions_per_block=2),
)


@pytest.fixture(scope="module")
def cond_tree():
    """A conditional NaturalSpeech2 tree without a codec (prompt latents in)."""
    from naturalspeech2_tpu.models.aligner import AlignerNet as JAlignerNet
    from naturalspeech2_tpu.models.naturalspeech2 import NaturalSpeech2 as JNaturalSpeech2

    jmodel = JModel(**COND_MODEL_CFG)
    ns2 = JNaturalSpeech2(model=jmodel, **COND_NS2_CFG)
    prompt, text = jnp.zeros((1, 5, 16)), jnp.zeros((1, 4), jnp.int32)
    variables = ns2.init(jax.random.PRNGKey(0), prompt, text, None, 8,
                         method=ns2.conditioning_for_sample)
    prompt_enc, cond, _ = ns2.apply(variables, prompt, text, None, 8,
                                    method=ns2.conditioning_for_sample)
    tree = dict(variables["params"])
    tree["model"] = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 16)), jnp.zeros((1,)),
                                prompt=prompt_enc, cond=cond)["params"]
    tree["aligner"] = {"aligner": JAlignerNet(dim_in=8, dim_hidden=24, attn_channels=8).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 5, 8)), jnp.zeros((1, 3, 24)))["params"]}
    return numpy_tree(tree)


def test_conditional_tree_loads_whole(cond_tree):
    state = load_jax_params(cond_tree)
    assert len(state) == _n_leaves(cond_tree)
    ns2 = NaturalSpeech2(Model(**COND_MODEL_CFG), **COND_NS2_CFG)
    ns2.load_state_dict(state, strict=True)
    trunk = cond_tree["duration_pitch"]["to_pitch_pred"]
    # a GroupNorm's scale is its weight; an Embed table is the weight as it is
    assert torch.equal(ns2.duration_pitch.to_pitch_pred.convs[1][0].units[1].norm.weight,
                       t(trunk["conv_1_0"]["ConvUnit_1"]["GroupNorm_0"]["scale"]))
    assert torch.equal(ns2.phoneme_enc.token_emb.weight,
                       t(cond_tree["phoneme_enc"]["token_emb"]["embedding"]))
    assert torch.equal(ns2.model.transformer.cross_attn[1].to_kv,
                       t(cond_tree["model"]["transformer"]["cross_attn_1"]["to_kv"]["kernel"]))
    # [self, cross, ff] norms per layer
    assert ns2.model.transformer.ada_norm_w.shape == (2 * 3, 16 * 8, 2 * 16)


@pytest.mark.parametrize("path", [
    ("model", "transformer", "cross_attn_1", "to_kv"),
    ("model", "perceiver_resampler", "latents"),
    ("duration_pitch", "to_duration_pred", "conv_1_1", "ConvUnit_0", "GroupNorm_0", "bias"),
    ("aligner", "aligner", "query_conv3"),
    ("pitch_emb",),
], ids=["cross_attn", "resampler", "group_norm", "aligner", "pitch_emb"])
def test_conditional_missing_leaf_raises(cond_tree, path):
    tree = copy.deepcopy(cond_tree)
    node = tree
    for key in path[:-1]:
        node = node[key]
    del node[path[-1]]
    with pytest.raises(KeyError, match="lacks the leaf"):
        load_jax_params(tree)


def test_conditional_extra_leaf_raises(cond_tree):
    tree = copy.deepcopy(cond_tree)
    tree["prompt_enc"]["transformer"]["attn_0"]["to_q"]["bias"] = np.zeros((16,), np.float32)
    with pytest.raises(ValueError, match="does not take"):
        load_jax_params(tree)
