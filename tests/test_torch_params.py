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
