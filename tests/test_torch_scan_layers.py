"""Port parity for `scan_layers=True`: the JAX package stacks every
per-layer transformer parameter under `layers` with a leading depth axis
and runs depth under `nn.scan`; `load_jax_params` unbinds that axis into
the port's per-layer modules, whose forward is the unrolled one. The JAX
side runs its Pallas kernels in interpret mode (`use_flash=True`)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.models.transformer import ConditionableTransformer as JCT
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params, sample
from naturalspeech2_tpu_torch.models.transformer import ConditionableTransformer

from torch_parity import assert_close, jitter, normal, numpy_tree, t

CT_CFG = dict(dim=16, depth=3, dim_head=8, heads=2, ff_causal_conv=True, dim_cond_mult=4)
MODEL_CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2)
COND_MODEL_CFG = dict(MODEL_CFG, condition_on_prompt=True, dim_prompt=24, num_latents_m=8,
                      resampler_depth=1)
CODEC_CFG = dict(channels=4, codebook_dim=16)
B, N, M = 2, 16, 8
# as tests/test_torch_denoiser.py and tests/test_torch_sample.py: f32
# matmuls summed in another order, through the whole network (1e-4) or
# three DDIM steps whose 1/σ factors amplify them, then the codec (2e-4)
ATOL, SAMPLE_ATOL = 1e-4, 2e-4


def _stack_layers(tree: dict) -> dict:
    """An unrolled transformer tree (attn_i, cross_attn_i, ff_i) as the
    `scan_layers` tree (layers/{attn,cross_attn,ff} stacked on axis 0), as
    tests/test_scan_layers.py maps it."""
    out = {k: v for k, v in tree.items() if not k.rsplit("_", 1)[-1].isdigit()}
    depth = sum(1 for k in tree if k.startswith("attn_"))
    names = [n for n in ("attn", "cross_attn", "ff") if f"{n}_0" in tree]
    out["layers"] = {n: jax.tree_util.tree_map(lambda *leaves: np.stack(leaves),
                                               *[tree[f"{n}_{i}"] for i in range(depth)])
                     for n in names}
    return out


@pytest.mark.parametrize("cross_attn", [False, True], ids=["self_only", "cross_attn"])
def test_transformer_matches_jax_scan(cross_attn):
    rng = np.random.default_rng(1)
    x, times = normal(rng, B, N, 16), normal(rng, B, 64)
    ctx = normal(rng, B, M, 16) if cross_attn else None
    jct = JCT(**CT_CFG, cross_attn=cross_attn, use_flash=True, scan_layers=True)
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = jct.init(jax.random.PRNGKey(0), jnp.asarray(x), times=jnp.asarray(times),
                      context=jctx)["params"]
    params = jitter(numpy_tree(params), 2, scale=0.1)
    assert params["layers"]["attn"]["to_q"]["kernel"].shape == (3, 16, 16)
    expected = jct.apply({"params": params}, jnp.asarray(x), times=jnp.asarray(times),
                         context=jctx)

    port = ConditionableTransformer(**CT_CFG, cross_attn=cross_attn, scan_layers=True)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        actual = port(t(x), t(times), context=None if ctx is None else t(ctx))
    assert_close(actual, expected, atol=ATOL)


def test_model_matches_jax_scan():
    rng = np.random.default_rng(3)
    x, times = normal(rng, B, N, 16), rng.uniform(size=(B,)).astype(np.float32)
    jmodel = JModel(**MODEL_CFG, use_flash_attn=True, scan_layers=True)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(times))["params"]
    params = jitter(numpy_tree(params), 4, scale=0.1)
    expected = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(times))

    port = Model(**MODEL_CFG, scan_layers=True)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        assert_close(port(t(x), t(times)), expected, atol=ATOL)


def _cond_inputs(seed):
    rng = np.random.default_rng(seed)
    return (normal(rng, B, N, 16), rng.uniform(size=(B,)).astype(np.float32),
            normal(rng, B, 5, 24), normal(rng, B, 11, 24))


def test_conditional_model_matches_jax_scan():
    """Cross-attention layers stacked under layers/cross_attn."""
    x, times, prompt, cond = _cond_inputs(5)
    jmodel = JModel(**COND_MODEL_CFG, scan_layers=True)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(times),
                         prompt=jnp.asarray(prompt), cond=jnp.asarray(cond))["params"]
    params = jitter(numpy_tree(params), 6, scale=0.1)
    assert "cross_attn" in params["transformer"]["layers"]
    drop = np.array([True, False])
    expected = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(times),
                            prompt=jnp.asarray(prompt), cond=jnp.asarray(cond),
                            cond_drop_mask=jnp.asarray(drop))

    port = Model(**COND_MODEL_CFG, scan_layers=True)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        actual = port(t(x), t(times), prompt=t(prompt), cond=t(cond),
                      cond_drop_mask=torch.from_numpy(drop))
    assert_close(actual, expected, atol=ATOL)


def test_sample_from_a_scan_tree_matches_jax():
    jmodel, jcodec = JModel(**MODEL_CFG, scan_layers=True), JSoundStream(**CODEC_CFG)
    params = {
        "model": jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), jnp.zeros((1,)))["params"],
        "codec": jcodec.init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"],
    }
    params = jitter(numpy_tree(params), 7, scale=0.1)
    key, length, steps = jax.random.PRNGKey(7), 4, 3
    ns2_j = jns2.NaturalSpeech2(model=jmodel, codec=jcodec, timesteps=1000)
    expected = jns2.sample(ns2_j, {"params": params}, key, length=length, batch_size=B,
                           timesteps=steps)

    ns2_t = NaturalSpeech2(Model(**MODEL_CFG, scan_layers=True), SoundStream(**CODEC_CFG),
                           timesteps=1000)
    ns2_t.load_state_dict(load_jax_params(params), strict=True)
    noise = t(jax.random.normal(key, (B, length, 16)))
    audio = sample(ns2_t, length=length, batch_size=B, timesteps=steps, noise=noise)
    assert audio.shape == (B, length * 320)
    assert_close(audio, expected, atol=SAMPLE_ATOL)


@pytest.fixture(scope="module", params=[False, True], ids=["unconditional", "conditional"])
def unrolled_tree(request):
    """An unrolled JAX Model tree, with cross-attention layers if
    conditional."""
    x, times, prompt, cond = _cond_inputs(8)
    if request.param:
        tree = JModel(**COND_MODEL_CFG).init(jax.random.PRNGKey(2), jnp.asarray(x),
                                             jnp.asarray(times), prompt=jnp.asarray(prompt),
                                             cond=jnp.asarray(cond))["params"]
    else:
        tree = JModel(**MODEL_CFG).init(jax.random.PRNGKey(2), jnp.asarray(x),
                                        jnp.asarray(times))["params"]
    return jitter(numpy_tree(tree), 9)


def _stacked(tree):
    tree = copy.deepcopy(tree)
    tree["transformer"] = _stack_layers(tree["transformer"])
    return tree


def test_nested_scan_tree_loads_as_the_unrolled_one(unrolled_tree):
    """Inside a NaturalSpeech2 tree too, the stacked layout gives the state
    the unrolled one gives, leaf for leaf."""
    want = load_jax_params({"model": unrolled_tree})
    got = load_jax_params({"model": _stacked(unrolled_tree)})
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_scan_tree_extra_leaf_raises(unrolled_tree):
    tree = _stacked(unrolled_tree)
    tree["transformer"]["layers"]["attn"]["to_q"]["bias"] = np.zeros((2, 16), np.float32)
    with pytest.raises(ValueError, match="does not take"):
        load_jax_params(tree)


def test_scan_tree_depth_mismatch_raises(unrolled_tree):
    tree = _stacked(unrolled_tree)
    kernel = tree["transformer"]["layers"]["ff"]["Dense_1"]["kernel"]
    tree["transformer"]["layers"]["ff"]["Dense_1"]["kernel"] = kernel[:1]
    with pytest.raises(ValueError, match="depth axis"):
        load_jax_params(tree)


def test_scan_and_unrolled_layers_together_raise(unrolled_tree):
    tree = _stacked(unrolled_tree)
    tree["transformer"]["attn_0"] = copy.deepcopy(unrolled_tree["transformer"]["attn_0"])
    with pytest.raises(ValueError, match="both"):
        load_jax_params(tree)
