"""The port runs the JAX package's route at every shape.

The JAX package gates each fused block by shape (`fits_fused_attn_block`,
`fits_fused_cross_attn_block`, `fits_fused_ff_block`, and the WaveNet's
`_forward_dispatch`) and runs the unfused module code past each gate: the
norm, the projections, flash attention and W_o for attention, tensor ops
for the feed-forward, the XLA twin for the WaveNet. The port keeps copies
of the gates. Here they are held equal to the JAX package's on a grid of
shapes, and at n 20 and n 150, where the JAX package runs the unfused
routes, the port's `ConditionableTransformer`, conditional `Model` and
training loss with its gradients are held against it, with a spy showing
that the unfused route ran (flash attention, forward and backward) and no
block twin did."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.models.transformer import ConditionableTransformer as JCT
from naturalspeech2_tpu.ops import attn_block_kernel as jak
from naturalspeech2_tpu.ops import ff_block_kernel as jfk
from naturalspeech2_tpu.ops import wavenet_kernel as jwk
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params
from naturalspeech2_tpu_torch.models import blocks, transformer
from naturalspeech2_tpu_torch.models.transformer import ConditionableTransformer
from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
from naturalspeech2_tpu_torch.ops import flash_attention as fa
from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

from torch_parity import assert_close, jitter, normal, numpy_tree, t

GRID_N = (20, 150, 512, 1024, 2808, 2816, 4500, 9000, 6713, 21600)
GRID_D = (128, 512)
M, DH, LAYERS = 32, 64, 8

CT_CFG = dict(dim=16, depth=2, dim_head=8, heads=2, ff_causal_conv=True, dim_cond_mult=4)
MODEL_CFG = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=3, wavenet_stacks=2)
COND_MODEL_CFG = dict(MODEL_CFG, condition_on_prompt=True, dim_prompt=24, num_latents_m=8,
                      resampler_depth=1)
CODEC_CFG = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=3)
B = 2
# as tests/test_torch_denoiser.py and tests/test_torch_loss.py: f32
# products summed in another order through the whole network (1e-4); the
# loss relative (1e-5) and each gradient against its largest entry (2e-4)
ATOL, LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-5, 2e-4
OFF_GATE_N = (20, 150)  # 20 and 150 are not multiples of 8


def _jax_wavenet_route(n, d, L):
    if jwk._kernel_vmem_bytes(n, d, L) <= jwk.VMEM_SCRATCH_LIMIT_BYTES:
        return "stack"
    if d <= jwk.LANE_MAX_DIM and jwk._lane_vmem_bytes(n, d, L) <= jwk.LANE_VMEM_LIMIT_BYTES:
        return "lanes"
    return "plain"


@pytest.mark.parametrize("d", GRID_D)
@pytest.mark.parametrize("n", GRID_N)
def test_gates_equal_the_jax_packages(n, d):
    inner = int(d * 4 * 2 / 3)
    assert ak.fits_fused_attn_block(n, d, DH) == jak.fits_fused_attn_block(n, d, DH)
    assert (ak.fits_fused_cross_attn_block(n, M, d, d, DH)
            == jak.fits_fused_cross_attn_block(n, M, d, d, DH))
    assert fk.fits_fused_ff_block(n, d, inner) == jfk.fits_fused_ff_block(n, d, inner)
    assert wk.wavenet_route(n, d, LAYERS) == _jax_wavenet_route(n, d, LAYERS)


def test_gates_on_the_smoke_paths():
    """The routes the chip smoke run counts launches for: training (b16 x
    150), long-form (4500, 9000) and scaled (d 512 at 1024)."""
    def routes(n, d):
        inner = int(d * 4 * 2 / 3)
        return (ak.fits_fused_attn_block(n, d, DH), fk.fits_fused_ff_block(n, d, inner),
                wk.wavenet_route(n, d, LAYERS))

    assert routes(1024, 128) == (True, True, "stack")
    assert routes(150, 128) == (False, False, "stack")
    assert routes(4500, 128) == (False, False, "stack")
    assert routes(9000, 128) == (False, True, "lanes")
    assert routes(1024, 512) == (True, True, "plain")
    assert ak.fits_fused_cross_attn_block(512, M, 128, 128, DH)


@pytest.fixture
def spy(monkeypatch):
    """Counts flash attention's forward and backward calls and fails on
    any call of a block twin."""
    calls = {"flash_forward": 0, "flash_backward": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    def forbidden(name):
        def wrapper(*a, **k):
            raise AssertionError(f"{name} ran at a shape the JAX package runs unfused")
        return wrapper

    for name in calls:
        monkeypatch.setattr(fa, name, counted(name, getattr(fa, name)))
    monkeypatch.setattr(transformer, "attn_block", forbidden("attn_block"))
    monkeypatch.setattr(transformer, "cross_attn_block", forbidden("cross_attn_block"))
    monkeypatch.setattr(blocks, "ff_block", forbidden("ff_block"))
    return calls


@pytest.mark.parametrize("cross_attn", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("n", OFF_GATE_N)
def test_transformer_off_gate_matches_jax(spy, n, cross_attn):
    rng = np.random.default_rng(n)
    x, times = normal(rng, B, n, 16), normal(rng, B, 64)
    ctx = normal(rng, B, 8, 16) if cross_attn else None  # 8 latents: only n is off the gate
    jct = JCT(**CT_CFG, cross_attn=cross_attn, use_flash=True)
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = jct.init(jax.random.PRNGKey(0), jnp.asarray(x), times=jnp.asarray(times),
                      context=jctx)["params"]
    params = jitter(numpy_tree(params), 2, scale=0.1)
    expected = jct.apply({"params": params}, jnp.asarray(x), times=jnp.asarray(times),
                         context=jctx)

    port = ConditionableTransformer(**CT_CFG, cross_attn=cross_attn)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        actual = port(t(x), t(times), context=None if ctx is None else t(ctx))
    assert_close(actual, expected, atol=ATOL)
    layers = CT_CFG["depth"] * (2 if cross_attn else 1)
    assert spy == {"flash_forward": layers, "flash_backward": 0}


@pytest.mark.parametrize("n", OFF_GATE_N)
def test_conditional_model_off_gate_matches_jax(spy, n):
    rng = np.random.default_rng(n + 1)
    x, times = normal(rng, B, n, 16), rng.uniform(size=(B,)).astype(np.float32)
    prompt, cond = normal(rng, B, 5, 24), normal(rng, B, 11, 24)
    jmodel = JModel(**COND_MODEL_CFG)
    kwargs = dict(prompt=jnp.asarray(prompt), cond=jnp.asarray(cond))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(times),
                         **kwargs)["params"]
    params = jitter(numpy_tree(params), 6, scale=0.1)
    drop = np.array([True, False])
    expected = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(times),
                            cond_drop_mask=jnp.asarray(drop), **kwargs)

    port = Model(**COND_MODEL_CFG)
    port.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        actual = port(t(x), t(times), prompt=t(prompt), cond=t(cond),
                      cond_drop_mask=torch.from_numpy(drop))
    assert_close(actual, expected, atol=ATOL)
    # the resampler's layer and, per transformer layer, the self and cross blocks
    assert spy == {"flash_forward": 1 + 2 * COND_MODEL_CFG["depth"], "flash_backward": 0}


@pytest.fixture(scope="module")
def loss_params():
    jmodel, jcodec = JModel(**MODEL_CFG), JSoundStream(**CODEC_CFG)
    model = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)), jnp.zeros((1,)))
    tree = {
        "model": model["params"],
        "codec": jcodec.init(jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"],
    }
    return jitter(numpy_tree(tree), 3, scale=0.1)


@pytest.mark.parametrize("frames", OFF_GATE_N)
def test_training_loss_off_gate_matches_jax(spy, loss_params, frames):
    """The loss and every denoiser gradient; the backward of each
    attention block runs flash attention's backward (K5 on a card)."""
    rng = np.random.default_rng(frames)
    audio = np.tanh(normal(rng, B, frames * 320))
    times = rng.uniform(0.05, 0.95, B).astype(np.float32)
    noise = normal(rng, B, frames, 16)
    ns2_j = jns2.NaturalSpeech2(model=JModel(**MODEL_CFG), codec=JSoundStream(**CODEC_CFG),
                                timesteps=1000)

    def loss_j(p):
        return ns2_j.apply({"params": p}, jnp.asarray(audio), times=jnp.asarray(times),
                           noise=jnp.asarray(noise))["loss"]

    loss_value, grads_j = jax.value_and_grad(loss_j)(loss_params)

    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), timesteps=1000)
    ns2_t.load_state_dict(load_jax_params(loss_params), strict=True)
    loss = ns2_t(t(audio), times=t(times), noise=t(noise))["loss"]
    assert_close(loss, loss_value, atol=0, rtol=LOSS_RTOL)
    loss.backward()
    depth = MODEL_CFG["depth"]
    assert spy == {"flash_forward": depth, "flash_backward": depth}

    named = dict(ns2_t.named_parameters())
    for name, want in load_jax_params(numpy_tree(grads_j)).items():
        if name.startswith("model."):
            scale = max(float(np.abs(want.numpy()).max()), 1e-6)
            assert_close(named[name].grad / scale, want.numpy() / scale, atol=GRAD_RTOL)
