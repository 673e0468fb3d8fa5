"""Port parity for the JAX modules' remaining options, outputs and gradients:
the unfused WaveNet (`Wavenet`, and `Model(use_fused_wavenet=False)`, on
the JAX tree's ``wavenet/stack_{s}/block_{l}`` layout mapped one to one),
the conditional and unscaled `RMSNorm` (``dim_cond``, ``scale=False``), and
`ConditionableTransformer`'s plain layer (``dim_cond_mult=None``: a
RMSNorm module before each sub-block, attention on flash attention K4 /
K5 with ``use_flash``, in interpret mode on the JAX side) with and without
cross-attention, ``ff_causal_conv=False`` in both layers, and
``scan_layers``. Gradients are held relative to each parameter tensor's
largest entry (f32 sums in another order through a few layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.blocks import RMSNorm as JRMSNorm
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.models.transformer import ConditionableTransformer as JCT
from naturalspeech2_tpu.models.wavenet import Wavenet as JWavenet
from naturalspeech2_tpu_torch import ConditionableTransformer, Model, Wavenet, load_jax_params
from naturalspeech2_tpu_torch.models.blocks import RMSNorm

from torch_parity import assert_close, jitter, normal, numpy_tree, t

B, N, M, DIM = 2, 16, 8, 16
ATOL, GRAD_RTOL = 1e-5, 1e-5


def _grads_match(port: torch.nn.Module, jax_grads, prefix: str = "",
                 fused_wavenet: bool = True) -> None:
    """The port's ``.grad`` of every parameter against JAX's gradient tree,
    relative to the tensor's largest entry."""
    expected = load_jax_params(numpy_tree(jax_grads), fused_wavenet=fused_wavenet)
    named = dict(port.named_parameters())
    assert set(named) == {prefix + k for k in expected}
    for name, want in expected.items():
        got = named[prefix + name].grad
        scale = max(float(want.abs().max()), 1e-12)
        assert_close(got / scale, want.numpy() / scale, atol=GRAD_RTOL)


def _wavenet_state(params: dict) -> dict:
    """A bare `Wavenet` tree as the port's state dict (`load_jax_params`
    maps it inside a Model tree)."""
    tree = {"wavenet": params, "time_pos_emb": {"weights": np.zeros(2, np.float32)},
            "to_time_hidden": {"kernel": np.zeros((1, 1), np.float32),
                               "bias": np.zeros(1, np.float32)},
            "transformer": {"pred_norm": {"gamma": np.zeros(1, np.float32)},
                            "to_pred": {"kernel": np.zeros((1, 1), np.float32)}}}
    state = load_jax_params(tree, fused_wavenet=False)
    return {k[len("wavenet."):]: v for k, v in state.items() if k.startswith("wavenet.")}


@pytest.mark.parametrize("cond", [None, 4], ids=["uncond", "time_cond"])
def test_wavenet_matches_jax(cond):
    rng = np.random.default_rng(0)
    x, times = normal(rng, B, N, DIM), normal(rng, B, DIM * (cond or 1))
    jwn = JWavenet(dim=DIM, stacks=2, layers=3, dim_cond_mult=cond)
    tm = jnp.asarray(times) if cond else None
    params = jitter(numpy_tree(jwn.init(jax.random.PRNGKey(0), jnp.asarray(x), tm)["params"]), 1,
                    scale=0.1)

    def loss_j(p, xx):
        return jnp.sum(jwn.apply({"params": p}, xx, tm) ** 2)

    expected = jwn.apply({"params": params}, jnp.asarray(x), tm)
    grads, gx = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))

    port = Wavenet(DIM, 2, 3, dim_cond_mult=cond)
    port.load_state_dict(_wavenet_state(params), strict=True)
    xt = t(x).requires_grad_()
    out = port(xt, t(times) if cond else None)
    assert_close(out, expected, atol=ATOL)
    (out**2).sum().backward()
    expected_grads = _wavenet_state(numpy_tree(grads))
    for name, p in port.named_parameters():
        want = expected_grads[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert_close(p.grad / scale, want / scale, atol=GRAD_RTOL)
    gx = np.asarray(gx)
    assert_close(xt.grad / np.abs(gx).max(), gx / np.abs(gx).max(), atol=GRAD_RTOL)


@pytest.mark.parametrize("kw", [dict(), dict(condition_on_prompt=True, dim_prompt=24,
                                             num_latents_m=4, resampler_depth=1)],
                         ids=["unconditional", "conditional"])
def test_unfused_model_matches_jax(kw):
    """`Model(use_fused_wavenet=False)`: forward and every gradient; the
    same tree loads into the fused model too (stacked) with the same
    output."""
    cfg = dict(dim=DIM, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
               use_fused_wavenet=False, **kw)
    rng = np.random.default_rng(1)
    x, times = normal(rng, B, N, DIM), rng.uniform(size=B).astype(np.float32)
    extra = {}
    if kw:
        extra = dict(prompt=normal(rng, B, 12, 24), cond=normal(rng, B, N, 24))
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    jmodel = JModel(**cfg)
    params = jitter(numpy_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                           jnp.asarray(times), **jx)["params"]), 2, scale=0.1)

    def loss_j(p):
        return jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(times), **jx) ** 2)

    expected = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(times), **jx)
    grads = jax.grad(loss_j)(params)

    port = Model(**cfg).eval()
    port.load_state_dict(load_jax_params(params, fused_wavenet=False), strict=True)
    assert any(k.startswith("wavenet.stack_1.block_1.skip_conv") for k in port.state_dict())
    tx = {k: t(v) for k, v in extra.items()}
    out = port(t(x), t(times), **tx)
    assert_close(out, expected, atol=ATOL)
    (out**2).sum().backward()
    _grads_match(port, grads, fused_wavenet=False)

    fused = Model(**{**cfg, "use_fused_wavenet": True}).eval()
    fused.load_state_dict(load_jax_params(params), strict=True)
    with torch.no_grad():
        assert_close(fused(t(x), t(times), **tx), expected, atol=ATOL)
    with pytest.raises(ValueError, match="unfused WaveNet tree"):
        load_jax_params(numpy_tree(JModel(**{**cfg, "use_fused_wavenet": True}).init(
            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(times), **jx)["params"]),
            fused_wavenet=False)


@pytest.mark.parametrize("kw", [dict(), dict(scale=False), dict(dim_cond=12),
                                dict(scale=False, dim_cond=12)],
                         ids=["plain", "no_scale", "dim_cond", "no_scale_dim_cond"])
def test_rmsnorm_options_match_jax(kw):
    rng = np.random.default_rng(2)
    x, cond = normal(rng, B, N, DIM), normal(rng, B, 12)
    jnorm = JRMSNorm(DIM, **kw)
    jc = jnp.asarray(cond) if "dim_cond" in kw else None
    variables = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x), jc)
    init = numpy_tree(variables.get("params", {}))
    params = jitter(init, 3, scale=0.1)

    def loss_j(p, xx):
        return jnp.sum(jnorm.apply({"params": p}, xx, jc) ** 3)

    expected = jnorm.apply({"params": params}, jnp.asarray(x), jc)
    grads, gx = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))

    port = RMSNorm(DIM, **kw)
    if "dim_cond" in kw:  # the identity at init, as JAX's
        assert np.array_equal(port.to_gamma_beta.bias.detach().numpy(),
                              init["to_gamma_beta"]["bias"])
        assert not port.to_gamma_beta.weight.detach().any()

    def state(tree):
        out = {}
        if "gamma" in tree:
            out["gamma"] = t(tree["gamma"])
        if "to_gamma_beta" in tree:
            out["to_gamma_beta.weight"] = t(tree["to_gamma_beta"]["kernel"]).T
            out["to_gamma_beta.bias"] = t(tree["to_gamma_beta"]["bias"])
        return out

    port.load_state_dict(state(params), strict=True)
    assert (port.gamma is None) == (kw.get("scale") is False)
    xt = t(x).requires_grad_()
    out = port(xt, t(cond) if "dim_cond" in kw else None)
    assert_close(out, expected, atol=ATOL)
    (out**3).sum().backward()
    for name, want in state(numpy_tree(grads)).items():
        scale = max(float(want.abs().max()), 1e-12)
        assert_close(dict(port.named_parameters())[name].grad / scale, want.numpy() / scale,
                     atol=GRAD_RTOL)
    gx = np.asarray(gx)
    assert_close(xt.grad / np.abs(gx).max(), gx / np.abs(gx).max(), atol=GRAD_RTOL)
    if "dim_cond" in kw:
        with pytest.raises(ValueError, match="needs cond"):
            port(t(x))


CT_CASES = {
    "plain_cross": dict(dim_cond_mult=None, ff_causal_conv=False, cross_attn=True),
    "plain_self": dict(dim_cond_mult=None, ff_causal_conv=True, cross_attn=False),
    "plain_plain_attn": dict(dim_cond_mult=None, ff_causal_conv=False, cross_attn=True,
                             use_flash=False),
    "plain_scan": dict(dim_cond_mult=None, ff_causal_conv=False, cross_attn=True,
                       scan_layers=True),
    "adaptive_no_conv": dict(dim_cond_mult=4, ff_causal_conv=False, cross_attn=True),
    "adaptive_no_conv_scan": dict(dim_cond_mult=4, ff_causal_conv=False, cross_attn=False,
                                  scan_layers=True),
}


@pytest.mark.parametrize("case", list(CT_CASES))
def test_conditionable_transformer_options_match_jax(case):
    kw = {"use_flash": True, **CT_CASES[case]}
    cfg = dict(dim=DIM, depth=2, dim_head=8, heads=2, **kw)
    rng = np.random.default_rng(4)
    x, times, ctx = normal(rng, B, N, DIM), normal(rng, B, 4 * DIM), normal(rng, B, M, DIM)
    jct = JCT(**cfg)
    jctx = jnp.asarray(ctx) if kw["cross_attn"] else None
    params = jitter(numpy_tree(jct.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                        times=jnp.asarray(times), context=jctx)["params"]), 5,
                    scale=0.1)
    if kw.get("scan_layers"):
        assert "layers" in params
    if kw["dim_cond_mult"] is None:
        assert "ada_norm_w" not in params

    def loss_j(p, xx):
        return jnp.sum(jct.apply({"params": p}, xx, times=jnp.asarray(times), context=jctx) ** 2)

    expected = jct.apply({"params": params}, jnp.asarray(x), times=jnp.asarray(times),
                         context=jctx)
    grads, gx = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))

    port = ConditionableTransformer(**cfg)
    port.load_state_dict(load_jax_params(params), strict=True)
    xt = t(x).requires_grad_()
    out = port(xt, t(times), context=t(ctx) if kw["cross_attn"] else None)
    assert_close(out, expected, atol=ATOL)
    (out**2).sum().backward()
    _grads_match(port, grads)
    gx = np.asarray(gx)
    assert_close(xt.grad / np.abs(gx).max(), gx / np.abs(gx).max(), atol=GRAD_RTOL)
