"""Port parity for AMP training (`Trainer(amp=True)`) on the CPU, against
the JAX package at the same operand dtypes: K4's bf16 forward with
dropout and K5's bf16 backward (the Pallas kernels in interpret mode), the
bf16 RVQ (K6), the mixed routes of K1, K1b, K2, K2b and K3 (f32
activations against bf16 weights, what AMP's denoiser runs) and the
backward of each block in bf16 and mixed, then the AMP loss and its f32
master gradients, unconditional and conditional, against
`jax.value_and_grad` of the JAX trainer's cast (`Trainer._loss_fn`: every
f32 parameter and every float input to bf16), and two optimizer steps
against the JAX AMP step. Inputs are made with numpy from a seed.

XLA on the CPU may keep excess precision where a bf16 kernel rounds, and
the two frameworks sum bf16 products in other orders, so bf16 results are
held to bf16-sized tolerances relative to their largest entry; mixed
routes compute in f32 on both sides and are held to f32 ones."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.ops import attn_block_kernel as jattn
from naturalspeech2_tpu.ops import ff_block_kernel as jff
from naturalspeech2_tpu.ops import flash_attention as jfa
from naturalspeech2_tpu.ops import rvq as jrvq
from naturalspeech2_tpu.ops import wavenet_kernel as jwn
from naturalspeech2_tpu.parallel.mesh import make_mesh
from naturalspeech2_tpu.trainer import Trainer as JTrainer
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, Trainer, load_jax_params
from naturalspeech2_tpu_torch.ops import attn_block_kernel, ff_block_kernel, gemm_cache
from naturalspeech2_tpu_torch.ops import flash_attention as fa
from naturalspeech2_tpu_torch.ops import rvq as trvq
from naturalspeech2_tpu_torch.ops import wavenet_kernel

from torch_parity import assert_codes_match, jitter, normal, numpy_tree, t
import test_torch_cond_train as cond

BF16 = torch.bfloat16
# A bf16 kernel output or gradient against JAX's: one bf16 rounding is 2^-9
# of its magnitude, the products' operands round at the same points on both
# sides but are summed in other orders. 1e-2 of the largest entry passes
# that with room; a dropped rounding point or a wrong layout does not.
BF16_TOL = 1e-2
# A mixed route against JAX's: both compute in f32 on the bf16 weights'
# values (exact in f32), in other orders: ~1e-6 relative.
MIXED_TOL = 1e-5
# The AMP loss and its f32 master gradients against the JAX AMP step. The
# denoiser computes in f32 against the bf16 weight copies on both sides: fed
# the same bf16 latents, each f32 master gradient is the same bf16 cotangent
# but for f32 orderings and the rounding of the weights' bf16 gradients (one
# bf16 ulp is 2^-8 of an entry), within GRAD_RTOL of its largest entry.
# From raw audio (and a prompt), the codec and the conditioning encoders
# run bf16 chains on both sides whose f32 sums round to the other bf16
# neighbour here and there (one ulp in some layers), and the gradients
# amplify that: moving the audio (the prompt) by one bf16 ulp on half its
# samples changes JAX's own AMP gradients by more than GRAD_RTOL, so those
# runs are held to that noise floor, measured in the test on the JAX side,
# or GRAD_RTOL where it is lower. Losses within LOSS_RTOL relative; every
# gradient correlated with JAX's at least GRAD_CORR (a wrong dtype route or
# a missing cast is O(1)).
LOSS_RTOL, GRAD_RTOL, GRAD_CORR = 2e-2, 5e-2, 0.99
# Two AMP optimizer steps: Adam moves every weight by at most ~lr a step,
# and where a gradient entry is within bf16 rounding of zero the two sides
# may step in opposite directions: the parameters differ by at most 2·lr a
# step (Adam's own bound), and each tensor's update is correlated with
# JAX's at least UPDATE_CORR.
LR, UPDATE_CORR = 1e-3, 0.9


def _hold(actual, expected, tol, dtype=None):
    if dtype is not None:
        assert actual.dtype == dtype, actual.dtype
    got = actual.detach().float().numpy()
    want = np.asarray(jnp.asarray(expected, dtype=jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, f"max error {err:.3e} of the largest entry, above {tol}"


def _bf(a):
    """A numpy array rounded to bf16: (the JAX array, the torch tensor)."""
    return jnp.asarray(a, dtype=jnp.bfloat16), torch.from_numpy(np.asarray(a)).to(BF16)


def _f32(a):
    return jnp.asarray(a, dtype=jnp.float32), torch.from_numpy(np.asarray(a, np.float32))


# --------------------------------------------------------------------- #
# K4 forward with dropout and K5 backward in bf16
# --------------------------------------------------------------------- #

SEED = (0x12345678, 0x9ABCDEF0)
# (b, h, n_q, n_kv, causal, masked, dropout); causal dropout and more than
# 1024 keys call `pl.program_id` inside a traced `pl.when` in the JAX
# kernels, which has no CPU lowering: those are held through the keep mask
FLASH_CASES = {
    "masked": (3, 2, 37, 37, False, True, 0.0),
    "masked_causal": (3, 2, 37, 37, True, True, 0.0),
    "masked_dropout": (3, 2, 37, 37, False, True, 0.2),
    "cross_lengths_dropout": (2, 3, 20, 150, False, True, 0.5),
}


def _flash_inputs(b, h, n_q, n_kv, masked, seed=0, d=16):
    rng = np.random.default_rng(seed)
    arrays = [normal(rng, b, h, n, d) for n in (n_q, n_kv, n_kv, n_q)]
    mask = None
    if masked:
        mask = rng.random((b, n_kv)) > 0.2
        mask[1, :3] = False
        if b > 2:
            mask[2] = False
    return [_bf(a) for a in arrays], mask


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_bf16_forward_and_backward_match_jax(case):
    """K4 (`_flash_oneshot_kernel`) and K5 (`_flash_bwd_dq_kernel`,
    `_flash_bwd_dkv_kernel`) at bf16, with the rate's keep mask: o, dq, dk
    and dv in bf16, lse in f32. The backward takes JAX's o and lse, so each
    kernel is held apart."""
    b, h, n_q, n_kv, causal, masked, rate = FLASH_CASES[case]
    ((q, tq), (k, tk), (v, tv), (do, tdo)), mask = _flash_inputs(b, h, n_q, n_kv, masked)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jseed = jnp.asarray([SEED], dtype=jnp.uint32) if rate > 0 else None
    cfg = dict(causal=causal, scale=0.3, dropout_rate=rate)
    o_j, lse_j = jfa._flash_forward(q, k, v, jmask, jseed, **cfg)
    o, lse = fa.flash_forward(tq, tk, tv, tmask, SEED, **cfg)
    _hold(o, o_j, BF16_TOL, BF16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :n_q, 0], atol=1e-4)
    grads_j = jfa._flash_backward(q, k, v, jmask, jseed, lse_j, o_j, do, **cfg)
    lse_t = torch.from_numpy(np.asarray(lse_j)[:, :, :n_q, 0].copy())
    o_t = torch.from_numpy(np.array(o_j.astype(jnp.float32))).to(BF16)
    grads = fa.flash_backward(tq, tk, tv, tmask, SEED, lse_t, o_t, tdo, **cfg)
    for got, want in zip(grads, grads_j):
        _hold(got, want, BF16_TOL, BF16)


def _attention_f32(q, k, v, mask, keep, causal, scale):
    """Attention in f32 with an explicit keep multiplier: autograd's
    gradients are the function the bf16 backward rounds."""
    n_q, n_kv = q.shape[2], k.shape[2]
    valid = fa._valid(q.shape[0], n_q, n_kv, mask, causal, q.device)
    s = torch.where(valid, torch.einsum("bhid,bhjd->bhij", q, k) * scale, fa.NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return torch.einsum("bhij,bhjd->bhid", p * keep, v)


@pytest.mark.parametrize("n_kv, causal", [(37, True), (1100, False)],
                         ids=["causal_dropout", "multi_block_dropout"])
def test_flash_bf16_backward_beyond_interpret_mode(n_kv, causal):
    """Where JAX's kernels cannot run on the CPU: the bf16 backward with
    dropout against autograd of f32 attention through the same keep mask
    (held bit for bit against JAX's in tests/test_torch_flash.py)."""
    b, h, n_q, rate = 2, 2, 37 if causal else 24, 0.2
    ((_, tq), (_, tk), (_, tv), (_, tdo)), _ = _flash_inputs(b, h, n_q, n_kv, False, seed=1)
    cfg = dict(causal=causal, scale=0.3, dropout_rate=rate)
    o, lse = fa.flash_forward(tq, tk, tv, None, SEED, **cfg)
    grads = fa.flash_backward(tq, tk, tv, None, SEED, lse, o, tdo, **cfg)
    keep = fa.dropout_keep_scaled(SEED, b, h, n_q, n_kv, rate)
    leaves = [x.float().requires_grad_() for x in (tq, tk, tv)]
    ref = _attention_f32(*leaves, None, keep, causal, 0.3)
    _hold(o, ref.detach().numpy(), BF16_TOL, BF16)
    for got, want in zip(grads, torch.autograd.grad(ref, leaves, tdo.float())):
        _hold(got, want.numpy(), BF16_TOL, BF16)


# --------------------------------------------------------------------- #
# K6 on bf16 operands
# --------------------------------------------------------------------- #


def test_rvq_bf16_matches_jax():
    """`rvq_quantize` at bf16 x and codebooks (`_rvq_kernel` upcasts x and
    promotes the codebooks): codes equal but for near-ties, `quantized` in
    bf16, equal to the codebook rows' sum rounded once."""
    rng = np.random.default_rng(7)
    (x, tx), (cb, tcb) = _bf(normal(rng, 300, 16)), _bf(normal(rng, 3, 64, 16))
    quantized_j, codes_j = jrvq.rvq_quantize(x, cb)
    quantized, codes = trvq.rvq(tx, tcb)
    assert quantized.dtype == BF16 and codes.dtype == torch.int32
    same = assert_codes_match(tx.float().numpy(), tcb.float().numpy(), codes.numpy(),
                              np.asarray(codes_j), tie_tol=1e-4)
    assert same.mean() > 0.95
    np.testing.assert_array_equal(quantized.float().numpy()[same],
                                  np.asarray(quantized_j.astype(jnp.float32))[same])
    plain, _ = trvq.rvq_bf16_torch(tx, tcb)
    assert torch.equal(plain, quantized)


# --------------------------------------------------------------------- #
# the blocks: mixed forward, bf16 and mixed backward
# --------------------------------------------------------------------- #


def _cast(arrays, dtypes):
    """Each array as (JAX, torch) at its dtype: "f32" or "bf16"."""
    return [(_bf if d == "bf16" else _f32)(a) for a, d in zip(arrays, dtypes)]


def _wavenet_arrays(seed, b=2, n=16, d=16, S=2, L=3):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, n, d), normal(rng, S, L, 3 * d, d, scale=(3 * d) ** -0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, S, L, d, d, scale=d**-0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, L, d, d, scale=d**-0.5),
            normal(rng, L, d, scale=0.1), 1 + normal(rng, b, S, L, 2 * d, scale=0.1))


# the operand dtypes of each kind: activations (x, FiLM / γ, β, context)
# against weights
KINDS = {"mixed": ("f32", "bf16"), "bf16": ("bf16", "bf16")}


def _grads_match(jax_fn, torch_fn, pairs, cotangent, tol):
    """vjp of the JAX function against autograd through the port's, each
    gradient at its input's dtype."""
    jargs = [p[0] for p in pairs]
    out_j, vjp_fn = jax.vjp(jax_fn, *jargs)
    ct = cotangent(out_j.dtype)
    grads_j = vjp_fn(ct[0])
    leaves = [p[1].clone().requires_grad_() for p in pairs]
    out = torch_fn(*leaves)
    out.backward(ct[1])
    for leaf, want in zip(leaves, grads_j):
        assert leaf.grad.dtype == leaf.dtype
        _hold(leaf.grad, want, tol)
    return out, out_j


def _cotangent(shape, seed):
    g = normal(np.random.default_rng(seed), *shape)
    return lambda dtype: (jnp.asarray(g, dtype=dtype),
                          torch.from_numpy(g).to(torch.float32 if dtype == jnp.float32 else BF16))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("route", ["stack", "lanes"])
def test_wavenet_routes_and_backward_match_jax(route, kind):
    """K1 / K1b: the forward (mixed: f32 on the weights' values, as the JAX
    kernels promote them) and the vjp of `_bwd` (the plain body in f32,
    each cotangent cast to its primal's dtype)."""
    act, wt = KINDS[kind]
    arrays = _wavenet_arrays(0)
    pairs = _cast(arrays, (act, wt, wt, wt, wt, wt, wt, act))
    jax_fwd = jwn._fused_forward if route == "stack" else jwn._fused_forward_per_lane
    expected = jax_fwd(*[p[0] for p in pairs])
    with torch.no_grad():
        actual = wavenet_kernel._forward(route, *[p[1] for p in pairs])
    _hold(actual, expected, MIXED_TOL if kind == "mixed" else BF16_TOL,
          torch.float32 if kind == "mixed" else BF16)
    _grads_match(jwn.fused_wavenet_body, lambda *a: wavenet_kernel._WavenetBody.apply(route, *a),
                 pairs, _cotangent(arrays[0].shape, 1), BF16_TOL)


def _attn_arrays(seed, b=2, n=16, dm=16, heads=2, dh=8, dc=24, m=8):
    rng = np.random.default_rng(seed)
    hd = heads * dh
    return (normal(rng, b, n, dm), 1 + normal(rng, b, dm, scale=0.1), normal(rng, b, dm, scale=0.1),
            normal(rng, dm, hd, scale=dm**-0.5), normal(rng, dm, 2 * hd, scale=dm**-0.5),
            normal(rng, hd, dm, scale=hd**-0.5), normal(rng, b, m, dc),
            normal(rng, dc, 2 * hd, scale=dc**-0.5))


@pytest.mark.parametrize("kind", list(KINDS))
def test_attn_block_mixed_and_backward_match_jax(kind):
    """K2: the mixed forward against `_attn_block_kernel` at f32 x and bf16
    weights, and the vjp of `_fused_bwd` (`_attn_core_flash` in f32, its
    attention core on the flash kernels)."""
    act, wt = KINDS[kind]
    heads, dh = 2, 8
    x, g, b, wq, wkv, wo, _, _ = _attn_arrays(2)
    pairs = _cast((x, g, b, wq, wkv, wo), (act, act, act, wt, wt, wt))
    cfg = dict(heads=heads, dim_head=dh, scale=dh**-0.5)
    if kind == "mixed":
        jx, jg, jb, jwq, jwkv, jwo = [p[0] for p in pairs]
        wk, wv = jnp.split(jwkv, 2, axis=-1)
        to_heads = lambda w: w.reshape(w.shape[0], heads, dh).transpose(1, 0, 2)  # noqa: E731
        expected = jattn._fused_forward(jx, jg, jb, to_heads(jwq), to_heads(wk), to_heads(wv),
                                        jwo.reshape(heads, dh, -1), scale=dh**-0.5)
        with torch.no_grad():
            actual = attn_block_kernel.attn_block(*[p[1] for p in pairs], **cfg)
        _hold(actual - pairs[0][1], expected - pairs[0][0], MIXED_TOL, torch.float32)
    _grads_match(lambda *a: jattn.fused_attn_block(*a, **cfg),
                 lambda *a: attn_block_kernel._AttnBlock.apply(*a, heads, dh, dh**-0.5),
                 pairs, _cotangent(x.shape, 3), BF16_TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_cross_attn_block_mixed_and_backward_match_jax(kind):
    """K2b: the mixed forward against `_cross_attn_block_kernel`, and the
    vjp of `_cross_fused_bwd` (`cross_attn_block_xla`, which widens its
    inputs)."""
    act, wt = KINDS[kind]
    heads, dh = 2, 8
    x, g, b, wq, _, wo, ctx, wkv = _attn_arrays(4)
    pairs = _cast((x, ctx, g, b, wq, wkv, wo), (act, act, act, act, wt, wt, wt))
    cfg = dict(heads=heads, dim_head=dh, scale=dh**-0.5)
    if kind == "mixed":
        with torch.no_grad():
            actual = attn_block_kernel.cross_attn_block(*[p[1] for p in pairs], **cfg)
        expected = jattn.fused_cross_attn_block(*[p[0] for p in pairs], **cfg)
        _hold(actual - pairs[0][1], expected - pairs[0][0], MIXED_TOL, torch.float32)
    _grads_match(lambda *a: jattn.fused_cross_attn_block(*a, **cfg),
                 lambda *a: attn_block_kernel._CrossAttnBlock.apply(*a, heads, dh, dh**-0.5),
                 pairs, _cotangent(x.shape, 5), BF16_TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_ff_block_mixed_and_backward_match_jax(kind):
    """K3: the mixed forward against `_ff_block_kernel`, and the vjp of
    `_fused_bwd` (`ff_block_xla`, which widens its inputs)."""
    act, wt = KINDS[kind]
    dm = 16
    inner = int(dm * 4 * 2 / 3)
    rng = np.random.default_rng(6)
    arrays = (normal(rng, 2, 16, dm), 1 + normal(rng, 2, dm, scale=0.1),
              normal(rng, 2, dm, scale=0.1), normal(rng, dm, 2 * inner, scale=dm**-0.5),
              normal(rng, 2 * inner, scale=0.1), normal(rng, 3, inner, inner, scale=inner**-0.5),
              normal(rng, inner, scale=0.1), normal(rng, inner, dm, scale=inner**-0.5),
              normal(rng, dm, scale=0.1))
    pairs = _cast(arrays, (act, act, act) + (wt,) * 6)

    def jax_fn(x, g, b, w1, b1, wc, bc, w2, b2):
        return jff.fused_ff_block(x, g, b, w1, b1, wc, bc, w2, b2, approximate=True)

    if kind == "mixed":
        with torch.no_grad():
            actual = ff_block_kernel.ff_block(*[p[1] for p in pairs])
        expected = jax_fn(*[p[0] for p in pairs])
        _hold(actual - pairs[0][1], expected - pairs[0][0], MIXED_TOL, torch.float32)
    _grads_match(jax_fn, lambda *a: ff_block_kernel._FFBlock.apply(*a), pairs,
                 _cotangent(arrays[0].shape, 7), BF16_TOL)


def test_weight_cache_never_serves_a_dead_copy():
    """Per-step bf16 copies of a weight (AMP training) pack anew every
    step: an entry dies with its tensor, before the allocator can hand its
    id or its memory to the next copy."""
    master = torch.randn(64, 64)
    built = []
    for step in range(5):
        with torch.no_grad():
            master.add_(1.0)
        copy = master.to(BF16)
        value = gemm_cache.cached("test copy", lambda w: built.append(w.float().sum()) or w.sum(),
                                  copy)
        assert torch.equal(value, copy.sum()) and len(built) == step + 1
        del copy


# --------------------------------------------------------------------- #
# the AMP loss and its f32 master gradients, and two AMP steps
# --------------------------------------------------------------------- #

UNCOND_MODEL = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2)
UNCOND_CODEC = dict(channels=4, codebook_dim=16, codebook_size=32, num_quantizers=2)
FRAMES = 8  # 8 latent frames: the JAX gates pass, so K2 and K3 run (mixed)


def _to_bf16_tree(tree):
    return jax.tree_util.tree_map(
        lambda p: p.astype(jnp.bfloat16) if p.dtype == jnp.float32 else p, tree)


def _amp_loss_fn(ns2_j, **apply_kwargs):
    """The JAX trainer's AMP loss (`Trainer._loss_fn`): bf16 copies of the
    f32 parameters and of every float input, the losses back in f32."""
    def loss(p, batch, times, noise):
        batch = {k: v.astype(jnp.bfloat16) if jnp.issubdtype(v.dtype, jnp.floating) else v
                 for k, v in batch.items()}
        audio = batch.pop("audio")
        losses = ns2_j.apply({"params": _to_bf16_tree(p)}, audio, **batch, times=times,
                             noise=noise, **apply_kwargs)
        return losses["loss"].astype(jnp.float32), {k: v.astype(jnp.float32)
                                                    for k, v in losses.items()}

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port_amp_losses(ns2_t, batch, times, noise, tmp_path):
    trainer = Trainer(ns2_t, batches=iter([]), train_batch_size=len(times), amp=True,
                      results_folder=str(tmp_path))
    tensors = trainer._tensors(batch)
    audio = tensors.pop("audio")
    assert audio.dtype == BF16
    draws = {"times": t(times), "noise": t(noise).to(BF16)}
    losses = trainer.losses(audio, tensors, draws)
    losses["loss"].backward()
    assert all(p.dtype == torch.float32 for p in ns2_t.parameters())
    return losses


def _grad_errors(grads, grads_j):
    """{name: (max error / the largest entry, correlation)} of the port's
    f32 master gradients against JAX's, frozen codec excluded (zero in
    JAX, untouched in the port)."""
    errors = {}
    for name, want in load_jax_params(numpy_tree(grads_j)).items():
        got, want = grads[name], want.numpy()
        if name.startswith("codec."):
            assert got is None and not np.any(want), name
            continue
        assert got is not None and got.dtype == torch.float32, name
        got = got.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1] if want.size > 1 and want.any() else 1.0
        errors[name] = (float(np.abs(got - want).max()) / scale, float(corr))
    return errors


def _hold_grads(ns2_t, grads_j, tol=GRAD_RTOL):
    errors = _grad_errors({n: p.grad for n, p in ns2_t.named_parameters()}, grads_j)
    worst = max(errors.items(), key=lambda kv: kv[1][0])
    assert worst[1][0] <= tol, (worst, tol)
    low = {n: c for n, (_, c) in errors.items() if c < GRAD_CORR}
    assert not low, low
    return {name.split(".")[0] for name in errors}


def _jax_floor(value_and_grad, params, batch, key, *args):
    """JAX's own AMP gradients' change, worst tensor relative to its largest
    entry, when ``batch[key]`` moves by one bf16 ulp on half its samples."""
    def grads(b):
        return value_and_grad(params, {k: jnp.asarray(v) for k, v in b.items()}, *args)[1]

    sign = np.random.default_rng(11).choice([-1.0, 1.0], batch[key].shape)
    moved = dict(batch, **{key: (batch[key] * (1 + 2.0**-9 * sign)).astype(np.float32)})
    g0, g1 = grads(batch), grads(moved)
    trained = lambda g: {k: v for k, v in g.items() if k != "codec"}  # noqa: E731
    errors = jax.tree_util.tree_map(
        lambda a, b: float(jnp.abs(a - b).max() / jnp.maximum(jnp.abs(a).max(), 1e-12)),
        trained(g0), trained(g1))
    return max(jax.tree_util.tree_leaves(errors))


def _hold_losses(losses, losses_j):
    for k, v in losses_j.items():
        assert losses[k].dtype == torch.float32
        assert float(losses[k].detach()) == pytest.approx(float(v), rel=LOSS_RTOL, abs=1e-4), k


@pytest.fixture(scope="module")
def uncond_params():
    tree = {
        "model": JModel(**UNCOND_MODEL).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                                             jnp.zeros((1,)))["params"],
        "codec": JSoundStream(**UNCOND_CODEC).init(jax.random.PRNGKey(1),
                                                   jnp.zeros((1, 640)))["params"],
    }
    return jitter(numpy_tree(tree), 3, scale=0.1)


@pytest.fixture(scope="module")
def uncond_jax():
    """(the JAX module, its jitted AMP value_and_grad), compiled once."""
    ns2_j = jns2.NaturalSpeech2(model=JModel(**UNCOND_MODEL), codec=JSoundStream(**UNCOND_CODEC))
    return ns2_j, _amp_loss_fn(ns2_j)


def _uncond_port(params):
    ns2 = NaturalSpeech2(Model(**UNCOND_MODEL), SoundStream(**UNCOND_CODEC))
    ns2.load_state_dict(load_jax_params(params), strict=True)
    return ns2


def _uncond_case(seed, latents: bool):
    rng = np.random.default_rng(seed)
    audio = (normal(rng, 2, FRAMES, 16) * 3 if latents
             else np.tanh(normal(rng, 2, FRAMES * 320)))
    return audio, rng.uniform(0.05, 0.95, 2).astype(np.float32), normal(rng, 2, FRAMES, 16)


@pytest.mark.parametrize("latents", [True, False], ids=["latents", "raw_audio"])
def test_unconditional_amp_loss_and_grads_match_jax(uncond_params, uncond_jax, tmp_path, latents):
    """The flagship's AMP loss at the tiny widths, from bf16 latents and from
    raw audio (the codec and K6 in bf16): the denoiser in f32 against bf16
    weights (mixed K1, K2, K3; K4 / K5 in f32 through K2's backward)."""
    audio, times, noise = _uncond_case(0, latents)
    vg = uncond_jax[1]
    params = jax.tree_util.tree_map(jnp.asarray, uncond_params)
    draws = (jnp.asarray(times), jnp.asarray(noise, dtype=jnp.bfloat16))
    (_, losses_j), grads_j = vg(params, {"audio": jnp.asarray(audio)}, *draws)
    ns2_t = _uncond_port(uncond_params)
    _hold_losses(_port_amp_losses(ns2_t, audio, times, noise, tmp_path), losses_j)
    tol = GRAD_RTOL if latents else max(GRAD_RTOL, _jax_floor(vg, params, {"audio": audio},
                                                              "audio", *draws))
    assert _hold_grads(ns2_t, grads_j, tol) == {"model"}


@pytest.fixture(scope="module")
def cond_params():
    """The conditional tree of tests/test_torch_cond_train.py: the module's
    jitted init, the full codec merged in, every leaf jittered."""
    ns2_j = cond._jax_ns2()
    batch = {k: jnp.asarray(v) for k, v in cond._batch(0, [cond.T_X, cond.T_X - 1]).items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "times", "noise", "cfg",
                                                             "dropout"))}
    variables = jax.jit(lambda b: ns2_j.init(rngs, b.pop("audio"), **b))(dict(batch))
    tree = dict(variables["params"])
    tree["codec"] = ns2_j.codec.init(jax.random.PRNGKey(5), batch["audio"])["params"]
    return jitter(numpy_tree(tree), 7, scale=0.05)


def test_conditional_amp_loss_and_grads_match_jax(cond_params, tmp_path):
    """README config 2's loss at the tiny widths of tests/test_conditional.py,
    eval mode: the codec, K6 ×2, the prompt encoder (K4 / K5 in bf16), the
    phoneme encoder, the duration / pitch trunks and the resampler in bf16,
    mel and pitch in f32, the aligner mixed, the denoiser in f32 against
    bf16 weights."""
    batch = cond._batch(1, [cond.T_X, cond.T_X - 2])
    times, noise = cond._draws(2)
    vg = _amp_loss_fn(cond._jax_ns2(), deterministic=True)
    (_, losses_j), grads_j = vg(jax.tree_util.tree_map(jnp.asarray, cond_params),
                                {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.asarray(times), jnp.asarray(noise, dtype=jnp.bfloat16))
    ns2_t = cond._port(cond_params)
    _hold_losses(_port_amp_losses(ns2_t, batch, times, noise, tmp_path), losses_j)
    params = jax.tree_util.tree_map(jnp.asarray, cond_params)
    floor = _jax_floor(vg, params, batch, "prompt", jnp.asarray(times),
                       jnp.asarray(noise, dtype=jnp.bfloat16))
    reached = _hold_grads(ns2_t, grads_j, max(GRAD_RTOL, floor))
    assert {"model", "prompt_enc", "phoneme_enc", "duration_pitch", "aligner"} <= reached


def test_two_amp_steps_match_jax(uncond_params, uncond_jax, tmp_path):
    """`Trainer(amp=True).train_step` twice (grad accumulation 2, clipping,
    Adam, EMA) against the same steps of the JAX AMP loss and the JAX
    Trainer's optimizer: losses, f32 master parameters and EMA."""
    rng = np.random.default_rng(1)
    micro, accum, steps = 2, 2, 2
    batches = [np.tanh(normal(rng, accum * micro, FRAMES * 320)) for _ in range(steps)]
    draws = [(rng.uniform(0.05, 0.95, micro).astype(np.float32), normal(rng, micro, FRAMES, 16))
             for _ in range(steps * accum)]
    common = dict(train_batch_size=micro, grad_accum_every=accum, lr=LR, ema_decay=0.9,
                  ema_update_every=2, train_num_steps=4, max_grad_norm=0.5)
    ns2_j, grad_fn = uncond_jax
    jtrainer = JTrainer(ns2_j, batches=iter([]), results_folder=str(tmp_path / "jax"), amp=True,
                        mesh=make_mesh(n_data=1, devices=jax.devices()[:1]), **common)
    p = jax.tree_util.tree_map(jnp.asarray, uncond_params)
    opt_state, ema, losses_j = jtrainer.optimizer.init(p), p, []
    for step in range(steps):
        micros = batches[step].reshape(accum, micro, -1)
        acc, loss_sum = None, 0.0
        for m in range(accum):
            times, noise = draws[step * accum + m]
            (loss, _), g = grad_fn(p, {"audio": jnp.asarray(micros[m])}, jnp.asarray(times),
                                   jnp.asarray(noise, dtype=jnp.bfloat16))
            acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
            loss_sum += float(loss)
        grads = jax.tree_util.tree_map(lambda g: g / accum, acc)
        updates, opt_state = jtrainer.optimizer.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        if (step + 1) % 2 == 0:
            ema = jax.tree_util.tree_map(lambda e, q: e * 0.9 + q * 0.1, ema, p)
        losses_j.append(loss_sum / accum)

    ns2_t = _uncond_port(uncond_params)
    trainer = Trainer(ns2_t, batches=iter([]), results_folder=str(tmp_path / "port"), amp=True,
                      **common)
    queue = [(t(a), t(b).to(BF16)) for a, b in draws]
    trainer.draw = lambda audio: queue.pop(0)
    for step in range(steps):
        metrics = trainer.train_step(batches[step])
        assert metrics["loss"] == pytest.approx(losses_j[step], rel=LOSS_RTOL)
    assert not queue
    start = load_jax_params(uncond_params)
    for got, tree in ((dict(ns2_t.named_parameters()), p), (trainer.ema, ema)):
        for name, want in load_jax_params(numpy_tree(tree)).items():
            if name.startswith("codec."):  # zero gradients: Adam leaves them
                continue
            assert got[name].dtype == torch.float32, name
            moved = got[name].detach().numpy() - start[name].numpy()
            moved_j = want.numpy() - start[name].numpy()
            assert np.abs(moved - moved_j).max() <= 2 * LR * steps, name
            if moved.size > 1:
                assert np.corrcoef(moved.ravel(), moved_j.ravel())[0, 1] >= UPDATE_CORR, name
    adam = trainer.optimizer.state[next(ns2_t.parameters())]
    assert adam["exp_avg"].dtype == adam["exp_avg_sq"].dtype == torch.float32


def test_bf16_training_tracks_f32_loss_curve(tmp_path):
    """The port's twin of tests/test_trainer_options.py's test of the same
    name, with its bounds: AMP training learns, and ends in the f32 run's
    regime on the same data and seeds (400 steps of the tiny model on a
    fixed batch, the per-step loss averaged over the first and last 50)."""
    fixed = np.random.RandomState(0).uniform(-1, 1, size=(4, 640)).astype(np.float32)

    def run(amp):
        torch.manual_seed(0)
        codec = SoundStream(codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16,
                            use_pallas_rvq=False)
        model = Model(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                      use_flash_attn=False)
        trainer = Trainer(NaturalSpeech2(model=model, codec=codec, timesteps=8),
                          batches=iter([]), train_batch_size=4, lr=3e-3, train_num_steps=25,
                          save_and_sample_every=1000, amp=amp,
                          results_folder=str(tmp_path / f"amp_{amp}"), seed=0)
        losses = [trainer.train_step(fixed)["loss"] for _ in range(400)]
        return float(np.mean(losses[:50])), float(np.mean(losses[-50:]))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny tensors: one thread is the fastest
    try:
        f32_head, f32_tail = run(False)
        bf16_head, bf16_tail = run(True)
    finally:
        torch.set_num_threads(threads)
    assert f32_tail < 0.9 * f32_head, (f32_head, f32_tail)
    assert bf16_tail < 0.9 * bf16_head, (bf16_head, bf16_tail)
    assert abs(bf16_tail - f32_tail) < 0.3 * f32_tail + 0.05, (f32_tail, bf16_tail)


def test_amp_remat_and_evaluate(uncond_params, tmp_path):
    """Under AMP, `remat=True` recomputes the same step (the bf16 copies
    are made outside the rematerialised forward, as the JAX trainer casts
    outside `jax.checkpoint`), and `evaluate()` runs the AMP loss with
    fixed draws: f32 values, equal across calls."""
    rng = np.random.default_rng(4)
    batch = np.tanh(normal(rng, 2, FRAMES * 320))
    draw = (t(rng.uniform(0.1, 0.9, 2).astype(np.float32)), t(normal(rng, 2, FRAMES, 16)).to(BF16))
    out = []
    for remat in (False, True):
        trainer = Trainer(_uncond_port(uncond_params), batches=iter([]), train_batch_size=2,
                          amp=True, remat=remat, val_batches=iter([batch, batch]),
                          results_folder=str(tmp_path))
        trainer.draw = lambda audio, generator=None: draw
        trainer.train_step(batch)
        out.append(dict(trainer.ns2.named_parameters()))
    for name, p in out[0].items():
        assert torch.equal(p, out[1][name]), name
    first, second = trainer.evaluate(), trainer.evaluate()
    assert set(first) == {"val_loss", "val_diffusion"} and first == second
