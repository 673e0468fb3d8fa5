"""The rounding of K4's and K5's bf16 kernels (csrc/flash_fwd_bf16.cu,
csrc/flash_bwd_bf16.cu), emulated with torch ops on the CPU and held
against the JAX package's Pallas kernels at bf16 (`_flash_forward`,
`_flash_backward`, interpret mode), and the mesh's default device.

The kernels cannot run here; their arithmetic differs from the plain
versions at two points, which these emulate:

- K4 rescales its online softmax per tile of 128 keys, so P is rounded to
  bf16 against the running row max of its tile, not the final one, and its
  e^x is 2^(s·c − m·c) with c = scale·log2 e;
- K5's dV = Aᵀ·dO runs the f32 A as two bf16 parts (hi = bf16(A), lo =
  bf16(A − hi)), each part's product summed in f32.

These check the rounding design only. The emulations are torch code
written here: no code of the kernels runs in them, so a change to
flash_fwd_bf16.cu or flash_bwd_bf16.cu cannot fail them. The kernels
themselves are held to the plain versions on the card (chip_smoke.py phase
46). Inputs are made with numpy from a seed, rounded to bf16 alike on both
sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import flash_attention as jfa
from naturalspeech2_tpu_torch.ops import flash_attention as fa
from naturalspeech2_tpu_torch.parallel import make_mesh

from torch_parity import normal

# As tests/test_torch_bf16.py: one bf16 rounding of the output is 2^-9 of
# its magnitude, and the two sides sum their products in other orders;
# 1e-2 of the largest entry passes that with room, a dropped rounding point
# or a wrong layout does not.
BF16_TOL = 1e-2
# K4's key tile
KEY_TILE = 128
# What the two bf16 parts of A leave out: at most 2^-16 of each entry (the
# rounding of lo); summed over the queries with signs that cancel, well
# within 2^-14 of dv's largest entry.
SPLIT_TOL = 2.0**-14
LOG2E = 1.4426950408889634


def _arrays(b, h, n_q, n_kv, d, seed, masked):
    rng = np.random.default_rng(seed)
    arrays = [normal(rng, b, h, n, d) for n in (n_q, n_kv, n_kv, n_q)]
    mask = None
    if masked:
        mask = rng.random((b, n_kv)) > 0.2
        mask[0, 0] = True
        if b > 1:
            mask[1] = False  # a batch row whose keys are all masked
    jax_in = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    torch_in = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return jax_in, torch_in, mask


def _rel(actual: torch.Tensor, expected) -> float:
    got = actual.float().numpy()
    want = np.asarray(jnp.asarray(expected, dtype=jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def k4_bf16_tiled(q, k, v, mask, keep, *, causal: bool, scale: float, tile: int = KEY_TILE):
    """K4 bf16's arithmetic in torch ops: for each tile of ``tile`` keys,
    the running max m (raw logits), P = 2^(s·c − m·c) over the visible
    keys, l and O rescaled by 2^((m_old − m)·c), P·keep rounded to bf16
    before P·V summed in f32; o = O / l rounded to bf16, lse = m·scale +
    log l (NEG_INF where every key is masked)."""
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    c = scale * LOG2E
    valid = fa._valid(b, n_q, n_kv, None if mask is None else torch.from_numpy(mask), causal,
                      "cpu")
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    s = torch.where(valid, s, -torch.inf)
    m = torch.full((b, h, n_q, 1), -torch.inf)
    l = torch.zeros(b, h, n_q, 1)
    o = torch.zeros(b, h, n_q, v.shape[-1])
    for k0 in range(0, n_kv, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.exp2((m - m_use) * c)
        p = torch.exp2(st * c - m_use * c)
        l = l * corr + p.sum(-1, keepdim=True)
        pk = (p * keep[..., k0:k0 + tile]).to(torch.bfloat16).float()
        o = o * corr + torch.einsum("bhij,bhjd->bhid", pk, v[:, :, k0:k0 + tile].float())
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l == 0.0, fa.NEG_INF, m * scale + torch.log(safe_l))[..., 0]
    return (o / safe_l).to(torch.bfloat16), lse


def _dv_parts(q, k, do, mask, keep, lse, *, causal: bool, scale: float):
    """(dV from hi + lo bf16 parts of A, dV from the f32 A), both f32, A =
    P∘keep with P = exp(q kᵀ·scale − lse) over the visible keys."""
    b, _, n_q, _ = q.shape
    n_kv = k.shape[2]
    valid = fa._valid(b, n_q, n_kv, None if mask is None else torch.from_numpy(mask), causal,
                      "cpu")
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    a = torch.where(valid, torch.exp(s - lse[..., None]), 0.0) * keep
    hi = a.to(torch.bfloat16).float()
    lo = (a - hi).to(torch.bfloat16).float()
    split = (torch.einsum("bhij,bhid->bhjd", hi, do.float())
             + torch.einsum("bhij,bhid->bhjd", lo, do.float()))
    return split, torch.einsum("bhij,bhid->bhjd", a, do.float())


# (b, h, n_q, n_kv, d, causal, masked, dropout): past one key tile, causal
# and masked with a fully masked batch row; and cross lengths with dropout
# (causal dropout has no CPU lowering in the JAX kernels)
CASES = {
    "multi_tile_causal_masked": (2, 2, 1100, 1100, 64, True, True, 0.0),
    "cross_dropout": (2, 3, 40, 300, 64, False, True, 0.5),
}
SEED = (0x2468ACE0, 0x13579BDF)


@pytest.mark.parametrize("case", list(CASES))
def test_k4_bf16_tiled_rounding_matches_jax(case):
    """K4 bf16's per-tile rounding, as emulated here (the design, not the
    kernel), against `_flash_forward` at bf16, and against the plain bf16
    version (rounded against the final max)."""
    b, h, n_q, n_kv, d, causal, masked, rate = CASES[case]
    (q, k, v, _), (tq, tk, tv, _), mask = _arrays(b, h, n_q, n_kv, d, 3, masked)
    seed = SEED if rate else None
    keep = (fa.dropout_keep_scaled(seed, b, h, n_q, n_kv, rate) if rate
            else torch.ones(b, h, n_q, n_kv))
    o, lse = k4_bf16_tiled(tq, tk, tv, mask, keep, causal=causal, scale=d**-0.5)
    jseed = jnp.asarray([seed], dtype=jnp.uint32) if rate else None
    o_j, lse_j = jfa._flash_forward(q, k, v, None if mask is None else jnp.asarray(mask), jseed,
                                    causal=causal, scale=d**-0.5, dropout_rate=rate)
    assert _rel(o, o_j) <= BF16_TOL
    o_p, lse_p = fa.flash_forward_bf16_torch(
        tq, tk, tv, None if mask is None else torch.from_numpy(mask), seed, causal=causal,
        scale=d**-0.5, dropout_rate=rate)
    assert float((o.float() - o_p.float()).abs().max() / o_p.float().abs().max()) <= BF16_TOL
    assert not torch.equal(o, o_p)  # past one tile, the running max moves some roundings
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :n_q, 0], rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(lse == fa.NEG_INF, lse_p == fa.NEG_INF)
    if masked and b > 1:
        assert not o[1].float().any()  # every key masked: o = 0


@pytest.mark.parametrize("case", list(CASES))
def test_k5_bf16_split_dv_matches_jax(case):
    """K5 bf16's dV from two bf16 parts of A, as emulated here (the design,
    not the kernel): within BF16_TOL of `_flash_backward`'s dv at bf16, and
    within SPLIT_TOL of the largest entry of the unsplit f32 product."""
    b, h, n_q, n_kv, d, causal, masked, rate = CASES[case]
    (q, k, v, do), (tq, tk, tv, tdo), mask = _arrays(b, h, n_q, n_kv, d, 4, masked)
    seed = SEED if rate else None
    jseed = jnp.asarray([seed], dtype=jnp.uint32) if rate else None
    jmask = None if mask is None else jnp.asarray(mask)
    cfg = dict(causal=causal, scale=d**-0.5, dropout_rate=rate)
    o_j, lse_j = jfa._flash_forward(q, k, v, jmask, jseed, **cfg)
    _, _, dv_j = jfa._flash_backward(q, k, v, jmask, jseed, lse_j, o_j, do, **cfg)
    lse = torch.from_numpy(np.asarray(lse_j)[:, :, :n_q, 0].copy())
    keep = (fa.dropout_keep_scaled(seed, b, h, n_q, n_kv, rate) if rate
            else torch.ones(b, h, n_q, n_kv))
    split, unsplit = _dv_parts(tq, tk, tdo, mask, keep, lse, causal=causal, scale=d**-0.5)
    assert float((split - unsplit).abs().max()) <= SPLIT_TOL * float(unsplit.abs().max())
    assert not torch.equal(split, unsplit)  # the lo part carries what hi drops
    assert _rel(split.to(torch.bfloat16), dv_j) <= BF16_TOL


def test_make_mesh_without_a_device_raises_on_a_cpu_host():
    """No CUDA device and no ``device``: make_mesh refuses to fall back to
    the CPU and names the way to ask for it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: make_mesh() takes it")
    with pytest.raises(RuntimeError, match="device=.cpu."):
        make_mesh()
    assert make_mesh(device="cpu").device == torch.device("cpu")
