"""The design of the mixed entry points of K1, K1b, K2, K2b and K3 and of
K6 in bf16 on the bf16 GEMM core (csrc/wavenet.cu, csrc/wavenet_lane.cu,
csrc/attn_block.cu, csrc/cross_attn_block.cu, csrc/ff_block.cu,
csrc/rvq.cu, csrc/gemm_bf16.cuh), held on the CPU through torch models of
their layouts and arithmetic:

- K1 and K1b mixed (AMP training's denoiser: f32 x and FiLM against bf16
  weights): x's three bf16 planes (``split3``, exact sum), three-part
  products against the blocks packed "bf16_sw128", the gate on f32 biases
  and FiLM, the skips summed to f32 (``wavenet_body_planes_torch`` on f32
  x), against the JAX package's `_fused_forward` and
  `_fused_forward_per_lane` at f32 x and bf16 weights (Pallas in interpret
  mode);
- K6 bf16: x one bf16 pass, then the f32 residual's three planes against
  the bf16 codebook packed "bf16_sw128", d² = ‖C‖² − 2·acc and the first
  minimum (``rvq_planes_torch``), against `rvq_quantize` at bf16 x and
  codebooks; the skips' loader twin (``split_lanes_at``) over the
  residual's planes and the packed codebooks' chunks;
- K3 mixed (AMP's feed-forward block: f32 x, γ, β and biases against bf16
  weights): n(x)'s three planes, the GEGLU over their parts with a in f32,
  a's three planes, the conv over the 3 parts × 3 causal taps of a, c's
  three planes, W₂ over c's parts (``ff_block_planes_torch``), against
  `_ff_block_kernel` at f32 x and bf16 weights, and the conv's loader twin
  (``split_taps_at``) over a's planes;
- K2 mixed (AMP's attention block): n(x)'s planes, q/k/v kept in f32, the
  f32 attention core, o's three planes, W_o over them with and without the
  residual (``attn_block_planes_torch``), against `_attn_block_kernel` at
  f32 x and bf16 weights, and the W_o loader's twin
  (``split_head_rows_at``) over o's planes;
- K2b mixed (AMP's cross-attention block): the context's and n(x)'s
  planes, q and k/v kept in f32, the f32 attention core, o's planes, W_o
  over them with and without the residual
  (``cross_attn_block_planes_torch``), against `_cross_attn_block_kernel`
  at f32 x and ctx and bf16 weights, and the k/v loader's twin
  (``split_lanes_at``) over the context's planes;
- the packing of the weights and the scratch of every entry point.

These hold torch models of the kernels, not the kernels: no CUDA code runs
here, so a change to the .cu or .cuh sources cannot fail them. The kernels
themselves are held to their plain versions on the card (chip_smoke.py
phase 27). Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from naturalspeech2_tpu.ops import attn_block_kernel as jattn
from naturalspeech2_tpu.ops import ff_block_kernel as jff
from naturalspeech2_tpu.ops import rvq as jrvq
from naturalspeech2_tpu.ops import wavenet_kernel as jwn
from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
from naturalspeech2_tpu_torch.ops import gemm_cache
from naturalspeech2_tpu_torch.ops import rvq
from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

from torch_parity import assert_codes_match, normal

BF16 = torch.bfloat16
# The planes carry x and every lane exactly and each part's product with a
# bf16 weight is exact, so the model differs from JAX's f32 kernel only by
# f32 summation order (≈ 1e-7 of the largest entry); a dropped part of x
# or of a lane leaves ≥ 2^-16 ≈ 1.5e-5 (chip_smoke.py's WAVENET_TOL).
WAVENET_TOL = 1e-5
# Codes may part only where two candidates' d² are this close (the sums'
# order; chip_smoke.py's RVQ_TIE_TOL).
RVQ_TIE_TOL = 1e-3
ROW_TILE = 128  # the kernels' row tile (BM)
# The blocks' planes carry every f32 operand exactly and each part's
# product with a bf16 weight is exact, so the models differ from JAX's f32
# kernels only by f32 summation order (≈ 1e-7 of the largest entry of y −
# x); a dropped part leaves ≥ 2^-16 ≈ 1.5e-5 (chip_smoke.py's BLOCK_TOL,
# relative to the largest entry of y − x).
BLOCK_TOL = 1e-5


def _wavenet_arrays(seed, b, n, d, S, L):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, n, d), normal(rng, S, L, 3 * d, d, scale=(3 * d) ** -0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, S, L, d, d, scale=d**-0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, L, d, d, scale=d**-0.5),
            normal(rng, L, d, scale=0.1), 1 + normal(rng, b, S, L, 2 * d, scale=0.1))


def _mixed(arrays):
    """(torch, JAX) operands of the mixed entry: x and FiLM f32, the
    weights and biases rounded to bf16."""
    t = [torch.from_numpy(a) for a in arrays]
    t[1:7] = [w.to(BF16) for w in t[1:7]]
    j = [jnp.asarray(a) for a in arrays]
    j[1:7] = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays[1:7]]
    return t, j


# (route, (b, n, d, S, L)): K1 at d 128, and d 96 padded to 128, n 260
# holding the last lanes' 2δ = 256 taps and off the row tile; K1b at d 128
K1_CASES = [("stack", (2, 100, 128, 2, 3)), ("stack", (1, 260, 96, 2, 8)),
            ("lanes", (2, 100, 128, 2, 3))]


def _k1_id(c) -> str:
    route, case = c
    return ("" if route == "stack" else "lanes-") + "-".join(map(str, case))


@pytest.mark.parametrize("case", K1_CASES, ids=_k1_id)
def test_k1_mixed_planes_model_matches_pallas(case):
    """K1 and K1b mixed: x's planes sum to x exactly, the weights packed
    "bf16_sw128" unpack to the bf16 blocks exactly, and the three-part body
    (f32 biases, FiLM and output) against `_fused_forward` (K1b:
    `_fused_forward_per_lane`) at f32 x and bf16 weights within WAVENET_TOL
    of its largest entry."""
    route, (b, n, d, S, L) = case
    arrays = _wavenet_arrays(240, b, n, d, S, L)
    targs, jargs = _mixed(arrays)
    x = targs[0]
    planes = wk.split3(x)
    assert all(p.dtype == BF16 for p in planes)
    assert torch.equal(sum(p.double() for p in planes), x.double())

    fmt = gemm_cache.fmt_of(torch.float32, BF16, "wavenet_body" if route == "stack"
                            else "wavenet_lanes")
    wt = wk.pack_wavenet_weights(*targs[1:7], route, torch.float32, fmt)
    d_p = wt.d
    assert d_p == -(-d // 64) * 64 and wt.blocks.dtype == BF16
    assert wt.conv_b.dtype == wt.res_b.dtype == wt.skip_b.dtype == torch.float32
    padded = wk.pad_wavenet_weights(*(w.float() for w in targs[1:7]), d_p)
    blocks = wk.block_weights(padded[0], padded[2]).transpose(-1, -2)
    assert torch.equal(gemm_cache.unpack_b(wt.blocks, "bf16_sw128")[0].float(), blocks)

    jax_fwd = jwn._fused_forward if route == "stack" else jwn._fused_forward_per_lane
    expected = np.asarray(jax_fwd(*jargs), dtype=np.float32)
    out, _ = wk.wavenet_body_planes_torch(x, targs[7], wt, route)
    assert out.dtype == torch.float32 and out.shape == (b, n, d)
    if route == "stack":
        assert torch.equal(wk.wavenet_body_packed_torch(x, targs[7], wt, "stack"), out)
    err = np.abs(out.numpy() - expected).max() / np.abs(expected).max()
    assert err <= WAVENET_TOL, f"max error {err:.3e} of the largest entry, above {WAVENET_TOL}"
    # one plane of x instead of three: the JAX kernel's f32 x is not bf16
    one = wk.wavenet_body_planes_torch(x.to(BF16).float(), targs[7], wt, route)[0]
    assert np.abs(one.numpy() - expected).max() / np.abs(expected).max() > WAVENET_TOL


def _rvq_arrays(seed, m, num_q, size, d):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(normal(rng, m, d)).to(BF16)
    cb = torch.from_numpy(normal(rng, num_q, size, d)).to(BF16)
    return x, cb


# (m, Q, K, d): m 510 at the codec's widths, and a ragged shape (m off the
# row tile, K and d off 64)
RVQ_CASES = [(510, 4, 1024, 128), (130, 4, 1000, 72)]


@pytest.mark.parametrize("case", RVQ_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k6_bf16_planes_model_matches_pallas(case):
    """K6 bf16: the planes model's codes equal `rvq_quantize`'s at bf16 x
    and codebooks but for near-ties within RVQ_TIE_TOL in d², and its bf16
    quantized sum bit-equal on the agreeing rows; the plain
    ``rvq_bf16_torch`` likewise."""
    m, num_q, size, d = case
    x, cb = _rvq_arrays(241, m, num_q, size, d)
    packed, norms = rvq.pack_codebooks(cb)
    quantized, codes = rvq.rvq_planes_torch(x, packed, norms, size)
    assert quantized.dtype == BF16 and codes.dtype == torch.int32
    assert quantized.shape == (m, d) and codes.shape == (m, num_q)
    q_j, codes_j = jrvq.rvq_quantize(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16),
                                     jnp.asarray(cb.float().numpy(), dtype=jnp.bfloat16))
    xs, cbs = x.float().numpy(), cb.float().numpy()
    same = assert_codes_match(xs, cbs, codes.numpy(), np.asarray(codes_j), RVQ_TIE_TOL)
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(quantized.float().numpy()[same],
                                  np.asarray(q_j.astype(jnp.float32))[same])
    plain_q, plain_codes = rvq.rvq_bf16_torch(x, cb)
    same = assert_codes_match(xs, cbs, codes.numpy(), plain_codes.numpy(), RVQ_TIE_TOL)
    assert same.mean() >= 0.99
    assert torch.equal(quantized[torch.from_numpy(same)], plain_q[torch.from_numpy(same)])


def test_k6_bf16_loader_reads_the_planes_against_the_stage_codebook():
    """The twin of the stages' loader (`SplitLanes` with one lane and three
    parts over the residual's planes [3, m, d_p]): each chunk of A is a
    box of one plane, lo first, and its B chunk is the stage's codebook's
    chunk in the packed run of every stage; summed over the chunks, A·B is
    the planes' product with C_q (f32 sums, other orders)."""
    m, num_q, size, d = 300, 3, 200, 72
    x, cb = _rvq_arrays(242, m, num_q, size, d)
    packed, _ = rvq.pack_codebooks(cb)
    d_p, k_p = packed.shape[1] * 64, packed.shape[2]
    chunks = packed.reshape(num_q * d_p // 64, 1, k_p, 64)
    r = x.float() - cb[0].float()[torch.arange(m) % size]
    planes = torch.stack([torch.nn.functional.pad(p, (0, d_p - d)) for p in wk.split3(r)])
    per_stage = d_p // wk.BF16_CHUNK
    for qi in range(1, num_q):
        want = sum(p.float() for p in planes) @ torch.nn.functional.pad(
            cb[qi].float(), (0, d_p - d)).T
        for t0 in range(0, m, ROW_TILE):
            acc = 0
            for kc in range(3 * per_stage):
                (c, t, part, seq), kb = wk.split_lanes_at(
                    kc, t0, 0, batch=1, w=d_p, lanes=1, parts=3, slot0=0,
                    b_chunk0=qi * per_stage)
                assert seq == 0 and t == t0 and part == 2 - kc // per_stage
                assert kb == qi * per_stage + kc % per_stage
                box = planes[part, t:t + ROW_TILE, c:c + 64].float()
                b_chunk = gemm_cache.unpack_b(chunks[kb], "bf16_sw128")[0].float()  # [K_p, 64]
                acc = acc + box @ b_chunk[:size].T
            rows = want[t0:t0 + ROW_TILE]
            assert torch.allclose(acc, rows, rtol=0, atol=1e-5 * rows.abs().max())


def test_pack_codebooks_bf16_is_the_bf16_core_format():
    """bf16 codebooks pack "bf16_sw128" ([Q, d/64, K, 64], bf16, padded with
    zeros) and unpack exactly; their norms are f32 of the bf16 values; f32
    codebooks keep the split-TF32 core's "split"."""
    _, cb = _rvq_arrays(243, 1, 3, 100, 72)
    packed, norms = rvq.pack_codebooks(cb)
    assert packed.dtype == BF16 and packed.shape == (3, 2, 128, 64)
    hi, lo = gemm_cache.unpack_b(packed, "bf16_sw128")
    assert not lo.any() and not hi[:, 100:].any() and not hi[..., 72:].any()
    assert torch.equal(hi[:, :100, :72], cb)
    assert norms.dtype == torch.float32
    assert torch.equal(norms, (cb.float() ** 2).sum(-1))
    f32_packed, _ = rvq.pack_codebooks(cb.float())
    assert f32_packed.dtype == torch.float32 and f32_packed.shape[-2] == 2  # hi and lo
    assert torch.equal(sum(gemm_cache.unpack_b(f32_packed))[:, :100, :72], cb.float())


def test_scratch_of_both_entries():
    """The scratch in the C entries' argument order: K1 mixed x's three
    planes [b, 3, n, d_p] and the lanes' planes [L·b, 3, n, d_p], bf16; K1b
    mixed x's three planes and LANE_GROUP lanes' planes [LANE_GROUP·b, 3, n,
    d_p], bf16 (the skips summed into the f32 output); f32 K1b the f32 lane
    pair; K6 bf16 best [Q, m] all ones, the f32 residual and sum [m, d] and
    the residual's planes [3, m, d_p], bf16; K6 f32 best and the residual.
    TMA reads each 16-byte aligned. The format, and so the core, of each
    mixed route comes from ``fmt_of``."""
    b, n, d_p, L = 2, 50, 128, 8
    f32 = torch.float32
    assert [gemm_cache.fmt_of(f32, BF16, e) for e in ("wavenet_body", "wavenet_lanes")] == \
        ["bf16_sw128", "bf16_sw128"]
    got = wk.scratch(b, n, d_p, L, "stack", f32, "cpu",
                     gemm_cache.fmt_of(f32, BF16, "wavenet_body"))
    assert [t.shape for t in got] == [(b, 3, n, d_p)] + [(L * b, 3, n, d_p)] * 2
    assert all(t.dtype == BF16 and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in got)
    lanes = wk.scratch(b, n, d_p, L, "lanes", f32, "cpu",
                       gemm_cache.fmt_of(f32, BF16, "wavenet_lanes"))
    assert [t.shape for t in lanes] == [(b, 3, n, d_p)] + [(wk.LANE_GROUP * b, 3, n, d_p)] * 2
    assert all(t.dtype == BF16 and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in lanes)
    f32_lanes = wk.scratch(b, n, d_p, L, "lanes", f32, "cpu")
    assert [(t.shape, t.dtype) for t in f32_lanes] == [((b, n, d_p), torch.float32)] * 2
    m, d, num_q = 130, 72, 4
    best, residual, total, planes = rvq.scratch(m, d, num_q, BF16, "cpu")
    assert best.shape == (num_q, m) and best.dtype == torch.int64 and bool((best == -1).all())
    assert residual.shape == total.shape == (m, d)
    assert residual.dtype == total.dtype == torch.float32
    assert planes.shape == (3, m, 128) and planes.dtype == BF16 and planes.data_ptr() % 16 == 0
    f32 = rvq.scratch(m, d, num_q, torch.float32, "cpu")
    assert [t.shape for t in f32] == [(num_q, m), (m, d)]


def _mixed_block(arrays, n_act):
    """(torch, JAX) operands of a mixed block: the first ``n_act`` arrays
    (the activations) f32, the rest (weights and biases) rounded to bf16."""
    t = [torch.from_numpy(a) for a in arrays]
    t[n_act:] = [w.to(BF16) for w in t[n_act:]]
    j = [jnp.asarray(a) for a in arrays[:n_act]]
    j += [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays[n_act:]]
    return t, j


def _block_err(y, expected, x) -> float:
    """max |y − expected| relative to the largest entry of expected − x."""
    expected = np.asarray(expected, dtype=np.float32)
    return np.abs(y.numpy() - expected).max() / np.abs(expected - x.numpy()).max()


def _is_split(planes: torch.Tensor, dim: int = 1) -> bool:
    """Whether the three bf16 planes along ``dim`` (hi, mid, lo) are
    ``split3`` of the f32 value they sum to."""
    parts = planes.unbind(dim)
    total = sum(p.float() for p in parts)
    return all(torch.equal(a, b) for a, b in zip(gemm_cache.split3(total), parts)) and \
        torch.equal(sum(p.double() for p in parts), total.double())


def _box(planes, seq: int, part: int, t: int, c: int) -> torch.Tensor:
    """A TMA box of ROW_TILE rows from t and 64 columns from c of plane
    ``part`` of sequence ``seq`` (planes [b, parts, n, w]), rows outside the
    sequence zeros."""
    n = planes.shape[2]
    rows = torch.arange(t, t + ROW_TILE)
    inside = (rows >= 0) & (rows < n)
    out = torch.zeros(ROW_TILE, 64)
    out[inside] = planes[seq, part, rows[inside], c:c + 64].float()
    return out


def _ff_arrays(seed, b, n, dm, inner):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, n, dm), 1 + normal(rng, b, dm, scale=0.1),
            normal(rng, b, dm, scale=0.1), normal(rng, dm, 2 * inner, scale=dm**-0.5),
            normal(rng, 2 * inner, scale=0.1),
            normal(rng, 3, inner, inner, scale=(3 * inner) ** -0.5),
            normal(rng, inner, scale=0.1), normal(rng, inner, dm, scale=inner**-0.5),
            normal(rng, dm, scale=0.1))


def _ff_packed(targs):
    """The mixed entry's weights as the wrapper packs them: "bf16_sw128",
    the biases widened to f32."""
    wt = fk.pack_ff_weights(*targs[3:8], gemm_cache.fmt_of(torch.float32, BF16, "ff_block"))
    return wt._replace(b_val=wt.b_val.float(), b_gate=wt.b_gate.float(), bc=wt.bc.float())


# (b, n, dm, inner): AMP's widths at a short crop; dm and inner off 64
K3_CASES = [(2, 16, 128, 341), (2, 40, 96, 200)]


@pytest.mark.parametrize("case", K3_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k3_mixed_planes_model_matches_pallas(case):
    """K3 mixed: the weights packed "bf16_sw128" unpack to the bf16 weights
    exactly (32 value and the same 32 gate rows a tile, inner padded to 64
    with zeros); n(x)'s, a's and c's planes are `split3` of f32 values and
    n(x)'s sum to the f32 norm exactly; y against `_ff_block_kernel` at f32
    x and bf16 weights within BLOCK_TOL of its largest entry of y − x."""
    b, n, dm, inner = case
    targs, jargs = _mixed_block(_ff_arrays(250, *case), 3)
    x, gamma, beta = targs[:3]
    wt = _ff_packed(targs)
    ip = wt.ip
    assert ip == -(-inner // 64) * 64 and wt.geglu.dtype == wt.conv.dtype == BF16
    assert wt.b_val.dtype == wt.bc.dtype == torch.float32
    w1, wc, w2 = targs[3], targs[5], targs[7]
    geglu = gemm_cache.unpack_b(wt.geglu, "bf16_sw128")[0][:2 * ip].reshape(ip // 32, 2, 32, -1)
    for half, w in enumerate((w1[:, :inner], w1[:, inner:])):
        rows = geglu[:, half].reshape(ip, -1)
        assert torch.equal(rows[:inner, :dm], w.T) and not rows[inner:].any()
    conv = gemm_cache.unpack_b(wt.conv, "bf16_sw128")[0][:ip, :3 * ip]
    assert torch.equal(conv.reshape(ip, 3, ip).permute(1, 2, 0)[:, :inner, :inner], wc)
    out = gemm_cache.unpack_b(wt.out, "bf16_sw128")[0]
    assert torch.equal(out[:dm, :inner], w2.T) and not out[:, inner:].any()

    y, xn, a, c = fk.ff_block_planes_torch(x, gamma, beta, wt, targs[8].float())
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert [t.shape for t in (xn, a, c)] == [(b, 3, n, dm), (b, 3, n, ip), (b, 3, n, ip)]
    assert all(t.dtype == BF16 and _is_split(t) for t in (xn, a, c))
    assert torch.equal(sum(p.double() for p in xn.unbind(1)),
                       fk.ada_norm(x, gamma, beta).double())
    expected = jff.fused_ff_block(*jargs, approximate=True)
    err = _block_err(y, expected, x)
    assert err <= BLOCK_TOL, f"max error {err:.3e} of the largest entry of y - x, above {BLOCK_TOL}"
    # one plane of x instead of three: the JAX kernel's f32 x is not bf16
    one = fk.ff_block_planes_torch(x.to(BF16).float(), gamma, beta, wt, targs[8].float())[0]
    assert _block_err(one, expected, x) > BLOCK_TOL


def test_k3_mixed_conv_loader_reads_three_parts_of_three_taps():
    """The twin of the conv's loader (`SplitTaps` with dilation 1, three
    parts, one lane of b sequences) over a's planes [b, 3, n, ip]: each
    chunk of A is a box of one plane and one tap, lo first, shifted back by
    2 − tap rows (the rows before t = 0 zeros), against the packed conv's
    chunk of that tap; summed over the chunks, A·B is the causal conv of a
    (f32 sums, other orders)."""
    b, n, dm, inner = 2, 150, 96, 200
    targs, _ = _mixed_block(_ff_arrays(251, b, n, dm, inner), 3)
    wt = _ff_packed(targs)
    ip = wt.ip
    _, _, a, _ = fk.ff_block_planes_torch(*targs[:3], wt, targs[8].float())
    a_f32 = sum(p.float() for p in a.unbind(1))
    want = fk.causal_conv3(a_f32, F.pad(targs[5].float(), (0, ip - inner, 0, ip - inner)),
                           torch.zeros(ip))
    chunks = wt.conv.reshape(3 * ip // 64, 1, ip, 64)
    for bi in range(b):
        for t0 in range(0, n, ROW_TILE):
            acc = 0
            for kc in range(9 * ip // 64):
                (c, t, part, seq), kb = wk.split_taps_at(kc, t0, bi, w=ip, per_lane=b, lane0=0,
                                                         parts=3, shared=False, b_block0=0)
                tap = kc % (3 * ip // 64) * 64 // ip
                assert seq == bi and part == 2 - kc // (3 * ip // 64) and t == t0 - (2 - tap)
                b_chunk = gemm_cache.unpack_b(chunks[kb], "bf16_sw128")[0].float()  # [ip, 64]
                acc = acc + _box(a, seq, part, t, c) @ b_chunk.T
            rows = want[bi, t0:t0 + ROW_TILE]
            assert torch.allclose(acc[:rows.shape[0]], rows, rtol=0, atol=1e-5 * want.abs().max())


def _attn_arrays(seed, b, n, dm, heads, dim_head):
    rng = np.random.default_rng(seed)
    hd = heads * dim_head
    return (normal(rng, b, n, dm), 1 + normal(rng, b, dm, scale=0.1),
            normal(rng, b, dm, scale=0.1), normal(rng, dm, hd, scale=dm**-0.5),
            normal(rng, dm, 2 * hd, scale=dm**-0.5), normal(rng, hd, dm, scale=hd**-0.5))


# (b, n, dm, heads, dim_head): 8 heads of 64 at dm 128 (AMP's); heads of 8
# (padded to K4's 64) at dm 96
K2_CASES = [(2, 16, 128, 8, 64), (2, 24, 96, 2, 8)]


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("case", K2_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k2_mixed_planes_model_matches_pallas(case, residual):
    """K2 mixed: the weights packed "bf16_sw128" unpack to the bf16 heads
    exactly (each padded to K4's width with zeros); n(x)'s planes sum to the
    f32 norm exactly, q/k/v are f32 and equal n(x)·W in f32, o's planes
    [b, 3·H, n, dh] are `split3` of o; y against `_attn_block_kernel` at
    f32 x and bf16 weights (without the residual: y − x) within BLOCK_TOL
    of its largest entry of y − x."""
    b, n, dm, heads, dim_head = case
    targs, jargs = _mixed_block(_attn_arrays(252, *case), 3)
    x, gamma, beta, wq, wkv, wo = targs
    scale = dim_head**-0.5
    packed = ak.pack_attn_weights(wq, wkv, wo, heads, dim_head,
                                  gemm_cache.fmt_of(torch.float32, BF16, "attn_block"))
    dh = ak.kernel_head_dim(dim_head)
    assert all(p.dtype == BF16 for p in packed)
    qkv_w = gemm_cache.unpack_b(packed[0], "bf16_sw128")[0][:3 * heads * dh].reshape(
        3, heads, dh, -1)
    for which, w in enumerate((wq, *wkv.chunk(2, dim=-1))):
        heads_w = w.reshape(dm, heads, dim_head).permute(1, 2, 0)
        assert torch.equal(qkv_w[which, :, :dim_head, :dm], heads_w)
        assert not qkv_w[which, :, dim_head:].any()

    y, xn, qkv, o_planes = ak.attn_block_planes_torch(x, gamma, beta, packed, heads=heads,
                                                      scale=scale, residual=residual)
    assert y.dtype == qkv.dtype == torch.float32 and y.shape == x.shape
    assert qkv.shape == (3, b, heads, n, dh) and o_planes.shape == (b, 3 * heads, n, dh)
    assert xn.dtype == o_planes.dtype == BF16 and _is_split(xn)
    assert _is_split(o_planes.reshape(b, 3, heads, n, dh))
    xn_f32 = fk.ada_norm(x, gamma, beta)
    assert torch.equal(sum(p.double() for p in xn.unbind(1)), xn_f32.double())
    q = (xn_f32 @ wq.float()).reshape(b, n, heads, dim_head).transpose(1, 2)
    assert torch.allclose(qkv[0, ..., :dim_head], q, rtol=0, atol=1e-6 * q.abs().max())
    assert not qkv[..., dim_head:].any()
    wk_, wv_ = jnp.split(jargs[4], 2, axis=-1)
    to_heads = lambda w: w.reshape(dm, heads, dim_head).transpose(1, 0, 2)  # noqa: E731
    expected = jattn._fused_forward(*jargs[:3], to_heads(jargs[3]), to_heads(wk_), to_heads(wv_),
                                    jargs[5].reshape(heads, dim_head, dm), scale=scale)
    got = y if residual else y + x
    err = _block_err(got, expected, x)
    assert err <= BLOCK_TOL, f"max error {err:.3e} of the largest entry of y - x, above {BLOCK_TOL}"


def test_k2_mixed_wo_loader_reads_the_heads_parts():
    """The twin of the W_o loader (`SplitHeadRows`) over o's planes [b,
    3·H, n, dh]: each chunk of A is a box of one head's part, lo first,
    against the packed W_o's chunk of that head; summed over the chunks,
    A·B is o's heads' concatenation times W_o (f32 sums, other orders)."""
    b, n, dm, heads, dim_head = 2, 150, 96, 2, 128
    targs, _ = _mixed_block(_attn_arrays(253, b, n, dm, heads, dim_head), 3)
    packed = ak.pack_attn_weights(*targs[3:], heads, dim_head,
                                  gemm_cache.fmt_of(torch.float32, BF16, "attn_block"))
    _, _, _, o_planes = ak.attn_block_planes_torch(*targs[:3], packed, heads=heads,
                                                   scale=dim_head**-0.5)
    dh = ak.kernel_head_dim(dim_head)
    hd = heads * dh
    o = sum(p.float() for p in o_planes.reshape(b, 3, heads, n, dh).unbind(1))
    want = o.transpose(1, 2).reshape(b, n, hd) @ targs[5].float()
    chunks = packed[1].reshape(hd // 64, 1, -1, 64)
    for bi in range(b):
        for t0 in range(0, n, ROW_TILE):
            acc = 0
            for kc in range(3 * hd // 64):
                (c, t, sl, seq), kb = ak.split_head_rows_at(kc, t0, bi, heads=heads, dh=dh)
                assert seq == bi and t == t0 and sl // heads == 2 - kc // (hd // 64)
                b_chunk = gemm_cache.unpack_b(chunks[kb], "bf16_sw128")[0].float()
                acc = acc + _box(o_planes, seq, sl, t, c) @ b_chunk[:dm].T
            rows = want[bi, t0:t0 + ROW_TILE]
            assert torch.allclose(acc[:rows.shape[0]], rows, rtol=0, atol=1e-5 * want.abs().max())


def _cross_arrays(seed, b, n, dm, heads, dim_head, m, dc):
    rng = np.random.default_rng(seed)
    hd = heads * dim_head
    return (normal(rng, b, n, dm), normal(rng, b, m, dc), 1 + normal(rng, b, dm, scale=0.1),
            normal(rng, b, dm, scale=0.1), normal(rng, dm, hd, scale=dm**-0.5),
            normal(rng, dc, 2 * hd, scale=dc**-0.5), normal(rng, hd, dm, scale=hd**-0.5))


# (b, n, dm, heads, dim_head, m, dc): AMP's widths (8 heads of 64, dm = dc
# = 128) at a short crop; heads of 8 (padded to K4's 64), dm 96 and dc 100
# off 64, and m 5 off every tile
K2B_CASES = [(2, 16, 128, 8, 64, 8, 128), (2, 24, 96, 2, 8, 5, 100)]


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("case", K2B_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k2b_mixed_planes_model_matches_pallas(case, residual):
    """K2b mixed: the context's planes [b, 3, m, dc padded to 64] and n(x)'s
    sum to their f32 values exactly (zeros past dc), q and kv are f32; y
    against `_cross_fused_forward` at f32 x and ctx and bf16 weights
    (without the residual: y − x) within BLOCK_TOL of its largest entry of
    y − x, and past it with one plane of the context or of x in place of
    three."""
    b, n, dm, heads, dim_head, m, dc = case
    targs, jargs = _mixed_block(_cross_arrays(254, *case), 4)
    x, ctx, gamma, beta, wq, wkv, wo = targs
    scale = dim_head**-0.5
    packed = ak.pack_cross_weights(wq, wkv, wo, heads, dim_head,
                                   gemm_cache.fmt_of(torch.float32, BF16, "cross_attn_block"))
    dh = ak.kernel_head_dim(dim_head)
    dc_pad = -(-dc // 64) * 64
    assert all(p.dtype == BF16 for p in packed)

    y, xn, c, q, kv, o_planes = ak.cross_attn_block_planes_torch(
        x, ctx, gamma, beta, packed, heads=heads, scale=scale, residual=residual)
    assert y.dtype == q.dtype == kv.dtype == torch.float32 and y.shape == x.shape
    assert q.shape == (b, heads, n, dh) and kv.shape == (2, b, heads, m, dh)
    assert c.shape == (b, 3, m, dc_pad) and o_planes.shape == (b, 3 * heads, n, dh)
    assert xn.dtype == c.dtype == o_planes.dtype == BF16 and _is_split(xn) and _is_split(c)
    assert torch.equal(sum(p.double() for p in xn.unbind(1)),
                       fk.ada_norm(x, gamma, beta).double())
    assert torch.equal(sum(p.double() for p in c.unbind(1))[..., :dc], ctx.double())
    assert not c[..., dc:].any()
    k = (ctx @ wkv[:, :heads * dim_head].float()).reshape(b, m, heads, dim_head).transpose(1, 2)
    assert torch.allclose(kv[0, ..., :dim_head], k, rtol=0, atol=1e-6 * k.abs().max())
    assert not kv[..., dim_head:].any() and not q[..., dim_head:].any()
    wk_, wv_ = jnp.split(jargs[5], 2, axis=-1)
    to_heads = lambda w, rows: w.reshape(rows, heads, dim_head).transpose(1, 0, 2)  # noqa: E731
    expected = jattn._cross_fused_forward(
        *jargs[:4], to_heads(jargs[4], dm), to_heads(wk_, dc), to_heads(wv_, dc),
        jargs[6].reshape(heads, dim_head, dm), scale=scale)
    got = y if residual else y + x
    err = _block_err(got, expected, x)
    assert err <= BLOCK_TOL, f"max error {err:.3e} of the largest entry of y - x, above {BLOCK_TOL}"
    # one plane of the context (or of x) instead of three: the JAX kernel's
    # f32 ctx and x are not bf16 (the lo plane alone moves y by ~3e-6 of its
    # largest entry here, under BLOCK_TOL: the softmax averages it away)
    for args in ((x, ctx.to(BF16).float()), (x.to(BF16).float(), ctx)):
        one = ak.cross_attn_block_planes_torch(*args, gamma, beta, packed, heads=heads,
                                               scale=scale, residual=residual)[0]
        assert _block_err(one if residual else one + x, expected, x) > BLOCK_TOL


def test_k2b_mixed_kv_loader_reads_the_context_parts():
    """The twin of the k/v GEMM's loader (`SplitLanes` with one lane and
    three parts over the context's planes [b, 3, m, dc_pad], sequences of m
    rows): each chunk of A is a box of one plane, lo first, the rows past m
    zeros, against the packed [W_k | W_v]'s chunk; summed over the chunks,
    A·B is the context times [W_k | W_v] (f32 sums, other orders)."""
    b, n, dm, heads, dim_head, m, dc = 2, 16, 96, 2, 128, 32, 100
    targs, _ = _mixed_block(_cross_arrays(255, b, n, dm, heads, dim_head, m, dc), 4)
    packed = ak.pack_cross_weights(*targs[4:], heads, dim_head,
                                   gemm_cache.fmt_of(torch.float32, BF16, "cross_attn_block"))
    _, _, c, _, _, _ = ak.cross_attn_block_planes_torch(*targs[:4], packed, heads=heads,
                                                        scale=dim_head**-0.5)
    dc_pad = c.shape[-1]
    hd = heads * ak.kernel_head_dim(dim_head)
    want = targs[1] @ targs[5].float()  # [b, m, 2·H·dh]: k's heads, then v's
    per_part = dc_pad // 64
    chunks = packed[1].reshape(per_part, 1, -1, 64)
    for bi in range(b):
        acc = 0
        for kc in range(3 * per_part):
            (col, t, part, seq), kb = wk.split_lanes_at(kc, 0, bi, batch=b, w=dc_pad, lanes=1,
                                                        parts=3, slot0=0, b_chunk0=0)
            assert seq == bi and t == 0 and part == 2 - kc // per_part and kb == kc % per_part
            b_chunk = gemm_cache.unpack_b(chunks[kb], "bf16_sw128")[0].float()  # [2·hd, 64]
            acc = acc + _box(c, seq, part, t, col) @ b_chunk[:2 * hd].T
        assert not acc[m:].any()
        assert torch.allclose(acc[:m], want[bi], rtol=0, atol=1e-5 * want.abs().max())


def test_blocks_mixed_scratch_and_format():
    """Every mixed entry packs "bf16_sw128" (``fmt_of`` by entry point);
    their scratch in the C entries' argument order: K3 a's planes [b, 3, n,
    ip] and c's [b, 3, n, max(ip, dm padded to 64)] (n(x)'s planes first),
    bf16; K2 qkv [3, b, H, n, dh] and o [b, H, n, dh] f32, then the planes
    of 3·max(H·dh, dm padded to 64) values a row, bf16; K2b q, kv and o f32,
    then the same planes and the context's [b, 3, m, dc padded to 64],
    bf16; TMA reads each 16-byte aligned. f32 and bf16 keep their
    scratch."""
    f32 = torch.float32
    fmts = {e: gemm_cache.fmt_of(f32, BF16, e) for e in sorted(gemm_cache.MIXED_ENTRIES)}
    assert fmts == {"attn_block": "bf16_sw128", "cross_attn_block": "bf16_sw128",
                    "ff_block": "bf16_sw128", "wavenet_body": "bf16_sw128",
                    "wavenet_lanes": "bf16_sw128"}
    assert gemm_cache.fmt_of(f32) == "split" and gemm_cache.fmt_of(BF16) == "bf16_sw128"
    with pytest.raises(ValueError):
        gemm_cache.fmt_of(f32, BF16)
    b, n = 2, 50
    for dm, ip in ((128, 384), (512, 384)):
        a, c = fk.scratch(b, n, dm, ip, f32, "cpu", "bf16_sw128")
        assert a.dtype == c.dtype == BF16
        assert a.numel() == b * 3 * n * ip and c.numel() == b * 3 * n * max(ip, dm)
        assert a.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
        a, c = fk.scratch(b, n, dm, ip, BF16, "cpu")
        assert a.numel() == b * n * ip and c.numel() == b * n * max(ip, dm)
    a, c = fk.scratch(b, n, 128, 352, f32, "cpu")
    assert a.dtype == f32 and a.numel() == c.numel() == b * n * 352
    for dm, heads, dh in ((128, 8, 64), (640, 2, 128)):
        qkv, o, planes = ak.attn_scratch(b, n, dm, heads, dh, f32, "cpu", "bf16_sw128")
        assert qkv.shape == (3, b, heads, n, dh) and o.shape == (b, heads, n, dh)
        assert qkv.dtype == o.dtype == f32 and planes.dtype == BF16
        assert planes.numel() == b * n * 3 * max(heads * dh, dm) and planes.data_ptr() % 16 == 0
        qkv, o = ak.attn_scratch(b, n, dm, heads, dh, BF16, "cpu")
        assert qkv.dtype == BF16 and o.numel() == b * n * max(heads * dh, dm)
        qkv, o = ak.attn_scratch(b, n, dm, heads, dh, f32, "cpu")
        assert o.shape == (b, heads, n, dh) and o.dtype == f32
    for dm, dc, heads, dh in ((128, 128, 8, 64), (96, 100, 2, 128)):
        m = 32
        q, kv, o, planes = ak.cross_scratch(b, n, m, dm, dc, heads, dh, f32, "cpu", "bf16_sw128")
        assert q.shape == o.shape == (b, heads, n, dh) and kv.shape == (2, b, heads, m, dh)
        assert q.dtype == kv.dtype == o.dtype == f32 and planes.dtype == BF16
        assert planes.numel() == b * n * 3 * max(heads * dh, -(-dm // 64) * 64) + \
            b * m * 3 * -(-dc // 64) * 64
        assert planes.data_ptr() % 16 == 0 and (planes.numel() - b * m * 3 * -(-dc // 64) * 64) \
            * 2 % 16 == 0
        q, kv, o = ak.cross_scratch(b, n, m, dm, dc, heads, dh, f32, "cpu")
        assert kv.shape == (2, b, heads, m, dh) and o.dtype == f32
