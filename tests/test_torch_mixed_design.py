"""The design of K1's mixed entry point and of K6 in bf16 on the bf16 GEMM
core (csrc/wavenet.cu, csrc/rvq.cu, csrc/gemm_bf16.cuh), held on the CPU
through torch models of their layouts and arithmetic:

- K1 mixed (AMP training's denoiser: f32 x and FiLM against bf16 weights):
  x's three bf16 planes (``split3``, exact sum), three-part products
  against the blocks packed "bf16_sw128", the gate on f32 biases and FiLM,
  the skips summed to f32 (``wavenet_body_planes_torch`` on f32 x), against
  the JAX package's `_fused_forward` at f32 x and bf16 weights (Pallas in
  interpret mode);
- K6 bf16: x one bf16 pass, then the f32 residual's three planes against
  the bf16 codebook packed "bf16_sw128", d² = ‖C‖² − 2·acc and the first
  minimum (``rvq_planes_torch``), against `rvq_quantize` at bf16 x and
  codebooks; the skips' loader twin (``split_lanes_at``) over the
  residual's planes and the packed codebooks' chunks;
- the packing of the codebooks and the scratch of both entry points.

These hold torch models of the kernels, not the kernels: no CUDA code runs
here, so a change to the .cu or .cuh sources cannot fail them. The kernels
themselves are held to their plain versions on the card (chip_smoke.py
phase 27). Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import rvq as jrvq
from naturalspeech2_tpu.ops import wavenet_kernel as jwn
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


# (b, n, d, S, L): d 128, and d 96 padded to 128; n 260 holds the last
# lanes' 2δ = 256 taps and is not a multiple of the row tile
K1_CASES = [(2, 100, 128, 2, 3), (1, 260, 96, 2, 8)]


@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k1_mixed_planes_model_matches_pallas(case):
    """K1 mixed: x's planes sum to x exactly, the weights packed
    "bf16_sw128" unpack to the bf16 blocks exactly, and the three-part body
    (f32 biases, FiLM and output) against `_fused_forward` at f32 x and bf16
    weights within WAVENET_TOL of its largest entry."""
    b, n, d, S, L = case
    arrays = _wavenet_arrays(240, b, n, d, S, L)
    targs, jargs = _mixed(arrays)
    x = targs[0]
    planes = wk.split3(x)
    assert all(p.dtype == BF16 for p in planes)
    assert torch.equal(sum(p.double() for p in planes), x.double())

    wt = wk.pack_wavenet_weights(*targs[1:7], "stack", torch.float32, "bf16_sw128")
    d_p = wt.d
    assert d_p == -(-d // 64) * 64 and wt.blocks.dtype == BF16
    assert wt.conv_b.dtype == wt.res_b.dtype == wt.skip_b.dtype == torch.float32
    padded = wk.pad_wavenet_weights(*(w.float() for w in targs[1:7]), d_p)
    blocks = wk.block_weights(padded[0], padded[2]).transpose(-1, -2)
    assert torch.equal(gemm_cache.unpack_b(wt.blocks, "bf16_sw128")[0].float(), blocks)

    expected = np.asarray(jwn._fused_forward(*jargs), dtype=np.float32)
    out, _ = wk.wavenet_body_planes_torch(x, targs[7], wt, "stack")
    assert out.dtype == torch.float32 and out.shape == (b, n, d)
    assert torch.equal(wk.wavenet_body_packed_torch(x, targs[7], wt, "stack"), out)
    err = np.abs(out.numpy() - expected).max() / np.abs(expected).max()
    assert err <= WAVENET_TOL, f"max error {err:.3e} of the largest entry, above {WAVENET_TOL}"
    # one plane of x instead of three: the JAX kernel's f32 x is not bf16
    one = wk.wavenet_body_planes_torch(x.to(BF16).float(), targs[7], wt, "stack")[0]
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
    mixed still the f32 lane pair; K6 bf16 best [Q, m] all ones, the f32
    residual and sum [m, d] and the residual's planes [3, m, d_p], bf16;
    K6 f32 best and the residual. TMA reads each 16-byte aligned. The
    format, and so the core, of each mixed route comes from ``fmt_of``."""
    b, n, d_p, L = 2, 50, 128, 4
    f32 = torch.float32
    assert [gemm_cache.fmt_of(f32, BF16, r) for r in ("stack", "lanes")] == ["bf16_sw128", "tf32"]
    got = wk.scratch(b, n, d_p, L, "stack", f32, "cpu", gemm_cache.fmt_of(f32, BF16, "stack"))
    assert [t.shape for t in got] == [(b, 3, n, d_p)] + [(L * b, 3, n, d_p)] * 2
    assert all(t.dtype == BF16 and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in got)
    lanes = wk.scratch(b, n, d_p, L, "lanes", f32, "cpu", gemm_cache.fmt_of(f32, BF16, "lanes"))
    assert [(t.shape, t.dtype) for t in lanes] == [((b, n, d_p), torch.float32)] * 2
    m, d, num_q = 130, 72, 4
    best, residual, total, planes = rvq.scratch(m, d, num_q, BF16, "cpu")
    assert best.shape == (num_q, m) and best.dtype == torch.int64 and bool((best == -1).all())
    assert residual.shape == total.shape == (m, d)
    assert residual.dtype == total.dtype == torch.float32
    assert planes.shape == (3, m, 128) and planes.dtype == BF16 and planes.data_ptr() % 16 == 0
    f32 = rvq.scratch(m, d, num_q, torch.float32, "cpu")
    assert [t.shape for t in f32] == [(num_q, m), (m, d)]
