"""The design of K1's and K1b's bf16 kernels and of K1b's `bf16_matmul`
(csrc/wavenet.cu, csrc/wavenet_lane.cu on the bf16 GEMM core
csrc/gemm_bf16.cuh), held on the CPU through torch models of their layouts
and arithmetic: the three-part split of an f32 lane into bf16 planes, the
"bf16_sw128" packing of the blocks and skips, the coordinates of the split,
dilated tap loader (`SplitTaps`) and of the skips' loader (`SplitLanes`),
with three planes a lane or one (`bf16_matmul`), and the planes-and-parts
body against the JAX package's Pallas kernels at bf16 (`_fused_forward`,
`_fused_forward_per_lane`, interpret mode) and, with one part, against
`_fused_forward_per_lane(..., bf16_matmul=True)` in f32.

These hold torch models of the kernel, not the kernel: no CUDA code runs
here, so a change to the .cu or .cuh sources cannot fail them. The kernels
themselves are held to their plain bf16 versions on the card
(chip_smoke.py phase 22). Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import wavenet_kernel as jwn
from naturalspeech2_tpu_torch.ops import gemm_cache
from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

from torch_parity import normal

# As tests/test_torch_bf16.py: the output is bf16, one rounding of it 2^-9
# of its magnitude; 1e-2 of the largest entry passes that and the two
# sides' orders of summation with room, a dropped rounding point or a
# wrong layout does not.
BF16_TOL = 1e-2
# The planes carry each f32 lane exactly, so the f32 lanes of the model
# differ from the f32 body's only by f32 summation order (≈ 1e-7 of the
# largest entry); a dropped lo part leaves up to 2^-16 ≈ 1.5e-5.
LANES_RTOL = 1e-6
TILE = 128  # the kernel's row tile (BM)


def _tie_values(rng, count: int) -> np.ndarray:
    """f32 values whose low bits make a bf16 rounding tie for hi (low 16
    bits 0x8000) or for mid (bits below mid's last kept bit halfway), and
    neighbours of those, at random exponents and signs."""
    sign = rng.integers(0, 2, count).astype(np.uint32) << 31
    exp = rng.integers(27, 227, count).astype(np.uint32) << 23  # ≈ 1e-30 .. 1e30
    top = rng.integers(0, 1 << 7, count).astype(np.uint32) << 16
    low = rng.choice(np.array([0x8000, 0x0080, 0x8080, 0x7F80, 0x0040, 0xFF80, 0x0001, 0x8001],
                              dtype=np.uint32), count)
    return (sign | exp | top | low).view(np.float32)


def _split_inputs() -> np.ndarray:
    rng = np.random.default_rng(220)
    mags = 10.0 ** rng.uniform(-30, 30, 4000)
    signs = rng.choice([-1.0, 1.0], 4000)
    bf16_exact = torch.from_numpy(rng.standard_normal(500).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    return np.concatenate([(mags * signs).astype(np.float32), _tie_values(rng, 4000),
                           np.array([0.0, -0.0, 1.0, -1.0, 1e-30, -1e30, 1e30], np.float32),
                           bf16_exact])


def test_split3_parts_are_bf16_and_sum_exactly():
    """(a) hi + mid + lo == v exactly, each part a bf16 value."""
    v = torch.from_numpy(_split_inputs())
    parts = wk.split3(v)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    total = sum(p.double() for p in parts)
    assert torch.equal(total, v.double())
    hi, mid, lo = (p.double().abs() for p in parts)
    # each part holds what the one before it left: at most half its ulp
    assert bool(((mid <= hi * 2.0**-8) | (hi == 0)).all())
    assert bool(((lo <= mid * 2.0**-8) | (mid == 0)).all())


def test_split3_ties_round_to_nearest_even():
    """(a) hi is torch's own round-to-nearest-even of v at the ties."""
    v = torch.from_numpy(_tie_values(np.random.default_rng(221), 2000))
    hi, mid, _ = wk.split3(v)
    assert torch.equal(hi, v.to(torch.bfloat16))
    assert torch.equal(mid, (v - hi.float()).to(torch.bfloat16))


def test_split3_part_products_are_exact():
    """(a) each part times a bf16 weight is the float64 product, in f32."""
    rng = np.random.default_rng(222)
    v = torch.from_numpy(_split_inputs())
    w = torch.from_numpy((10.0 ** rng.uniform(-2, 2, v.numel())
                          * rng.choice([-1.0, 1.0], v.numel())).astype(np.float32))
    w = w.to(torch.bfloat16)
    for part in wk.split3(v):
        assert torch.equal((part.float() * w.float()).double(), part.double() * w.double())


def _wavenet_arrays(seed, b, n, d, S, L):
    rng = np.random.default_rng(seed)
    return (normal(rng, b, n, d), normal(rng, S, L, 3 * d, d, scale=(3 * d) ** -0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, S, L, d, d, scale=d**-0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, L, d, d, scale=d**-0.5),
            normal(rng, L, d, scale=0.1), 1 + normal(rng, b, S, L, 2 * d, scale=0.1))


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("route", ["stack", "lanes"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_bf16_sw128_packing_of_blocks_and_skips(d, route):
    """(b) the blocks and skips packed "bf16_sw128" unpack to
    ``block_weights`` and skip_w, padded to 64 channels; the blocks are one
    run of S·L·3d_p/64 chunks, and both routes' skips are the same bytes
    ([L·d_p/64, d_p, 64])."""
    S, L = 2, 3
    _, conv_w, conv_b, res_w, res_b, skip_w, skip_b, _ = _bf16(*_wavenet_arrays(3, 1, 4, d, S, L))
    wt = wk.pack_wavenet_weights(conv_w, conv_b, res_w, res_b, skip_w, skip_b, route)
    d_p = -(-d // 64) * 64
    assert wt.fmt == "bf16_sw128" and wt.d == d_p and wt.blocks.dtype == torch.bfloat16
    assert wt.blocks.shape == (S, L, 3 * d_p // 64, 2 * d_p, 64) and wt.blocks.is_contiguous()
    padded = wk.pad_wavenet_weights(conv_w, conv_b, res_w, res_b, skip_w, skip_b, d_p)
    blocks = gemm_cache.unpack_b(wt.blocks, "bf16_sw128")[0]
    assert torch.equal(blocks, wk.block_weights(padded[0], padded[2]).transpose(-1, -2))
    skip = gemm_cache.unpack_b(wt.skip, "bf16_sw128")[0]
    if route == "stack":
        assert torch.equal(skip, padded[4].reshape(L * d_p, d_p).T)
        assert wt.skip_b.dtype == torch.float32
        assert torch.equal(wt.skip_b, padded[5].float().sum(0))
    else:
        assert torch.equal(skip, padded[4].transpose(-1, -2))
        assert torch.equal(wt.skip_b, padded[5])
    other = wk.pack_wavenet_weights(conv_w, conv_b, res_w, res_b, skip_w, skip_b,
                                    "lanes" if route == "stack" else "stack")
    assert torch.equal(wt.skip.reshape(-1), other.skip.reshape(-1))


def _box(t, c, row, part, seq, rows=TILE, width=wk.BF16_CHUNK):
    """A TMA box of ``t`` [seqs, parts, n, w]: rows row .. row + rows - 1
    (zeros outside 0 .. n - 1) of channels c .. c + width - 1 of plane
    ``part`` of sequence ``seq``."""
    n = t.shape[2]
    lo, hi = max(row, 0), min(row + rows, n)
    out = torch.zeros(rows, width, dtype=t.dtype)
    if hi > lo:
        out[lo - row:hi - row] = t[seq, part, lo:hi, c:c + width]
    return out


def _tile_rows(got, want, t0):
    """The rows of a row tile from t0 that lie in the sequence (the
    epilogue stores no row at or past n), of the assembled A and of the
    expected [n, k]."""
    live = min(TILE, want.shape[0] - t0)
    return got[:live], want[t0:t0 + live]


@pytest.mark.parametrize("lanes", ["stack", "lanes"])
@pytest.mark.parametrize("parts,first", [(3, False), (1, True), (1, False)],
                         ids=["False", "True", "one-plane"])
@pytest.mark.parametrize("d_p", [64, 128])
def test_split_taps_loader_is_the_shifted_concatenation(d_p, parts, first, lanes):
    """(c) ``split_taps_at``, the twin of ``SplitTaps::at``: each row tile's
    A assembled from boxes of the planes [G·b, parts, n, d_p] (three, or
    `bf16_matmul`'s one) or of x (one part, every lane's, in the first
    stack) is the parts' [x_{t−2δ} | x_{t−δ} | x_t], lo first, zeros before
    t = 0, at δ up to 128 with n < 2δ and n % 128 != 0; each part's chunks
    multiply the chunks of their lane's block."""
    rng = np.random.default_rng(223)
    b, n, S, L = 2, 200, 2, 8
    s = 1
    if lanes == "stack":  # K1: the stack's L lanes in one launch
        lane0, group = 0, L
    else:  # K1b: lanes 6 and 7 in one launch
        lane0, group = 6, 2
    planes = torch.from_numpy(normal(rng, group * b, parts, n, d_p)).to(torch.bfloat16)
    x = torch.from_numpy(normal(rng, b, 1, n, d_p)).to(torch.bfloat16)
    src = x if first else planes
    per_part = 3 * d_p // wk.BF16_CHUNK
    b_block0 = (s * L + lane0) * per_part
    for bi in range(group * b):
        lane = lane0 + bi // b
        seq = bi % b if first else bi
        dil = 2**lane
        want_parts = []
        for q in reversed(range(parts)):  # lo first
            a = src[seq, q]
            want_parts.append(torch.cat([wk._shift(a[None], 2 * dil)[0],
                                         wk._shift(a[None], dil)[0], a], dim=-1))
        want = torch.cat(want_parts, dim=-1)
        for t0 in range(0, n, TILE):
            got, chunks = [], []
            for kc in range(parts * per_part):
                (c, row, part, sq), kb = wk.split_taps_at(
                    kc, t0, bi, w=d_p, per_lane=b, lane0=lane0, parts=parts, shared=first,
                    b_block0=b_block0)
                got.append(_box(src, c, row, part, sq))
                chunks.append(kb)
            assert torch.equal(*_tile_rows(torch.cat(got, dim=-1), want, t0))
            block = (s * L + lane) * per_part
            assert chunks == [block + kc % per_part for kc in range(parts * per_part)]


@pytest.mark.parametrize("lanes,slot0,parts", [(8, 0, 3), (1, 0, 3), (1, 1, 3), (1, 1, 1)],
                         ids=["8-0", "1-0", "1-1", "1-1-one-plane"])
def test_split_lanes_loader_is_the_lanes_side_by_side(lanes, slot0, parts):
    """(c) ``split_lanes_at``, the twin of ``SplitLanes::at``: the skips'
    A is the lanes' planes side by side, lo first (K1: every lane; K1b: one
    lane, at its place in the planes; `bf16_matmul`: one plane a lane), and
    each part's chunks run over the lanes' skips."""
    rng = np.random.default_rng(224)
    b, n, d_p = 2, 300, 128
    slots = max(lanes, slot0 + 1)
    planes = torch.from_numpy(normal(rng, slots * b, parts, n, d_p)).to(torch.bfloat16)
    per_part = lanes * d_p // wk.BF16_CHUNK
    b_chunk0 = 5 * d_p // wk.BF16_CHUNK
    for bi in range(b):
        want = torch.cat([torch.cat([planes[(slot0 + l) * b + bi, q] for l in range(lanes)],
                                    dim=-1) for q in reversed(range(parts))], dim=-1)
        for t0 in range(0, n, TILE):
            got, chunks = [], []
            for kc in range(parts * per_part):
                (c, row, part, seq), kb = wk.split_lanes_at(
                    kc, t0, bi, batch=b, w=d_p, lanes=lanes, parts=parts, slot0=slot0,
                    b_chunk0=b_chunk0)
                got.append(_box(planes, c, row, part, seq))
                chunks.append(kb)
            assert torch.equal(*_tile_rows(torch.cat(got, dim=-1), want, t0))
            assert chunks == [b_chunk0 + kc % per_part for kc in range(parts * per_part)]


# (route, b, n, d, S, L): d 96 pads to 128; n 260 holds the last lanes' 2δ
# = 256 taps; n % 128 != 0
BODY_CASES = [("stack", 2, 100, 64, 2, 3), ("stack", 1, 130, 96, 2, 5),
              ("lanes", 1, 260, 96, 2, 8), ("lanes", 3, 40, 64, 2, 4)]
# K1b's `bf16_matmul` (one plane a lane, f32 in and out), as "lanes"
BF16MM_CASES = [("bf16mm", 1, 260, 96, 2, 8), ("bf16mm", 3, 40, 64, 2, 4)]


def _f32_lanes(args, route):
    """The last stack's lanes of the f32 body (``wk._block``) on the
    widened values."""
    x, conv_w, conv_b, res_w, res_b, _, _, film = (a.float() for a in args)
    S, L = conv_w.shape[:2]
    lanes = [x] * L
    for s in range(S):
        lanes = [wk._block(lanes[l], conv_w[s, l], conv_b[s, l], res_w[s, l], res_b[s, l],
                           film[:, s, l], 2**l) for l in range(L)]
    return torch.stack(lanes)


@pytest.mark.parametrize("case", BODY_CASES + BF16MM_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_planes_body_matches_pallas_bf16(case):
    """(d) the planes-and-parts body, through both routes' packing, against
    JAX's `_fused_forward` / `_fused_forward_per_lane` at bf16; with one
    part ("bf16mm": f32 x, weights and FiLM, the weights packed
    "bf16_sw128") against `_fused_forward_per_lane(..., bf16_matmul=True)`
    and the plain ``wavenet_body_lanes_bf16mm_torch``, which round the same
    operands: both within BF16_TOL, the gap to the plain version printed."""
    route, b, n, d, S, L = case
    arrays = _wavenet_arrays(225, b, n, d, S, L)
    if route == "bf16mm":
        targs = [torch.from_numpy(a) for a in arrays]
        expected = np.asarray(jwn._fused_forward_per_lane(
            *[jnp.asarray(a) for a in arrays], bf16_matmul=True), dtype=np.float32)
        wt = wk.pack_wavenet_weights(*targs[1:7], "lanes", fmt="bf16_sw128")
        out, _ = wk.wavenet_body_planes_torch(targs[0], targs[7], wt, "lanes", parts=1)
        assert out.dtype == torch.float32 and out.shape == (b, n, d)
        plain = wk.wavenet_body_lanes_bf16mm_torch(*targs)
        gap = ((out - plain).abs().max() / plain.abs().max()).item()
        print(f"one-plane body against the plain bf16_matmul version: {gap:.3e} of its largest "
              f"entry")
        assert gap <= BF16_TOL
        assert torch.equal(wk.wavenet_body_packed_torch(targs[0], targs[7], wt, "lanes"), out)
    else:
        targs = _bf16(*arrays)
        jax_fn = jwn._fused_forward if route == "stack" else jwn._fused_forward_per_lane
        expected = np.asarray(jax_fn(*[jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]),
                              dtype=np.float32)
        wt = wk.pack_wavenet_weights(*targs[1:7], route)
        out, _ = wk.wavenet_body_planes_torch(targs[0], targs[7], wt, route)
        assert out.dtype == torch.bfloat16 and out.shape == (b, n, d)
        assert torch.equal(wk.wavenet_body_packed_torch(targs[0], targs[7], wt, route), out)
    got = out.float().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - expected).max() / np.abs(expected).max()
    assert err <= BF16_TOL, f"max error {err:.3e} of the largest entry, above {BF16_TOL}"


@pytest.mark.parametrize("case", BODY_CASES, ids=lambda c: "-".join(map(str, c)))
def test_planes_body_lanes_are_the_f32_lanes(case):
    """(d) the planes carry the f32 lanes: hi + mid + lo of the last stack
    against the f32 body's lanes within LANES_RTOL of their largest entry
    (a dropped part misses by 2^-16 of an entry), and the padded channels
    exact zeros."""
    route, b, n, d, S, L = case
    targs = _bf16(*_wavenet_arrays(226, b, n, d, S, L))
    wt = wk.pack_wavenet_weights(*targs[1:7], route)
    _, lanes = wk.wavenet_body_planes_torch(targs[0], targs[7], wt, route)
    assert lanes.shape == (L, b, n, wt.d)
    assert not lanes[..., d:].any()
    want = _f32_lanes(targs, route)
    err = (lanes[..., :d] - want).abs().max() / want.abs().max()
    assert err <= LANES_RTOL, f"lanes off by {err:.3e} of the largest entry"


@pytest.mark.parametrize("route", ["stack", "lanes", "bf16mm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scratch_holds_the_planes(route, dtype):
    """The wrapper's scratch, in the C entry's argument order: in bf16 two
    plane buffers [lanes·b, 3, n, d_p] (L lanes for K1, LANE_GROUP for K1b)
    and K1b's f32 sum of the skips; in f32 the f32 lanes' pair; for
    `bf16_matmul` ("bf16mm", whatever the dtype) x's bf16 copy [b, n, d_p]
    and two one-plane buffers [LANE_GROUP·b, 1, n, d_p], 16-byte aligned for
    TMA."""
    b, n, d_p, L = 2, 50, 64, 4
    got = wk.scratch(b, n, d_p, L, route, dtype, "cpu")
    if route == "bf16mm":
        assert [t.shape for t in got] == [(b, n, d_p)] + [(wk.LANE_GROUP * b, 1, n, d_p)] * 2
        assert all(t.dtype == torch.bfloat16 and t.is_contiguous() for t in got)
        assert all(t.data_ptr() % 16 == 0 for t in got)
    elif dtype == torch.bfloat16:
        lanes = L if route == "stack" else wk.LANE_GROUP
        assert [t.shape for t in got[:2]] == [(lanes * b, 3, n, d_p)] * 2
        assert all(t.dtype == torch.bfloat16 for t in got[:2])
        if route == "lanes":
            assert got[2].shape == (b, n, d_p) and got[2].dtype == torch.float32
        assert len(got) == (3 if route == "lanes" else 2)
    else:
        lead = (b,) if route == "lanes" else (L, b)
        assert [t.shape for t in got] == [(*lead, n, d_p)] * 2
        assert all(t.dtype == torch.float32 for t in got)
