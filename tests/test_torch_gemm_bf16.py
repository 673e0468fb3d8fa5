"""The bf16 GEMM core's operand layouts (`csrc/gemm_bf16.cuh`), held on the
CPU, where the kernel cannot run: the "bf16_sw128" weight packing and the
kernel's 128-byte swizzle, the conv GEMM's A as three zero-filled,
row-shifted views of one buffer (TMA boxes within a sequence), and K3's
and K2's packed plain paths on that format against the JAX package's bf16
kernels (interpret mode, as tests/test_torch_bf16.py runs them).

Tolerances: packing and the swizzle move bf16 values without arithmetic,
so they hold exactly; the tap emulation computes the same f32 products as
`causal_conv3` in another order, within ATOL = 1e-5 on O(1) outputs; the
packed bf16 paths against JAX hold to tests/test_torch_bf16.py's BF16_TOL
(1e-2 of the largest entry: the rounding points match, the sums' order and
XLA's excess precision do not)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import attn_block_kernel as jattn
from naturalspeech2_tpu.ops import ff_block_kernel as jff
from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
from naturalspeech2_tpu_torch.ops import gemm_cache

from torch_parity import normal

ATOL = 1e-5
BF16_TOL = 1e-2
CHUNK = gemm_cache.SW128_CHUNK
TILE_ROWS = 128  # the rows of A the kernel's blocks of two consumer warpgroups own


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(normal(rng, *shape, scale=scale)).to(torch.bfloat16)


def _k3_weights(dm: int, inner: int):
    """K3's B operands as Bᵀ [N, K]: the GEGLU's, the conv's, W₂'s."""
    rng = np.random.default_rng(dm)
    return (_bf16(rng, 2 * inner, dm), _bf16(rng, inner, 3 * inner), _bf16(rng, dm, inner))


@pytest.mark.parametrize("dm", [40, 96, 128, 512])
def test_sw128_pack_unpack_exact(dm):
    """unpack_b inverts pack_b(., "bf16_sw128") exactly, the padding to
    multiples of 64 in N and K exact zeros, at K3's shapes (inner =
    int(8·dm/3): 106, 256, 341, 1365)."""
    inner = int(8 * dm / 3)
    for bt in _k3_weights(dm, inner):
        n, k = bt.shape
        packed = gemm_cache.pack_b(bt, "bf16_sw128")
        n_pad, k_pad = gemm_cache.round_up(n, CHUNK), gemm_cache.round_up(k, CHUNK)
        assert packed.dtype == torch.bfloat16
        assert tuple(packed.shape) == (k_pad // CHUNK, n_pad, CHUNK)
        hi, lo = gemm_cache.unpack_b(packed, "bf16_sw128")
        assert tuple(hi.shape) == (n_pad, k_pad) and not lo.any()
        assert torch.equal(hi[:n, :k], bt)
        assert not hi[n:].any() and not hi[:, k:].any()


def _swizzled(r: int, c: int) -> int:
    """`sm90::swizzled` (csrc/flash_bf16.cuh): the byte offset in a panel of
    16-byte piece c of row r."""
    return r * 128 + ((c ^ (r % 8)) << 4)


def _panel_read(panel: np.ndarray, rows: int) -> np.ndarray:
    """What `wgmma` reads from a K-major, 128-byte swizzled [rows, 64] bf16
    panel (CUTLASS's Swizzle<3,4,3>: byte address bits 4-6 xor bits 7-9,
    the panel 1024-byte aligned): element (r, k) at byte r·128 + ((k / 8)
    ^ (r % 8))·16 + (k % 8)·2."""
    out = np.empty((rows, CHUNK), dtype=panel.dtype)
    for r in range(rows):
        for k in range(CHUNK):
            byte = r * 128 + (((k // 8) ^ (r % 8)) << 4) + (k % 8) * 2
            out[r, k] = panel[byte // 2]
    return out


@pytest.mark.parametrize("bn", [64, 128, 256])
def test_sw128_swizzle_model(bn):
    """A Python model of the kernel's copies: B's TMA box (rows n0 .. n0 +
    bn of a chunk of the packed run, no swizzle) lands in shared memory as
    it lies, and A's box with the 128-byte swizzle puts its 16-byte piece c
    of row r at `swizzled(r, c)`; what the swizzled descriptor then reads is
    Bᵀ[n0 + r, 64·kc + k] and A[r, 64·kc + k], for every tile width the core
    launches, the rows past N zeros."""
    rng = np.random.default_rng(bn)
    n, k = 200, 150
    bt = _bf16(rng, n, k)
    packed = gemm_cache.pack_b(bt, "bf16_sw128")
    bits = packed.view(torch.int16).numpy()  # the bf16 bit patterns, compared exactly
    dense = np.zeros((gemm_cache.round_up(n, bn), gemm_cache.round_up(k, CHUNK)), np.int16)
    dense[:n, :k] = bt.view(torch.int16).numpy()
    n_rows = packed.shape[1]
    for kc in range(packed.shape[0]):
        for n0 in range(0, n_rows, bn):
            smem = np.zeros(bn * CHUNK, np.int16)
            run = bits[kc, n0:n0 + bn].reshape(-1)  # rows past n_rows stay zero
            smem[:run.size] = run
            np.testing.assert_array_equal(_panel_read(smem, bn),
                                          dense[n0:n0 + bn, CHUNK * kc:CHUNK * (kc + 1)])
    a = np.asarray(rng.integers(-2**15, 2**15, size=(64, CHUNK)), np.int16)
    smem = np.zeros(64 * CHUNK, np.int16)
    for r in range(64):
        for c in range(8):
            at = _swizzled(r, c) // 2
            smem[at:at + 8] = a[r, 8 * c:8 * c + 8]
    np.testing.assert_array_equal(_panel_read(smem, 64), a)


def _tap_box(a: torch.Tensor, bi: int, t0: int, kc: int, w: int) -> torch.Tensor:
    """`bgemm::TapRows`' TMA box for the 128-row tile at rows t0 .. t0 + 127
    of sequence bi, chunk kc, on the map of a [b, n, w]: rows t0 - (2 - tap)
    .. of that sequence, the 64 columns of the chunk within its tap; rows
    before 0 or past n (out of the map's bounds) read as zeros."""
    n = a.shape[1]
    k0 = kc * CHUNK
    tap = k0 // w
    shift = 2 - tap
    box = torch.zeros(TILE_ROWS, CHUNK)
    for r in range(TILE_ROWS):
        t = t0 - shift + r
        if 0 <= t < n:
            box[r] = a[bi, t, k0 - tap * w:k0 - tap * w + CHUNK]
    return box


@pytest.mark.parametrize("n", [5, 150, 1000])
def test_tap_rows_emulation(n):
    """The conv GEMM's A as the kernel builds it from one [b, n, w] buffer:
    tiles of 128 rows within one sequence (a sequence's last tile runs past
    its end unless 128 divides n), each chunk a box of the three taps'
    row-shifted views zero-filled out of bounds, times the packed conv Bᵀ
    equals `causal_conv3` of the sequences."""
    b, w = 3, CHUNK
    rng = np.random.default_rng(n)
    a = torch.from_numpy(normal(rng, b, n, w))
    wc = torch.from_numpy(normal(rng, 3, w, w, scale=(3 * w) ** -0.5))
    bc = torch.from_numpy(normal(rng, w, scale=0.1))
    conv_bt = wc.permute(2, 0, 1).reshape(w, 3 * w)  # as pack_ff_weights lays it out
    got = torch.empty(b, n, w)
    for bi in range(b):
        for t0 in range(0, n, TILE_ROWS):
            tile = torch.cat([_tap_box(a, bi, t0, kc, w) for kc in range(3 * w // CHUNK)], dim=1)
            rows = min(TILE_ROWS, n - t0)  # the epilogue stores the sequence's rows only
            got[bi, t0:t0 + rows] = (tile @ conv_bt.T + bc)[:rows]
    want = fk.causal_conv3(a, wc, bc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def _hold(actual: torch.Tensor, expected) -> None:
    assert actual.dtype == torch.bfloat16
    got = actual.float().numpy()
    want = np.asarray(jnp.asarray(expected, dtype=jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BF16_TOL, f"max error {err:.3e} of the largest entry, above {BF16_TOL}"


@pytest.mark.parametrize("dm, inner", [(16, 42), (40, 106), (96, 64), (160, 106)],
                         ids=["16", "40", "96-64", "160-106"])
def test_ff_block_packed_bf16_matches_jax(dm, inner):
    """K3's packed plain path on "bf16_sw128" (inner 42 → ip 64, 106 →
    128; at ff_mult 1, inner = int(2·dm/3), dm padded to 64 is wider than
    ip: 128 against 64, 192 against 128) against `_ff_block_kernel` at
    bf16."""
    rng = np.random.default_rng(30 + dm)
    arrays = (normal(rng, 2, 16, dm), 1 + normal(rng, 2, dm, scale=0.1),
              normal(rng, 2, dm, scale=0.1), normal(rng, dm, 2 * inner, scale=dm**-0.5),
              normal(rng, 2 * inner, scale=0.1), normal(rng, 3, inner, inner, scale=inner**-0.5),
              normal(rng, inner, scale=0.1), normal(rng, inner, dm, scale=inner**-0.5),
              normal(rng, dm, scale=0.1))
    j = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    x, g, b, w1, b1, wc, bc, w2, b2 = j
    expected = jff._fused_forward(x, g, b, w1[:, :inner], b1[:inner], w1[:, inner:], b1[inner:],
                                  wc, bc, w2, b2, approximate=True)
    weights = fk.pack_ff_weights(*t[3:8], fmt="bf16_sw128")
    assert weights.ip % CHUNK == 0 and weights.geglu.shape[-1] == CHUNK
    _hold(fk.ff_block_packed_torch(t[0], t[1], t[2], weights, t[8]), expected)


@pytest.mark.parametrize("dm, inner", [(512, 341), (256, 170), (96, 64), (512, 1365),
                                       (40, 106)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ff_scratch_holds_the_normed_rows(dm, inner, dtype):
    """K3's scratch: a holds b·n rows of ip; c as many rows of ip, but in
    bf16 of dm padded to 64 where that is wider, since the norm pre-pass
    writes n(x) there before the conv overwrites it. The two do not
    overlap."""
    b, n = 2, 24
    fmt = gemm_cache.fmt_of(dtype)
    ip = gemm_cache.round_up(inner, gemm_cache.chunk_of(fmt))
    a, c = fk.scratch(b, n, dm, ip, dtype, "cpu")
    c_row = max(ip, gemm_cache.round_up(dm, CHUNK)) if dtype == torch.bfloat16 else ip
    assert a.dtype == c.dtype == dtype
    assert a.numel() == b * n * ip and c.numel() == b * n * c_row
    assert c.data_ptr() == a.data_ptr() + a.numel() * a.element_size()
    assert c.data_ptr() % 16 == 0


@pytest.mark.parametrize("dm, heads, dim_head", [(16, 2, 8), (40, 2, 64)])
def test_attn_block_packed_bf16_matches_jax(dm, heads, dim_head):
    """K2's packed plain path on "bf16_sw128" (dm padded to 64, heads to
    K4's 64) against `_attn_block_kernel` at bf16."""
    hd = heads * dim_head
    rng = np.random.default_rng(40 + dm)
    arrays = (normal(rng, 2, 16, dm), 1 + normal(rng, 2, dm, scale=0.1),
              normal(rng, 2, dm, scale=0.1), normal(rng, dm, hd, scale=dm**-0.5),
              normal(rng, dm, 2 * hd, scale=dm**-0.5), normal(rng, hd, dm, scale=hd**-0.5))
    j = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    x, g, b, wq, wkv, wo = j
    wk, wv = jnp.split(wkv, 2, axis=-1)
    to_heads = lambda w: w.reshape(dm, heads, dim_head).transpose(1, 0, 2)  # noqa: E731
    expected = jattn._fused_forward(x, g, b, to_heads(wq), to_heads(wk), to_heads(wv),
                                    wo.reshape(heads, dim_head, dm), scale=dim_head**-0.5)
    packed = ak.pack_attn_weights(*t[3:], heads, dim_head, "bf16_sw128")
    assert all(p.shape[-1] == CHUNK for p in packed)
    _hold(ak.attn_block_packed_torch(*t[:3], packed, heads=heads, scale=dim_head**-0.5),
          expected)


@pytest.mark.parametrize("dm, dc, heads, dim_head", [(40, 20, 2, 64), (160, 36, 2, 8),
                                                     (16, 24, 2, 8)],
                         ids=["dm40-dc20", "dm160-over-hd", "16-24"])
def test_cross_attn_block_packed_bf16_matches_jax(dm, dc, heads, dim_head):
    """K2b's packed plain path on "bf16_sw128" against `_cross_attn_block_kernel`
    at bf16: a ragged dm (40, padded to 64), contexts of dc 20 and 36 (not
    multiples of 8: the kernel copies such rows for TMA), and dm 160 (padded
    to 192) wider than the heads' 2 · 64 (heads of 8 padded to K4's 64)."""
    hd = heads * dim_head
    rng = np.random.default_rng(50 + dm + dc)
    arrays = (normal(rng, 2, 16, dm), normal(rng, 2, 8, dc), 1 + normal(rng, 2, dm, scale=0.1),
              normal(rng, 2, dm, scale=0.1), normal(rng, dm, hd, scale=dm**-0.5),
              normal(rng, dc, 2 * hd, scale=dc**-0.5), normal(rng, hd, dm, scale=hd**-0.5))
    j = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    x, ctx, g, b, wq, wkv, wo = j
    wk, wv = jnp.split(wkv, 2, axis=-1)
    to_heads = lambda w: w.reshape(w.shape[0], heads, dim_head).transpose(1, 0, 2)  # noqa: E731
    expected = jattn._cross_fused_forward(x, ctx, g, b, to_heads(wq), to_heads(wk), to_heads(wv),
                                          wo.reshape(heads, dim_head, dm), scale=dim_head**-0.5)
    packed = ak.pack_cross_weights(*t[4:], heads, dim_head, "bf16_sw128")
    assert all(p.shape[-1] == CHUNK for p in packed)
    _hold(ak.cross_attn_block_packed_torch(*t[:4], packed, heads=heads, scale=dim_head**-0.5),
          expected)


@pytest.mark.parametrize("dm, dc, heads, dh", [(128, 128, 8, 64), (512, 128, 4, 64),
                                               (40, 20, 2, 64), (96, 100, 1, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cross_scratch_holds_the_normed_rows(dm, dc, heads, dh, dtype):
    """K2b's scratch: q [b, H, n, dh]; in bf16 o holds max(H·dh, dm padded
    to 64) values a row, since the norm pre-pass writes n(x) there before K4
    overwrites it (dm 512 against 4 heads of 64: a tensor-parallel rank's),
    and kv has room after its two planes for the context at a row of dc
    rounded up to 8, 16-byte aligned for TMA; in f32 kv and o are K4's
    [2, b, H, m, dh] and [b, H, n, dh]."""
    b, n, m = 2, 24, 32
    q, kv, o = ak.cross_scratch(b, n, m, dm, dc, heads, dh, dtype, "cpu")
    assert q.shape == (b, heads, n, dh) and q.dtype == kv.dtype == o.dtype == dtype
    if dtype == torch.bfloat16:
        plane = b * heads * m * dh
        assert o.numel() == b * n * max(heads * dh, gemm_cache.round_up(dm, CHUNK))
        assert kv.numel() == 2 * plane + b * m * gemm_cache.round_up(dc, 8)
        assert (kv.data_ptr() + 2 * plane * kv.element_size()) % 16 == 0
    else:
        assert kv.shape == (2, b, heads, m, dh) and o.shape == q.shape
