"""The kernels' padded widths, held on the CPU.

On the card every kernel takes a fixed width or a multiple of one: K1 and
K1b d % 32, K2, K2b and K4 / K5 heads of 64 or a multiple of 128 (heads
wider than 128 in K4's and K5's chunked kernels, which sum the logits over
128-wide chunks of the head dim), and the split-TF32 GEMM core of K1, K2,
K2b, K3 and K6 packed 64-row, 32-column weight tiles. Other widths are
padded with exact zeros and the results cut back. Each wrapper's
pad-and-cut is a plain function here (the packed-weight versions of K1,
K2, K2b, K3 and K6 compute from the very layout the kernel reads; K4's and
K5's chunked order through `head_chunk`), run at the JAX package's test
widths (dim 16, dim_head 8, codebook dim 16, context 24) and at the wide
ones (heads of 96 to 320, K2b at dim 640, codebook dim 192, the WaveNet at
d 128 with dilations to 128) against the JAX function on the unpadded
inputs, the Pallas kernels in interpret mode. On the CPU this is the only
place the padding is seen: the wrappers run the plain versions on CPU
tensors before they pad.

Tolerance: the padded and unpadded functions differ only in the order of
f32 sums (zero terms add exactly), so every comparison holds to ATOL =
1e-5 on O(1) outputs, gradients relative to their largest entry."""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.ops import attn_block_kernel as jak
from naturalspeech2_tpu.ops import ff_block_kernel as jff
from naturalspeech2_tpu.ops import flash_attention as jfa
from naturalspeech2_tpu.ops import rvq as jrvq
from naturalspeech2_tpu.ops import wavenet_kernel as jwk
from naturalspeech2_tpu_torch.ops import attn_block_kernel as ak
from naturalspeech2_tpu_torch.ops import ff_block_kernel as fk
from naturalspeech2_tpu_torch.ops import flash_attention as fa
from naturalspeech2_tpu_torch.ops import gemm_cache
from naturalspeech2_tpu_torch.ops import rvq as rq
from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

from torch_parity import assert_close, assert_codes_match, normal, t

ATOL = 1e-5
DIM, DIM_HEAD, HEADS, CODEBOOK_DIM, CONTEXT = 16, 8, 2, 16, 24
SCALE = DIM_HEAD**-0.5


def _block_inputs(rng, b, n, dm):
    return normal(rng, b, n, dm), 1 + normal(rng, b, dm, scale=0.1), normal(rng, b, dm, scale=0.1)


def kmajor(r: int, k: int, rows: int = 64) -> int:
    """`kmajor<rows>` of csrc/wgmma.cuh: where wgmma reads element (r, k)."""
    return (k // 8) * 8 * rows + ((k % 8) // 4 * (rows // 8) + r // 8) * 32 + (r % 8) * 4 + k % 4


def test_packed_tiles_are_the_wgmma_layout():
    """Every element of a ragged Bᵀ [70, 45] lands where the kernel's
    descriptors read it, split into hi and lo; the padding is zeros."""
    bt = torch.from_numpy(normal(np.random.default_rng(0), 70, 45))
    packed = gemm_cache.pack_b(bt)
    assert packed.shape == (2, 2, 2, 2048)
    hi, lo = gemm_cache.tf32_split(torch.nn.functional.pad(bt, (0, 64 - 45, 0, 128 - 70)))
    for j in range(2):
        for c in range(2):
            for r in range(64):
                at = torch.tensor([kmajor(r, k) for k in range(32)])
                assert torch.equal(packed[j, c, 0, at], hi[64 * j + r, 32 * c:32 * c + 32])
                assert torch.equal(packed[j, c, 1, at], lo[64 * j + r, 32 * c:32 * c + 32])
    dense_hi, dense_lo = gemm_cache.unpack_b(packed)
    assert torch.equal((dense_hi + dense_lo)[:70, :45], bt)
    assert not (dense_hi + dense_lo)[70:].any() and not (dense_hi + dense_lo)[:, 45:].any()


def test_cache_builds_once_per_version_and_dies_with_its_tensor():
    calls = []

    def build(w):
        calls.append(1)
        return w * 2

    w = torch.ones(4, 3)
    first = gemm_cache.cached("test", build, w)
    assert gemm_cache.cached("test", build, w) is first and len(calls) == 1
    assert gemm_cache.cached("test", build, w[1:]) is not first  # a view: another key
    with torch.no_grad():
        w.add_(1.0)  # an optimizer step bumps the version
    assert torch.equal(gemm_cache.cached("test", build, w), w * 2) and len(calls) == 3
    keys = [k for k in gemm_cache._entries if k[0] == "test"]
    del w
    gc.collect()
    assert not any(k in gemm_cache._entries for k in keys)


def _wavenet_inputs(rng, b, n, d, S, L):
    return [normal(rng, b, n, d), normal(rng, S, L, 3 * d, d, scale=(3 * d) ** -0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, S, L, d, d, scale=d**-0.5),
            normal(rng, S, L, d, scale=0.1), normal(rng, L, d, d, scale=d**-0.5),
            normal(rng, L, d, scale=0.1), 1 + normal(rng, b, S, L, 2 * d, scale=0.1)]


def _packed_body(args, route):
    weights = wk.pack_wavenet_weights(*(t(a) for a in args[1:7]), route)
    return wk.wavenet_body_packed_torch(t(args[0]), t(args[7]), weights, route), weights


def test_k1_padded_body_matches_pallas():
    rng = np.random.default_rng(1)
    b, n, d, S, L = 2, 40, DIM, 2, 3
    args = [normal(rng, b, n, d), normal(rng, S, L, 3 * d, d, scale=0.1),
            normal(rng, S, L, d, scale=0.1), normal(rng, S, L, d, d, scale=0.1),
            normal(rng, S, L, d, scale=0.1), normal(rng, L, d, d, scale=0.1),
            normal(rng, L, d, scale=0.1), normal(rng, b, S, L, 2 * d, scale=0.5)]
    expected = jwk.fused_wavenet_body(*(jnp.asarray(a) for a in args))
    actual, weights = _packed_body(args, "stack")
    assert weights.d == wk.KERNEL_ALIGN == 32
    assert actual.shape == (b, n, d)
    assert_close(actual, expected, atol=ATOL)


# (route, d, S, L, n): the JAX whole-stack kernel (K1) and per-lane kernel
# (K1b) at d 16 (padded to 32) and 128, dilations up to 128, n off every
# 64-row tile
WAVENET_CASES = {"stack_d16": ("stack", 16, 2, 8, 150), "stack_d128": ("stack", 128, 2, 8, 150),
                 "lanes_d16": ("lanes", 16, 2, 8, 150), "lanes_d128": ("lanes", 128, 2, 8, 150)}


@pytest.mark.parametrize("case", list(WAVENET_CASES))
def test_k1_k1b_packed_body_matches_pallas(case):
    """The body from the packed, interleaved [3d, 2d] block weights and the
    dilated tap views, as K1 and K1b read them, against the Pallas
    kernels."""
    route, d, S, L, n = WAVENET_CASES[case]
    args = _wavenet_inputs(np.random.default_rng(d + L), 1, n, d, S, L)
    jax_fn = jwk._fused_forward if route == "stack" else jwk._fused_forward_per_lane
    expected = np.asarray(jax_fn(*(jnp.asarray(a) for a in args)))
    actual, weights = _packed_body(args, route)
    assert weights.blocks.shape[:4] == (S, L, weights.d // 32, 3 * weights.d // 32)
    scale = np.abs(expected).max()
    assert_close(actual / scale, expected / scale, atol=ATOL)


def test_k1_block_weight_interleaves_conv_and_residual():
    """Tile j of a block's B holds conv columns 32j .. 32j + 31, then the
    residual's same columns, whose rows are zero on taps 0 and 1."""
    d = 64
    conv_w, res_w = torch.randn(1, 1, 3 * d, d), torch.randn(1, 1, d, d)
    b = wk.block_weights(conv_w, res_w)[0, 0]
    for j in range(d // 32):
        assert torch.equal(b[:, 64 * j:64 * j + 32], conv_w[0, 0, :, 32 * j:32 * j + 32])
        assert not b[:2 * d, 64 * j + 32:64 * j + 64].any()
        assert torch.equal(b[2 * d:, 64 * j + 32:64 * j + 64], res_w[0, 0, :, 32 * j:32 * j + 32])


@pytest.mark.parametrize("dm, heads, dim_head", [(DIM, HEADS, DIM_HEAD), (24, 3, 8)],
                         ids=["dim16_dh8", "dim24_dh8"])
def test_k2_packed_block_matches_pallas(dm, heads, dim_head):
    rng = np.random.default_rng(2)
    hd = heads * dim_head
    x, g, be = _block_inputs(rng, 2, 40, dm)
    wq, wkv = normal(rng, dm, hd, scale=dm**-0.5), normal(rng, dm, 2 * hd, scale=dm**-0.5)
    wo = normal(rng, hd, dm, scale=hd**-0.5)
    scale = dim_head**-0.5
    expected = jak.fused_attn_block(*(jnp.asarray(a) for a in (x, g, be, wq, wkv, wo)),
                                    heads=heads, dim_head=dim_head, scale=scale)
    packed = ak.pack_attn_weights(t(wq), t(wkv), t(wo), heads, dim_head)
    actual = ak.attn_block_packed_torch(t(x), t(g), t(be), packed, heads=heads, scale=scale)
    assert_close(actual, expected, atol=ATOL)


def _k2b_case(rng, b, n, m, dm, dc, heads, dim_head):
    """K2b's packed twin against the Pallas kernel at one width."""
    hd = heads * dim_head
    x, g, be = _block_inputs(rng, b, n, dm)
    ctx = normal(rng, b, m, dc)
    wq, wkv = normal(rng, dm, hd, scale=dm**-0.5), normal(rng, dc, 2 * hd, scale=dc**-0.5)
    wo = normal(rng, hd, dm, scale=hd**-0.5)
    scale = dim_head**-0.5
    args = (x, ctx, g, be, wq, wkv, wo)
    expected = jak.fused_cross_attn_block(*(jnp.asarray(a) for a in args), heads=heads,
                                          dim_head=dim_head, scale=scale)
    packed = ak.pack_cross_weights(t(wq), t(wkv), t(wo), heads, dim_head)
    dh = fa.kernel_head_dim(dim_head)
    assert [gemm_cache.unpack_b(p)[0].shape for p in packed] == [
        (heads * dh, gemm_cache.round_up(dm, 32)), (2 * heads * dh, gemm_cache.round_up(dc, 32)),
        (gemm_cache.round_up(dm, 64), heads * dh)]
    actual = ak.cross_attn_block_packed_torch(t(x), t(ctx), t(g), t(be), packed, heads=heads,
                                              scale=scale)
    assert_close(actual, expected, atol=ATOL)


def test_k2b_padded_block_matches_pallas():
    _k2b_case(np.random.default_rng(3), 2, 24, 8, DIM, CONTEXT, HEADS, DIM_HEAD)


# (dm, dc, heads, dim_head): the conditional denoiser's widths, and dim 24
# with a 24-wide context
@pytest.mark.parametrize("dm, dc, heads, dim_head", [(128, 128, 8, 64), (24, CONTEXT, 3, 8)],
                         ids=["flagship", "dim24_dh8"])
def test_k2b_packed_block_matches_pallas(dm, dc, heads, dim_head):
    _k2b_case(np.random.default_rng(11), 2, 16, 8, dm, dc, heads, dim_head)


@pytest.mark.parametrize("dm", [DIM, 24], ids=["dim16", "dim24"])
def test_k3_packed_block_matches_pallas(dm):
    rng = np.random.default_rng(4)
    inner = int(dm * 4 * 2 / 3)
    x, g, be = _block_inputs(rng, 2, 40, dm)
    w1, b1 = normal(rng, dm, 2 * inner, scale=dm**-0.5), normal(rng, 2 * inner, scale=0.1)
    wc = normal(rng, 3, inner, inner, scale=(3 * inner) ** -0.5)
    bc, w2 = normal(rng, inner, scale=0.1), normal(rng, inner, dm, scale=inner**-0.5)
    b2 = normal(rng, dm, scale=0.1)
    args = (x, g, be, w1, b1, wc, bc, w2, b2)
    expected = jff.fused_ff_block(*(jnp.asarray(a) for a in args), approximate=True)
    weights = fk.pack_ff_weights(t(w1), t(b1), t(wc), t(bc), t(w2))
    assert weights.ip == 64 and weights.ip % gemm_cache.CHUNK == 0
    actual = fk.ff_block_packed_torch(t(x), t(g), t(be), weights, t(b2))
    assert_close(actual, expected, atol=ATOL)


# (b, h, n_q, n_kv, causal, masked, dropout) at dim_head 8
FLASH_CASES = {"plain": (2, 2, 40, 40, False, False, 0.0),
               "masked_causal": (3, 2, 37, 37, True, True, 0.0),
               "masked_dropout": (2, 2, 37, 50, False, True, 0.2)}
SEED = (0x12345678, 0x9ABCDEF0)


def _flash_inputs(b, h, n_q, n_kv, masked, seed, d=DIM_HEAD):
    rng = np.random.default_rng(seed)
    q, k, v = (normal(rng, b, h, n, d) for n in (n_q, n_kv, n_kv))
    do = normal(rng, b, h, n_q, d)
    mask = None
    if masked:
        mask = rng.random((b, n_kv)) > 0.2
        mask[1, :3] = False
    return q, k, v, do, mask


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_k4_k5_padded_head_dim_matches_pallas(case):
    b, h, n_q, n_kv, causal, masked, dropout = FLASH_CASES[case]
    q, k, v, do, mask = _flash_inputs(b, h, n_q, n_kv, masked, seed=5)
    jmask = None if mask is None else jnp.asarray(mask)
    jseed = jnp.asarray([SEED], dtype=jnp.uint32) if dropout > 0 else None
    cfg = dict(causal=causal, scale=SCALE, dropout_rate=dropout)
    o_j, lse_j = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, jseed,
                                    **cfg)
    grads_j = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, jseed,
                                  lse_j, o_j, jnp.asarray(do), **cfg)

    tmask = None if mask is None else torch.from_numpy(mask)
    qp, kp, vp, dop = fa.pad_head_dim(t(q), t(k), t(v), t(do))
    assert qp.shape[-1] == fa.kernel_head_dim(DIM_HEAD) == 64
    o_p, lse = fa.flash_forward_torch(qp, kp, vp, tmask, SEED, **cfg)
    assert not o_p[..., DIM_HEAD:].any()  # zero v columns give zero output columns
    assert_close(o_p[..., :DIM_HEAD], o_j, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :n_q, 0], atol=ATOL)
    grads = fa.flash_backward_torch(qp, kp, vp, tmask, SEED, lse, o_p, dop, **cfg)
    for got, want in zip(grads, grads_j):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert_close(got[..., :DIM_HEAD] / scale, want / scale, atol=ATOL)


def _k6_case(seed, d, tie_tol):
    """K6's packed twin against the Pallas kernel at codebook dim d."""
    rng = np.random.default_rng(seed)
    x, cb = normal(rng, 200, d), normal(rng, 3, 40, d)
    q_j, codes_j = jrvq.rvq_quantize(jnp.asarray(x), jnp.asarray(cb))
    packed, norms = rq.pack_codebooks(t(cb))
    assert packed.shape == (3, 1, gemm_cache.round_up(d, 32) // 32, 2, 2048)
    q_p, codes = rq.rvq_packed_torch(t(x), packed, norms, 40)
    same = assert_codes_match(x, cb, codes.numpy(), np.asarray(codes_j), tie_tol)
    assert same.mean() > 0.95
    np.testing.assert_allclose(q_p.numpy()[same], np.asarray(q_j)[same], atol=ATOL)


def test_k6_padded_codebook_dim_matches_pallas():
    _k6_case(6, CODEBOOK_DIM, 1e-4)


@pytest.mark.parametrize("dim_head", [96, 128, 192])
def test_k2_wide_heads_match_pallas(dim_head):
    rng = np.random.default_rng(7)
    dm, heads = 32, 2
    hd = heads * dim_head
    x, g, be = _block_inputs(rng, 2, 24, dm)
    wq, wkv = normal(rng, dm, hd, scale=dm**-0.5), normal(rng, dm, 2 * hd, scale=dm**-0.5)
    wo = normal(rng, hd, dm, scale=hd**-0.5)
    scale = dim_head**-0.5
    expected = jak.fused_attn_block(*(jnp.asarray(a) for a in (x, g, be, wq, wkv, wo)),
                                    heads=heads, dim_head=dim_head, scale=scale)
    packed = ak.pack_attn_weights(t(wq), t(wkv), t(wo), heads, dim_head)
    assert gemm_cache.unpack_b(packed[1])[0].shape[1] == heads * fa.kernel_head_dim(dim_head)
    actual = ak.attn_block_packed_torch(t(x), t(g), t(be), packed, heads=heads, scale=scale)
    assert_close(actual, expected, atol=ATOL)


# (dm, dim_head): heads of 96, 128 and 192, and K2b past dim 512
@pytest.mark.parametrize("dm, dim_head", [(DIM, 96), (DIM, 128), (640, DIM_HEAD), (DIM, 192)],
                         ids=["dh96", "dh128", "dim640", "dh192"])
def test_k2b_wide_widths_match_pallas(dm, dim_head):
    _k2b_case(np.random.default_rng(8), 2, 16, 8, dm, CONTEXT, 2, dim_head)


@pytest.mark.parametrize("dim_head", [96, 128])
@pytest.mark.parametrize("case", ["plain", "masked_causal"])
def test_k4_k5_wide_heads_match_pallas(case, dim_head):
    b, h, n_q, n_kv, causal, masked, dropout = FLASH_CASES[case]
    q, k, v, do, mask = _flash_inputs(b, h, n_q, n_kv, masked, seed=9, d=dim_head)
    jmask = None if mask is None else jnp.asarray(mask)
    cfg = dict(causal=causal, scale=dim_head**-0.5, dropout_rate=dropout)
    o_j, lse_j = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, None,
                                    **cfg)
    grads_j = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, None,
                                  lse_j, o_j, jnp.asarray(do), **cfg)
    tmask = None if mask is None else torch.from_numpy(mask)
    qp, kp, vp, dop = fa.pad_head_dim(t(q), t(k), t(v), t(do))
    assert qp.shape[-1] == 128
    o_p, lse = fa.flash_forward_torch(qp, kp, vp, tmask, None, **cfg)
    assert not o_p[..., dim_head:].any()
    assert_close(o_p[..., :dim_head], o_j, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :n_q, 0], atol=ATOL)
    grads = fa.flash_backward_torch(qp, kp, vp, tmask, None, lse, o_p, dop, **cfg)
    for got, want in zip(grads, grads_j):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert_close(got[..., :dim_head] / scale, want / scale, atol=ATOL)


# (d, causal, masked, dropout): heads past 128, in the kernels' chunked order
CHUNKED_CASES = {"plain": (2, 2, 40, 40, False, False, 0.0),
                 "masked_causal": (3, 2, 37, 37, True, True, 0.0),
                 "masked_dropout": (2, 2, 37, 50, False, True, 0.2)}


@pytest.mark.parametrize("dim_head", [192, 320])
@pytest.mark.parametrize("case", list(CHUNKED_CASES))
def test_k4_k5_chunked_head_dim_matches_pallas(case, dim_head):
    """Heads of 192 and 320 padded to 256 and 384, as the wrappers pad them
    for the chunked kernels, with the logits and dP summed over 128-wide
    chunks of the head dim; dropout through the same Threefry keep mask."""
    b, h, n_q, n_kv, causal, masked, dropout = CHUNKED_CASES[case]
    q, k, v, do, mask = _flash_inputs(b, h, n_q, n_kv, masked, seed=12, d=dim_head)
    jmask = None if mask is None else jnp.asarray(mask)
    jseed = jnp.asarray([SEED], dtype=jnp.uint32) if dropout > 0 else None
    cfg = dict(causal=causal, scale=dim_head**-0.5, dropout_rate=dropout)
    o_j, lse_j = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, jseed,
                                    **cfg)
    grads_j = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, jseed,
                                  lse_j, o_j, jnp.asarray(do), **cfg)
    tmask = None if mask is None else torch.from_numpy(mask)
    seed = SEED if dropout > 0 else None
    qp, kp, vp, dop = fa.pad_head_dim(t(q), t(k), t(v), t(do))
    assert qp.shape[-1] == gemm_cache.round_up(dim_head, fa.KERNEL_HEAD_CHUNK)
    chunk = dict(cfg, head_chunk=fa.KERNEL_HEAD_CHUNK)
    o_p, lse = fa.flash_forward_torch(qp, kp, vp, tmask, seed, **chunk)
    assert not o_p[..., dim_head:].any()
    assert_close(o_p[..., :dim_head], o_j, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :n_q, 0], atol=ATOL)
    grads = fa.flash_backward_torch(qp, kp, vp, tmask, seed, lse, o_p, dop, **chunk)
    for got, want in zip(grads, grads_j):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert_close(got[..., :dim_head] / scale, want / scale, atol=ATOL)


def test_k6_wide_codebook_dim_matches_pallas():
    _k6_case(10, 192, 1e-3)


def test_wider_than_the_kernels_is_a_named_error():
    """Heads of any width reach the kernels, padded to 64 or a multiple of
    128 (192 → 256, 320 → 384), as the JAX kernels pad them; off CUDA the
    wrappers still refuse before any launch, and name why."""
    cfg = dict(heads=1, dim_head=192, scale=0.1)
    with pytest.raises(ValueError, match="CUDA"):  # on a non-CUDA device: refused first
        ak.attn_block(*(torch.zeros(s, device="meta") for s in
                        ((1, 8, 16), (1, 16), (1, 16), (16, 192), (16, 384), (192, 16))), **cfg)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_forward(*(torch.zeros(1, 1, 8, 192, device="meta") for _ in range(3)),
                         scale=0.1)
    widths = (8, 64, 65, 96, 128, 129, 192, 256, 320, 384)
    assert [fa.kernel_head_dim(d) for d in widths] == [64, 64, 128, 128, 128, 256, 256, 256, 384,
                                                       384]
    assert [p.shape[-1] for p in fa.pad_head_dim(torch.zeros(2, 192), torch.zeros(3, 192))] == [
        256, 256]
    packed = ak.pack_attn_weights(*(torch.zeros(s) for s in ((16, 320), (16, 640), (320, 16))),
                                  1, 320)
    assert gemm_cache.unpack_b(packed[1])[0].shape == (64, 384)
    assert fa.KERNEL_HEAD_CHUNK == 128
    assert jax.default_backend() == "cpu"
