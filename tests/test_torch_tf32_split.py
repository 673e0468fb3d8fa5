"""Split TF32, the arithmetic of the flash-attention kernels K4 and K5
(`naturalspeech2_tpu_torch/csrc/flash.cuh`) and of the GEMM core of K1,
K1b, K2, K2b, K3 and K6 (`csrc/gemm_tf32x3.cuh`), emulated on the CPU.

An f32 operand x becomes hi = tf32(x) (rounded half away from zero at
mantissa bit 13, as `cvt.rna.tf32.f32` does; the kernels do it with two
integer operations on the bit pattern) and lo = x - hi, whose low 13 bits
the tensor core drops. A product a·b is a_hi·b_hi + (a_hi·b_lo + a_lo·b_hi).
Here each TF32 product is exact in f32 (11 x 11 significant bits) and the
sums are f32 matrix products on the CPU. Unit-normal q, k, v at
[1, 2, 150 | 1024, 64]: attention with three passes per product stays
within `chip_smoke.FLASH_TOL` of f64 for o, lse and the gradients, and
with one TF32 pass (hi·hi alone) it does not. This grounds the tolerance
that `chip_smoke.py` holds the kernels to on the card.

The GEMM core's emulation adds what the tensor cores do where they add
(the model of the card that reproduced the flash kernels' errors): each `wgmma`
k-step's eight products are exact, the accumulator and the products are
aligned to the largest of them and truncated to 24 bits, and the sum is
truncated to f32. The core sums each chunk of 32 k in fresh accumulators,
the large terms apart from the two small ones, and adds the chunk to the
f32 result. At the K of K3's causal conv (3 x 352 at dim 128, 3 x 1376 at
dim 512) three passes stay within `chip_smoke.BLOCK_TOL` (relative to the
largest entry of the product, as chip_smoke holds K2 and K3 relative to
the largest entry of y - x) with room, and one pass fails it. The WaveNet
body's 32-block chain (4 stacks x 8 layers, d 128), each block one product
with its packed, interleaved [3d, 2d] weight and the skips one product with
K = 8·d, as K1 runs it, stays within `chip_smoke.WAVENET_TOL` of f64
(relative to the largest entry of the output) with room, and one pass
fails it. K2b's four launches (q and k/v projections and W_o on the core,
K4's logits and P·V) at the conditional widths (dm 128, 8 heads of 64, a
32-latent context) stay within `chip_smoke.BLOCK_TOL` of f64 relative to
the largest entry of y - x, and one pass fails it; K6's stages, each
stage's distances on the core in three passes, keep `rvq_torch`'s codes at
the training shape's codebooks but for near-ties within
`chip_smoke.RVQ_TIE_TOL`."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from naturalspeech2_tpu_torch.ops import wavenet_kernel as wk

SCALE = 64**-0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The emulations below are thousands of small tensor ops. Alone they
    take about as long on one thread as on eight, but in a full test run,
    where every worker's threads share the cores, each op's threads wait on
    one another: the WaveNet chain took 715 s there on the default threads
    (20 s alone), the run's longest test by far. They run on one thread,
    restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


FLASH_TOL = _chip_smoke().FLASH_TOL
BLOCK_TOL = _chip_smoke().BLOCK_TOL
WAVENET_TOL = _chip_smoke().WAVENET_TOL
RVQ_TIE_TOL = _chip_smoke().RVQ_TIE_TOL


def tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, half away from zero, on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits dropped, as the tensor core reads it."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b in f32 from TF32 operands: three passes or one."""
    a_hi, b_hi = tf32_hi(a), tf32_hi(b)
    big = a_hi @ b_hi
    if passes == 1:
        return big
    a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
    return big + (a_hi @ b_lo + a_lo @ b_hi)


def attention(q, k, v, do, passes: int):
    """(o, lse, dq, dk, dv) with every product in TF32 (``passes`` 1 or 3)
    or, with ``passes`` 0, in the inputs' own precision."""
    mm = (lambda a, b: a @ b) if passes == 0 else (lambda a, b: matmul(a, b, passes))
    s = mm(q, k.T) * SCALE
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    lse = (m + torch.log(l))[:, 0]
    o = mm(p, v) / l
    p = p / l
    dp = mm(do, v.T)
    ds = p * (dp - (do * o).sum(-1, keepdim=True)) * SCALE
    return o, lse, mm(ds, k), mm(ds.T, q), mm(p.T, do)


def _inputs(n: int, head: int):
    g = torch.Generator().manual_seed(1000 * n + head)
    return [torch.randn(n, 64, generator=g) for _ in range(4)]


def _errors(n: int, passes: int) -> dict:
    """Worst error over 2 heads: absolute for o and lse, relative to each
    gradient's largest entry for dq, dk, dv."""
    worst = dict.fromkeys(("o", "lse", "dq", "dk", "dv"), 0.0)
    for head in range(2):
        x = _inputs(n, head)
        exact = attention(*(t.double() for t in x), passes=0)
        got = attention(*x, passes=passes)
        for i, name in enumerate(worst):
            err = (got[i].double() - exact[i]).abs().max().item()
            if name.startswith("d"):
                err /= exact[i].abs().max().item()
            worst[name] = max(worst[name], err)
    return worst


def test_tf32_rounding():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0**-10  # TF32 keeps 10 mantissa bits
    cases = {1.0 + ulp / 2: 1.0 + ulp, 1.0 + ulp / 2 - 2**-23: 1.0, -(1.0 + ulp / 2): -(1.0 + ulp),
             1.0 + 3 * ulp / 4: 1.0 + ulp, 3.0: 3.0}
    for x, want in cases.items():
        assert tf32_hi(one * x).item() == want, x
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32_hi(x)
    assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((x - hi).abs() <= hi.abs() * 2.0**-11)
    # x - hi is exact in f32: hi + (x - hi) gives x back
    assert torch.equal(hi + (x - hi), x)


@pytest.mark.parametrize("n", [150, 1024])
def test_three_passes_stay_within_flash_tol(n):
    errors = _errors(n, passes=3)
    assert max(errors.values()) < FLASH_TOL, errors


@pytest.mark.parametrize("n", [150, 1024])
def test_one_pass_does_not(n):
    errors = _errors(n, passes=1)
    assert errors["o"] > FLASH_TOL and errors["lse"] > FLASH_TOL, errors
    assert min(errors[g] for g in ("dq", "dk", "dv")) > FLASH_TOL, errors


def test_flash_tol_sits_between_the_two():
    """Three passes err at least 5x below the tolerance, one pass at least
    5x above it (o at n 150, the training shape)."""
    three, one = _errors(150, passes=3), _errors(150, passes=1)
    assert max(three.values()) * 5 < FLASH_TOL < one["o"] / 5, (three, one)
    assert np.isfinite(list(three.values())).all()


# ---- the GEMM core of K2 and K3, with the tensor cores' truncating adds ----

def _truncate(x: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """x (f64) truncated toward zero to a multiple of 2^exp."""
    step = torch.ldexp(torch.ones_like(x), exp)
    return torch.trunc(x / step) * step


def _exponent(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.log2(x.abs().clamp(min=1e-300)))


def _mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a·b over one k-step of 8 (a [M, 8], b [8, N], TF32 values in
    f64), added as the tensor cores add: the 8 exact products and acc
    aligned to the largest and truncated to 24 bits, the sum truncated to
    f32."""
    terms = torch.cat([acc[:, None, :], a[:, :, None] * b[None, :, :]], dim=1)
    top = _exponent(terms.abs().amax(dim=1))[:, None, :]
    total = _truncate(terms, top - 23).sum(dim=1)  # exact in f64
    return torch.where(total == 0, total, _truncate(total, _exponent(total) - 23))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float().double()


def gemm_core(a: torch.Tensor, b: torch.Tensor, passes: int, chunk: int = 32) -> torch.Tensor:
    """a @ b as csrc/gemm_tf32x3.cuh computes it: per chunk of 32 k, fresh
    accumulators, big = Σ hi·hi and (with three passes) small = Σ hi·lo +
    lo·hi, then result += big + small in f32."""
    a_hi, b_hi = tf32_hi(a).double(), tf32_hi(b).double()
    a_lo = tf32_truncate(a - tf32_hi(a)).double()
    b_lo = tf32_truncate(b - tf32_hi(b)).double()
    result = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for c0 in range(0, a.shape[1], chunk):
        big, small = torch.zeros_like(result), torch.zeros_like(result)
        for k in range(c0, c0 + chunk, 8):
            ks = slice(k, k + 8)
            if passes == 3:
                small = _mma(small, a_hi[:, ks], b_lo[ks])
                small = _mma(small, a_lo[:, ks], b_hi[ks])
            big = _mma(big, a_hi[:, ks], b_hi[ks])
        result = _f32(result + _f32(big + small))
    return result


def _core_error(inner: int, passes: int) -> float:
    """Error of the emulated core against f64 at K3's conv, K = 3·inner:
    activations of the conv's scale against weights of its init scale,
    relative to the product's largest entry."""
    g = torch.Generator().manual_seed(inner)
    k = 3 * inner
    a = torch.randn(16, k, generator=g) * 0.3
    b = torch.randn(k, 64, generator=g) / k**0.5
    exact = a.double() @ b.double()
    return ((gemm_core(a, b, passes) - exact).abs().max() / exact.abs().max()).item()


@pytest.mark.parametrize("inner", [352, 1376], ids=["dim128", "dim512"])
def test_gemm_core_three_passes_meet_block_tol_one_pass_fails(inner):
    three, one = _core_error(inner, 3), _core_error(inner, 1)
    assert three * 5 < BLOCK_TOL < one / 5, (three, one)


# ---- the WaveNet body on the GEMM core (K1, K1b) ----------------------------

def _wavenet_chain(mm, dtype, n: int = 80, d: int = 128, S: int = 4, L: int = 8):
    """The body at b1 x n, through ``mm`` for every product: each block's
    [x_{t-2δ} | x_{t-δ} | x_t] times its interleaved B [3d, 2d]
    (``wavenet_kernel.block_weights``), then the FiLM gate on the conv half
    plus the residual half; the skips one product over the lanes side by
    side. Activations kept in ``dtype`` between products, as the kernels
    keep them in f32."""
    g = torch.Generator().manual_seed(d)
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale  # noqa: E731
    x = rn(n, d)
    conv_w, conv_b = rn(S, L, 3 * d, d, scale=(3 * d) ** -0.5), rn(S, L, d, scale=0.1)
    res_w, res_b = rn(S, L, d, d, scale=d**-0.5), rn(S, L, d, scale=0.1)
    skip_w, skip_b = rn(L, d, d, scale=d**-0.5), rn(L, d, scale=0.1)
    film = 1 + rn(S, L, 2 * d, scale=0.1)
    blocks = wk.block_weights(conv_w, res_w).to(dtype)

    def shift(a, rows):
        return torch.cat([torch.zeros(min(rows, n), d, dtype=dtype), a[:max(n - rows, 0)]])

    lanes = [x.to(dtype)] * L
    for s in range(S):
        new = []
        for l, a in enumerate(lanes):
            dil = 2**l
            y = mm(torch.cat([shift(a, 2 * dil), shift(a, dil), a], dim=-1), blocks[s, l])
            y = y.reshape(n, d // 32, 2, 32)
            conv, res = y[:, :, 0].reshape(n, d), y[:, :, 1].reshape(n, d)
            f = film[s, l].to(dtype)
            conv = (conv + conv_b[s, l].to(dtype)) * f[:d] + f[d:]
            new.append((torch.tanh(conv) * torch.sigmoid(conv) + res + res_b[s, l]).to(dtype))
        lanes = new
    return mm(torch.cat(lanes, dim=-1), skip_w.reshape(L * d, d).to(dtype)) + skip_b.sum(0)


def _wavenet_error(passes: int) -> float:
    exact = _wavenet_chain(lambda a, b: a @ b, torch.float64)
    core = _wavenet_chain(lambda a, b: gemm_core(a, b, passes).float(), torch.float32)
    return ((core.double() - exact).abs().max() / exact.abs().max()).item()


def test_wavenet_core_three_passes_meet_wavenet_tol_one_pass_fails():
    three, one = _wavenet_error(3), _wavenet_error(1)
    assert three * 5 < WAVENET_TOL < one / 5, (three, one)


# ---- K2b's four launches and K6's distances on the same core ----------------

def _cross_block(proj, core_s, core_pv, dtype, n: int = 64, m: int = 32, dm: int = 128,
                 heads: int = 8, dh: int = 64):
    """(y, x) of the cross-attention block at b1 as K2b runs it: q = n(x)·W_q
    and k, v = ctx·W_{k,v} through ``proj``, each head's logits through
    ``core_s`` and P·V (one 32-key tile, unnormalised, then / l) through
    ``core_pv``, y = x + o·W_o through ``proj``; the norm and the softmax in
    ``dtype``. Inputs at the conditional shape's widths, seeded."""
    g = torch.Generator().manual_seed(dm + m)
    rn = lambda *shape, scale=1.0: torch.randn(*shape, generator=g) * scale  # noqa: E731
    hd = heads * dh
    x, ctx = rn(n, dm), rn(m, dm)
    gamma, beta = 1 + rn(dm, scale=0.1), rn(dm, scale=0.1)
    wq, wkv = rn(dm, hd, scale=dm**-0.5), rn(dm, 2 * hd, scale=dm**-0.5)
    wo = rn(hd, dm, scale=hd**-0.5)
    xd = x.to(dtype)
    xn = xd / xd.norm(dim=-1, keepdim=True).clamp(min=1e-12) * dm**0.5 * gamma.to(dtype)
    xn = (xn + beta.to(dtype)).to(dtype)
    q = proj(xn, wq.to(dtype)).to(dtype)
    kv = proj(ctx.to(dtype), wkv.to(dtype)).to(dtype)
    outs = []
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        s = core_s(q[:, cols], kv[:, cols].T.contiguous()).to(dtype) * dh**-0.5
        p = torch.exp(s - s.amax(-1, keepdim=True))
        outs.append((core_pv(p, kv[:, hd:][:, cols]).to(dtype) / p.sum(-1, keepdim=True)))
    return xd + proj(torch.cat(outs, dim=-1), wo.to(dtype)).to(dtype), xd


def _cross_error(passes: int) -> float:
    """The emulated K2b against f64, relative to the largest entry of y - x:
    the projections on the GEMM core (fresh accumulators per chunk of 32),
    K4's logits in one accumulator over the head dim and P·V over the one
    32-key tile, all with the tensor cores' truncating adds."""
    exact, x = _cross_block(lambda a, b: a @ b, lambda a, b: a @ b, lambda a, b: a @ b,
                            torch.float64)
    core, _ = _cross_block(lambda a, b: gemm_core(a, b, passes).float(),
                           lambda a, b: gemm_core(a, b, passes, chunk=64).float(),
                           lambda a, b: gemm_core(a, b, passes, chunk=32).float(), torch.float32)
    return ((core.double() - exact).abs().max() / (exact - x).abs().max()).item()


def test_cross_block_three_passes_meet_block_tol_one_pass_fails():
    three, one = _cross_error(3), _cross_error(1)
    assert three * 5 < BLOCK_TOL < one / 5, (three, one)


def _rvq_stages(passes: int, rows: int = 160):
    """K6's stages at the training shape's codebooks (Q 8, K 1024, d 128)
    on ``rows`` rows, each stage's −2·r·Cᵀ on the emulated core (``passes``
    1 or 3, truncating adds) and the first minimum: (x, codebooks, codes,
    the largest error in d² against f64 on the same residuals)."""
    g = torch.Generator().manual_seed(8)
    x, cb = torch.randn(rows, 128, generator=g), torch.randn(8, 1024, 128, generator=g)
    norms = (cb * cb).sum(-1)
    r, codes, worst = x.clone(), [], 0.0
    for qi in range(cb.shape[0]):
        d2 = -2.0 * gemm_core(r, cb[qi].T, passes).float() + norms[qi]
        exact = -2.0 * (r.double() @ cb[qi].double().T) + norms[qi].double()
        worst = max(worst, (d2.double() - exact).abs().max().item())
        idx = torch.argmin(d2, dim=-1)
        r = r - cb[qi][idx]
        codes.append(idx)
    return x, cb, torch.stack(codes, dim=-1), worst


def test_rvq_distances_in_three_passes_keep_the_plain_codes():
    """Three passes err in d² far below chip_smoke's RVQ_TIE_TOL (a gap of
    1e-3, where d² is ~256), so K6's codes equal ``rvq_torch``'s (f32) but
    at near-ties; one pass errs above it."""
    from naturalspeech2_tpu_torch.ops.rvq import rvq_torch

    from torch_parity import assert_codes_match

    x, cb, codes, three = _rvq_stages(3)
    _, plain = rvq_torch(x, cb)
    same = assert_codes_match(x.numpy(), cb.numpy(), codes.numpy(), plain.numpy(), RVQ_TIE_TOL)
    assert same.mean() > 0.95, same.mean()
    one = _rvq_stages(1)[3]
    assert three * 5 < RVQ_TIE_TOL < one, (three, one)
