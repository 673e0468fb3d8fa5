"""Split TF32, the arithmetic of the flash-attention kernels K4 and K5
(`naturalspeech2_tpu_torch/csrc/flash.cuh`), emulated on the CPU.

An f32 operand x becomes hi = tf32(x) (rounded half away from zero at
mantissa bit 13, as `cvt.rna.tf32.f32` does; the kernels do it with two
integer operations on the bit pattern) and lo = x - hi, whose low 13 bits
the tensor core drops. A product a·b is a_hi·b_hi + (a_hi·b_lo + a_lo·b_hi).
Here each TF32 product is exact in f32 (11 x 11 significant bits) and the
sums are f32 matrix products on the CPU. Unit-normal q, k, v at
[1, 2, 150 | 1024, 64]: attention with three passes per product stays
within `chip_smoke.FLASH_TOL` of f64 for o, lse and the gradients, and
with one TF32 pass (hi·hi alone) it does not. This grounds the tolerance
that `chip_smoke.py` holds the kernels to on the card."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

SCALE = 64**-0.5


def _flash_tol() -> float:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FLASH_TOL


FLASH_TOL = _flash_tol()


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
