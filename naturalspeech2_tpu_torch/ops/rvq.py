"""K6: residual vector quantization (twin of `naturalspeech2_tpu/ops/rvq.py`).

For each of the Q stages, in order: the nearest codebook entry to the
running residual (d² = −2·r·Cᵀ + ‖C‖², the first minimal index), then
r −= C[idx]. Returns the quantized sum ``[m, d]`` and the codes ``[m, Q]``
(int32).

``rvq`` launches the kernels of ``csrc/rvq.cu`` on CUDA tensors (per stage
the distances on a GEMM core with a first-minimum epilogue, then the
residual update; any codebook dim and size) and runs the plain version
``rvq_torch`` on CPU tensors. bf16 ``x`` and codebooks (AMP training's
codec) run the f32 function on their values, as the JAX kernel upcasts x
and promotes the codebooks in its dots, and return ``quantized`` in bf16
(``rvq_bf16_torch``; on a card ``ns2_rvq_bf16`` on the bf16 GEMM core: x
one bf16 pass, from the second stage on the f32 residual as three bf16
planes that sum to it exactly, three passes, the residual and the sum in
f32; ``rvq_planes_torch`` is that scheme in plain PyTorch). The kernels
read the codebooks packed for their core with their squared norms
(``pack_codebooks``, once per parameter version); ``rvq_packed_torch``
computes the function from that layout in plain PyTorch. ``rvq_quantize``
adds the straight-through gradient; ``rvq_reference`` is the twin of
``rvq_xla`` (which keeps ‖r‖², so a near-tie may pick another code than
the kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.ops import gemm_cache
from naturalspeech2_tpu_torch.ops.gemm_cache import split3


def rvq_torch(x, codebooks, norms=None):
    """Plain version of the kernel's function (`_rvq_kernel`): ‖r‖² dropped,
    first minimal index, the quantized sum accumulated stage by stage in
    f32 and returned at x's dtype. ``norms`` [Q, K]: the codebooks' squared
    norms, if already at hand."""
    r = x.to(torch.float32)
    codebooks = codebooks.to(torch.float32)
    total = torch.zeros_like(r)
    if norms is None:
        norms = (codebooks * codebooks).sum(dim=-1)  # [Q, K]
    codes = []
    for qi in range(codebooks.shape[0]):
        d2 = -2.0 * (r @ codebooks[qi].T) + norms[qi]
        idx = torch.argmin(d2, dim=-1)  # the first minimal index
        q = codebooks[qi][idx]
        r = r - q
        total = total + q
        codes.append(idx)
    return total.to(x.dtype), torch.stack(codes, dim=-1).to(torch.int32)


def rvq_bf16_torch(x, codebooks):
    """Plain version of K6 on bf16 x and codebooks: ``rvq_torch`` on their
    values (exact in f32), ``quantized`` rounded to bf16 once."""
    return rvq_torch(x.to(torch.bfloat16), codebooks.to(torch.bfloat16))


def rvq_reference(x, codebooks):
    """The twin of ``rvq_xla``: full squared distances, quantized = x − r."""
    residual = x
    codes = []
    for qi in range(codebooks.shape[0]):
        cb = codebooks[qi]
        d2 = (residual**2).sum(-1, keepdim=True) - 2.0 * residual @ cb.T + (cb**2).sum(-1)[None, :]
        idx = torch.argmin(d2, dim=-1)
        residual = residual - cb[idx]
        codes.append(idx)
    return x - residual, torch.stack(codes, dim=-1).to(torch.int32)


def pack_codebooks(codebooks):
    """(packed, norms): each stage's codebook C_q [K, d] as its GEMM core's
    packed Bᵀ (``gemm_cache.pack_b``; f32 codebooks "split", the split-TF32
    core's TF32 hi and lo in 64-row tiles of 32-wide chunks, bf16 ones
    "bf16_sw128", the bf16 core's [Q, d / 64, K, 64], exact; zero-padded)
    and the squared norms [Q, K] in f32 (a plain reduction, as XLA computes
    them outside the Pallas kernel)."""
    fmt = "bf16_sw128" if codebooks.dtype == torch.bfloat16 else "split"
    wide = codebooks.to(torch.float32)
    return gemm_cache.pack_b(codebooks, fmt), (wide * wide).sum(dim=-1).contiguous()


def rvq_packed_torch(x, packed, norms, size: int):
    """``rvq_torch`` from the kernel's layout: the codebooks unpacked from
    ``pack_codebooks``'s tiles (hi + lo, zero-padded dims), the first
    ``size`` codes of each, x padded with zero dims to match; the quantized
    sum cut back to d. The check of K6's packing on the CPU."""
    d = x.shape[-1]
    fmt = "bf16_sw128" if packed.dtype == torch.bfloat16 else None
    codebooks = sum(gemm_cache.unpack_b(packed, fmt))[:, :size]
    total, codes = rvq_torch(F.pad(x, (0, codebooks.shape[-1] - d)), codebooks, norms)
    return total[:, :d], codes


def rvq_planes_torch(x, packed, norms, size: int):
    """``ns2_rvq_bf16``'s scheme in plain PyTorch, from its layout (bf16 x,
    the codebooks packed "bf16_sw128"): each stage's distances are the bf16
    core's products summed in f32, x itself at the first stage, then the
    f32 residual's three bf16 planes (``split3``, lo first), each product
    of a part and a bf16 code exact; d² = ‖C‖² − 2·acc over the first
    ``size`` codes, the first minimum; the residual and the sum in f32, the
    sum rounded to bf16 once. The check of the bf16 kernel's design on the
    CPU (the order of its f32 sums aside)."""
    m, d = x.shape
    codebooks = gemm_cache.unpack_b(packed, "bf16_sw128")[0][:, :size].float()  # [Q, K, d_p]
    x = x.to(torch.bfloat16).float()
    planes = [F.pad(x, (0, codebooks.shape[-1] - d))]
    r, total, codes = x, torch.zeros_like(x), []
    for qi in range(codebooks.shape[0]):
        acc = sum(p.float() @ codebooks[qi].T for p in reversed(planes))
        idx = torch.argmin(norms[qi] - 2.0 * acc, dim=-1)  # the first minimal index
        q = codebooks[qi][idx, :d]
        r, total = r - q, total + q
        planes = [F.pad(p.float(), (0, codebooks.shape[-1] - d)) for p in split3(r)]
        codes.append(idx)
    return total.to(torch.bfloat16), torch.stack(codes, dim=-1).to(torch.int32)


def scratch(m: int, d: int, num_q: int, dtype: torch.dtype, device) -> list:
    """The scratch of K6's entry point for x [m, d] of ``dtype``, in its
    argument order: best [Q, m] int64, all ones (no minimum yet), the f32
    residual [m, d]; in bf16 also the f32 sum [m, d] and the residual's
    three bf16 planes [3, m, d padded to 64] (the first plane holds x's
    rows where TMA cannot read x itself)."""
    best = torch.full((num_q, m), -1, dtype=torch.int64, device=device)
    residual = torch.empty((m, d), dtype=torch.float32, device=device)
    if dtype != torch.bfloat16:
        return [best, residual]
    d_p = gemm_cache.round_up(d, gemm_cache.SW128_CHUNK)
    return [best, residual, torch.empty_like(residual),
            torch.empty((3, m, d_p), dtype=torch.bfloat16, device=device)]


def rvq(x, codebooks):
    """K6: ``(quantized [m, d], codes [m, Q] int32)``. CUDA tensors launch
    the kernels (2·Q launches, counted as one launch of K6; f32, or bf16
    through its own entry point, counted in ``rvq.launches_bf16``); CPU
    tensors run ``rvq_torch``."""
    if x.device.type == "cpu":
        return rvq_torch(x, codebooks)
    _build.require_cuda("rvq", x.dtype, x=x, codebooks=codebooks)
    m, d = x.shape
    num_q, size = codebooks.shape[:2]
    _build.require_shapes("rvq", codebooks=(codebooks, (num_q, size, d)))
    if m < 1:
        raise ValueError("rvq: no rows")
    packed, norms = gemm_cache.cached("rvq", pack_codebooks, codebooks)
    quantized = torch.empty_like(x)
    codes = torch.empty((m, num_q), dtype=torch.int32, device=x.device)
    state = scratch(m, d, num_q, x.dtype, x.device)
    err = _build.entry("ns2_rvq", x.dtype)(
        x.data_ptr(), codebooks.data_ptr(), packed.data_ptr(), norms.data_ptr(),
        *(t.data_ptr() for t in state), quantized.data_ptr(), codes.data_ptr(), m, d, num_q, size,
        _build.stream(x),
    )
    _build.check(err, "ns2_rvq")
    _build.count(rvq, x.dtype)
    return quantized, codes


rvq.launches = rvq.launches_bf16 = 0


class _RVQ(torch.autograd.Function):
    """Straight-through: the gradient of ``quantized`` goes to ``x`` as is;
    the codebooks get none (they are not learned by backprop)."""

    @staticmethod
    def forward(ctx, x, codebooks):
        quantized, codes = rvq(x, codebooks)
        ctx.mark_non_differentiable(codes)
        return quantized, codes

    @staticmethod
    def backward(ctx, g_quantized, g_codes):
        return g_quantized, None


def rvq_quantize(x: torch.Tensor, codebooks: torch.Tensor):
    """``[m, d]`` × ``[Q, K, d]`` → (quantized ``[m, d]``, codes ``[m, Q]``),
    with the straight-through gradient to ``x``."""
    return _RVQ.apply(x, codebooks)


def rvq_cross_entropy(x, codebooks, codes):
    """Cross-entropy of −distance logits against the given codes, averaged
    over stages, the residual advanced along the given codes (the twin of
    `rvq_cross_entropy`). x ``[m, d]``, codes ``[m, Q]``."""
    dtype = torch.promote_types(x.dtype, codebooks.dtype)
    residual, codebooks = x.to(dtype), codebooks.to(dtype)
    total = 0.0
    codes = codes.long()
    for qi in range(codebooks.shape[0]):
        cb = codebooks[qi]
        d2 = (residual**2).sum(-1, keepdim=True) - 2.0 * residual @ cb.T + (cb**2).sum(-1)[None, :]
        total = total + F.cross_entropy(-d2, codes[:, qi])
        residual = residual - cb[codes[:, qi]]
    return total / codebooks.shape[0]
