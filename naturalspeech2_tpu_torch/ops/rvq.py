"""K6: residual vector quantization (twin of `naturalspeech2_tpu/ops/rvq.py`).

For each of the Q stages, in order: the nearest codebook entry to the
running residual (d² = −2·r·Cᵀ + ‖C‖², the first minimal index), then
r −= C[idx]. Returns the quantized sum ``[m, d]`` and the codes ``[m, Q]``
(int32).

``rvq`` launches the kernel of ``csrc/rvq.cu`` on CUDA tensors (any
codebook dim: the kernel runs the distances over chunks of 128 dims, and
other widths are padded with zero columns to a multiple of 128, which
change no distance) and runs the plain version ``rvq_torch`` on CPU
tensors. ``rvq_quantize`` adds the
straight-through gradient; ``rvq_reference`` is the twin of ``rvq_xla``
(which keeps ‖r‖², so a near-tie may pick another code than the kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.ops import gemm_cache

# The kernel's chunk of the codebook dim, to a multiple of which codebooks
# are padded.
KERNEL_DIM = 128


def rvq_torch(x, codebooks):
    """Plain version of the kernel's function (`_rvq_kernel`): ‖r‖² dropped,
    first minimal index, the quantized sum accumulated stage by stage."""
    r = x.to(torch.float32)
    total = torch.zeros_like(r)
    norms = (codebooks * codebooks).sum(dim=-1)  # [Q, K]
    codes = []
    for qi in range(codebooks.shape[0]):
        d2 = -2.0 * (r @ codebooks[qi].T) + norms[qi]
        idx = torch.argmin(d2, dim=-1)  # the first minimal index
        q = codebooks[qi][idx]
        r = r - q
        total = total + q
        codes.append(idx)
    return total, torch.stack(codes, dim=-1).to(torch.int32)


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


def pad_codebook_dim(x, codebooks):
    """x [m, d] and codebooks [Q, K, d] with zero columns up to a multiple
    of the kernel's chunk, as ``rvq`` pads them."""
    pad = gemm_cache.round_up(x.shape[-1], KERNEL_DIM) - x.shape[-1]
    return F.pad(x, (0, pad)), F.pad(codebooks, (0, pad))


def rvq(x, codebooks):
    """K6: ``(quantized [m, d], codes [m, Q] int32)``. CUDA tensors launch
    the kernel (the codebook norms are a plain reduction beside it, as XLA
    computes them outside the Pallas kernel); CPU tensors run
    ``rvq_torch``."""
    if x.device.type == "cpu":
        return rvq_torch(x, codebooks)
    _build.require_cuda_f32("rvq", x=x, codebooks=codebooks)
    m, d = x.shape
    num_q, size = codebooks.shape[:2]
    _build.require_shapes("rvq", codebooks=(codebooks, (num_q, size, d)))
    d_p = gemm_cache.round_up(d, KERNEL_DIM)
    if d_p != d:
        padded = gemm_cache.cached("rvq", lambda cb: F.pad(cb, (0, d_p - d)), codebooks)
        quantized, codes = rvq(F.pad(x, (0, d_p - d)), padded)
        return quantized[:, :d].contiguous(), codes
    norms = (codebooks * codebooks).sum(dim=-1).contiguous()
    residual, quantized = torch.empty_like(x), torch.empty_like(x)
    codes = torch.empty((m, num_q), dtype=torch.int32, device=x.device)
    err = _build.library().ns2_rvq(
        x.data_ptr(), codebooks.data_ptr(), norms.data_ptr(), residual.data_ptr(),
        quantized.data_ptr(), codes.data_ptr(), m, d, num_q, size, _build.stream(x),
    )
    _build.check(err, "ns2_rvq")
    rvq.launches += 1
    return quantized, codes


rvq.launches = 0


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
    residual = x
    total = 0.0
    codes = codes.long()
    for qi in range(codebooks.shape[0]):
        cb = codebooks[qi]
        d2 = (residual**2).sum(-1, keepdim=True) - 2.0 * residual @ cb.T + (cb**2).sum(-1)[None, :]
        total = total + F.cross_entropy(-d2, codes[:, qi])
        residual = residual - cb[codes[:, qi]]
    return total / codebooks.shape[0]
