"""Core building blocks, ``[b, n, d]`` layout (twins of
`naturalspeech2_tpu/models/blocks.py`)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.ops.ff_block_kernel import ff_block


def _normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / max(‖x‖, 1e-12) · √dim over the last axis (not torch.nn.RMSNorm)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp(min=1e-12) * math.sqrt(dim)


def ada_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, dim: int) -> torch.Tensor:
    """Adaptive RMSNorm x/‖x‖·√d·γ + β with per-sample [b, d] γ and β."""
    return _normalize(x, dim) * gamma[:, None, :] + beta[:, None, :]


class RMSNorm(nn.Module):
    """x/‖x‖·√dim·γ with a learned γ (initialised to 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _normalize(x, self.dim) * self.gamma


class LearnedSinusoidalPosEmb(nn.Module):
    """Learned-frequency Fourier time embedding; output width ``dim + 1``."""

    def __init__(self, dim: int):
        super().__init__()
        if dim % 2 != 0:
            raise ValueError(f"LearnedSinusoidalPosEmb needs an even dim, got {dim}")
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t[:, None]
        freqs = t * self.weights[None, :] * 2 * math.pi
        return torch.cat([t, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class CausalConv1d(nn.Module):
    """1-D conv with left padding dilation·(kernel−1); input and output
    ``[b, n, d]``."""

    def __init__(self, dim_in: int, features: int, kernel_size: int, dilation: int = 1):
        super().__init__()
        self.pad = dilation * (kernel_size - 1)
        self.conv = nn.Conv1d(dim_in, features, kernel_size, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), (self.pad, 0))
        return self.conv(x).transpose(1, 2)


class FeedForward(nn.Module):
    """GEGLU MLP with a causal k=3 conv between gate and out-projection,
    as one pre-norm residual block: ``x + FF(adaRMSNorm(x))`` through
    kernel K3.

    The weights keep the JAX layouts the kernel consumes: ``w1`` [dim,
    2·inner] (value half first), ``wc`` [3, inner, inner], ``w2``
    [inner, dim], with ``inner = int(dim·mult·2/3)``.
    """

    def __init__(self, dim: int, mult: int = 4, causal_conv: bool = True,
                 gelu_approximate: bool = True):
        super().__init__()
        if not causal_conv:
            raise NotImplementedError(
                "FeedForward(causal_conv=False) is not ported yet (ROADMAP Queue 1, slice 4)"
            )
        if not gelu_approximate:
            raise NotImplementedError(
                "gelu_approximate=False is not ported yet (ROADMAP Queue 1, option list)"
            )
        inner = int(dim * mult * 2 / 3)
        self.w1 = nn.Parameter(torch.randn(dim, 2 * inner) / math.sqrt(dim))
        self.b1 = nn.Parameter(torch.zeros(2 * inner))
        self.wc = nn.Parameter(torch.randn(3, inner, inner) / math.sqrt(3 * inner))
        self.bc = nn.Parameter(torch.zeros(inner))
        self.w2 = nn.Parameter(torch.randn(inner, dim) / math.sqrt(inner))
        self.b2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        return ff_block(x, gamma, beta, self.w1, self.b1, self.wc, self.bc, self.w2, self.b2)
