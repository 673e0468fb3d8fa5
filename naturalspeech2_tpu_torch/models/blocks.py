"""Core building blocks, ``[b, n, d]`` layout (twins of
`naturalspeech2_tpu/models/blocks.py`)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.ops.dropout import Dropout
from naturalspeech2_tpu_torch.ops.ff_block_kernel import causal_conv3, ff_block, fits_fused_ff_block
from naturalspeech2_tpu_torch.utils.helpers import promoted


def _normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / max(‖x‖, 1e-12) · √dim over the last axis (not torch.nn.RMSNorm)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp(min=1e-12) * math.sqrt(dim)


def ada_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, dim: int) -> torch.Tensor:
    """Adaptive RMSNorm x/‖x‖·√d·γ + β with per-sample [b, d] γ and β,
    which follow x's dtype (as the JAX module casts them)."""
    return (_normalize(x, dim) * gamma[:, None, :].to(x.dtype)
            + beta[:, None, :].to(x.dtype))


def promoted_linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` at the promoted dtype of x and the layer's weight, as
    flax's Dense computes with mixed operands: f32 diffusion times through
    bf16 weights run in f32."""
    return F.linear(*promoted(x, layer.weight, layer.bias))


def promoted_conv1d(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` (channels-first x; any ``nn.Conv1d`` or ``nn.Conv2d``) at
    the promoted dtype of x and the conv's weight, as flax's Conv computes
    with mixed operands.

    A bf16 convolution on the CPU is computed in f32 on the bf16 values and
    rounded once, which is its function (f32 sums of exact products):
    torch's oneDNN bf16 convolution returns wrong values on some CPUs at
    some strided shapes (kernel 16 at stride 8, the codec's last encoder
    block, is off by more than the output's size)."""
    x, weight, bias = promoted(x, conv.weight, conv.bias)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        wide = (t if t is None else t.float() for t in (x, weight, bias))
        return conv._conv_forward(*wide).to(torch.bfloat16)
    return conv._conv_forward(x, weight, bias)


class RMSNorm(nn.Module):
    """x/‖x‖·√dim·γ with a learned γ (initialised to 1; none with
    ``scale=False``). With ``dim_cond`` the output is FiLM-modulated per
    sample by ``to_gamma_beta(cond)`` [b, 2·dim], a Linear initialised to
    weight 0 and bias [1…, 0…] (identity at init): ``norm(x, cond)``."""

    def __init__(self, dim: int, scale: bool = True, dim_cond: Optional[int] = None):
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim)) if scale else None
        self.to_gamma_beta = None
        if dim_cond is not None:
            self.to_gamma_beta = nn.Linear(dim_cond, 2 * dim)
            nn.init.zeros_(self.to_gamma_beta.weight)
            with torch.no_grad():
                self.to_gamma_beta.bias.copy_(torch.cat([torch.ones(dim), torch.zeros(dim)]))

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = _normalize(x, self.dim)
        if self.gamma is not None:
            out = out * self.gamma
        if self.to_gamma_beta is None:
            return out
        if cond is None:
            raise ValueError("a conditional RMSNorm needs cond")
        gamma, beta = promoted_linear(self.to_gamma_beta, cond).chunk(2, dim=-1)
        return out * gamma[:, None, :] + beta[:, None, :]


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
        return promoted_conv1d(self.conv, x).transpose(1, 2)


class ConvUnit(nn.Module):
    """Conv(k, same) → GroupNorm(groups, eps 1e-5) → SiLU → dropout (drawn
    for the global batch, `ops.dropout`); input and output ``[b, n, d]``."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int = 3, groups: int = 8,
                 dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Conv1d(dim_in, dim_out, kernel, padding=kernel // 2)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.norm(promoted_conv1d(self.conv, x.transpose(1, 2)))).transpose(1, 2)
        return self.dropout(x)


class ResnetBlock(nn.Module):
    """``num_convs`` ConvUnits plus the input, projected by a 1×1 conv
    when the widths differ."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int, dropout: float = 0.0,
                 groups: int = 8, num_convs: int = 2):
        super().__init__()
        self.units = nn.ModuleList(
            ConvUnit(dim_in if i == 0 else dim_out, dim_out, kernel, groups, dropout)
            for i in range(num_convs)
        )
        self.res_conv = nn.Conv1d(dim_in, dim_out, 1) if dim_in != dim_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for unit in self.units:
            h = unit(h)
        if self.res_conv is not None:
            x = promoted_conv1d(self.res_conv, x.transpose(1, 2)).transpose(1, 2)
        return h + x


class ConvBlock(nn.Module):
    """Conv(k, same) → SiLU → dropout, no norm."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int, dropout: float = 0.0):
        super().__init__()
        self.conv = nn.Conv1d(dim_in, dim_out, kernel, padding=kernel // 2)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(F.silu(promoted_conv1d(self.conv, x.transpose(1, 2)).transpose(1, 2)))


class FeedForward(nn.Module):
    """GEGLU MLP, ``inner = int(dim·mult·2/3)``, with a causal k=3 conv
    between gate and out-projection where ``causal_conv``:

    - ``ff(x, gamma, beta)`` is the pre-norm residual block
      ``x + FF(adaRMSNorm(x))`` of the adaptive transformer: kernel K3
      where ``causal_conv``, ``use_fused``, ``gelu_approximate`` and the
      JAX package's gate `fits_fused_ff_block` all pass, else the same
      function as separate tensor ops (exact GELU with
      ``gelu_approximate=False``), as the JAX module runs it;
    - ``ff(x)`` is the MLP alone, ``W₂·([conv₃](gelu(x·W_g + b_g) ∘ (x·W_v +
      b_v))) + b₂``, with no norm and no residual (the encoders' MLP, and
      the plain transformer layer's).

    The weights keep the JAX layouts: ``w1`` [dim, 2·inner] (value half
    first), ``wc`` [3, inner, inner], ``w2`` [inner, dim].
    """

    def __init__(self, dim: int, mult: int = 4, causal_conv: bool = True,
                 gelu_approximate: bool = True, use_fused: bool = True):
        super().__init__()
        self.dim, self.causal_conv = dim, causal_conv
        self.fused = use_fused and gelu_approximate
        self.approximate = "tanh" if gelu_approximate else "none"
        inner = int(dim * mult * 2 / 3)
        self.w1 = nn.Parameter(torch.randn(dim, 2 * inner) / math.sqrt(dim))
        self.b1 = nn.Parameter(torch.zeros(2 * inner))
        if causal_conv:
            self.wc = nn.Parameter(torch.randn(3, inner, inner) / math.sqrt(3 * inner))
            self.bc = nn.Parameter(torch.zeros(inner))
        self.w2 = nn.Parameter(torch.randn(inner, dim) / math.sqrt(inner))
        self.b2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual = None
        if gamma is not None:
            if (self.causal_conv and self.fused
                    and fits_fused_ff_block(x.shape[1], self.dim, self.w2.shape[0])):
                return ff_block(x, gamma, beta, self.w1, self.b1, self.wc, self.bc, self.w2,
                                self.b2)
            residual, x = x, ada_rmsnorm(x, gamma, beta, self.dim)
        x, w1, b1 = promoted(x, self.w1, self.b1)
        val, gate = (x @ w1 + b1).chunk(2, dim=-1)
        a = F.gelu(gate, approximate=self.approximate) * val
        if self.causal_conv:
            # the conv's weights follow the activations, as the JAX module casts them
            a = causal_conv3(a, self.wc.to(a.dtype), self.bc.to(a.dtype))
        a, w2, b2 = promoted(a, self.w2, self.b2)
        out = a @ w2 + b2
        return out if residual is None else residual + out
