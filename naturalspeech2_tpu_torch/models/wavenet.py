"""WaveNet stack of the denoiser (twins of `FusedWavenet`, `Wavenet`,
`WavenetStack` and `WavenetResBlock` in
`naturalspeech2_tpu/models/wavenet.py`), ``[b, n, d]`` layout.

init causal conv → S stacks of L dilated causal convs with FiLM time
conditioning and tanh·σ gates (stack s > 0's block l consumes stack
s−1's block-l output; the last stack's skips are summed) → 1×1 final
conv. `FusedWavenet` runs the body as one kernel (K1) on stacked
weights; `Wavenet` (``Model(use_fused_wavenet=False)``) runs it block by
block on cuDNN convs, as the JAX package runs its unfused module on XLA
convs, with no kernel of its own.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import torch
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import CausalConv1d, promoted_linear
from naturalspeech2_tpu_torch.ops.wavenet_kernel import wavenet_body
from naturalspeech2_tpu_torch.utils.helpers import promoted


class FusedWavenet(nn.Module):
    """The stacked parameters keep the JAX layouts K1 consumes:
    conv_w [S, L, 3d, d] (taps x_{t−2δ}, x_{t−δ}, x_t), res_w [S, L, d, d],
    skip_w [L, d, d], film_w [S, L, dim_time, 2d] (γ first, β second)."""

    def __init__(self, dim: int, stacks: int, layers: int, dim_cond_mult: int):
        super().__init__()
        d, S, L = dim, stacks, layers
        self.init_conv = CausalConv1d(d, d, 3)
        self.conv_w = nn.Parameter(torch.randn(S, L, 3 * d, d) / math.sqrt(3 * d))
        self.conv_b = nn.Parameter(torch.zeros(S, L, d))
        self.res_w = nn.Parameter(torch.randn(S, L, d, d) / math.sqrt(d))
        self.res_b = nn.Parameter(torch.zeros(S, L, d))
        self.skip_w = nn.Parameter(torch.randn(L, d, d) / math.sqrt(d))
        self.skip_b = nn.Parameter(torch.zeros(L, d))
        dim_time = d * dim_cond_mult
        self.film_w = nn.Parameter(torch.randn(S, L, dim_time, 2 * d) / math.sqrt(dim_time))
        self.film_b = nn.Parameter(torch.cat([torch.ones(S, L, d), torch.zeros(S, L, d)], dim=-1))
        self.final_conv = CausalConv1d(d, d, 1)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x [b, n, d] and the time condition t [b, dim_time] → [b, n, d]."""
        x = self.init_conv(x)
        t, film_w, film_b = promoted(t, self.film_w, self.film_b)
        film = torch.einsum("bt,sltc->bslc", t, film_w) + film_b
        skip = wavenet_body(
            x.contiguous(), self.conv_w, self.conv_b, self.res_w, self.res_b,
            self.skip_w, self.skip_b, film.contiguous(),
        )
        return self.final_conv(skip)


class WavenetResBlock(nn.Module):
    """One block: h = FiLM(conv_δ(x)) (γ, β from ``to_time_cond(t)``, with
    ``dim_cond_mult``), then tanh(h)·σ(h) + res_conv(x); with
    ``skip_conv`` also skip_conv(h). Returns (h, skip or None)."""

    def __init__(self, dim: int, dilation: int, kernel_size: int = 3, skip_conv: bool = False,
                 dim_cond_mult: Optional[int] = None):
        super().__init__()
        self.res_conv = CausalConv1d(dim, dim, 1)
        self.conv = CausalConv1d(dim, dim, kernel_size, dilation=dilation)
        self.to_time_cond = (nn.Linear(dim * dim_cond_mult, 2 * dim)
                             if dim_cond_mult is not None else None)
        self.skip_conv = CausalConv1d(dim, dim, 1) if skip_conv else None

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None):
        res = self.res_conv(x)
        h = self.conv(x)
        if self.to_time_cond is not None:
            if t is None:
                raise ValueError("a time-conditioned WaveNet block needs t")
            gamma, beta = promoted_linear(self.to_time_cond, t).chunk(2, dim=-1)
            h = h * gamma[:, None, :] + beta[:, None, :]
        h = torch.tanh(h) * torch.sigmoid(h) + res
        return h, (self.skip_conv(h) if self.skip_conv is not None else None)


class WavenetStack(nn.Module):
    """``layers`` blocks ``block_{l}`` at dilations 2⁰..2^(layers−1). Takes
    one tensor (fanned out to every block) or the previous stack's list of
    block outputs; returns that list, or with ``has_skip`` the blocks'
    skips stacked [layers, b, n, d]."""

    def __init__(self, dim: int, layers: int, kernel_size: int = 3, has_skip: bool = False,
                 dim_cond_mult: Optional[int] = None):
        super().__init__()
        self.layers, self.has_skip = layers, has_skip
        for i in range(layers):
            self.add_module(f"block_{i}", WavenetResBlock(dim, 2**i, kernel_size, has_skip,
                                                          dim_cond_mult))

    def forward(self, x: Union[torch.Tensor, List[torch.Tensor]],
                t: Optional[torch.Tensor] = None):
        if isinstance(x, torch.Tensor):
            x = [x] * self.layers
        residuals, skips = [], []
        for i, block_input in enumerate(x):
            residual, skip = getattr(self, f"block_{i}")(block_input, t)
            residuals.append(residual)
            skips.append(skip)
        return torch.stack(skips) if self.has_skip else residuals


class Wavenet(nn.Module):
    """init causal conv → ``stacks`` stacks ``stack_{s}`` (the last with
    skips) → the skips summed → 1×1 final conv; the module tree is the JAX
    tree's ``wavenet/stack_{s}/block_{l}``."""

    def __init__(self, dim: int, stacks: int, layers: int, init_conv_kernel: int = 3,
                 dim_cond_mult: Optional[int] = None):
        super().__init__()
        self.stacks = stacks
        self.init_conv = CausalConv1d(dim, dim, init_conv_kernel)
        for s in range(stacks):
            self.add_module(f"stack_{s}", WavenetStack(dim, layers, has_skip=s == stacks - 1,
                                                       dim_cond_mult=dim_cond_mult))
        self.final_conv = CausalConv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.init_conv(x)
        for s in range(self.stacks):
            x = getattr(self, f"stack_{s}")(x, t)
        return self.final_conv(x.sum(dim=0))
