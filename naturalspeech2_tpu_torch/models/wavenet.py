"""WaveNet stack of the denoiser (twin of `FusedWavenet` in
`naturalspeech2_tpu/models/wavenet.py`), ``[b, n, d]`` layout.

init causal conv → the fused body (kernel K1: S stacks of L dilated
causal convs with FiLM time conditioning and tanh·σ gates; stack s > 0's
block l consumes stack s−1's block-l output; the last stack's skips are
summed) → 1×1 final conv.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import CausalConv1d
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
