"""The diffusion denoiser (twin of `Model` in
`naturalspeech2_tpu/models/denoiser.py`), unconditional configuration:
learned-Fourier time embedding → Linear(dim·4) → SiLU, then the fused
WaveNet and the adaptive transformer, both conditioned on that time
embedding."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import LearnedSinusoidalPosEmb
from naturalspeech2_tpu_torch.models.transformer import ConditionableTransformer
from naturalspeech2_tpu_torch.models.wavenet import FusedWavenet


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet (ROADMAP Queue 1, {item})")


class Model(nn.Module):
    def __init__(
        self,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: int = 4,
        wavenet_layers: int = 8,
        wavenet_stacks: int = 4,
        dim_cond_mult: int = 4,
        use_flash_attn: bool = True,
        condition_on_prompt: bool = False,
        use_fused_wavenet: bool = True,
        scan_layers: bool = False,
        self_cond: bool = False,
        gelu_approximate: bool = True,
    ):
        super().__init__()
        if condition_on_prompt:
            raise _not_ported("condition_on_prompt=True", "slice 4")
        if self_cond:
            raise _not_ported("self_cond=True", "slice 3")
        if scan_layers:
            raise _not_ported("scan_layers=True", "option list")
        if not use_fused_wavenet:
            raise _not_ported("use_fused_wavenet=False", "option list")
        if not use_flash_attn:
            raise _not_ported("use_flash_attn=False", "option list")
        if not gelu_approximate:
            raise _not_ported("gelu_approximate=False", "option list")
        self.dim = dim
        dim_time = dim * dim_cond_mult
        self.time_pos_emb = LearnedSinusoidalPosEmb(dim)
        self.to_time_hidden = nn.Linear(dim + 1, dim_time)
        nn.init.zeros_(self.to_time_hidden.bias)
        self.wavenet = FusedWavenet(dim, wavenet_stacks, wavenet_layers, dim_cond_mult)
        self.transformer = ConditionableTransformer(
            dim, depth, dim_head=dim_head, heads=heads, ff_mult=ff_mult,
            ff_causal_conv=True, dim_cond_mult=dim_cond_mult,
        )

    def forward(self, x: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        """x [b, n, dim], times [b] (or a scalar) → prediction [b, n, dim]."""
        if times.ndim == 0:
            times = times.expand(x.shape[0])
        t = F.silu(self.to_time_hidden(self.time_pos_emb(times)))
        x = self.wavenet(x, t)
        return self.transformer(x, times=t)


def forward_with_cond_scale(
    model: Model, x: torch.Tensor, times: torch.Tensor, *, cond_scale: float = 1.0
) -> torch.Tensor:
    """Classifier-free-guided forward. The unconditional model has no
    condition to drop, so, as in the JAX package, this is its plain
    forward whatever ``cond_scale`` is."""
    return model(x, times)
