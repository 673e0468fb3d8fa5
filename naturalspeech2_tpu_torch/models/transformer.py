"""Adaptive-RMSNorm transformer of the denoiser (twins of `Attention` and
`ConditionableTransformer` in `naturalspeech2_tpu/models/transformer.py`),
``[b, n, d]`` layout.

Each layer is a pre-norm self-attention block (kernel K2) and a pre-norm
GEGLU + causal-conv feed-forward block (kernel K3), both residual, with
every norm's γ/β computed from the time condition by one stacked einsum;
the head is RMSNorm + a bias-free Linear.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import FeedForward, RMSNorm
from naturalspeech2_tpu_torch.ops.attn_block_kernel import attn_block


class Attention(nn.Module):
    """Pre-norm residual self-attention, ``x + attn(adaRMSNorm(x))``,
    through kernel K2. The projections keep the JAX Dense layouts the
    kernel consumes: to_q [dim, H·dh], to_kv [dim, 2·H·dh] (k first),
    to_out [H·dh, dim], all without bias."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.to_q = nn.Parameter(torch.randn(dim, inner) / math.sqrt(dim))
        self.to_kv = nn.Parameter(torch.randn(dim, 2 * inner) / math.sqrt(dim))
        self.to_out = nn.Parameter(torch.randn(inner, dim) / math.sqrt(inner))

    def forward(self, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
        return attn_block(
            x, gamma, beta, self.to_q, self.to_kv, self.to_out,
            heads=self.heads, dim_head=self.dim_head, scale=self.dim_head**-0.5,
        )


class ConditionableTransformer(nn.Module):
    """Unrolled adaptive transformer: per layer adaRMSNorm(t)→self-attn and
    adaRMSNorm(t)→FF(causal conv), then RMSNorm + Linear."""

    def __init__(
        self,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: int = 4,
        ff_causal_conv: bool = True,
        dim_cond_mult: Optional[int] = 4,
        cross_attn: bool = False,
        use_flash: bool = True,
        scan_layers: bool = False,
        gelu_approximate: bool = True,
    ):
        super().__init__()
        if cross_attn:
            raise NotImplementedError(
                "cross_attn=True is not ported yet (ROADMAP Queue 1, slice 4; kernel K2b)"
            )
        if dim_cond_mult is None:
            raise NotImplementedError(
                "the unconditioned transformer (dim_cond_mult=None) is not ported yet "
                "(ROADMAP Queue 1, slice 4)"
            )
        if scan_layers:
            raise NotImplementedError("scan_layers=True is not ported yet (ROADMAP Queue 1, option list)")
        if not use_flash:
            raise NotImplementedError("use_flash=False is not ported yet (ROADMAP Queue 1, option list)")
        self.dim, self.depth = dim, depth
        n_norms = depth * 2  # [attn, ff] per layer
        dim_cond = dim * dim_cond_mult
        self.ada_norm_w = nn.Parameter(torch.zeros(n_norms, dim_cond, 2 * dim))
        self.ada_norm_b = nn.Parameter(
            torch.cat([torch.ones(n_norms, dim), torch.zeros(n_norms, dim)], dim=-1)
        )
        self.attn = nn.ModuleList(
            Attention(dim, dim_head=dim_head, heads=heads) for _ in range(depth)
        )
        self.ff = nn.ModuleList(
            FeedForward(dim, mult=ff_mult, causal_conv=ff_causal_conv,
                        gelu_approximate=gelu_approximate)
            for _ in range(depth)
        )
        self.pred_norm = RMSNorm(dim)
        self.to_pred = nn.Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        d = self.dim
        ada = torch.einsum("bt,ntc->bnc", times, self.ada_norm_w) + self.ada_norm_b
        gammas = ada[..., :d].transpose(0, 1).contiguous()  # [n_norms, b, d]
        betas = ada[..., d:].transpose(0, 1).contiguous()
        x = x.contiguous()
        for i in range(self.depth):
            x = self.attn[i](x, gammas[2 * i], betas[2 * i])
            x = self.ff[i](x, gammas[2 * i + 1], betas[2 * i + 1])
        return self.to_pred(self.pred_norm(x))
