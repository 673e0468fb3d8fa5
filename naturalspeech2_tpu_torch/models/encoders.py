"""Conditioning encoders, ``[b, n, d]`` layout (twins of
`naturalspeech2_tpu/models/encoders.py`): the Perceiver resampler of the
denoiser, the phoneme and speech-prompt encoders and the duration / pitch
predictor."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import (
    CausalConv1d,
    ConvBlock,
    FeedForward,
    ResnetBlock,
    RMSNorm,
    promoted_conv1d,
    promoted_linear,
)
from naturalspeech2_tpu_torch.models.transformer import Attention, Transformer
from naturalspeech2_tpu_torch.ops.dropout import Dropout


class PerceiverResampler(nn.Module):
    """``num_latents`` learned queries attend, themselves included in the
    context, to the prompt tokens: depth × [attention + latents, plain
    GEGLU MLP + latents], then RMSNorm."""

    def __init__(self, dim: int, depth: int, dim_context: Optional[int] = None,
                 num_latents: int = 64, dim_head: int = 64, heads: int = 8, ff_mult: int = 4,
                 use_flash_attn: bool = False, gelu_approximate: bool = True):
        super().__init__()
        dim_context = dim_context or dim
        self.proj_context = nn.Linear(dim_context, dim) if dim_context != dim else None
        self.latents = nn.Parameter(torch.randn(num_latents, dim) * 0.02)
        self.attn = nn.ModuleList(
            Attention(dim, dim_head, heads, use_flash=use_flash_attn,
                      cross_attn_include_queries=True)
            for _ in range(depth)
        )
        self.ff = nn.ModuleList(
            FeedForward(dim, mult=ff_mult, causal_conv=False, gelu_approximate=gelu_approximate)
            for _ in range(depth)
        )
        self.norm = RMSNorm(dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.proj_context is not None:
            x = promoted_linear(self.proj_context, x)
        latents = self.latents.expand(x.shape[0], *self.latents.shape)
        for attn, ff in zip(self.attn, self.ff):
            latents = attn(latents, context=x, mask=mask) + latents
            latents = ff(latents) + latents
        return self.norm(latents)


class PhonemeEncoder(nn.Module):
    """Token embedding (negative ids map to the pad id ``num_tokens``) →
    causal conv → SiLU → dropout → `Transformer`."""

    def __init__(self, num_tokens: int, dim: int = 512, dim_hidden: int = 512,
                 kernel_size: int = 9, depth: int = 6, dim_head: int = 64, heads: int = 8,
                 conv_dropout: float = 0.2, attn_dropout: float = 0.0, use_flash: bool = False,
                 gelu_approximate: bool = True):
        super().__init__()
        self.pad_id = num_tokens
        self.token_emb = nn.Embedding(num_tokens + 1, dim)
        self.conv = CausalConv1d(dim, dim_hidden, kernel_size)
        self.dropout = Dropout(conv_dropout)
        self.transformer = Transformer(
            dim_hidden, depth, dim_head=dim_head, heads=heads, dropout=attn_dropout,
            use_flash=use_flash, gelu_approximate=gelu_approximate,
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.token_emb(torch.where(x < 0, self.pad_id, x))
        x = self.dropout(F.silu(self.conv(x)))
        return self.transformer(x, mask=mask)


class SpeechPromptEncoder(nn.Module):
    """k-wide same-padded convs, each followed by SiLU, walking the widths
    ``dims``, then a `Transformer` at ``dims[-1]``."""

    def __init__(self, dim_codebook: int,
                 dims: Sequence[int] = (256, 2048, 2048, 2048, 2048, 512, 512, 512),
                 depth: int = 6, heads: int = 8, dim_head: int = 64, dropout: float = 0.2,
                 kernel_size: int = 9, use_flash_attn: bool = True,
                 gelu_approximate: bool = True):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"SpeechPromptEncoder takes an odd kernel, got {kernel_size}")
        self.dim_codebook, self.dim_out = dim_codebook, dims[-1]
        widths = (dim_codebook, *dims)
        # flax SAME at stride 1 and an odd kernel: (k−1)/2 on both sides
        self.convs = nn.ModuleList(
            nn.Conv1d(a, b, kernel_size, padding=(kernel_size - 1) // 2)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.transformer = Transformer(
            dims[-1], depth, heads=heads, dim_head=dim_head, dropout=dropout,
            use_flash=use_flash_attn, gelu_approximate=gelu_approximate,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.dim_codebook:
            raise ValueError(f"prompt latents have width {x.shape[-1]}, expected {self.dim_codebook}")
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = F.silu(promoted_conv1d(conv, x))
        return self.transformer(x.transpose(1, 2))


class DurationPitchPredictorTrunk(nn.Module):
    """depth × [convolutions → RMSNorm → attention to the prompt (queries
    included) + residual], then Dense(1) → ReLU or softplus."""

    def __init__(self, dim_in: int, dim: int = 512, depth: int = 10, kernel_size: int = 3,
                 dim_context: Optional[int] = None, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.2, use_resnet_block: bool = True,
                 num_convs_per_resnet_block: int = 2, num_convolutions_per_block: int = 3,
                 use_flash_attn: bool = False, head_activation: str = "relu"):
        super().__init__()
        if head_activation not in ("relu", "softplus"):
            raise ValueError(f"head_activation must be 'relu' or 'softplus', got {head_activation!r}")
        self.head_activation = head_activation
        self.convs = nn.ModuleList()
        for i in range(depth):
            block = nn.ModuleList()
            for c in range(num_convolutions_per_block):
                width = dim_in if i == 0 and c == 0 else dim
                block.append(
                    ResnetBlock(width, dim, kernel_size, num_convs=num_convs_per_resnet_block)
                    if use_resnet_block else ConvBlock(width, dim, kernel_size)
                )
            self.convs.append(block)
        self.norms = nn.ModuleList(RMSNorm(dim) for _ in range(depth))
        self.attn = nn.ModuleList(
            Attention(dim, dim_head, heads, dim_context=dim_context, dropout=dropout,
                      use_flash=use_flash_attn, cross_attn_include_queries=True)
            for _ in range(depth)
        )
        self.to_pred = nn.Linear(dim, 1)

    def forward(self, x: torch.Tensor, encoded_prompts: torch.Tensor,
                prompt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block, norm, attn in zip(self.convs, self.norms, self.attn):
            for conv in block:
                x = conv(x)
            x = attn(norm(x), context=encoded_prompts, mask=prompt_mask) + x
        x = promoted_linear(self.to_pred, x)[..., 0]
        return F.softplus(x) if self.head_activation == "softplus" else F.relu(x)


class DurationPitchPredictor(nn.Module):
    """Two trunks of the same shape and their own weights over the phoneme
    encodings ``[b, t_x, dim]``: ``(duration, pitch)``, each ``[b, t_x]``."""

    def __init__(self, dim: int, dim_encoded_prompts: Optional[int] = None,
                 num_convolutions_per_block: int = 3,
                 use_resnet_block: bool = True, num_convs_per_resnet_block: int = 2,
                 depth: int = 10, kernel_size: int = 3, heads: int = 8, dim_head: int = 64,
                 dim_hidden: int = 512, dropout: float = 0.2, use_flash_attn: bool = False,
                 head_activation: str = "relu"):
        super().__init__()
        kwargs = dict(
            dim_in=dim, dim=dim_hidden, depth=depth, kernel_size=kernel_size,
            dim_context=dim_encoded_prompts or dim, heads=heads, dim_head=dim_head,
            dropout=dropout, use_resnet_block=use_resnet_block,
            num_convs_per_resnet_block=num_convs_per_resnet_block,
            num_convolutions_per_block=num_convolutions_per_block,
            use_flash_attn=use_flash_attn, head_activation=head_activation,
        )
        self.to_duration_pred = DurationPitchPredictorTrunk(**kwargs)
        self.to_pitch_pred = DurationPitchPredictorTrunk(**kwargs)

    def forward(self, x: torch.Tensor, encoded_prompts: torch.Tensor,
                prompt_mask: Optional[torch.Tensor] = None):
        return (self.to_duration_pred(x, encoded_prompts, prompt_mask),
                self.to_pitch_pred(x, encoded_prompts, prompt_mask))
