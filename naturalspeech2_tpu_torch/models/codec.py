"""Neural audio codec, decode path (twin of `SoundStream.decode` in
`naturalspeech2_tpu/models/codec.py`).

latents [b, n, codebook_dim] → decoder_stem (k7) → 4 × DecoderBlock
(ELU → transposed conv ×stride → 2 × ResidualUnit) → decoder_head (k7) →
audio [b, n·hop]. The convs run channels-first inside and keep the
``[b, n, d]`` layout at the module's edges.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class SameConv1d(nn.Conv1d):
    """Stride-1 odd-kernel conv with flax ``padding="SAME"``: dilation·(k−1)/2
    zeros on each side."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, dilation: int = 1):
        if kernel_size % 2 != 1:
            raise ValueError(f"SameConv1d takes odd kernels, got {kernel_size}")
        super().__init__(dim_in, dim_out, kernel_size, dilation=dilation,
                         padding=dilation * (kernel_size - 1) // 2)


class SameConvTranspose1d(nn.ConvTranspose1d):
    """flax ``ConvTranspose(kernel 2s, stride s, padding="SAME")``: output
    length n·s.

    Flax (``transpose_kernel=False``) correlates the zero-stuffed input,
    padded by ceil((3s−2)/2) on the left, with the unflipped kernel. That
    equals a transposed conv with the flipped kernel, cropped from index
    k−1−ceil((3s−2)/2); the weight here holds the flipped kernel
    [in, out, k] (see `params.py`)."""

    def __init__(self, dim_in: int, dim_out: int, stride: int):
        super().__init__(dim_in, dim_out, 2 * stride, stride=stride)
        k = 2 * stride
        self.crop = k - 1 - math.ceil((3 * stride - 2) / 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1]
        y = super().forward(x)
        return y[..., self.crop : self.crop + n * self.stride[0]]


class ResidualUnit(nn.Module):
    """x + Conv1(ELU(Conv7_dilated(ELU(x))))."""

    def __init__(self, chan: int, dilation: int = 1):
        super().__init__()
        self.conv1 = SameConv1d(chan, chan, 7, dilation=dilation)
        self.conv2 = SameConv1d(chan, chan, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.elu(self.conv1(F.elu(x))))


class DecoderBlock(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, stride: int):
        super().__init__()
        self.up = SameConvTranspose1d(chan_in, chan_out, stride)
        self.res1 = ResidualUnit(chan_out, dilation=1)
        self.res2 = ResidualUnit(chan_out, dilation=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res2(self.res1(self.up(F.elu(x))))


class SoundStream(nn.Module):
    """The codec's decoder and its codebooks (so a JAX tree loads whole).
    Audio is ``[b, T]`` float."""

    def __init__(
        self,
        codebook_dim: int = 128,
        channels: int = 32,
        strides: Sequence[int] = (2, 4, 5, 8),
        num_quantizers: int = 8,
        codebook_size: int = 1024,
    ):
        super().__init__()
        self.codebook_dim = codebook_dim
        chans = [channels * 2**i for i in range(len(strides))]
        rev = list(reversed(chans))
        self.decoder_stem = SameConv1d(codebook_dim, rev[0], 7)
        self.decoder_blocks = nn.ModuleList(
            DecoderBlock(c_in, c_out, s)
            for c_in, c_out, s in zip(rev, rev[1:] + [channels], reversed(strides))
        )
        self.decoder_head = SameConv1d(channels, 1, 7)
        self.codebooks = nn.Parameter(torch.randn(num_quantizers, codebook_size, codebook_dim))

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [b, n, d] → audio [b, n·hop]."""
        x = self.decoder_stem(latents.transpose(1, 2))
        for blk in self.decoder_blocks:
            x = blk(x)
        return self.decoder_head(x)[:, 0]

    def encode_latents(self, audio: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "codec encode is not ported yet (ROADMAP Queue 1, slice 2 item 9; kernel K6)"
        )

    def quantize(self, latents: torch.Tensor):
        raise NotImplementedError(
            "codec quantize is not ported yet (ROADMAP Queue 1, slice 2 item 9; kernel K6)"
        )
