"""Neural audio codec (twin of `SoundStream` in
`naturalspeech2_tpu/models/codec.py`).

encode: audio [b, T] → encoder_stem (k7) → 4 × EncoderBlock (2 ×
ResidualUnit → ELU → strided conv k=2s, stride s) → encoder_head (k3) →
latents [b, T/hop, codebook_dim]; quantize: residual VQ over the
codebooks (kernel K6) with the straight-through gradient.
decode: latents → decoder_stem (k7) → 4 × DecoderBlock (ELU → transposed
conv ×stride → 2 × ResidualUnit) → decoder_head (k7) → audio [b, n·hop].
The convs run channels-first inside and keep the ``[b, n, d]`` layout at
the module's edges.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import promoted_conv1d
from naturalspeech2_tpu_torch.ops.rvq import rvq_cross_entropy, rvq_quantize, rvq_reference


class SameConv1d(nn.Conv1d):
    """Stride-1 odd-kernel conv with flax ``padding="SAME"``: dilation·(k−1)/2
    zeros on each side."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, dilation: int = 1):
        if kernel_size % 2 != 1:
            raise ValueError(f"SameConv1d takes odd kernels, got {kernel_size}")
        super().__init__(dim_in, dim_out, kernel_size, dilation=dilation,
                         padding=dilation * (kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv1d(self, x)


class StridedSameConv1d(nn.Conv1d):
    """flax ``Conv(kernel 2s, stride s, padding="SAME")``: output length
    n/s. SAME pads s in all, ⌊s/2⌋ on the left and the rest on the right,
    which ``padding=`` cannot express (at s = 5: 2 and 3)."""

    def __init__(self, dim_in: int, dim_out: int, stride: int):
        super().__init__(dim_in, dim_out, 2 * stride, stride=stride)
        self.pads = (stride // 2, stride - stride // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return promoted_conv1d(self, F.pad(x, self.pads))


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


class EncoderBlock(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, stride: int):
        super().__init__()
        self.res1 = ResidualUnit(chan_in, dilation=1)
        self.res2 = ResidualUnit(chan_in, dilation=3)
        self.down = StridedSameConv1d(chan_in, chan_out, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.elu(self.res2(self.res1(x))))


class DecoderBlock(nn.Module):
    def __init__(self, chan_in: int, chan_out: int, stride: int):
        super().__init__()
        self.up = SameConvTranspose1d(chan_in, chan_out, stride)
        self.res1 = ResidualUnit(chan_out, dilation=1)
        self.res2 = ResidualUnit(chan_out, dilation=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res2(self.res1(self.up(F.elu(x))))


class SoundStream(nn.Module):
    """The codec: encoder, residual VQ codebooks and decoder. Audio is
    ``[b, T]`` float in [-1, 1] at ``target_sample_hz``. With
    ``use_pallas_rvq`` the quantizer is K6 (``rvq_quantize``); without it,
    the twin of ``rvq_xla`` (``rvq_reference``) with the same explicit
    straight-through as the JAX module."""

    def __init__(
        self,
        codebook_dim: int = 128,
        channels: int = 32,
        strides: Sequence[int] = (2, 4, 5, 8),
        num_quantizers: int = 8,
        codebook_size: int = 1024,
        target_sample_hz: int = 24000,
        use_pallas_rvq: bool = True,
    ):
        super().__init__()
        self.target_sample_hz = target_sample_hz
        self.use_pallas_rvq = use_pallas_rvq
        self.codebook_dim = codebook_dim
        self.num_quantizers = num_quantizers
        self.seq_len_multiple_of = math.prod(strides)  # the hop, 320 samples per frame
        chans = [channels * 2**i for i in range(len(strides))]
        self.encoder_stem = SameConv1d(1, channels, 7)
        self.encoder_blocks = nn.ModuleList(
            EncoderBlock(c_in, c_out, s) for c_in, c_out, s in zip([channels] + chans, chans, strides)
        )
        self.encoder_head = SameConv1d(chans[-1], codebook_dim, 3)
        rev = list(reversed(chans))
        self.decoder_stem = SameConv1d(codebook_dim, rev[0], 7)
        self.decoder_blocks = nn.ModuleList(
            DecoderBlock(c_in, c_out, s)
            for c_in, c_out, s in zip(rev, rev[1:] + [channels], reversed(strides))
        )
        self.decoder_head = SameConv1d(channels, 1, 7)
        self.codebooks = nn.Parameter(torch.randn(num_quantizers, codebook_size, codebook_dim))

    def encode_latents(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [b, T] (T a multiple of the hop) → latents [b, T/hop, d]."""
        x = self.encoder_stem(audio[:, None, :])
        for blk in self.encoder_blocks:
            x = blk(x)
        return self.encoder_head(x).transpose(1, 2)

    def quantize(self, latents: torch.Tensor):
        """latents [b, n, d] → (quantized [b, n, d], codes [b, n, Q] int32),
        straight-through to the latents."""
        b, n, d = latents.shape
        flat = latents.reshape(b * n, d).contiguous()
        if self.use_pallas_rvq:
            quantized, codes = rvq_quantize(flat, self.codebooks)
        else:
            quantized, codes = rvq_reference(flat, self.codebooks)
            quantized = flat + (quantized - flat).detach()
        return quantized.reshape(b, n, d), codes.reshape(b, n, self.num_quantizers)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [b, n, d] → audio [b, n·hop]."""
        x = self.decoder_stem(latents.transpose(1, 2))
        for blk in self.decoder_blocks:
            x = blk(x)
        return self.decoder_head(x)[:, 0]

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [b, n, Q] → Σ_q codebooks[q][codes[..., q]], [b, n, d]."""
        codes = codes.long()
        total = torch.zeros((*codes.shape[:2], self.codebook_dim), dtype=self.codebooks.dtype,
                            device=codes.device)
        for qi in range(self.num_quantizers):
            total = total + self.codebooks[qi][codes[..., qi]]
        return total

    def decode_from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decode(self.dequantize(codes))

    def rq(self, latents: torch.Tensor, codes: torch.Tensor):
        """(quantized, cross-entropy) of the latents against given codes."""
        b, n, d = latents.shape
        ce = rvq_cross_entropy(latents.reshape(b * n, d), self.codebooks, codes.reshape(b * n, -1))
        return self.dequantize(codes), ce

    def forward(self, audio: torch.Tensor, return_encoded: bool = False,
                curtail_from_left: bool = False):
        """Trims T to a hop multiple (from the left for prompts), encodes and
        quantizes. With ``return_encoded``: ``(latents, codes, None)``, the
        latents unquantized; without: the decoded quantized latents."""
        hop = self.seq_len_multiple_of
        t = audio.shape[-1]
        t_use = (t // hop) * hop
        if t_use != t:
            audio = audio[..., t - t_use:] if curtail_from_left else audio[..., :t_use]
        latents = self.encode_latents(audio)
        quantized, codes = self.quantize(latents)
        if return_encoded:
            return latents, codes, None
        return self.decode(quantized)

    def codec_loss(self, audio: torch.Tensor) -> dict:
        """The codec's own training losses: waveform L1 of the decoded
        straight-through quantized latents, and the commitment
        ‖latents − sg(quantized)‖² (`CodecTrainer` trains with more)."""
        latents = self.encode_latents(audio)
        quantized, _ = self.quantize(latents)
        recon = self.decode(latents + (quantized - latents).detach())
        return {"recon": (recon - audio).abs().mean(),
                "commitment": ((latents - quantized.detach()) ** 2).mean()}
