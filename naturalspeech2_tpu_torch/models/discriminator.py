"""Multi-scale STFT discriminators for adversarial codec training (twin of
`naturalspeech2_tpu/models/discriminator.py`).

One discriminator per STFT resolution reads the complex spectrogram
(real and imaginary parts as two channels, [b, 2, frames, bins] here,
channels-first) through strided LeakyReLU convs and returns its logits
map and every intermediate feature map (for feature matching). The convs
pad as flax's ``padding="SAME"``: at stride 2 along the bins the pad is
asymmetric, computed from each input's size.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import promoted_conv1d
from naturalspeech2_tpu_torch.ops.mel import stft

# (n_fft, hop) per scale
DEFAULT_SCALES: Tuple[Tuple[int, int], ...] = (
    (1024, 256),
    (512, 128),
    (256, 64),
)


class SameConv2d(nn.Conv2d):
    """flax ``Conv(padding="SAME")`` in 2-D: output ceil(n / s) per axis, the
    pad max((out − 1)·s + k − n, 0) split with the smaller half first."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(reversed(x.shape[-2:]), reversed(self.kernel_size),
                           reversed(self.stride)):
            total = max((math.ceil(n / s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return promoted_conv1d(self, F.pad(x, pads))


class STFTDiscriminator(nn.Module):
    """Audio [b, T] → complex STFT → conv (3, 9) → ``n_layers − 1`` convs (3,
    9) at stride (1, 2) → conv (3, 3), each with LeakyReLU(0.2) and kept as
    a feature → a one-channel conv (3, 3): the logits [b, 1, frames, bins']."""

    def __init__(self, n_fft: int, hop: int, channels: int = 32, n_layers: int = 4):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        convs = [SameConv2d(2, channels, (3, 9))]
        convs += [SameConv2d(channels, channels, (3, 9), stride=(1, 2))
                  for _ in range(n_layers - 1)]
        convs += [SameConv2d(channels, channels, (3, 3)), SameConv2d(channels, 1, (3, 3))]
        self.convs = nn.ModuleList(convs)

    def forward(self, audio: torch.Tensor):
        spec = stft(audio, n_fft=self.n_fft, hop_length=self.hop, win_length=self.n_fft)
        x = torch.stack([spec.real, spec.imag], dim=1).transpose(2, 3)  # [b, 2, frames, bins]
        features: List[torch.Tensor] = []
        for conv in self.convs[:-1]:
            x = F.leaky_relu(conv(x), 0.2)
            features.append(x)
        return self.convs[-1](x), features


class MultiScaleSTFTDiscriminator(nn.Module):
    """One `STFTDiscriminator` per (n_fft, hop), as ``disc_{n_fft}``; returns
    (logits per scale, features per scale)."""

    def __init__(self, scales: Sequence[Tuple[int, int]] = DEFAULT_SCALES, channels: int = 32):
        super().__init__()
        self.names = []
        for n_fft, hop in scales:
            self.add_module(f"disc_{n_fft}", STFTDiscriminator(n_fft, hop, channels))
            self.names.append(f"disc_{n_fft}")

    def forward(self, audio: torch.Tensor):
        logits, features = [], []
        for name in self.names:
            lg, ft = getattr(self, name)(audio)
            logits.append(lg)
            features.append(ft)
        return logits, features


def discriminator_hinge_loss(real_logits, fake_logits) -> torch.Tensor:
    """L_D = mean over scales of E[relu(1 − D(x))] + E[relu(1 + D(x̂))]."""
    total = 0.0
    for r, f in zip(real_logits, fake_logits):
        total = total + F.relu(1.0 - r).mean() + F.relu(1.0 + f).mean()
    return total / len(real_logits)


def generator_hinge_loss(fake_logits) -> torch.Tensor:
    """L_G = mean over scales of E[relu(1 − D(x̂))]."""
    total = 0.0
    for f in fake_logits:
        total = total + F.relu(1.0 - f).mean()
    return total / len(fake_logits)


def feature_matching_loss(real_features, fake_features,
                          batch_sum: Callable = lambda x: x) -> torch.Tensor:
    """Mean over scales and layers of mean|D(x) − D(x̂)| / max(mean|D(x)|, 1e-6),
    each mean from sums over the batch that ``batch_sum`` completes (data
    parallel: `parallel.comm.global_sum` adds the other ranks' rows)."""
    parts = [torch.stack([(r - f).abs().sum(), r.abs().sum(), r.new_tensor(float(r.numel()))])
             for rs, fs in zip(real_features, fake_features) for r, f in zip(rs, fs)]
    sums = batch_sum(torch.stack(parts))  # [layers, 3]
    ratios = (sums[:, 0] / sums[:, 2]) / (sums[:, 1] / sums[:, 2]).clamp(min=1e-6)
    return ratios.sum() / len(parts)
