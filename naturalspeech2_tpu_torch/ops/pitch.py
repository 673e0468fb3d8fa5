"""Pitch quantization for the conditioning stack (twin of `f0_to_coarse`
in `naturalspeech2_tpu/ops/pitch.py`). The pitch estimators belong to
conditional training (ROADMAP Queue 1, item 14)."""

from __future__ import annotations

import numpy as np
import torch


def f0_to_coarse(f0: torch.Tensor, f0_bin: int = 256, f0_max: float = 1100.0,
                 f0_min: float = 50.0) -> torch.Tensor:
    """Mel-scale quantization of F0 (Hz) into integer bins ``[1, f0_bin-1]``
    (0 Hz → bin 1). ``log(1 + f0/700)`` and the ``+0.5`` truncation are
    kept as the JAX package writes them, so the bins agree bit for bit
    away from bin boundaries."""
    f0_mel_max = 1127.0 * np.log(1 + f0_max / 700.0)
    f0_mel_min = 1127.0 * np.log(1 + f0_min / 700.0)
    f0_mel = 1127.0 * torch.log(1 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = f0_mel.clamp(1.0, float(f0_bin - 1))
    return (f0_mel + 0.5).to(torch.int32)
