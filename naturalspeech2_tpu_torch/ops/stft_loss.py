"""Multi-resolution STFT reconstruction loss (twin of
`naturalspeech2_tpu/ops/stft_loss.py`): spectral convergence plus
log-magnitude L1 over several FFT sizes, on the port's `ops/mel.py:stft`
(f32, cuFFT on the card)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from naturalspeech2_tpu_torch.ops.mel import stft

DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    # (n_fft, hop, win)
    (512, 128, 512),
    (1024, 256, 1024),
    (2048, 512, 2048),
)


def stft_magnitude(audio: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    return stft(audio, n_fft=n_fft, hop_length=hop, win_length=win).abs()


def multi_resolution_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                               resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS,
                               eps: float = 1e-7) -> torch.Tensor:
    """Mean over resolutions of ‖|S_t| − |S_p|‖ / max(‖|S_t|‖, eps) plus
    mean |log(|S_p| + eps) − log(|S_t| + eps)|, for audio [b, T]."""
    total = 0.0
    for n_fft, hop, win in resolutions:
        m_pred = stft_magnitude(pred, n_fft, hop, win)
        m_tgt = stft_magnitude(target, n_fft, hop, win)
        sc = torch.linalg.vector_norm(m_tgt - m_pred) / torch.linalg.vector_norm(m_tgt).clamp(
            min=eps)
        log_mag = (torch.log(m_pred + eps) - torch.log(m_tgt + eps)).abs().mean()
        total = total + sc + log_mag
    return total / len(resolutions)
