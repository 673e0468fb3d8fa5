"""Multi-resolution STFT reconstruction loss (twin of
`naturalspeech2_tpu/ops/stft_loss.py`): spectral convergence plus
log-magnitude L1 over several FFT sizes, on the port's `ops/mel.py:stft`
(f32, cuFFT on the card)."""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

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
                               eps: float = 1e-7,
                               batch_sum: Callable = lambda x: x) -> torch.Tensor:
    """Mean over resolutions of ‖|S_t| − |S_p|‖ / max(‖|S_t|‖, eps) plus
    mean |log(|S_p| + eps) − log(|S_t| + eps)|, for audio [b, T], from
    sums over the batch that ``batch_sum`` completes (data parallel:
    `parallel.comm.global_sum` adds the other ranks' rows)."""
    parts = []
    for n_fft, hop, win in resolutions:
        m_pred = stft_magnitude(pred, n_fft, hop, win)
        m_tgt = stft_magnitude(target, n_fft, hop, win)
        log_diff = (torch.log(m_pred + eps) - torch.log(m_tgt + eps)).abs()
        # squared norms, not sums of squares: √(‖x‖²) is ‖x‖ exactly, so one
        # process keeps the values and gradients the JAX parity tests hold
        parts.append(torch.stack([torch.linalg.vector_norm(m_tgt - m_pred).square(),
                                  torch.linalg.vector_norm(m_tgt).square(),
                                  log_diff.sum(), log_diff.new_tensor(float(log_diff.numel()))]))
    sums = batch_sum(torch.stack(parts))  # [resolutions, 4]
    sc = sums[:, 0].sqrt() / sums[:, 1].sqrt().clamp(min=eps)
    return (sc + sums[:, 2] / sums[:, 3]).sum() / len(resolutions)
