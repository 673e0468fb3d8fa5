"""Mel-spectrogram frontend (twin of `naturalspeech2_tpu/ops/mel.py`):
centred Hann STFT → power → HTK mel filterbank → dB, always in f32.

`torch.stft` computes the JAX package's `stft` when it is given the same
frames and window: the audio reflect-padded by n_fft // 2 on each side (as
``jnp.pad(mode="reflect")``, which reflects again where the pad is longer
than the audio, and ``F.pad`` refuses), and the periodic Hann of
``win_length`` (``np.hanning(w + 1)[:-1]``) zero-padded to ``n_fft`` on
both sides, built here in numpy as the JAX package builds it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """Triangular HTK filterbank ``[n_freqs, n_mels]``, no norm, over the
    frequency grid 0 … sample_rate // 2."""
    f_max = f_max if f_max is not None else sample_rate / 2
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _window(n_fft: int, win_length: int) -> np.ndarray:
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    pad = (n_fft - win_length) // 2
    return np.pad(window, (pad, n_fft - win_length - pad))


def reflect_pad(audio: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(audio, ((0, 0), (pad, pad)), mode="reflect")`` for any pad:
    the signal's reflection repeats with period 2·(T − 1)."""
    t = audio.shape[-1]
    if pad < t:
        return torch.nn.functional.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    period = 2 * (t - 1)
    idx = torch.arange(-pad, t + pad, device=audio.device).remainder(period)
    return audio[:, torch.where(idx >= t, period - idx, idx)]


def stft(audio: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
         win_length: int = 640) -> torch.Tensor:
    """Complex STFT ``[b, n_fft // 2 + 1, 1 + T // hop]`` of audio [b, T]."""
    audio = reflect_pad(audio.to(torch.float32), n_fft // 2)
    window = torch.from_numpy(_window(n_fft, win_length)).to(audio.device)
    return torch.stft(audio, n_fft, hop_length=hop_length, win_length=n_fft, window=window,
                      center=False, onesided=True, return_complex=True)


def audio_to_mel(audio: torch.Tensor, *, n_mels: int = 100, sample_rate: int = 24000,
                 f_max: float = 8000.0, n_fft: int = 1024, win_length: int = 640,
                 hop_length: int = 160, log: bool = True) -> torch.Tensor:
    """Audio [b, T] → (log-)mel ``[b, n_mels, 1 + T // hop]``; the log is
    10·log10(clamp(x, 1e-10)), in dB."""
    power = stft(audio, n_fft=n_fft, hop_length=hop_length, win_length=win_length).abs() ** 2
    fb = torch.from_numpy(mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_max=f_max))
    mel = torch.einsum("bft,fm->bmt", power, fb.to(power.device))
    if log:
        mel = 10.0 * torch.log10(mel.clamp(min=1e-10))
    return mel
