"""F0 (pitch) estimation and its coarse quantization (twins of
`compute_pitch`, `compute_pitch_nccf` and `f0_to_coarse` in
`naturalspeech2_tpu/ops/pitch.py`).

Both estimators frame the audio at the mel hop (reflect padding, then a
strided gather), so pitch and mel frames line up: ``compute_pitch`` peaks
the FFT autocorrelation normalised by the frame energy (the default,
``calc_pitch_with_pyworld=True``); ``compute_pitch_nccf`` normalises each
lag by both windows' energies and picks the lag track by Viterbi, a loop
over frames on the device. Unvoiced frames are 0 Hz. The pyworld route of
the JAX package needs a package the port does not use.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _frames(audio: torch.Tensor, hop_length: int, frame_length: int) -> torch.Tensor:
    """[b, T // hop + 1, frame_length] frames of reflect-padded audio, each
    with its mean taken off."""
    audio = audio.to(torch.float32)
    pad = frame_length // 2
    x = torch.nn.functional.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = audio.shape[-1] // hop_length + 1
    idx = (torch.arange(n_frames, device=audio.device)[:, None] * hop_length
           + torch.arange(frame_length, device=audio.device)[None, :])
    frames = x[:, idx]
    return frames - frames.mean(dim=-1, keepdim=True)


def _refine(scores: torch.Tensor, best: torch.Tensor, last: int):
    """(peak, sub-sample offset): the parabola through the scores at
    best − 1, best, best + 1 (indices clamped to 0 … last)."""
    def at(i):
        return scores.gather(-1, i[..., None])[..., 0]

    peak = at(best)
    left, right = at((best - 1).clamp(min=0)), at((best + 1).clamp(max=last))
    denom = left - 2 * peak + right
    delta = torch.where(denom.abs() > 1e-8, 0.5 * (left - right) / denom, 0.0)
    return peak, delta.clamp(-0.5, 0.5)


def compute_pitch(audio: torch.Tensor, *, sample_rate: int, hop_length: int,
                  f0_floor: float = 50.0, f0_ceil: float = 640.0,
                  frame_length: Optional[int] = None, voicing_threshold: float = 0.3,
                  median_smooth: bool = True) -> torch.Tensor:
    """Audio [b, T] → F0 [b, T // hop + 1] in Hz (0 = unvoiced): the first
    maximum of the normalised autocorrelation over the lags of
    f0_ceil … f0_floor, refined by a parabola, voiced above
    ``voicing_threshold``, then a 3-tap median over voiced frames."""
    max_lag = int(np.ceil(sample_rate / f0_floor))
    min_lag = max(2, int(np.floor(sample_rate / f0_ceil)))
    if frame_length is None:
        frame_length = 1 << int(np.ceil(np.log2(2 * max_lag)))
    frames = _frames(audio, hop_length, frame_length)
    n_fft = 2 * frame_length  # zero-padded: the linear, not circular, autocorrelation
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    acf = torch.fft.irfft(spec * torch.conj(spec), n=n_fft, dim=-1)[..., : max_lag + 2]
    nac = acf / acf[..., :1].clamp(min=1e-8)

    lags = torch.arange(max_lag + 2, device=audio.device)
    valid = (lags >= min_lag) & (lags <= max_lag)
    best = torch.where(valid, nac, -torch.inf).argmax(dim=-1)
    peak, delta = _refine(nac, best, max_lag + 1)
    f0 = sample_rate / (best.to(torch.float32) + delta).clamp(min=1.0)
    voiced = (peak > voicing_threshold) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    f0 = torch.where(voiced, f0, 0.0)
    if median_smooth:
        left = torch.cat([f0[:, :1], f0[:, :-1]], dim=1)
        right = torch.cat([f0[:, 1:], f0[:, -1:]], dim=1)
        med = torch.stack([left, f0, right]).median(dim=0).values
        f0 = torch.where(f0 > 0, med, 0.0)
    return f0


def compute_pitch_nccf(audio: torch.Tensor, *, sample_rate: int, hop_length: int,
                       f0_floor: float = 50.0, f0_ceil: float = 640.0,
                       voicing_threshold: float = 0.3,
                       transition_weight: float = 0.4) -> torch.Tensor:
    """Audio [b, T] → F0 [b, T // hop + 1] in Hz (0 = unvoiced), Kaldi
    style: each lag's cross-correlation normalised by √(E₀·E_τ), the lag
    track chosen by Viterbi with a −w·|log(τ/τ′)| transition score (ties to
    the first "from" lag), then refined by a parabola and voiced above
    ``voicing_threshold``."""
    max_lag = int(np.ceil(sample_rate / f0_floor))
    min_lag = max(2, int(np.floor(sample_rate / f0_ceil)))
    n_lags = max_lag - min_lag + 1
    window = max(2 * min_lag, max_lag)
    frame_length = window + max_lag
    frames = _frames(audio, hop_length, frame_length)
    device = frames.device

    # numerator[τ] = Σ_{t < window} x[t]·x[t + τ], by FFT
    n_fft = 1 << int(np.ceil(np.log2(2 * frame_length)))
    head = frames * (torch.arange(frame_length, device=device) < window)
    corr = torch.fft.irfft(torch.conj(torch.fft.rfft(head, n=n_fft, dim=-1))
                           * torch.fft.rfft(frames, n=n_fft, dim=-1), n=n_fft, dim=-1)
    num = corr[..., min_lag: max_lag + 1]
    csum = torch.cumsum(torch.nn.functional.pad(frames**2, (1, 0)), dim=-1)
    e0 = csum[..., window] - csum[..., 0]
    lag_idx = torch.arange(min_lag, max_lag + 1, device=device)
    e_tau = csum[..., lag_idx + window] - csum[..., lag_idx]
    nccf = num / torch.sqrt((e0[..., None] * e_tau).clamp(min=1e-12))

    lags = lag_idx.to(torch.float32)
    trans = -transition_weight * torch.abs(torch.log(lags[:, None] / lags[None, :]))
    score, back = nccf[:, 0], []
    for f in range(1, nccf.shape[1]):
        cand = score[:, :, None] + trans  # [b, from, to]
        best_score, best_prev = cand.max(dim=1)
        back.append(best_prev)
        score = best_score + nccf[:, f]
    state = score.argmax(dim=-1)
    path = [state]
    for best_prev in reversed(back):  # the lag of frame f from that of f + 1
        state = best_prev.gather(1, state[:, None])[:, 0]
        path.append(state)
    path = torch.stack(path[::-1], dim=1)

    best_nccf, delta = _refine(nccf, path, n_lags - 1)
    f0 = sample_rate / (path.to(torch.float32) + min_lag + delta).clamp(min=1.0)
    voiced = (best_nccf > voicing_threshold) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    return torch.where(voiced, f0, 0.0)


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
