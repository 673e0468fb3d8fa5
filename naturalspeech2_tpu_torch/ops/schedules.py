"""Continuous-time diffusion noise schedules γ(t) and their conversions
(twins of `naturalspeech2_tpu/ops/schedules.py:22-80`).

γ(t) is the signal variance share at t ∈ [0, 1] (γ(0)≈1 clean, γ(1)≈0 pure
noise); α = √γ·scale, σ = √(1−γ). All functions are elementwise and keep
the dtype and device of ``t``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def simple_linear_schedule(t: torch.Tensor, clip_min: float = 1e-9) -> torch.Tensor:
    """γ(t) = 1 − t."""
    return (1.0 - t).clamp(min=clip_min)


def cosine_schedule(
    t: torch.Tensor,
    start: float = 0.0,
    end: float = 1.0,
    tau: float = 1.0,
    clip_min: float = 1e-9,
) -> torch.Tensor:
    """Power-cosine γ(t) with remappable endpoints."""
    power = 2.0 * tau
    v_start = math.cos(start * math.pi / 2) ** power
    v_end = math.cos(end * math.pi / 2) ** power
    output = torch.cos((t * (end - start) + start) * math.pi / 2) ** power
    output = (v_end - output) / (v_end - v_start)
    return output.clamp(min=clip_min)


def sigmoid_schedule(
    t: torch.Tensor,
    start: float = -3.0,
    end: float = 3.0,
    tau: float = 1.0,
    clamp_min: float = 1e-9,
) -> torch.Tensor:
    """Sigmoid γ(t), the default schedule."""
    v_start = torch.sigmoid(torch.tensor(start / tau, dtype=t.dtype, device=t.device))
    v_end = torch.sigmoid(torch.tensor(end / tau, dtype=t.dtype, device=t.device))
    gamma = (-torch.sigmoid((t * (end - start) + start) / tau) + v_end) / (
        v_end - v_start
    )
    return gamma.clamp(min=clamp_min, max=1.0)


SCHEDULES: dict[str, Callable[..., torch.Tensor]] = {
    "linear": simple_linear_schedule,
    "cosine": cosine_schedule,
    "sigmoid": sigmoid_schedule,
}


def get_schedule(name: str) -> Callable[..., torch.Tensor]:
    """Name → γ(t) function."""
    if name not in SCHEDULES:
        raise ValueError(f"invalid noise schedule {name!r}; choose from {sorted(SCHEDULES)}")
    return SCHEDULES[name]


def gamma_to_alpha_sigma(gamma: torch.Tensor, scale: float = 1.0):
    """γ → (α, σ): α = √γ·scale, σ = √(1−γ)."""
    return torch.sqrt(gamma) * scale, torch.sqrt(1.0 - gamma)


def gamma_to_log_snr(gamma: torch.Tensor, scale: float = 1.0, eps: float = 1e-5) -> torch.Tensor:
    """γ → log SNR = log(γ·scale² / (1−γ)), clamped below at ``eps``."""
    return torch.log((gamma * (scale**2) / (1.0 - gamma)).clamp(min=eps))
