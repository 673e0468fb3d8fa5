"""Math helpers shared by the samplers (twins of
`naturalspeech2_tpu/utils/helpers.py:142-149`)."""

from __future__ import annotations

import torch


def safe_log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """log with its argument clamped to ``eps``."""
    return torch.log(t.clamp(min=eps))


def safe_div(numer: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Division with the denominator clamped to 1e-10."""
    return numer / denom.clamp(min=1e-10)
