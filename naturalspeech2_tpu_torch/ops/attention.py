"""Attention with key-padding masks and causal masking (twin of `attend`
and `attend_xla` in `naturalspeech2_tpu/ops/attention.py`).

``backend="flash"`` runs flash attention (K4 forward, K5 backward,
``ops/flash_attention.py``); ``backend="xla"`` is plain PyTorch, as the
JAX package leaves that route to XLA. Masked logits are the finite
``NEG_INF`` on both routes.
"""

from __future__ import annotations

from typing import Optional

import torch

from naturalspeech2_tpu_torch.ops.flash_attention import NEG_INF, flash_attention


def attend_plain(q, k, v, *, mask: Optional[torch.Tensor] = None, causal: bool = False,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Dot-product attention over ``[b, h, n, d]``; ``mask`` ``[b, n_kv]``
    (True = attend). Causal masking keeps key j for query i where
    j ≤ i + n_kv − n_q, as ``attend_xla`` does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    if mask is not None:
        sim = torch.where(mask[:, None, None, :], sim, NEG_INF)
    if causal:
        i, j = sim.shape[-2:]
        keep = torch.ones((i, j), dtype=torch.bool, device=sim.device).tril(j - i)
        sim = torch.where(keep, sim, NEG_INF)
    return torch.einsum("bhij,bhjd->bhid", torch.softmax(sim, dim=-1), v)


def attend(q, k, v, *, mask: Optional[torch.Tensor] = None, causal: bool = False,
           scale: Optional[float] = None, dropout: float = 0.0,
           backend: str = "xla") -> torch.Tensor:
    """``backend`` "flash" (K4/K5, with in-kernel dropout seeded from
    torch's default generator) or "xla" (plain)."""
    if backend == "flash":
        return flash_attention(q, k, v, mask=mask, causal=causal, scale=scale, dropout=dropout)
    if backend != "xla":
        raise ValueError(f"unknown attention backend {backend!r}")
    if dropout > 0.0:
        raise NotImplementedError(
            "dropout on the plain attention route is not ported yet (ROADMAP Queue 1, "
            "conditional training): its keep mask comes from jax.random in the JAX package"
        )
    return attend_plain(q, k, v, mask=mask, causal=causal, scale=scale)
