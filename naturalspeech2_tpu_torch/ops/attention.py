"""Attention with key-padding masks and causal masking (twin of `attend`
and `attend_xla` in `naturalspeech2_tpu/ops/attention.py`).

``backend="flash"`` runs flash attention (K4 forward, K5 backward,
``ops/flash_attention.py``); ``backend="xla"`` is plain PyTorch, as the
JAX package leaves that route to XLA. Masked logits are the finite
``NEG_INF`` on both routes. Dropout on the plain route keeps each
probability with probability 1 − p and scales it by 1/(1 − p), after the
softmax, as ``attend_xla`` does; in bf16 the logits and the softmax run in
f32 and the probabilities are rounded to v's dtype before P·V.

Both routes draw dropout for the global batch (`ops/dropout.py`): the
plain keep mask at the global [B, H, n_q, n_kv], cut to this rank's rows
and its heads ``h_offset ..`` of ``h_total``; flash attention's mask keyed
on the global row and head.
"""

from __future__ import annotations

from typing import Optional

import torch

from naturalspeech2_tpu_torch.ops.dropout import keep_mask, row_offset
from naturalspeech2_tpu_torch.ops.flash_attention import NEG_INF, flash_attention


def attend_plain(q, k, v, *, mask: Optional[torch.Tensor] = None, causal: bool = False,
                 scale: Optional[float] = None, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 keep: Optional[torch.Tensor] = None, h_offset: int = 0,
                 h_total: Optional[int] = None) -> torch.Tensor:
    """Dot-product attention over ``[b, h, n, d]``; ``mask`` ``[b, n_kv]``
    (True = attend). Causal masking keeps key j for query i where
    j ≤ i + n_kv − n_q, as ``attend_xla`` does. With ``dropout`` p > 0 the
    probabilities [b, h, n_q, n_kv] where ``keep`` is False become 0 and the
    rest are scaled by 1/(1 − p); ``keep`` defaults to uniform draws from
    ``generator`` (torch's default one if None) below 1 − p, drawn for the
    global batch and heads (`ops.dropout.keep_mask`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # the logits in f32 whatever the inputs' dtype, as `attend_xla` asks
    # for f32 results of its bf16 products (exact in f32)
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    if mask is not None:
        sim = torch.where(mask[:, None, None, :], sim, NEG_INF)
    if causal:
        i, j = sim.shape[-2:]
        visible = torch.ones((i, j), dtype=torch.bool, device=sim.device).tril(j - i)
        sim = torch.where(visible, sim, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    if dropout > 0.0:
        if keep is None:
            keep = keep_mask(attn.shape, dropout, generator, attn.device, h_offset, h_total)
        attn = torch.where(keep, attn / (1.0 - dropout), 0.0)
    return torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)


def attend(q, k, v, *, mask: Optional[torch.Tensor] = None, causal: bool = False,
           scale: Optional[float] = None, dropout: float = 0.0,
           generator: Optional[torch.Generator] = None, backend: str = "xla",
           h_offset: int = 0, h_total: Optional[int] = None) -> torch.Tensor:
    """``backend`` "flash" (K4/K5, with in-kernel dropout whose seed is
    drawn from ``generator``) or "xla" (plain, its keep mask drawn from
    ``generator``); torch's default generator if None. The heads are
    ``h_offset ..`` of ``h_total`` (default: all of them), the rows this
    rank's of the global batch."""
    if backend == "flash":
        return flash_attention(q, k, v, mask=mask, causal=causal, scale=scale, dropout=dropout,
                               generator=generator, b_offset=row_offset(q.shape[0])[0],
                               h_offset=h_offset)
    if backend != "xla":
        raise ValueError(f"unknown attention backend {backend!r}")
    return attend_plain(q, k, v, mask=mask, causal=causal, scale=scale, dropout=dropout,
                        generator=generator, h_offset=h_offset, h_total=h_total)
