"""Monotonic alignment search (twin of `maximum_path` in
`naturalspeech2_tpu/ops/mas.py`): a dynamic program over mel frames, a
loop on the device parallel over the batch and the phonemes, then a
backtrack loop over the frames in reverse.

The rules are the JAX package's: a phoneme stays rather than advances on
a tie (``v1 >= v0``), the direction outside the mask is "stay", the
backtrack starts at phoneme ``text_len − 1``, and the path is zeroed
outside the mask. An index the backtrack drives below 0 (fewer frames
than phonemes) is read as JAX reads it: wrapped once, then clamped.
"""

from __future__ import annotations

import torch

NEG = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """value, mask ``[b, t_x, t_y]`` (mask 1 inside text_len × mel_len) →
    the best monotonic 0/1 path of the same shape, each frame inside the
    mask assigned one phoneme."""
    value = value * mask
    b, t_x, t_y = value.shape
    device = value.device
    x_range = torch.arange(t_x, device=device)[None, :]
    v = torch.zeros(b, t_x, dtype=torch.float32, device=device)
    neg = torch.full((b, 1), NEG, dtype=torch.float32, device=device)
    stays = []
    for j in range(t_y):
        v0 = torch.cat([neg, v[:, :-1]], dim=1)  # from phoneme i − 1
        stay = v >= v0
        stays.append(stay)
        v = torch.where(x_range <= j, torch.where(stay, v, v0) + value[:, :, j], NEG)
    direction = torch.where(mask > 0, torch.stack(stays, dim=-1), True).to(torch.int64)

    index = mask[:, :, 0].sum(dim=1).to(torch.int64) - 1
    batch = torch.arange(b, device=device)
    rows = []
    for j in range(t_y - 1, -1, -1):
        rows.append(index)
        read = torch.where(index < 0, index + t_x, index).clamp(0, t_x - 1)
        index = index + direction[batch, read, j] - 1
    idx = torch.stack(rows[::-1], dim=-1)  # [b, t_y]
    path = (idx[:, None, :] == x_range[:, :, None]).to(value.dtype)
    return path * mask.to(path.dtype)
