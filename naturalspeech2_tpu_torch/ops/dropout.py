"""Dropout drawn for the global batch.

JAX draws every dropout mask over the global array, whatever part of it a
device holds. Here a rank holds some rows of each global batch (a data
mesh) and, under tensor parallelism, some heads of each attention: it
draws each mask at the global shape from a generator that is the same on
every rank, and keeps its rows and heads. A mesh step then draws exactly
the masks of the one-process step at the same global batch, and the
ranks of one model group, which hold the same rows, draw the same masks
for their replicated modules.

`batch_rows(index, count)` says, for the draws made inside it, that the
batch is block ``index`` of ``count`` equal row blocks (the trainer enters
it with the mesh's data index and size); outside it, every batch is the
whole one. With one block and every head, `dropout` is ``F.dropout`` and
`keep_mask` one ``torch.rand`` draw, as before: the draws of one process
are unchanged.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_ROWS = (0, 1)  # (this rank's block, the number of blocks) of every batch


@contextmanager
def batch_rows(index: int, count: int):
    """Within, a batch of b rows is rows ``index·b .. (index + 1)·b`` of
    a global batch of ``count·b``."""
    global _ROWS
    if not 0 <= index < count:
        raise ValueError(f"row block {index} of {count}")
    saved, _ROWS = _ROWS, (index, count)
    try:
        yield
    finally:
        _ROWS = saved


def row_offset(b: int) -> tuple:
    """(the global row of this batch's row 0, the global batch size) for a
    batch of ``b`` rows."""
    index, count = _ROWS
    return index * b, count * b


def _global_like(x: torch.Tensor, total: int, fill) -> torch.Tensor:
    """A tensor of x's shape with ``total`` rows, laid out in memory as x is
    (``F.dropout`` draws its mask into ``empty_like(x)``, whose elements it
    fills in memory order), filled by ``fill`` (a factory such as
    ``torch.empty``)."""
    order = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
    shape = [total if d == 0 else x.shape[d] for d in order]
    back = [order.index(d) for d in range(x.dim())]
    return fill(shape, dtype=x.dtype, device=x.device).permute(back)


def dropout(x: torch.Tensor, p: float, training: bool = True) -> torch.Tensor:
    """``F.dropout(x, p, training)`` with the mask drawn for the global
    batch and this rank's rows kept. The mask is ``F.dropout``'s own, drawn
    for a global tensor laid out in memory as x is: on the CPU a
    Bernoulli(1 − p) draw divided by 1 − p; on a card a keep mask from
    ``F.dropout`` on ones, applied as the card's kernel applies its own,
    (x · keep) · 1/(1 − p) in f32."""
    if not training or p == 0.0:
        return x
    first, total = row_offset(x.shape[0])
    if total == x.shape[0]:
        return F.dropout(x, p, True)
    rows = slice(first, first + x.shape[0])
    if x.device.type == "cpu":
        noise = _global_like(x, total, torch.empty).bernoulli_(1.0 - p)
        noise.div_(1.0 - p)
        return x * noise[rows]
    keep = F.dropout(_global_like(x, total, torch.ones), p, True)[rows] != 0
    scale = float(np.float32(1.0 / float(np.float32(1.0 - p))))
    return ((x.float() * keep) * scale).to(x.dtype)


def keep_mask(shape, p: float, generator: Optional[torch.Generator] = None, device=None,
              h_offset: int = 0, h_total: Optional[int] = None) -> torch.Tensor:
    """The keep mask [b, h, ...] of attention dropout at rate ``p``: uniform
    draws below 1 − p from ``generator`` (torch's default one if None),
    drawn at the global [B, H, ...] and cut to this rank's rows and its
    heads ``h_offset .. h_offset + h`` of ``h_total`` (default: h)."""
    b, h = shape[0], shape[1]
    first, total = row_offset(b)
    h_total = h if h_total is None else h_total
    draws = torch.rand((total, h_total, *shape[2:]), generator=generator, device=device)
    return draws[first:first + b, h_offset:h_offset + h] < 1.0 - p


class Dropout(nn.Module):
    """``nn.Dropout`` whose mask is drawn for the global batch
    (`dropout`)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.p, self.training)

    def extra_repr(self) -> str:
        return f"p={self.p}"
