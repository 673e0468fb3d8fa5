"""The aligner's network (twin of `AlignerNet` in
`naturalspeech2_tpu/models/aligner.py`): conv key and query projections
and soft attention by negative euclidean distance. Monotonic alignment
search, the forward-sum and binarization losses belong to conditional
training (ROADMAP Queue 1, item 13)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NEG = -1e9


class AlignerNet(nn.Module):
    """Keys: Conv(k3)→ReLU→Conv(k1); queries: Conv(k3)→ReLU→Conv(k1)→ReLU→
    Conv(k1). Inputs channels-last: queries [b, t_y, dim_in] (mel frames),
    keys [b, t_x, dim_hidden] (phoneme encodings)."""

    def __init__(self, dim_in: int = 80, dim_hidden: int = 512, attn_channels: int = 80):
        super().__init__()
        self.key_conv1 = nn.Conv1d(dim_hidden, dim_hidden * 2, 3, padding=1)
        self.key_conv2 = nn.Conv1d(dim_hidden * 2, attn_channels, 1)
        self.query_conv1 = nn.Conv1d(dim_in, dim_in * 2, 3, padding=1)
        self.query_conv2 = nn.Conv1d(dim_in * 2, dim_in, 1)
        self.query_conv3 = nn.Conv1d(dim_in, attn_channels, 1)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(attn, attn_logp)``, both ``[b, 1, t_y, t_x]``; ``mask``
        ``[b, t_x]`` sets masked keys' log-probabilities to −1e9."""
        k = self.key_conv2(F.relu(self.key_conv1(keys.transpose(1, 2)))).transpose(1, 2)
        q = F.relu(self.query_conv2(F.relu(self.query_conv1(queries.transpose(1, 2)))))
        q = self.query_conv3(q).transpose(1, 2)
        d2 = ((q**2).sum(-1, keepdim=True) - 2.0 * torch.einsum("byc,bxc->byx", q, k)
              + (k**2).sum(-1)[:, None, :])
        attn_logp = -torch.sqrt(d2.clamp(min=1e-12))[:, None]
        if mask is not None:
            attn_logp = torch.where(mask[:, None, None, :], attn_logp, NEG)
        return torch.softmax(attn_logp, dim=-1), attn_logp
