"""Phoneme-to-frame alignment (twins of `AlignerNet`, `Aligner`,
`ForwardSumLoss` and `BinLoss` in `naturalspeech2_tpu/models/aligner.py`):
conv key and query projections and soft attention by negative euclidean
distance; the hard alignment by monotonic alignment search
(`ops/mas.py`); the CTC forward-sum loss (`ops/ctc.py`) and the
binarization loss, sign-corrected as in the JAX package."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import promoted_conv1d
from naturalspeech2_tpu_torch.ops.ctc import forward_sum_loss
from naturalspeech2_tpu_torch.ops.mas import maximum_path
from naturalspeech2_tpu_torch.utils.helpers import promoted

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
        k = F.relu(promoted_conv1d(self.key_conv1, keys.transpose(1, 2)))
        k = promoted_conv1d(self.key_conv2, k).transpose(1, 2)
        q = F.relu(promoted_conv1d(self.query_conv1, queries.transpose(1, 2)))
        q = F.relu(promoted_conv1d(self.query_conv2, q))
        q = promoted_conv1d(self.query_conv3, q).transpose(1, 2)
        qk = torch.einsum("byc,bxc->byx", *promoted(q, k))
        d2 = (q**2).sum(-1, keepdim=True) - 2.0 * qk + (k**2).sum(-1)[:, None, :]
        attn_logp = -torch.sqrt(d2.clamp(min=1e-12))[:, None]
        if mask is not None:
            attn_logp = torch.where(mask[:, None, None, :], attn_logp, NEG)
        return torch.softmax(attn_logp, dim=-1), attn_logp


class Aligner(nn.Module):
    """`AlignerNet` (as ``aligner``) plus monotonic alignment search."""

    def __init__(self, dim_in: int, dim_hidden: int, attn_channels: int = 80):
        super().__init__()
        self.aligner = AlignerNet(dim_in, dim_hidden, attn_channels)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor, y: torch.Tensor,
                y_mask: torch.Tensor):
        """Phoneme encodings ``x`` [b, t_x, dim_hidden] and mel ``y`` [b,
        dim_in, t_y] with their masks → ``(durations [b, t_x] int32, soft
        [b, t_x, t_y], log-scores [b, 1, t_y, t_x], hard path [b, t_x,
        t_y])``; the path carries no gradient."""
        attn_soft, attn_logp = self.aligner(y.transpose(1, 2), x, x_mask)
        attn_mask = (x_mask[:, :, None] & y_mask[:, None, :]).to(attn_soft.dtype)
        soft = attn_soft[:, 0].transpose(1, 2)
        path = maximum_path(soft.detach(), attn_mask)
        return path.sum(dim=-1).to(torch.int32), soft, attn_logp, path


class ForwardSumLoss(nn.Module):
    def __init__(self, blank_logprob: float = -1.0):
        super().__init__()
        self.blank_logprob = blank_logprob

    def forward(self, attn_logprob, key_lens, query_lens):
        return forward_sum_loss(attn_logprob, key_lens, query_lens, self.blank_logprob)


class BinLoss(nn.Module):
    def forward(self, attn_hard: torch.Tensor, attn_logprob: torch.Tensor,
                key_lens: torch.Tensor) -> torch.Tensor:
        """−Σ hard · log_softmax(log-scores) / b, with the hard path [b, t_x,
        t_y], log-scores [b, 1, t_y, t_x] and keys past ``key_lens`` at
        −1e9."""
        logp = attn_logprob[:, 0]
        key_idx = torch.arange(logp.shape[-1], device=logp.device)[None, None, :]
        logp = torch.where(key_idx > key_lens[:, None, None], NEG, logp)
        logp = torch.log_softmax(logp, dim=-1)
        return -(attn_hard.transpose(1, 2) * logp).sum() / attn_logprob.shape[0]
