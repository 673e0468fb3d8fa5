"""Forward-sum (CTC) alignment loss (twin of `forward_sum_loss` in
`naturalspeech2_tpu/ops/ctc.py`).

The aligner's log-scores over phonemes are CTC emissions with a blank
class (log-score −1) prepended; the targets are phonemes 1 … key_len, in
order. The CTC forward recursion is `optax.ctc_loss`'s, written out as a
loop over frames on the device: log-softmax over the classes, log(0) as
``LOG_EPSILON`` = −1e5 rather than −inf, padded frames carried over
unchanged. So an infeasible alignment (fewer frames than phonemes) costs a
large finite amount, ≈ 1e5 per missing step, as in the JAX package, whose
`zero_infinity`-style filter lets it through; `F.ctc_loss(zero_infinity=
True)` would give 0 there instead.
"""

from __future__ import annotations

import torch

NEG = -1e9
LOG_EPSILON = -1e5


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             label_lens: torch.Tensor) -> torch.Tensor:
    """Per-example CTC negative log-likelihood ``[b]`` of the labels
    1 … label_len (class 0 the blank) under ``logits`` [b, t, K + 1], with
    ``logit_paddings`` [b, t] 1 on padded frames. The labels never repeat,
    so every emit-to-emit move skips no blank."""
    b, t, classes = logits.shape
    n = classes - 1
    logprobs = torch.log_softmax(logits, dim=-1)
    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=logits.dtype, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), LOG_EPSILON, dtype=logits.dtype, device=logits.device)
    pads = logit_paddings.to(torch.bool)
    for f in range(t):
        lp_emit, lp_phi, pad = logprobs[:, f, 1:], logprobs[:, f, :1], pads[:, f, None]
        # emit-to-blank epsilon move
        phi_in = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], emit)], dim=-1)
        next_emit = torch.logaddexp(phi_in[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = phi_in + lp_phi
        # emit-to-blank by a blank emission: only before a repeated label, so never
        next_phi = torch.cat([next_phi[:, :1],
                              torch.logaddexp(next_phi[:, 1:], emit + lp_phi + LOG_EPSILON)],
                             dim=-1)
        emit = torch.where(pad, emit, next_emit)
        phi = torch.where(pad, phi, next_phi)
    last = torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], emit)], dim=-1)
    return -last.gather(1, label_lens.to(torch.int64).clamp(0, n)[:, None])[:, 0]


def forward_sum_loss(attn_logprob: torch.Tensor, key_lens: torch.Tensor,
                     query_lens: torch.Tensor, blank_logprob: float = -1.0) -> torch.Tensor:
    """``attn_logprob`` [b, 1, t_frames, t_phonemes], ``key_lens`` (phonemes)
    and ``query_lens`` (frames) [b] → the batch mean of CTC NLL / max(key_len,
    1); classes past key_len are −1e9, frames past query_len padding, and a
    non-finite or ≥ 5e8 NLL counts 0."""
    b, _, t_q, t_k = attn_logprob.shape
    logits = torch.nn.functional.pad(attn_logprob[:, 0], (1, 0), value=blank_logprob)
    class_idx = torch.arange(t_k + 1, device=logits.device)[None, None, :]
    logits = torch.where(class_idx > key_lens[:, None, None], NEG, logits)
    frame_idx = torch.arange(t_q, device=logits.device)[None, :]
    per_example = ctc_loss(logits, frame_idx >= query_lens[:, None], key_lens)
    per_example = torch.where(torch.isfinite(per_example) & (per_example < -NEG / 2),
                              per_example, 0.0)
    return (per_example / key_lens.clamp(min=1)).mean()
