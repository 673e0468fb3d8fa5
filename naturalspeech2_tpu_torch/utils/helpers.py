"""Mask and length helpers of the conditioning stack, the CFG drop mask
and the duration average of training, and math helpers of the samplers
(twins of `naturalspeech2_tpu/utils/helpers.py:19-158`), the recomputing
vjp the kernels' backward passes share, and the promotion of mixed
operands that AMP training meets."""

from __future__ import annotations

from typing import Any

import torch


def exists(x: Any) -> bool:
    return x is not None


def default(val, d):
    """``val``, or ``d`` (called, if callable) when ``val`` is None."""
    if exists(val):
        return val
    return d() if callable(d) else d


def divisible_by(num: int, den: int) -> bool:
    return (num % den) == 0


def identity(t, *args, **kwargs):
    return t


def create_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean key-padding mask ``[b, max_len]``: True where position < length."""
    seq = torch.arange(max_len, dtype=lengths.dtype, device=lengths.device)
    return seq[None, :] < lengths[:, None]


def lengths_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """The number of True entries of each row of a ``[b, n]`` mask."""
    return mask.sum(dim=-1)


def pad_or_curtail_to_length(t: torch.Tensor, length: int, axis: int = 1) -> torch.Tensor:
    """Pad ``t`` with zeros at the end of ``axis``, or slice it, to ``length``."""
    axis = axis % t.ndim
    cur = t.shape[axis]
    if cur >= length:
        return t.narrow(axis, 0, length)
    pad = [0, 0] * (t.ndim - axis)  # F.pad lists the last axis first
    pad[-1] = length - cur
    return torch.nn.functional.pad(t, pad)


def generate_mask_from_repeats(repeats: torch.Tensor, max_length: int) -> torch.Tensor:
    """Integer durations ``[b, t_x]`` → boolean alignment ``[b, t_x,
    max_length]``: row i is True on the frames of phoneme i; frames past
    the total length stay False. Float durations are truncated, as JAX's
    ``astype(int32)`` does."""
    repeats = repeats.to(torch.int32)
    lengths = repeats.sum(dim=-1)
    cumsum = torch.cumsum(repeats, dim=-1, dtype=torch.int32)
    cumsum_exclusive = cumsum - repeats
    seq = torch.arange(max_length, dtype=torch.int32, device=repeats.device)[None, None, :]
    return ((seq < cumsum[..., None]) & (seq >= cumsum_exclusive[..., None])
            & (seq < lengths[:, None, None]))


def safe_log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """log with its argument clamped to ``eps``."""
    return torch.log(t.clamp(min=eps))


def safe_div(numer: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Division with the denominator clamped to 1e-10."""
    return numer / denom.clamp(min=1e-10)


def right_pad_dims_to(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` with singleton axes appended until it has ``x.ndim`` axes."""
    padding_dims = x.ndim - t.ndim
    if padding_dims <= 0:
        return t
    return t.reshape(t.shape + (1,) * padding_dims)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and widened back to f32: a rounding point of
    the JAX kernels' bf16 path (``.astype(mm)`` before a product)."""
    return t.to(torch.bfloat16).float()


def promoted(*tensors):
    """The tensors (None passes through) at their promoted float dtype, as
    JAX promotes mixed operands of a product: f32 activations against the
    bf16 weight copies of AMP training run in f32 on the weights' values."""
    dtypes = [t.dtype for t in tensors if t is not None]
    dtype = dtypes[0]
    for other in dtypes[1:]:
        dtype = torch.promote_types(dtype, other)
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def vjp(fn, primals, needs_grad, cotangent: torch.Tensor) -> tuple:
    """Gradients of ``fn(*primals)`` against ``cotangent`` for the primals
    flagged in ``needs_grad`` (None for the others), recomputing ``fn``
    under autograd: the backward of a kernel whose JAX twin is
    differentiated as the vjp of its XLA version."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(need) for p, need in zip(primals, needs_grad)]
        out = fn(*leaves)
    wanted = [leaf for leaf in leaves if leaf.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, cotangent.contiguous()) if wanted else ())
    return tuple(next(grads) if leaf.requires_grad else None for leaf in leaves)


def prob_mask_like(shape, prob: float, generator=None, device=None) -> torch.Tensor:
    """Boolean mask, True with probability ``prob`` (uniform draws from
    ``generator``, or torch's default one, below ``prob``): the
    classifier-free-guidance drop of training."""
    return torch.rand(tuple(shape), generator=generator, device=device) < prob


def average_over_durations(values: torch.Tensor, durs: torch.Tensor) -> torch.Tensor:
    """Frame values ``[b, 1, t]`` (pitch) averaged over each phoneme's
    frames given integer durations ``durs`` ``[b, t_x]``: ``[b, 1, t_x]``.
    Zero values count as missing; a segment without any (or of duration 0)
    gives 0. Segments are read off cumulative sums with a leading zero."""
    ends = torch.cumsum(durs, dim=1).to(torch.int64)
    starts = torch.nn.functional.pad(ends[:, :-1], (1, 0))
    t = values.shape[-1]
    nonzero = torch.where(values != 0.0, 1.0, 0.0).to(values.dtype)
    values_cums = torch.nn.functional.pad(torch.cumsum(values, dim=-1), (1, 0))
    cnt_cums = torch.nn.functional.pad(torch.cumsum(nonzero, dim=-1), (1, 0))
    idx_end, idx_start = ends.clamp(0, t)[:, None, :], starts.clamp(0, t)[:, None, :]
    sums = values_cums.gather(-1, idx_end) - values_cums.gather(-1, idx_start)
    cnts = cnt_cums.gather(-1, idx_end) - cnt_cums.gather(-1, idx_start)
    return torch.where(cnts > 0, sums / cnts.clamp(min=1.0), 0.0)
