"""Math helpers shared by the samplers (twins of
`naturalspeech2_tpu/utils/helpers.py:142-149`), and the recomputing vjp
the kernels' backward passes share."""

from __future__ import annotations

import torch


def safe_log(t: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """log with its argument clamped to ``eps``."""
    return torch.log(t.clamp(min=eps))


def safe_div(numer: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Division with the denominator clamped to 1e-10."""
    return numer / denom.clamp(min=1e-10)


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
