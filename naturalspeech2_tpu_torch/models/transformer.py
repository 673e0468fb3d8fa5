"""Attention and transformer stacks, ``[b, n, d]`` layout (twins of
`Attention`, `Transformer` and `ConditionableTransformer` in
`naturalspeech2_tpu/models/transformer.py`).

The denoiser's adaptive transformer runs, per layer, a pre-norm
self-attention block, with ``cross_attn`` a pre-norm cross-attention block
to the prompt latents, and a pre-norm GEGLU + causal-conv feed-forward
block, all residual, with every norm's γ/β computed from the time
condition by one stacked einsum; the head is RMSNorm + a bias-free Linear.
Each block runs fused (K2, K2b, K3) where the JAX package's shape gate
takes its fused kernel, and unfused where it does not: the attention
blocks through flash attention (K4, K5 backward), the feed-forward
through tensor ops. Without a time condition (``dim_cond_mult=None``) the
layer is the plain pre-RMSNorm one, its attention on K4 / K5. The
encoders' `Transformer` is
pre-RMSNorm attention (masked, flash K4 or plain) and a plain GEGLU MLP.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from naturalspeech2_tpu_torch.models.blocks import (
    FeedForward,
    RMSNorm,
    ada_rmsnorm,
    promoted_linear,
)
from naturalspeech2_tpu_torch.ops.attention import attend
from naturalspeech2_tpu_torch.parallel.comm import tp_copy, tp_reduce
from naturalspeech2_tpu_torch.utils.helpers import promoted
from naturalspeech2_tpu_torch.ops.attn_block_kernel import (
    attn_block,
    cross_attn_block,
    fits_fused_attn_block,
    fits_fused_cross_attn_block,
)


class Attention(nn.Module):
    """Multi-head attention with the JAX Dense layouts, all without bias:
    to_q [dim, H·dh], to_kv [dim_context, 2·H·dh] (k first), to_out
    [H·dh, dim].

    ``attn(x, gamma, beta)`` is the pre-norm residual block
    ``x + attn(adaRMSNorm(x))``, with ``context=`` the cross block. It takes
    no mask, causal masking or dropout. With ``use_flash``, as the JAX
    module, it runs kernel K2 (K2b) where `fits_fused_attn_block`
    (`fits_fused_cross_attn_block`) passes; otherwise the norm, the
    projections, attention and W_o as separate ops, the attention through
    flash attention (K4/K5) if ``use_flash``, else plain PyTorch.
    ``attn(x, context=..., mask=...)`` without γ/β is that attention alone
    (no norm, no residual).
    ``cross_attn_include_queries`` prepends x to the context and left-pads
    the key mask with True, as the JAX package does.

    Under tensor parallelism (`parallel.tp.shard_model` sets ``tp``, a
    mesh) the module holds ``heads`` of its ``all_heads`` heads, from
    ``head_offset`` on: its columns of to_q, the k and v columns of its
    heads in to_kv and its rows of to_out. It runs the route the whole
    module would (the gates read no head count), on its heads, and sums
    their output over the model group (*g*, `comm.tp_reduce`); every input
    of the heads passes *f* (`comm.tp_copy`), which sums its gradient over
    the group, and the residual is added once, after *g*. Dropout draws
    the mask of its heads out of the whole module's (`ops/dropout.py`).
    """

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, *,
                 dim_context: Optional[int] = None, causal: bool = False, dropout: float = 0.0,
                 use_flash: bool = False, cross_attn_include_queries: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.all_heads, self.head_offset, self.tp = heads, 0, None
        self.causal, self.dropout, self.use_flash = causal, dropout, use_flash
        self.include_queries = cross_attn_include_queries
        inner = dim_head * heads
        dim_context = dim_context or dim
        self.to_q = nn.Parameter(torch.randn(dim, inner) / math.sqrt(dim))
        self.to_kv = nn.Parameter(torch.randn(dim_context, 2 * inner) / math.sqrt(dim_context))
        self.to_out = nn.Parameter(torch.randn(inner, dim) / math.sqrt(inner))

    def forward(self, x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                beta: Optional[torch.Tensor] = None, *, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, dh = self.heads, self.dim_head
        f, g = self._region()
        if gamma is None:
            return g(self._attend(f(x), f(context), mask))
        if mask is not None or self.causal or self.include_queries:
            raise ValueError("the pre-norm attention block takes no mask, causal masking "
                             "or queries in its context")
        # the JAX module's gates: a fused block where it would take one
        n, dim = x.shape[1:]
        # under tensor parallelism the kernel returns this rank's heads'
        # sum without x, added once after the sum over the model group
        cfg = dict(heads=h, dim_head=dh, scale=dh**-0.5, residual=self.tp is None)
        part = None
        if self.use_flash and context is None and fits_fused_attn_block(n, dim, dh):
            part = attn_block(f(x), f(gamma), f(beta), self.to_q, self.to_kv, self.to_out, **cfg)
        elif self.use_flash and context is not None and fits_fused_cross_attn_block(
                n, context.shape[1], dim, context.shape[2], dh):
            part = cross_attn_block(f(x), f(context.contiguous()), f(gamma), f(beta), self.to_q,
                                    self.to_kv, self.to_out, **cfg)
        if part is not None:
            return part if self.tp is None else x + g(part)
        return x + g(self._attend(ada_rmsnorm(f(x), f(gamma), f(beta), dim), f(context), None))

    def _region(self):
        """(*f*, *g*) of the tensor-parallel region over the model group;
        identities without tensor parallelism."""
        if self.tp is None:
            return (lambda t: t), (lambda t: t)
        return (lambda t: tp_copy(self.tp, t)), (lambda t: tp_reduce(self.tp, t))

    def _attend(self, x: torch.Tensor, context: Optional[torch.Tensor],
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        h, dh = self.heads, self.dim_head
        ctx = x if context is None else context
        if context is not None and self.include_queries:
            ctx = torch.cat([x, ctx], dim=-2)
            if mask is not None:
                mask = nn.functional.pad(mask, (x.shape[-2], 0), value=True)
        x, ctx, to_q, to_kv, to_out = promoted(x, ctx, self.to_q, self.to_kv, self.to_out)
        k, v = (ctx @ to_kv).chunk(2, dim=-1)

        def split_heads(t):
            b, n, _ = t.shape
            return t.reshape(b, n, h, dh).transpose(1, 2).contiguous()

        out = attend(
            split_heads(x @ to_q), split_heads(k), split_heads(v), mask=mask,
            causal=self.causal, scale=dh**-0.5,
            dropout=self.dropout if self.training else 0.0,
            backend="flash" if self.use_flash else "xla",
            h_offset=self.head_offset, h_total=self.all_heads,
        )
        b, _, n, _ = out.shape
        return out.transpose(1, 2).reshape(b, n, h * dh) @ to_out


class Transformer(nn.Module):
    """Pre-norm encoder: depth × [RMSNorm → attention, RMSNorm → GEGLU
    MLP], both residual; ``causal`` masks each query's later keys (flash
    attention K4's causal mask with ``use_flash``), and ``final_norm`` ends
    with an RMSNorm, as the JAX module."""

    def __init__(self, dim: int, depth: int, *, causal: bool = False, dim_head: int = 64,
                 heads: int = 8, use_flash: bool = False, dropout: float = 0.0, ff_mult: int = 4,
                 final_norm: bool = False, gelu_approximate: bool = True):
        super().__init__()
        self.attn_norm = nn.ModuleList(RMSNorm(dim) for _ in range(depth))
        self.attn = nn.ModuleList(
            Attention(dim, dim_head, heads, causal=causal, dropout=dropout, use_flash=use_flash)
            for _ in range(depth)
        )
        self.ff_norm = nn.ModuleList(RMSNorm(dim) for _ in range(depth))
        self.ff = nn.ModuleList(
            FeedForward(dim, mult=ff_mult, causal_conv=False, gelu_approximate=gelu_approximate)
            for _ in range(depth)
        )
        self.final_norm = RMSNorm(dim) if final_norm else None

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for attn_norm, attn, ff_norm, ff in zip(self.attn_norm, self.attn, self.ff_norm, self.ff):
            x = attn(attn_norm(x), mask=mask) + x
            x = ff(ff_norm(x)) + x
        return x if self.final_norm is None else self.final_norm(x)


class ConditionableTransformer(nn.Module):
    """Unrolled transformer in one of two layers, as the JAX module:

    - adaptive (``dim_cond_mult`` set, the denoiser's): per layer
      adaRMSNorm(t)→self-attn, with ``cross_attn`` adaRMSNorm(t)→cross-attn
      (context), and adaRMSNorm(t)→FF, every norm's γ/β computed from the
      time condition by one stacked einsum ordered [self, cross, ff] per
      layer; the blocks run fused (K2, K2b, K3) where the JAX gates pass;
    - plain (``dim_cond_mult=None``): per layer RMSNorm→self-attn, with
      ``cross_attn`` RMSNorm→cross-attn(context), and RMSNorm→FF, each norm
      a module of its own (``attn_norm``, ``cross_attn_norm``, ``ff_norm``);
      the attention runs unfused, on flash attention (K4 forward, K5
      backward) with ``use_flash``; ``times`` is not read.

    Every sub-block is residual; the FF has its causal conv with
    ``ff_causal_conv``; the head is RMSNorm + a bias-free Linear.
    ``use_flash=False`` turns K2, K2b, K3 and flash attention off, as in
    the JAX module: every block runs unfused, its attention in plain
    PyTorch.

    ``scan_layers`` names the JAX parameter layout only (per-layer weights
    stacked under ``layers``, which `load_jax_params` unbinds into these
    modules): PyTorch has nothing to scan, and the forward is the unrolled
    one, which the JAX package holds equal to its scanned one. ``remat``
    recomputes each layer in the backward instead of keeping its
    activations (``torch.utils.checkpoint``, the JAX module's `nn.remat`):
    the same values and gradients for less memory."""

    def __init__(
        self,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: int = 4,
        ff_causal_conv: bool = True,
        dim_cond_mult: Optional[int] = 4,
        cross_attn: bool = False,
        use_flash: bool = True,
        scan_layers: bool = False,
        gelu_approximate: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.dim, self.depth, self.scan_layers = dim, depth, scan_layers
        self.has_cross_attn = cross_attn
        self.cond = dim_cond_mult is not None
        self.norms_per_layer = 3 if cross_attn else 2
        if self.cond:
            n_norms = depth * self.norms_per_layer
            dim_cond = dim * dim_cond_mult
            self.ada_norm_w = nn.Parameter(torch.zeros(n_norms, dim_cond, 2 * dim))
            self.ada_norm_b = nn.Parameter(
                torch.cat([torch.ones(n_norms, dim), torch.zeros(n_norms, dim)], dim=-1)
            )
        else:
            self.attn_norm = nn.ModuleList(RMSNorm(dim) for _ in range(depth))
            self.cross_attn_norm = nn.ModuleList(
                RMSNorm(dim) for _ in range(depth if cross_attn else 0))
            self.ff_norm = nn.ModuleList(RMSNorm(dim) for _ in range(depth))
        self.attn = nn.ModuleList(
            Attention(dim, dim_head=dim_head, heads=heads, use_flash=use_flash)
            for _ in range(depth)
        )
        self.cross_attn = nn.ModuleList(
            Attention(dim, dim_head=dim_head, heads=heads, use_flash=use_flash)
            for _ in range(depth if cross_attn else 0)
        )
        self.ff = nn.ModuleList(
            FeedForward(dim, mult=ff_mult, causal_conv=ff_causal_conv,
                        gelu_approximate=gelu_approximate, use_fused=use_flash)
            for _ in range(depth)
        )
        self.pred_norm = RMSNorm(dim)
        self.to_pred = nn.Linear(dim, dim, bias=False)

    def forward(self, x: torch.Tensor, times: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (context is not None) != self.has_cross_attn:
            raise ValueError("a context is needed exactly when cross_attn=True")
        gammas = betas = None
        if self.cond:
            if times is None:
                raise ValueError("the adaptive transformer needs times")
            d = self.dim
            times, ada_w, ada_b = promoted(times, self.ada_norm_w, self.ada_norm_b)
            ada = torch.einsum("bt,ntc->bnc", times, ada_w) + ada_b
            gammas = ada[..., :d].transpose(0, 1).contiguous()  # [n_norms, b, d]
            betas = ada[..., d:].transpose(0, 1).contiguous()
        x = x.contiguous()
        for i in range(self.depth):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self._layer, i, x, gammas, betas, context, use_reentrant=False)
            else:
                x = self._layer(i, x, gammas, betas, context)
        return promoted_linear(self.to_pred, self.pred_norm(x))

    def _layer(self, i: int, x, gammas, betas, context):
        if not self.cond:
            x = self.attn[i](self.attn_norm[i](x)) + x
            if context is not None:
                x = self.cross_attn[i](self.cross_attn_norm[i](x), context=context) + x
            return self.ff[i](self.ff_norm[i](x)) + x
        base = i * self.norms_per_layer
        x = self.attn[i](x, gammas[base], betas[base])
        if context is not None:
            x = self.cross_attn[i](x, gammas[base + 1], betas[base + 1], context=context)
        last = base + self.norms_per_layer - 1
        return self.ff[i](x, gammas[last], betas[last])
