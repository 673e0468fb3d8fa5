"""K2 and K2b: the fused pre-norm self- and cross-attention blocks (twins
of `naturalspeech2_tpu/ops/attn_block_kernel.py`).

    y = x + Σ_h softmax(q_h k_hᵀ · scale) v_h · W_o,h
    q, k, v = n(x) · W_{q,k,v},   n(x) = x / max(‖x‖, 1e-12) · √d · γ + β

K2b, ``cross_attn_block``, takes k and v from an unnormalised context
instead: k, v = ctx · W_{k,v}. It runs ``csrc/cross_attn_block.cu`` on CUDA
tensors and ``cross_attn_block_torch`` on CPU tensors; as
`_cross_fused_bwd` in the JAX package, its backward is the vjp of the
plain version.

``attn_block`` takes the Dense layouts of the `Attention` module and runs
the CUDA kernels of ``csrc/attn_block.cu`` on CUDA tensors and the plain
version ``attn_block_torch`` on CPU tensors. It is differentiable: its
backward, as `_fused_bwd` in the JAX package, is the vjp of
``attn_block_flash``, which recomputes the norm and the projections with
tensor ops and runs the attention core through flash attention (forward
K4, backward K5).

``fits_fused_attn_block`` and ``fits_fused_cross_attn_block`` are the JAX
package's shape gates, which `Attention` consults before it takes a block.
"""

from __future__ import annotations

import math

import torch

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.ops.flash_attention import FlashAttention
from naturalspeech2_tpu_torch.utils.helpers import vjp

# The JAX package's budget for its fused attention blocks
# (`VMEM_BUDGET_BYTES` of `naturalspeech2_tpu/ops/attn_block_kernel.py`).
VMEM_BUDGET_BYTES = 40 * 2**20


def _vmem_bytes(n: int, dm: int, dh: int) -> int:
    """The JAX package's footprint estimate of its fused self block."""
    dh_pad = max(dh, 128)
    return 4 * (4 * n * dm + n * n + 3 * n * dh_pad + 4 * dm * dh_pad + n)


def fits_fused_attn_block(n: int, dm: int, dh: int) -> bool:
    """Whether the self-attention block runs fused (K2) at sequence length
    ``n``, model width ``dm`` and head width ``dh``.

    This is the reference's routing rule (the JAX package's
    `fits_fused_attn_block`, its integer arithmetic unchanged), kept so that
    the port runs the reference's route at every shape. It is not a limit
    of the card: past it the port runs the unfused block (norm, projections,
    flash attention K4, W_o, residual), as the JAX package does."""
    return n % 8 == 0 and _vmem_bytes(n, dm, dh) <= VMEM_BUDGET_BYTES


def _cross_vmem_bytes(n: int, m: int, dm: int, dc: int, dh: int) -> int:
    """The JAX package's footprint estimate of its fused cross block."""
    dh_pad = max(dh, 128)
    return 4 * (4 * n * dm + m * dc + n * m + n * dh_pad + 2 * m * dh_pad
                + 2 * dm * dh_pad + 2 * dc * dh_pad + n)


def fits_fused_cross_attn_block(n: int, m: int, dm: int, dc: int, dh: int) -> bool:
    """Whether the cross-attention block to an ``m``-long, ``dc``-wide
    context runs fused (K2b).

    This is the reference's routing rule (the JAX package's
    `fits_fused_cross_attn_block`, its integer arithmetic unchanged), kept
    so that the port runs the reference's route at every shape. It is not a
    limit of the card: past it the port runs the unfused block through
    flash attention K4, as the JAX package does."""
    return n % 8 == 0 and m % 8 == 0 and _cross_vmem_bytes(n, m, dm, dc, dh) <= VMEM_BUDGET_BYTES


def attn_block_torch(x, gamma, beta, wq, wk, wv, wo, *, scale: float):
    """Plain PyTorch version, the twin of ``attn_block_xla``.

    x: [b, n, dm]; gamma/beta: [b, dm]; wq/wk/wv: [H, dm, dh]; wo: [H, dh, dm].
    """
    dm = x.shape[-1]
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    xn = x / norm.clamp(min=1e-12) * math.sqrt(dm)
    xn = xn * gamma[:, None, :] + beta[:, None, :]
    q = torch.einsum("bnd,hdk->bhnk", xn, wq)
    k = torch.einsum("bnd,hdk->bhnk", xn, wk)
    v = torch.einsum("bnd,hdk->bhnk", xn, wv)
    s = torch.einsum("bhik,bhjk->bhij", q, k) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bhjk->bhik", p, v)
    return x + torch.einsum("bhnk,hkd->bnd", o, wo)


def split_heads(wq, wkv, wo, heads: int, dim_head: int):
    """Dense layouts → per-head layouts, as ``fused_attn_block`` and
    ``fused_cross_attn_block`` do: wq [dm, H·dh] → [H, dm, dh]; wkv
    [dc, 2·H·dh] splits k first, v second, each → [H, dc, dh]; wo [H·dh,
    dm] → [H, dh, dm]."""
    wk, wv = wkv.chunk(2, dim=-1)
    to_heads = lambda w: w.reshape(w.shape[0], heads, dim_head).permute(1, 0, 2)  # noqa: E731
    return to_heads(wq), to_heads(wk), to_heads(wv), wo.reshape(heads, dim_head, wq.shape[0])


def attn_block_flash(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float):
    """The block with its attention core through flash attention (K4
    forward, K5 backward on a card), the twin of `_attn_core_flash` (Dense
    layouts, as ``attn_block`` takes them): K2's backward."""
    b, n, dm = x.shape
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    xn = x / norm.clamp(min=1e-12) * math.sqrt(dm)
    xn = xn * gamma[:, None, :] + beta[:, None, :]

    def to_heads(t):
        return t.reshape(b, n, heads, dim_head).transpose(1, 2).contiguous()

    k, v = (xn @ wkv).chunk(2, dim=-1)
    o = FlashAttention.apply(to_heads(xn @ wq), to_heads(k), to_heads(v), None, None, False,
                             float(scale), 0.0)
    return x + o.transpose(1, 2).reshape(b, n, heads * dim_head) @ wo


def _forward(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float):
    if x.device.type == "cpu":
        wq_h, wk_h, wv_h, wo_h = split_heads(wq, wkv, wo, heads, dim_head)
        return attn_block_torch(x, gamma, beta, wq_h, wk_h, wv_h, wo_h, scale=scale)
    _build.require_cuda_f32(
        "attn_block", x=x, gamma=gamma, beta=beta, wq=wq, wkv=wkv, wo=wo
    )
    b, n, dm = x.shape
    hd = heads * dim_head
    _build.require_shapes(
        "attn_block", gamma=(gamma, (b, dm)), beta=(beta, (b, dm)), wq=(wq, (dm, hd)),
        wkv=(wkv, (dm, 2 * hd)), wo=(wo, (hd, dm)),
    )
    if dim_head != 64 or dm not in (128, 512):
        raise ValueError(
            f"attn_block: the CUDA kernel takes dim_head 64 and dim 128 or 512, got {dim_head}, {dm}"
        )
    wqkv = torch.cat([wq, wkv], dim=-1)  # [dm, 3·H·dh]: q, then k, then v
    qkv = torch.empty((3, b, heads, n, dim_head), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _build.library().ns2_attn_block(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(), wo.data_ptr(),
        qkv.data_ptr(), out.data_ptr(), b, n, dm, heads, dim_head, float(scale),
        _build.stream(x),
    )
    _build.check(err, "ns2_attn_block")
    attn_block.launches += 1
    return out


class _AttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, wq, wkv, wo, heads, dim_head, scale):
        ctx.save_for_backward(x, gamma, beta, wq, wkv, wo)
        ctx.cfg = dict(heads=heads, dim_head=dim_head, scale=scale)
        return _forward(x, gamma, beta, wq, wkv, wo, **ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        grads = vjp(lambda *a: attn_block_flash(*a, **ctx.cfg), ctx.saved_tensors,
                    ctx.needs_input_grad[:6], g)
        return (*grads, None, None, None)


def attn_block(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float):
    """``x + W_o·attn(adaRMSNorm(x)·W_{q,k,v})``, differentiable.

    x: [b, n, dm]; gamma/beta: [b, dm]; wq: [dm, H·dh]; wkv: [dm, 2·H·dh];
    wo: [H·dh, dm]. CUDA tensors run the kernel (two launches, counted as
    one launch of K2); CPU tensors run the plain version.
    """
    return _AttnBlock.apply(x, gamma, beta, wq, wkv, wo, heads, dim_head, float(scale))


attn_block.launches = 0


def cross_attn_block_torch(x, ctx, gamma, beta, wq, wk, wv, wo, *, scale: float):
    """Plain PyTorch version of K2b, the twin of ``cross_attn_block_xla``.

    x: [b, n, dm]; ctx: [b, m, dc] (not normalised); gamma/beta: [b, dm];
    wq: [H, dm, dh]; wk/wv: [H, dc, dh]; wo: [H, dh, dm].
    """
    dm = x.shape[-1]
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    xn = x / norm.clamp(min=1e-12) * math.sqrt(dm)
    xn = xn * gamma[:, None, :] + beta[:, None, :]
    q = torch.einsum("bnd,hdk->bhnk", xn, wq)
    k = torch.einsum("bmd,hdk->bhmk", ctx, wk)
    v = torch.einsum("bmd,hdk->bhmk", ctx, wv)
    s = torch.einsum("bhik,bhjk->bhij", q, k) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bhjk->bhik", p, v)
    return x + torch.einsum("bhnk,hkd->bnd", o, wo)


def _cross_plain(x, ctx, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float):
    """``cross_attn_block_torch`` on the Dense layouts."""
    return cross_attn_block_torch(x, ctx, gamma, beta, *split_heads(wq, wkv, wo, heads, dim_head),
                                  scale=scale)


def _cross_forward(x, ctx, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float):
    if x.device.type == "cpu":
        return _cross_plain(x, ctx, gamma, beta, wq, wkv, wo, heads=heads, dim_head=dim_head,
                            scale=scale)
    _build.require_cuda_f32(
        "cross_attn_block", x=x, ctx=ctx, gamma=gamma, beta=beta, wq=wq, wkv=wkv, wo=wo
    )
    b, n, dm = x.shape
    m, dc = ctx.shape[1:]
    hd = heads * dim_head
    _build.require_shapes(
        "cross_attn_block", ctx=(ctx, (b, m, dc)), gamma=(gamma, (b, dm)), beta=(beta, (b, dm)),
        wq=(wq, (dm, hd)), wkv=(wkv, (dc, 2 * hd)), wo=(wo, (hd, dm)),
    )
    if dim_head != 64 or dm != 128 or dc != 128:
        raise ValueError(
            "cross_attn_block: the CUDA kernel takes dim_head 64 and model and context width "
            f"128, got {dim_head}, {dm}, {dc}"
        )
    if m < 1:
        raise ValueError("cross_attn_block: the context is empty")
    kv = torch.empty((2, b, heads, m, dim_head), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    err = _build.library().ns2_cross_attn_block(
        x.data_ptr(), ctx.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wq.data_ptr(),
        wkv.data_ptr(), wo.data_ptr(), kv.data_ptr(), out.data_ptr(), b, n, m, dm, dc, heads,
        dim_head, float(scale), _build.stream(x),
    )
    _build.check(err, "ns2_cross_attn_block")
    cross_attn_block.launches += 1
    return out


class _CrossAttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, gamma, beta, wq, wkv, wo, heads, dim_head, scale):
        ctx_.save_for_backward(x, ctx, gamma, beta, wq, wkv, wo)
        ctx_.cfg = dict(heads=heads, dim_head=dim_head, scale=scale)
        return _cross_forward(x, ctx, gamma, beta, wq, wkv, wo, **ctx_.cfg)

    @staticmethod
    def backward(ctx_, g):
        grads = vjp(lambda *a: _cross_plain(*a, **ctx_.cfg), ctx_.saved_tensors,
                    ctx_.needs_input_grad[:7], g)
        return (*grads, None, None, None)


def cross_attn_block(x, ctx, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int,
                     scale: float):
    """K2b: ``x + W_o·attn(adaRMSNorm(x)·W_q, ctx·W_k, ctx·W_v)``,
    differentiable.

    x: [b, n, dm]; ctx: [b, m, dc]; gamma/beta: [b, dm]; wq: [dm, H·dh];
    wkv: [dc, 2·H·dh] (k first); wo: [H·dh, dm]. CUDA tensors run the
    kernel (two launches, counted as one launch of K2b); CPU tensors run
    the plain version.
    """
    return _CrossAttnBlock.apply(x, ctx, gamma, beta, wq, wkv, wo, heads, dim_head, float(scale))


cross_attn_block.launches = 0
