"""K2: the fused pre-norm self-attention block (twin of
`naturalspeech2_tpu/ops/attn_block_kernel.py`, self-attention only).

    y = x + Σ_h softmax(q_h k_hᵀ · scale) v_h · W_o,h
    q, k, v = n(x) · W_{q,k,v},   n(x) = x / max(‖x‖, 1e-12) · √d · γ + β

``attn_block`` takes the Dense layouts of the `Attention` module and runs
the CUDA kernels of ``csrc/attn_block.cu`` on CUDA tensors and the plain
version ``attn_block_torch`` on CPU tensors. It is differentiable: its
backward, as `_fused_bwd` in the JAX package, is the vjp of
``attn_core_flash_torch``, which recomputes the norm and the projections
with plain tensor ops and runs the attention core through flash attention
(forward K4, backward K5).
"""

from __future__ import annotations

import math

import torch

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.ops.flash_attention import FlashAttention
from naturalspeech2_tpu_torch.utils.helpers import vjp


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
    """Dense layouts → per-head layouts, as ``fused_attn_block`` does:
    wq [dm, H·dh] → [H, dm, dh]; wkv [dm, 2·H·dh] splits k first, v
    second; wo [H·dh, dm] → [H, dh, dm]."""
    dm = wq.shape[0]
    wk, wv = wkv.chunk(2, dim=-1)
    to_heads = lambda w: w.reshape(dm, heads, dim_head).permute(1, 0, 2)  # noqa: E731
    return to_heads(wq), to_heads(wk), to_heads(wv), wo.reshape(heads, dim_head, dm)


def attn_core_flash_torch(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int,
                          scale: float):
    """The block with its attention core through flash attention, the twin
    of `_attn_core_flash` (Dense layouts, as ``attn_block`` takes them)."""
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
    if dim_head != 64 or dm != 128:
        raise ValueError(
            f"attn_block: the CUDA kernel takes dim_head 64 and dim 128, got {dim_head}, {dm}"
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
        grads = vjp(lambda *a: attn_core_flash_torch(*a, **ctx.cfg), ctx.saved_tensors,
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
