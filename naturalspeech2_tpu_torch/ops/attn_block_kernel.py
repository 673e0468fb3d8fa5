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

Both kernels are built the same way: the projections and W_o on a GEMM
core (in f32 the split-TF32 one), the attention core on K4. They read the
weights packed for the core (``pack_attn_weights``, ``pack_cross_weights``,
once per parameter version), each head padded with exact zeros to K4's
width (64, or a multiple of 128: ``flash_attention.kernel_head_dim``) and
dm and dc to the core's chunk; the norm keeps √dm of the real width.
``attn_block_packed_torch`` and ``cross_attn_block_packed_torch`` compute
the blocks from those layouts in plain PyTorch.

In bf16 (x bfloat16; the weights, γ, β and the context too) both run the
JAX kernels' `mm = bfloat16` path through the kernels' bf16 entry points:
the norm in f32, n(x), q, k, v, P and o rounded to bf16 before each
product, products summed in f32, the heads and the residual summed in f32
and y rounded once; ``attn_block_bf16_torch`` and
``cross_attn_block_bf16_torch`` are the plain versions, rounding point for
rounding point (the CPU route in bf16). Both blocks' bf16 projections run
the bf16 GEMM core (``csrc/gemm_bf16.cuh``, weights packed "bf16_sw128",
dm and dc padded to 64) after a norm pre-pass into the o scratch, which
holds max(H·dh, dm padded to 64) values a row (``cross_scratch`` sizes
K2b's).

Mixed (x, γ, β and the context float32, the weights bfloat16: AMP
training's denoiser) both compute the f32 block on the weights' values,
exact in f32, as the JAX kernels do with `mm = float32`: on a card through
their mixed entry points (counted in ``launches_mixed``), on the CPU the
plain f32 versions on the widened weights. Both run the bf16 GEMM core
(the weights packed "bf16_sw128"; n(x), K2b's context and K4 f32's output
o each carried as three bf16 planes, ``gemm_cache.split3``, so every
product is three exact bf16 passes; q, k, v in f32 for K4 f32;
``attn_block_planes_torch`` and ``cross_attn_block_planes_torch`` are
their models, ``attn_scratch`` and ``cross_scratch`` size their scratch).
The backward in every dtype is the vjp of a function that widens its
inputs to f32 and returns y at x's dtype, as the JAX package's twins do
(`_attn_core_flash`, `cross_attn_block_xla`), so each gradient comes back
at its input's dtype.

``residual=False`` leaves x out of y in every version, kernel and plain
alike: y = Σ_h o_h · W_o,h, the partial sum of a rank that holds some of
the heads under tensor parallelism (`parallel/tp.py`), whose sum over the
model group gets x added once; recovering it as y − x would cancel
digits. The default keeps every entry point as it was.

``fits_fused_attn_block`` and ``fits_fused_cross_attn_block`` are the JAX
package's shape gates, which `Attention` consults before it takes a block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.ops import gemm_cache
from naturalspeech2_tpu_torch.ops.ff_block_kernel import ada_norm
from naturalspeech2_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_forward_torch,
    kernel_head_dim,
)
from naturalspeech2_tpu_torch.utils.helpers import round_bf16 as _rd, vjp

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


def attn_block_torch(x, gamma, beta, wq, wk, wv, wo, *, scale: float, residual: bool = True):
    """Plain PyTorch version, the twin of ``attn_block_xla``.

    x: [b, n, dm]; gamma/beta: [b, dm]; wq/wk/wv: [H, dm, dh]; wo: [H, dh, dm].
    """
    xn = ada_norm(x, gamma, beta)
    q = torch.einsum("bnd,hdk->bhnk", xn, wq)
    k = torch.einsum("bnd,hdk->bhnk", xn, wk)
    v = torch.einsum("bnd,hdk->bhnk", xn, wv)
    s = torch.einsum("bhik,bhjk->bhij", q, k) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bhjk->bhik", p, v)
    out = torch.einsum("bhnk,hkd->bnd", o, wo)
    return x + out if residual else out


def _core_bf16(q, k, v, *, scale: float):
    """softmax(q kᵀ · scale) v as the JAX block kernels run it on bf16
    q, k, v (f32 values): logits and row statistics in f32, the globally
    normalised exp(s − m) rounded to bf16 before P·V, o = P·V / l in f32."""
    s = torch.einsum("bhik,bhjk->bhij", q, k) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return torch.einsum("bhij,bhjk->bhik", _rd(p), v) / p.sum(dim=-1, keepdim=True)


def attn_block_bf16_torch(x, gamma, beta, wq, wk, wv, wo, *, scale: float,
                          residual: bool = True):
    """Plain version of K2 in bf16, the rounding points of
    `_attn_block_kernel` at bf16 inputs (attn_block_kernel.py:100-154):
    the norm in f32 and n(x) rounded, q, k and v summed in f32 and rounded,
    the attention core as ``_core_bf16``, o rounded before W_o, the heads
    and x summed in f32 and rounded once. Layouts as ``attn_block_torch``."""
    return _block_bf16(x, None, gamma, beta, wq, wk, wv, wo, scale=scale, residual=residual)


def _block_bf16(x, ctx, gamma, beta, wq, wk, wv, wo, *, scale: float, residual: bool = True):
    """K2's bf16 plain version (``ctx`` None: k and v from n(x)) or K2b's
    (k and v from the raw ``ctx``)."""
    xf = x.float()
    xn = _rd(ada_norm(xf, gamma.float(), beta.float()))
    kv_in = xn if ctx is None else ctx.float()
    q = _rd(torch.einsum("bnd,hdk->bhnk", xn, wq.float()))
    k, v = (_rd(torch.einsum("bmd,hdk->bhmk", kv_in, w.float())) for w in (wk, wv))
    o = _core_bf16(q, k, v, scale=scale)
    out = torch.einsum("bhnk,hkd->bnd", _rd(o), wo.float())
    return (xf + out if residual else out).to(x.dtype)


def split_heads(wq, wkv, wo, heads: int, dim_head: int):
    """Dense layouts → per-head layouts, as ``fused_attn_block`` and
    ``fused_cross_attn_block`` do: wq [dm, H·dh] → [H, dm, dh]; wkv
    [dc, 2·H·dh] splits k first, v second, each → [H, dc, dh]; wo [H·dh,
    dm] → [H, dh, dm]."""
    wk, wv = wkv.chunk(2, dim=-1)
    to_heads = lambda w: w.reshape(w.shape[0], heads, dim_head).permute(1, 0, 2)  # noqa: E731
    return to_heads(wq), to_heads(wk), to_heads(wv), wo.reshape(heads, dim_head, wq.shape[0])


def attn_block_flash(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float,
                     residual: bool = True):
    """The block with its attention core through flash attention (K4
    forward, K5 backward on a card), the twin of `_attn_core_flash` (Dense
    layouts, as ``attn_block`` takes them): every input widened to f32, y
    returned at x's dtype. K2's backward."""
    b, n, _ = x.shape
    xf = x.float()
    wq, wkv, wo = wq.float(), wkv.float(), wo.float()
    xn = ada_norm(xf, gamma.float(), beta.float())

    def to_heads(t):
        return t.reshape(b, n, heads, dim_head).transpose(1, 2).contiguous()

    k, v = (xn @ wkv).chunk(2, dim=-1)
    o = FlashAttention.apply(to_heads(xn @ wq), to_heads(k), to_heads(v), None, None, False,
                             float(scale), 0.0)
    out = o.transpose(1, 2).reshape(b, n, heads * dim_head) @ wo
    return (xf + out if residual else out).to(x.dtype)


def _padded_heads(w, heads: int, dim_head: int, dh: int):
    """[rows, H·dim_head] → [rows, H, dh], each head padded with zero
    columns."""
    return F.pad(w.reshape(w.shape[0], heads, dim_head), (0, dh - dim_head))


def _pack_out(wo, heads: int, dim_head: int, dh: int, fmt: str = "split"):
    """W_o [H·dim_head, dm] as the core's packed Bᵀ [dm, H·dh], head h in
    columns h·dh .. h·dh + dim_head."""
    dm = wo.shape[1]
    out = F.pad(wo.reshape(heads, dim_head, dm), (0, 0, 0, dh - dim_head))
    return gemm_cache.pack_b(out.reshape(heads * dh, dm).T, fmt)


def pack_attn_weights(wq, wkv, wo, heads: int, dim_head: int, fmt: str = "split"):
    """(q/k/v, out): the Dense layouts in the GEMM core's format
    (``gemm_cache.pack_b`` in ``fmt``), each head padded with zeros to dh columns
    (``kernel_head_dim``). The q/k/v Bᵀ has 3·H·dh rows, row which·H·dh +
    h·dh + e = column e of head h of q, k or v; the out Bᵀ is W_oᵀ [dm,
    H·dh], head h in columns h·dh .. h·dh + dim_head."""
    dh = kernel_head_dim(dim_head)
    dm = wq.shape[0]
    wk, wv = wkv.chunk(2, dim=-1)
    qkv = torch.stack([_padded_heads(w, heads, dim_head, dh) for w in (wq, wk, wv)], dim=1)
    return (gemm_cache.pack_b(qkv.reshape(dm, 3 * heads * dh).T, fmt),
            _pack_out(wo, heads, dim_head, dh, fmt))


def pack_cross_weights(wq, wkv, wo, heads: int, dim_head: int, fmt: str = "split"):
    """(q, k/v, out): K2b's Dense layouts in the GEMM core's format, each
    head padded with zeros to dh columns (``kernel_head_dim``). The q Bᵀ
    has H·dh rows (row h·dh + e = column e of head h), the k/v Bᵀ 2·H·dh
    (k's heads, then v's), K = dc; the out Bᵀ as ``pack_attn_weights``'s."""
    dh = kernel_head_dim(dim_head)
    wk, wv = wkv.chunk(2, dim=-1)
    kv = torch.stack([_padded_heads(w, heads, dim_head, dh) for w in (wk, wv)], dim=1)
    return (gemm_cache.pack_b(_padded_heads(wq, heads, dim_head, dh).reshape(wq.shape[0], -1).T,
                              fmt),
            gemm_cache.pack_b(kv.reshape(wkv.shape[0], 2 * heads * dh).T, fmt),
            _pack_out(wo, heads, dim_head, dh, fmt))


def attn_block_packed_torch(x, gamma, beta, packed, *, heads: int, scale: float):
    """The kernel's three launches in plain PyTorch, from the packed weights:
    q/k/v at the padded head width dh in K4's layout, the attention core
    (``flash_forward_torch``), the heads' concatenation times W_o with the
    residual; the norm at the real dm. In f32 equal to ``attn_block_torch``
    up to f32 reordering, in bf16 (x, γ, β and the weights bf16, packed
    "bf16_sw128") to ``attn_block_bf16_torch``'s rounding points: the
    check of K2's padding and weight layout on the CPU."""
    b, n, dm = x.shape
    if x.dtype == torch.bfloat16:
        return _packed_bf16(x, gamma, beta, packed, heads=heads, scale=scale)
    dense = [sum(gemm_cache.unpack_b(p)) for p in packed]
    hd = dense[1].shape[1]  # H·dh: the out Bᵀ's K, a multiple of 64
    dh = hd // heads
    qkv = ada_norm(x, gamma, beta) @ dense[0][:3 * hd, :dm].T
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    o, _ = flash_forward_torch(q, k, v, None, None, causal=False, scale=scale)
    return x + o.transpose(1, 2).reshape(b, n, hd) @ dense[1][:dm, :hd].T


def _packed_bf16(x, gamma, beta, packed, *, heads: int, scale: float):
    """``attn_block_packed_torch`` in bf16: ``attn_block_bf16_torch``'s
    rounding points (n(x), q, k, v, P and o rounded, y once) on the packed
    weights (bf16 values)."""
    b, n, dm = x.shape
    xf = x.float()
    dense = [sum(gemm_cache.unpack_b(p, "bf16_sw128")).float() for p in packed]
    hd = dense[1].shape[1]
    dh = hd // heads
    xn = _rd(ada_norm(xf, gamma.float(), beta.float()))
    qkv = _rd(xn @ dense[0][:3 * hd, :dm].T)
    q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    o = _rd(_core_bf16(q, k, v, scale=scale))
    return (xf + o.transpose(1, 2).reshape(b, n, hd) @ dense[1][:dm, :hd].T).to(x.dtype)


def attn_block_planes_torch(x, gamma, beta, packed, *, heads: int, scale: float,
                            residual: bool = True):
    """The mixed entry point's launches in plain PyTorch (f32 x, γ and β
    against weights packed "bf16_sw128"): n(x) split into its three bf16
    planes, q/k/v as three-part products kept in f32 in K4's layout, the
    attention core in f32 (``flash_forward_torch``), o split into its three
    planes [b, 3·H, n, dh] (part q of head h at slice q·H + h), the heads'
    concatenation of o's parts times W_o, x added when ``residual``.
    Returns (y, the planes of n(x) [b, 3, n, dm], q/k/v [3, b, H, n, dh]
    f32, o's planes)."""
    b, n, dm = x.shape
    dense = [gemm_cache.unpack_b(p, "bf16_sw128")[0] for p in packed]
    hd = dense[1].shape[1]
    dh = hd // heads
    xn = torch.stack(gemm_cache.split3(ada_norm(x, gamma, beta)), dim=1)
    qkv = gemm_cache.parts_product(xn.unbind(1), dense[0][:3 * hd, :dm].T)
    qkv = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
    o, _ = flash_forward_torch(*qkv, None, None, causal=False, scale=scale)
    o_planes = torch.cat(gemm_cache.split3(o), dim=1)
    parts = [p.transpose(1, 2).reshape(b, n, hd) for p in o_planes.chunk(3, dim=1)]
    y = gemm_cache.parts_product(parts, dense[1][:dm, :hd].T)
    return (x + y if residual else y), xn, qkv, o_planes


def split_head_rows_at(kc: int, t0: int, bi: int, *, heads: int, dh: int):
    """The twin of the bf16 core's ``SplitHeadRows::at`` (``csrc/
    gemm_bf16.cuh``): chunk ``kc`` of the W_o product's A (K = 3·H·dh, the
    parts lo first) for the row tile from t0 of sequence bi is the box of
    64 columns from c, rows t onward, of slice ``part·H + h`` of o's planes
    [b, 3·H, n, dh]. Returns ((c, t, slice, bi), the chunk of the packed
    W_o it multiplies)."""
    per_part = heads * dh // gemm_cache.SW128_CHUNK
    p, kb = divmod(kc, per_part)
    k = kb * gemm_cache.SW128_CHUNK
    h = k // dh
    return (k - h * dh, t0, (2 - p) * heads + h, bi), kb


def attn_scratch(b: int, n: int, dm: int, heads: int, dh: int, dtype: torch.dtype, device,
                 fmt: str | None = None) -> tuple:
    """The scratch of K2's entry point at head width dh (K4's), in its
    argument order, for activations of ``dtype`` against weights packed in
    ``fmt`` (default: ``gemm_cache.fmt_of(dtype)``): qkv [3, b, H, n, dh]
    and o [b, H, n, dh] of the block's type; in bf16 o first holds n(x) at
    dm padded to 64, so it holds max(H·dh, dm padded to 64) values a row;
    for f32 activations on the bf16 core (the mixed entry) qkv and o f32,
    then bf16 planes of 3·max(H·dh, dm padded to 64) values a row (n(x)'s
    three planes, then o's)."""
    fmt = fmt or gemm_cache.fmt_of(dtype)
    qkv = torch.empty((3, b, heads, n, dh), dtype=dtype, device=device)
    row = max(heads * dh, gemm_cache.round_up(dm, gemm_cache.SW128_CHUNK))
    if fmt != "bf16_sw128":
        return qkv, torch.empty((b, heads, n, dh), dtype=dtype, device=device)
    if dtype == torch.bfloat16:
        return qkv, torch.empty(b * n * row, dtype=dtype, device=device)
    return (qkv, torch.empty((b, heads, n, dh), dtype=dtype, device=device),
            torch.empty(b * n * 3 * row, dtype=torch.bfloat16, device=device))


def _pack_checked(wq, wkv, wo, heads: int, dim_head: int, dtype: torch.dtype):
    """``pack_attn_weights`` after the wrapper's checks of the weights,
    which a cache hit then need not repeat; ``dtype`` is x's."""
    _build.require_cuda("attn_block", wq.dtype, wq=wq, wkv=wkv, wo=wo)
    dm, hd = wq.shape[0], heads * dim_head
    _build.require_shapes("attn_block", wq=(wq, (dm, hd)), wkv=(wkv, (dm, 2 * hd)),
                          wo=(wo, (hd, dm)))
    return pack_attn_weights(wq, wkv, wo, heads, dim_head,
                             gemm_cache.fmt_of(dtype, wq.dtype, "attn_block"))


def _forward(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float,
             residual: bool = True):
    if x.device.type == "cpu":
        wq_h, wk_h, wv_h, wo_h = split_heads(wq, wkv, wo, heads, dim_head)
        if x.dtype == torch.bfloat16:
            return attn_block_bf16_torch(x, gamma, beta, wq_h, wk_h, wv_h, wo_h, scale=scale,
                                         residual=residual)
        return attn_block_torch(x, gamma, beta, *(w.to(x.dtype) for w in (wq_h, wk_h, wv_h, wo_h)),
                                scale=scale, residual=residual)
    _build.require_cuda("attn_block", x.dtype, x=x, gamma=gamma, beta=beta)
    _build.suffix("attn_block", x.dtype, wq.dtype)
    b, n, dm = x.shape
    _build.require_shapes("attn_block", gamma=(gamma, (b, dm)), beta=(beta, (b, dm)))
    bt_qkv, bt_out = gemm_cache.cached(
        f"attn_block {heads} {dim_head} {x.dtype}",
        lambda *w: _pack_checked(*w, heads, dim_head, x.dtype), wq, wkv, wo)
    if wq.shape[0] != dm or wq.device != x.device:
        raise ValueError(f"attn_block: wq {tuple(wq.shape)} on {wq.device} does not take x "
                         f"{tuple(x.shape)} on {x.device}")
    state = attn_scratch(b, n, dm, heads, kernel_head_dim(dim_head), x.dtype, x.device,
                         gemm_cache.fmt_of(x.dtype, wq.dtype, "attn_block"))
    out = torch.empty_like(x)
    err = _build.entry("ns2_attn_block", x.dtype, wq.dtype)(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), bt_qkv.data_ptr(), bt_out.data_ptr(),
        *(t.data_ptr() for t in state), out.data_ptr(), b, n, dm, heads, state[0].shape[-1],
        float(scale), int(residual), _build.stream(x),
    )
    _build.check(err, "ns2_attn_block")
    _build.count(attn_block, x.dtype, wq.dtype)
    return out


class _AttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, wq, wkv, wo, heads, dim_head, scale, residual=True):
        ctx.save_for_backward(x, gamma, beta, wq, wkv, wo)
        ctx.cfg = dict(heads=heads, dim_head=dim_head, scale=scale, residual=residual)
        return _forward(x, gamma, beta, wq, wkv, wo, **ctx.cfg)

    @staticmethod
    def backward(ctx, g):
        grads = vjp(lambda *a: attn_block_flash(*a, **ctx.cfg), ctx.saved_tensors,
                    ctx.needs_input_grad[:6], g)
        return (*grads, None, None, None, None)


def attn_block(x, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float,
               residual: bool = True):
    """``x + W_o·attn(adaRMSNorm(x)·W_{q,k,v})``, differentiable.

    x: [b, n, dm]; gamma/beta: [b, dm]; wq: [dm, H·dh]; wkv: [dm, 2·H·dh];
    wo: [H·dh, dm]. CUDA tensors run the kernel (three launches: q/k/v on
    the GEMM core, K4's attention core, W_o on the GEMM core; in bf16 a norm
    pre-pass first and the bf16 GEMM core; mixed the norm pre-pass, q/k/v
    on the bf16 core, K4 f32, the split of o and W_o on the bf16 core;
    counted as one launch of K2); CPU tensors run the plain version.
    ``residual=False`` returns the heads' sum alone, without x.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta, wq, wkv, wo)):
        return _AttnBlock.apply(x, gamma, beta, wq, wkv, wo, heads, dim_head, float(scale),
                                bool(residual))
    # no graph to record: the autograd Function's overhead spared
    return _forward(x, gamma, beta, wq, wkv, wo, heads=heads, dim_head=dim_head,
                    scale=float(scale), residual=bool(residual))


attn_block.launches = attn_block.launches_bf16 = attn_block.launches_mixed = 0


def cross_attn_block_torch(x, ctx, gamma, beta, wq, wk, wv, wo, *, scale: float,
                           residual: bool = True):
    """Plain PyTorch version of K2b, the twin of ``cross_attn_block_xla``.

    x: [b, n, dm]; ctx: [b, m, dc] (not normalised); gamma/beta: [b, dm];
    wq: [H, dm, dh]; wk/wv: [H, dc, dh]; wo: [H, dh, dm].
    """
    xn = ada_norm(x, gamma, beta)
    q = torch.einsum("bnd,hdk->bhnk", xn, wq)
    k = torch.einsum("bmd,hdk->bhmk", ctx, wk)
    v = torch.einsum("bmd,hdk->bhmk", ctx, wv)
    s = torch.einsum("bhik,bhjk->bhij", q, k) * scale
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhij,bhjk->bhik", p, v)
    out = torch.einsum("bhnk,hkd->bnd", o, wo)
    return x + out if residual else out


def cross_attn_block_bf16_torch(x, ctx, gamma, beta, wq, wk, wv, wo, *, scale: float,
                                residual: bool = True):
    """Plain version of K2b in bf16, the rounding points of
    `_cross_attn_block_kernel` at bf16 inputs (attn_block_kernel.py:244-292):
    as ``attn_block_bf16_torch``, with k and v from the raw context (bf16).
    Layouts as ``cross_attn_block_torch``."""
    return _block_bf16(x, ctx, gamma, beta, wq, wk, wv, wo, scale=scale, residual=residual)


def _cross_plain(x, ctx, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float,
                 residual: bool = True):
    """``cross_attn_block_torch`` (``cross_attn_block_bf16_torch`` in bf16)
    on the Dense layouts; mixed, on the weights widened to f32."""
    heads_w = split_heads(wq, wkv, wo, heads, dim_head)
    if x.dtype == torch.bfloat16:
        return cross_attn_block_bf16_torch(x, ctx, gamma, beta, *heads_w, scale=scale,
                                           residual=residual)
    return cross_attn_block_torch(x, ctx, gamma, beta, *(w.to(x.dtype) for w in heads_w),
                                  scale=scale, residual=residual)


def _cross_xla(x, *args, heads: int, dim_head: int, scale: float, residual: bool = True):
    """The twin of ``cross_attn_block_xla`` on the Dense layouts: every
    input widened to f32, y returned at x's dtype. K2b's backward."""
    return _cross_plain(x.float(), *(t.float() for t in args), heads=heads, dim_head=dim_head,
                        scale=scale, residual=residual).to(x.dtype)


def cross_attn_block_packed_torch(x, ctx, gamma, beta, packed, *, heads: int, scale: float):
    """K2b's launches in plain PyTorch, from the packed weights
    (``pack_cross_weights``): q at the padded head width dh in K4's layout,
    k and v from the context's rows, the attention core
    (``flash_forward_torch``), the heads' concatenation times W_o with the
    residual; the norm at the real dm. In f32 equal to
    ``cross_attn_block_torch`` up to f32 reordering, in bf16 (x, ctx, γ, β
    and the weights bf16, packed "bf16_sw128") to
    ``cross_attn_block_bf16_torch``'s rounding points: the check of K2b's
    padding and weight layout on the CPU."""
    b, n, dm = x.shape
    m, dc = ctx.shape[1:]
    if x.dtype == torch.bfloat16:
        return _cross_packed_bf16(x, ctx, gamma, beta, packed, heads=heads, scale=scale)
    wq, wkv, wo = [sum(gemm_cache.unpack_b(p)) for p in packed]
    hd = wo.shape[1]  # H·dh: the out Bᵀ's K, a multiple of 64
    dh = hd // heads
    q = (ada_norm(x, gamma, beta) @ wq[:hd, :dm].T).reshape(b, n, heads, dh).transpose(1, 2)
    k, v = (ctx @ wkv[:2 * hd, :dc].T).reshape(b, m, 2, heads, dh).permute(2, 0, 3, 1, 4)
    o, _ = flash_forward_torch(q, k, v, None, None, causal=False, scale=scale)
    return x + o.transpose(1, 2).reshape(b, n, hd) @ wo[:dm, :hd].T


def _cross_packed_bf16(x, ctx, gamma, beta, packed, *, heads: int, scale: float):
    """``cross_attn_block_packed_torch`` in bf16: ``cross_attn_block_bf16_torch``'s
    rounding points (n(x), q, k, v, P and o rounded, y once) on the packed
    weights (bf16 values)."""
    b, n, dm = x.shape
    m, dc = ctx.shape[1:]
    xf = x.float()
    wq, wkv, wo = [sum(gemm_cache.unpack_b(p, "bf16_sw128")).float() for p in packed]
    hd = wo.shape[1]
    dh = hd // heads
    xn = _rd(ada_norm(xf, gamma.float(), beta.float()))
    q = _rd(xn @ wq[:hd, :dm].T).reshape(b, n, heads, dh).transpose(1, 2)
    k, v = _rd(ctx.float() @ wkv[:2 * hd, :dc].T).reshape(b, m, 2, heads, dh).permute(
        2, 0, 3, 1, 4)
    o = _rd(_core_bf16(q, k, v, scale=scale))
    return (xf + o.transpose(1, 2).reshape(b, n, hd) @ wo[:dm, :hd].T).to(x.dtype)


def cross_attn_block_planes_torch(x, ctx, gamma, beta, packed, *, heads: int, scale: float,
                                  residual: bool = True):
    """K2b's mixed entry point's launches in plain PyTorch (f32 x, ctx, γ and
    β against weights packed "bf16_sw128"), as ``attn_block_planes_torch``
    is K2's: the context split into its three bf16 planes at dc padded to
    64 (zeros past dc), n(x) into its three, q and k/v as three-part
    products kept in f32 in K4's layout, the attention core in f32
    (``flash_forward_torch``), o split into its three planes [b, 3·H, n,
    dh] (part q of head h at slice q·H + h), the heads' concatenation of
    o's parts times W_o, x added when ``residual``. Returns (y, the planes
    of n(x) [b, 3, n, dm], the context's planes [b, 3, m, dc padded], q [b,
    H, n, dh] and kv [2, b, H, m, dh] f32, o's planes)."""
    b, n, dm = x.shape
    m, dc = ctx.shape[1:]
    wq, wkv, wo = [gemm_cache.unpack_b(p, "bf16_sw128")[0] for p in packed]
    hd = wo.shape[1]
    dh = hd // heads
    xn = torch.stack(gemm_cache.split3(ada_norm(x, gamma, beta)), dim=1)
    q = gemm_cache.parts_product(xn.unbind(1), wq[:hd, :dm].T)
    q = q.reshape(b, n, heads, dh).transpose(1, 2)
    c = torch.stack(gemm_cache.split3(F.pad(ctx, (0, wkv.shape[1] - dc))), dim=1)
    kv = gemm_cache.parts_product(c.unbind(1), wkv[:2 * hd].T)
    kv = kv.reshape(b, m, 2, heads, dh).permute(2, 0, 3, 1, 4)
    o, _ = flash_forward_torch(q, *kv, None, None, causal=False, scale=scale)
    o_planes = torch.cat(gemm_cache.split3(o), dim=1)
    parts = [p.transpose(1, 2).reshape(b, n, hd) for p in o_planes.chunk(3, dim=1)]
    y = gemm_cache.parts_product(parts, wo[:dm, :hd].T)
    return (x + y if residual else y), xn, c, q, kv, o_planes


def cross_scratch(b: int, n: int, m: int, dm: int, dc: int, heads: int, dh: int,
                  dtype: torch.dtype, device, fmt: str | None = None) -> tuple:
    """The scratch of K2b's entry point at head width dh (K4's), in its
    argument order, for activations of ``dtype`` against weights packed in
    ``fmt`` (default: ``gemm_cache.fmt_of(dtype)``): q [b, H, n, dh], kv [2,
    b, H, m, dh] and o [b, H, n, dh] of the block's type. In bf16 o first
    holds n(x) at dm padded to 64, so it holds max(H·dh, dm padded to 64)
    values a row, and kv is flat with room after its two planes for b·m rows
    of dc rounded up to 8 (the kernel's copy of the context where TMA cannot
    read it as it is). For f32 activations on the bf16 core (the mixed
    entry) q, kv and o f32, then bf16 planes of 3·max(H·dh, dm padded to
    64) values for each of the b·n rows (n(x)'s three planes, then o's)
    and 3·(dc padded to 64) for each of the b·m rows of the context."""
    fmt = fmt or gemm_cache.fmt_of(dtype)
    q = torch.empty((b, heads, n, dh), dtype=dtype, device=device)
    if dtype != torch.bfloat16:
        kv = torch.empty((2, b, heads, m, dh), dtype=dtype, device=device)
        if fmt != "bf16_sw128":
            return q, kv, torch.empty_like(q)
        pad = gemm_cache.SW128_CHUNK
        row = max(heads * dh, gemm_cache.round_up(dm, pad))
        planes = b * n * 3 * row + b * m * 3 * gemm_cache.round_up(dc, pad)
        return q, kv, torch.empty_like(q), torch.empty(planes, dtype=torch.bfloat16,
                                                       device=device)
    kv = torch.empty(2 * b * heads * m * dh + b * m * gemm_cache.round_up(dc, 8), dtype=dtype,
                     device=device)
    o_row = max(heads * dh, gemm_cache.round_up(dm, gemm_cache.SW128_CHUNK))
    return q, kv, torch.empty(b * n * o_row, dtype=dtype, device=device)


def _pack_cross_checked(wq, wkv, wo, heads: int, dim_head: int, dtype: torch.dtype):
    """``pack_cross_weights`` after the wrapper's checks of the weights,
    which a cache hit then need not repeat; ``dtype`` is x's."""
    _build.require_cuda("cross_attn_block", wq.dtype, wq=wq, wkv=wkv, wo=wo)
    dm, dc, hd = wq.shape[0], wkv.shape[0], heads * dim_head
    _build.require_shapes("cross_attn_block", wq=(wq, (dm, hd)), wkv=(wkv, (dc, 2 * hd)),
                          wo=(wo, (hd, dm)))
    return pack_cross_weights(wq, wkv, wo, heads, dim_head,
                              gemm_cache.fmt_of(dtype, wq.dtype, "cross_attn_block"))


def _cross_forward(x, ctx, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int, scale: float,
                   residual: bool = True):
    if x.device.type == "cpu":
        return _cross_plain(x, ctx, gamma, beta, wq, wkv, wo, heads=heads, dim_head=dim_head,
                            scale=scale, residual=residual)
    _build.require_cuda("cross_attn_block", x.dtype, x=x, ctx=ctx, gamma=gamma, beta=beta)
    _build.suffix("cross_attn_block", x.dtype, wq.dtype)
    b, n, dm = x.shape
    m, dc = ctx.shape[1:]
    _build.require_shapes("cross_attn_block", ctx=(ctx, (b, m, dc)), gamma=(gamma, (b, dm)),
                          beta=(beta, (b, dm)))
    if m < 1:
        raise ValueError("cross_attn_block: the context is empty")
    packed = gemm_cache.cached(
        f"cross_attn_block {heads} {dim_head} {x.dtype}",
        lambda *w: _pack_cross_checked(*w, heads, dim_head, x.dtype), wq, wkv, wo)
    if wq.shape[0] != dm or wkv.shape[0] != dc or wq.device != x.device:
        raise ValueError(f"cross_attn_block: wq {tuple(wq.shape)}, wkv {tuple(wkv.shape)} on "
                         f"{wq.device} do not take x {tuple(x.shape)}, ctx {tuple(ctx.shape)} "
                         f"on {x.device}")
    state = cross_scratch(b, n, m, dm, dc, heads, kernel_head_dim(dim_head), x.dtype, x.device,
                          gemm_cache.fmt_of(x.dtype, wq.dtype, "cross_attn_block"))
    out = torch.empty_like(x)
    err = _build.entry("ns2_cross_attn_block", x.dtype, wq.dtype)(
        x.data_ptr(), ctx.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        *(p.data_ptr() for p in packed), *(t.data_ptr() for t in state), out.data_ptr(), b, n,
        m, dm, dc, heads, state[0].shape[-1], float(scale), int(residual), _build.stream(x),
    )
    _build.check(err, "ns2_cross_attn_block")
    _build.count(cross_attn_block, x.dtype, wq.dtype)
    return out


class _CrossAttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx_, x, ctx, gamma, beta, wq, wkv, wo, heads, dim_head, scale, residual=True):
        ctx_.save_for_backward(x, ctx, gamma, beta, wq, wkv, wo)
        ctx_.cfg = dict(heads=heads, dim_head=dim_head, scale=scale, residual=residual)
        return _cross_forward(x, ctx, gamma, beta, wq, wkv, wo, **ctx_.cfg)

    @staticmethod
    def backward(ctx_, g):
        grads = vjp(lambda *a: _cross_xla(*a, **ctx_.cfg), ctx_.saved_tensors,
                    ctx_.needs_input_grad[:7], g)
        return (*grads, None, None, None, None)


def cross_attn_block(x, ctx, gamma, beta, wq, wkv, wo, *, heads: int, dim_head: int,
                     scale: float, residual: bool = True):
    """K2b: ``x + W_o·attn(adaRMSNorm(x)·W_q, ctx·W_k, ctx·W_v)``,
    differentiable.

    x: [b, n, dm]; ctx: [b, m, dc]; gamma/beta: [b, dm]; wq: [dm, H·dh];
    wkv: [dc, 2·H·dh] (k first); wo: [H·dh, dm]. CUDA tensors run the
    kernel (four launches: q and k/v on the GEMM core, K4's attention core,
    W_o on the GEMM core; in bf16 a norm pre-pass first and the bf16 GEMM
    core, five launches, six where the context is copied for TMA; mixed the
    norm pre-pass with the context's split, q and k/v on the bf16 core, K4
    f32, the split of o and W_o on the bf16 core, six; counted as one launch
    of K2b; any dm, dc and head width); CPU tensors run the plain version.
    ``residual=False`` returns the heads' sum alone, without x.
    """
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, ctx, gamma, beta, wq, wkv, wo)):
        return _CrossAttnBlock.apply(x, ctx, gamma, beta, wq, wkv, wo, heads, dim_head,
                                     float(scale), bool(residual))
    # no graph to record: the autograd Function's overhead spared
    return _cross_forward(x, ctx, gamma, beta, wq, wkv, wo, heads=heads, dim_head=dim_head,
                          scale=float(scale), residual=bool(residual))


cross_attn_block.launches = cross_attn_block.launches_bf16 = 0
cross_attn_block.launches_mixed = 0
