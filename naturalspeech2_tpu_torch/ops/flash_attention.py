"""K4 and K5: flash attention forward and its dq / dk,dv backward (twins of
`naturalspeech2_tpu/ops/flash_attention.py`).

    o = softmax(q kᵀ · scale, masked) · v,   lse = log Σ exp(q kᵀ · scale)

over ``[b, h, n, d]`` f32 tensors, with an optional ``[b, n_kv]``
key-padding mask, causal masking (row ≥ col) and attention dropout on the
probabilities (the softmax normaliser uses the undropped ones). Masked
logits are the finite ``NEG_INF``; a fully masked row gives o = 0 and
lse = NEG_INF, and its backward leaks nothing into the masked keys.

Dropout draws its keep mask from Threefry-2x32-20, counter (row·n_kvp +
col, b·65536 + h) and key (seed[0], seed[1]), with n_kvp the key length
padded as the JAX package pads it, so the port keeps exactly the JAX
package's elements for the same seed and can regenerate them in the
backward without storing them. ``b_offset`` and ``h_offset`` (0 by
default) are added to b and h: a rank that holds batch rows
``b_offset ...`` or heads ``h_offset ...`` of a larger array draws exactly
that array's masks for them.

In bf16 (q, k and v bfloat16: the JAX kernels at a bf16 input dtype,
what AMP training runs in the prompt encoder and the resampler) the
forward runs the products on bf16 operands with f32 accumulation, keeps m,
l and lse in f32 over the undropped probabilities, applies the keep mask
in f32 and rounds P·keep to bf16 before P·V, and returns o in bf16
(``flash_forward_bf16_torch`` is the plain version, K4's
``ns2_flash_fwd_bf16`` the kernel). The backward in bf16 follows the JAX
kernels' rounding points (``flash_backward_bf16_torch``, K5's
``ns2_flash_bwd_bf16``): dO widened to f32, S and dP = dO·Vᵀ in f32, dS
rounded to bf16 before dS·K and dSᵀ·Q, dV = Aᵀ·dO with the dropped
probabilities A unrounded, delta in f32, and dq, dk, dv rounded to bf16.

``flash_forward`` (K4, ``csrc/flash_fwd.cu``) and ``flash_backward`` (K5,
``csrc/flash_bwd.cu``) launch the kernels on CUDA tensors and run the plain
versions ``flash_forward_torch`` / ``flash_backward_torch`` on CPU tensors.
The f32 kernels run every product on the tensor cores in split TF32 (three
TF32 products per f32 product), which keeps f32 accuracy; the bf16 ones
(``csrc/flash_fwd_bf16.cu``, ``csrc/flash_bwd_bf16.cu``) run on the bf16
tensor cores, K4's P rounded against the running row max of its 128-key
tile, K5's f32 A as two bf16 parts.
``flash_attention`` is differentiable (forward K4, backward K5);
``flash_attention_with_lse`` is forward only. The kernels take head dims
64 and multiples of 128; other heads are padded with zero columns to the
next of these (``pad_head_dim``, ``kernel_head_dim``) and the results cut
back, as the JAX package pads d to a multiple of 128: zero columns of q and
k change no logit, zero columns of v and dO give output columns that are
cut. Heads wider than 128 run the kernels' chunked variants, which sum the
logits (and dP) over 128-wide chunks of the head dim and write each
128-column chunk of the outputs from a block of its own; the plain
versions' ``head_chunk`` argument computes in that order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.utils.helpers import round_bf16

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
# The chunk of the head dim that the kernels stage: heads are 64 wide or a
# multiple of it.
KERNEL_HEAD_CHUNK = 128

_MASK32 = 0xFFFFFFFF
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """First output word of Threefry-2x32-20 (the twin of `_threefry2x32`),
    elementwise. Words are int64 tensors holding uint32 values; every sum
    wraps mod 2³²."""
    ks0, ks1 = k0 & _MASK32, k1 & _MASK32
    ks2 = ks0 ^ ks1 ^ 0x1BD11BDA
    x0 = (x0 + ks0) & _MASK32
    x1 = (x1 + ks1) & _MASK32
    subkeys = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2), (ks2, ks0))
    for block in range(5):
        for r in _ROTATIONS[:4] if block % 2 == 0 else _ROTATIONS[4:]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        a, b = subkeys[block]
        x0 = (x0 + a) & _MASK32
        x1 = (x1 + b + block + 1) & _MASK32
    return x0


def dropout_stride(n_kv: int) -> int:
    """The key length the JAX package counts dropout positions with: n_kv
    padded to its kv block, min(1024, max(128, next_pow2(n_kv)))."""
    block_kv = min(1024, max(128, 1 << (n_kv - 1).bit_length()))
    return -(-n_kv // block_kv) * block_kv


def keep_threshold(rate: float) -> int:
    """An element is kept when its 32 random bits are ≥ this."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate: float) -> float:
    """The kept probabilities' multiplier, 1/(1−rate) rounded to f32."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_keep_scaled(seed: Sequence[int], b: int, h: int, n_q: int, n_kv: int,
                        rate: float, device=None, b_offset: int = 0,
                        h_offset: int = 0) -> torch.Tensor:
    """[b, h, n_q, n_kv] multiplier keep/(1−rate) (twin of
    `_dropout_keep_scaled` over the whole grid), for batch rows and heads
    counted from ``b_offset`` and ``h_offset``."""
    rows = torch.arange(n_q, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(n_kv, dtype=torch.int64, device=device)[None, :]
    x0 = ((rows * dropout_stride(n_kv) + cols) & _MASK32).expand(b, h, n_q, n_kv)
    bh = (torch.arange(b, dtype=torch.int64, device=device)[:, None] + b_offset) * 65536 + (
        torch.arange(h, dtype=torch.int64, device=device)[None, :] + h_offset)
    x1 = (bh & _MASK32)[:, :, None, None].expand(b, h, n_q, n_kv)
    bits = threefry2x32(int(seed[0]), int(seed[1]), x0, x1)
    keep = (bits >= keep_threshold(rate)).to(torch.float32)
    return keep * keep_scale(rate)


def _valid(b: int, n_q: int, n_kv: int, mask, causal: bool, device) -> torch.Tensor:
    """[b, 1, n_q, n_kv] bool: key kept by the padding mask and, if causal,
    not after the query."""
    valid = torch.ones((b, 1, n_q, n_kv), dtype=torch.bool, device=device)
    if mask is not None:
        valid = valid & mask.to(torch.bool)[:, None, None, :]
    if causal:
        rows = torch.arange(n_q, device=device)[:, None]
        cols = torch.arange(n_kv, device=device)[None, :]
        valid = valid & (rows >= cols)
    return valid


def _xyt(x, y, head_chunk: Optional[int]):
    """x·yᵀ over the last dim of ``[b, h, n, d]`` tensors; with
    ``head_chunk`` the sum of the products of its chunks, each apart, as the
    chunked kernels sum them."""
    if head_chunk is None:
        return torch.einsum("bhid,bhjd->bhij", x, y)
    return sum(torch.einsum("bhid,bhjd->bhij", x[..., c:c + head_chunk], y[..., c:c + head_chunk])
               for c in range(0, x.shape[-1], head_chunk))


def flash_forward_bf16_torch(q, k, v, mask, seed=None, *, causal: bool, scale: float,
                             dropout_rate: float = 0.0, head_chunk: Optional[int] = None,
                             b_offset: int = 0, h_offset: int = 0):
    """Plain version of K4 in bf16, the JAX kernels' rounding points at a
    bf16 input dtype: the logits summed in f32 from the bf16 operands, m,
    l and lse in f32 over the unrounded, undropped probabilities, P times
    the dropout keep multiplier in f32, rounded to bf16 before P·V
    (``(p * keep).astype(v.dtype)``), o = P·V / l rounded to bf16."""
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    valid = _valid(b, n_q, n_kv, mask, causal, q.device)
    s = torch.where(valid, _xyt(q.float(), k.float(), head_chunk) * scale, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    lse = (m + torch.log(safe_l))[..., 0]
    if dropout_rate > 0.0:
        p = p * dropout_keep_scaled(seed, b, h, n_q, n_kv, dropout_rate, q.device, b_offset,
                                    h_offset)
    pv = torch.einsum("bhij,bhjd->bhid", round_bf16(p), v.float())
    return (pv / safe_l).to(torch.bfloat16), lse


def flash_forward_torch(q, k, v, mask, seed, *, causal: bool, scale: float,
                        dropout_rate: float = 0.0, head_chunk: Optional[int] = None,
                        b_offset: int = 0, h_offset: int = 0):
    """Plain version of K4: ``(o [b,h,n_q,d], lse [b,h,n_q])``, the function
    of `_flash_oneshot_kernel` / `_flash_kernel`. With ``head_chunk`` (d a
    multiple of it) the logits are summed over chunks of the head dim, as
    the kernel does for heads wider than 128. bf16 inputs run
    ``flash_forward_bf16_torch``."""
    if q.dtype == torch.bfloat16:
        return flash_forward_bf16_torch(q, k, v, mask, seed, causal=causal, scale=scale,
                                        dropout_rate=dropout_rate, head_chunk=head_chunk,
                                        b_offset=b_offset, h_offset=h_offset)
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    valid = _valid(b, n_q, n_kv, mask, causal, q.device)
    s = torch.where(valid, _xyt(q, k, head_chunk) * scale, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    lse = (m + torch.log(safe_l))[..., 0]
    if dropout_rate > 0.0:
        p = p * dropout_keep_scaled(seed, b, h, n_q, n_kv, dropout_rate, q.device, b_offset,
                                    h_offset)
    o = torch.einsum("bhij,bhjd->bhid", p, v) / safe_l
    return o, lse


def flash_backward_torch(q, k, v, mask, seed, lse, o, do, *, causal: bool, scale: float,
                         dropout_rate: float = 0.0, head_chunk: Optional[int] = None,
                         b_offset: int = 0, h_offset: int = 0):
    """Plain version of K5: ``(dq, dk, dv)`` from the saved lse, with
    delta = Σ_d dO·O and P recomputed as in `_flash_backward`. With
    ``head_chunk``, S and dP are summed over chunks of the head dim, as the
    kernels do for heads wider than 128. bf16 inputs run
    ``flash_backward_bf16_torch``."""
    if q.dtype == torch.bfloat16:
        return flash_backward_bf16_torch(q, k, v, mask, seed, lse, o, do, causal=causal,
                                         scale=scale, dropout_rate=dropout_rate,
                                         head_chunk=head_chunk, b_offset=b_offset,
                                         h_offset=h_offset)
    return _backward(q, k, v, mask, seed, lse, o, do, causal=causal, scale=scale,
                     dropout_rate=dropout_rate, head_chunk=head_chunk, b_offset=b_offset,
                     h_offset=h_offset)


def _backward(q, k, v, mask, seed, lse, o, do, *, causal, scale, dropout_rate, head_chunk,
              round_ds=lambda ds: ds, b_offset: int = 0, h_offset: int = 0):
    """The backward's function on f32 tensors; ``round_ds`` is applied to
    dS before dS·K and dSᵀ·Q (never to A before Aᵀ·dO)."""
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    valid = _valid(b, n_q, n_kv, mask, causal, q.device)
    delta = (do * o).sum(dim=-1, keepdim=True)
    s = _xyt(q, k, head_chunk) * scale
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = _xyt(do, v, head_chunk)
    a = p
    if dropout_rate > 0.0:
        keep = dropout_keep_scaled(seed, b, h, n_q, n_kv, dropout_rate, q.device, b_offset,
                                   h_offset)
        a = p * keep
        dp = dp * keep
    dv = torch.einsum("bhij,bhid->bhjd", a, do)
    ds = round_ds(p * (dp - delta) * scale)
    dq = torch.einsum("bhij,bhjd->bhid", ds, k)
    dk = torch.einsum("bhij,bhid->bhjd", ds, q)
    return dq, dk, dv


def flash_backward_bf16_torch(q, k, v, mask, seed, lse, o, do, *, causal: bool, scale: float,
                              dropout_rate: float = 0.0, head_chunk: Optional[int] = None,
                              b_offset: int = 0, h_offset: int = 0):
    """Plain version of K5 in bf16, the rounding points of
    `_flash_bwd_dq_kernel` / `_flash_bwd_dkv_kernel` at bf16 inputs: dO
    widened to f32; S = Q·Kᵀ and dP = dO·Vᵀ summed in f32 from the bf16
    values; delta = Σ dO·O in f32; dS = P∘(dP∘keep − delta)·scale in f32,
    rounded to bf16 before dS·K and dSᵀ·Q (``ds.astype(k.dtype)``); dV =
    Aᵀ·dO with A = P∘keep unrounded (``a.astype(do.dtype)``, dO being f32
    already); dq, dk and dv rounded to bf16."""
    grads = _backward(*(t.float() for t in (q, k, v)), mask, seed, lse,
                      *(t.float() for t in (o, do)), causal=causal, scale=scale,
                      dropout_rate=dropout_rate, head_chunk=head_chunk, round_ds=round_bf16,
                      b_offset=b_offset, h_offset=h_offset)
    return tuple(g.to(torch.bfloat16) for g in grads)


def kernel_head_dim(d: int) -> int:
    """The kernels' head dim that a d-wide head is padded to: 64, or the
    next multiple of 128 (``KERNEL_HEAD_CHUNK``), as the JAX kernels pad d
    to a multiple of 128. Heads wider than 128 run the kernels' chunked
    variants."""
    return 64 if d <= 64 else -(-d // KERNEL_HEAD_CHUNK) * KERNEL_HEAD_CHUNK


def pad_head_dim(*tensors):
    """Each ``[..., d]`` tensor with zero columns up to the kernels' head dim
    (``kernel_head_dim``; as it is when d is one already)."""
    width = kernel_head_dim(tensors[0].shape[-1])
    return tuple(t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


def _check(name: str, q, k, v, mask):
    _build.require_cuda(name, q.dtype, q=q, k=k, v=v)
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    _build.require_shapes(name, k=(k, (b, h, n_kv, d)), v=(v, (b, h, n_kv, d)))
    if kernel_head_dim(d) != d:
        raise ValueError(f"{name}: the CUDA kernels take head dims 64 and multiples of "
                         f"{KERNEL_HEAD_CHUNK}, got {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: the CUDA kernel copies rows in 16-byte pieces; q, k and v "
                         "must start on a 16-byte boundary")
    if mask is None:
        return None
    if mask.device != q.device or tuple(mask.shape) != (b, n_kv):
        raise ValueError(f"{name}: mask must be [{b}, {n_kv}] on {q.device}")
    return mask.to(torch.uint8).contiguous()


def _dropout_args(seed, dropout_rate: float, n_kv: int, b_offset: int = 0,
                  h_offset: int = 0) -> list:
    """(seed0, seed1, rate, stride, threshold, keep scale, batch offset,
    head offset) as the kernels take them; a rate of 0 turns dropout off."""
    if dropout_rate <= 0.0:
        return [0, 0, 0.0, 0, 0, 1.0, 0, 0]
    if seed is None:
        raise ValueError("dropout needs a seed")
    return [int(seed[0]) & _MASK32, int(seed[1]) & _MASK32, float(dropout_rate),
            dropout_stride(n_kv), keep_threshold(dropout_rate), keep_scale(dropout_rate),
            int(b_offset), int(h_offset)]


def flash_forward(q, k, v, mask=None, seed=None, *, causal: bool = False, scale: float,
                  dropout_rate: float = 0.0, b_offset: int = 0, h_offset: int = 0):
    """K4: ``(o, lse)``. CUDA tensors launch ``csrc/flash_fwd.cu`` (heads
    padded to 64 or a multiple of 128, o cut back; f32, or bf16 through its
    own entry point in ``csrc/flash_fwd_bf16.cu``, counted in
    ``flash_forward.launches_bf16``); CPU
    tensors run ``flash_forward_torch``. ``b_offset`` and ``h_offset`` key
    the dropout mask on the global batch row and head."""
    offsets = dict(b_offset=b_offset, h_offset=h_offset)
    if q.device.type == "cpu":
        return flash_forward_torch(q, k, v, mask, seed, causal=causal, scale=scale,
                                   dropout_rate=dropout_rate, **offsets)
    d = q.shape[-1]
    if d != kernel_head_dim(d) and q.device.type == "cuda":
        o, lse = flash_forward(*pad_head_dim(q, k, v), mask, seed, causal=causal, scale=scale,
                               dropout_rate=dropout_rate, **offsets)
        return o[..., :d].contiguous(), lse
    mask8 = _check("flash_forward", q, k, v, mask)
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    err = _build.entry("ns2_flash_fwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask8 is None else mask8.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, n_q, n_kv, d, int(causal), float(scale),
        *_dropout_args(seed, dropout_rate, n_kv, b_offset, h_offset), _build.stream(q),
    )
    _build.check(err, "ns2_flash_fwd")
    _build.count(flash_forward, q.dtype)
    return o, lse


def flash_backward(q, k, v, mask, seed, lse, o, do, *, causal: bool = False, scale: float,
                   dropout_rate: float = 0.0, b_offset: int = 0, h_offset: int = 0):
    """K5: ``(dq, dk, dv)``. CUDA tensors launch the dq and dk/dv kernels of
    ``csrc/flash_bwd.cu`` (counted as one launch of K5; heads padded to 64
    or a multiple of 128, the gradients cut back; f32, or bf16 through its
    own entry point in ``csrc/flash_bwd_bf16.cu``, counted in
    ``flash_backward.launches_bf16``) after
    delta = Σ dO·O as a plain f32 reduction (XLA computes it outside the
    kernels too); CPU tensors run ``flash_backward_torch``. The offsets as
    ``flash_forward``'s."""
    offsets = dict(b_offset=b_offset, h_offset=h_offset)
    if q.device.type == "cpu":
        return flash_backward_torch(q, k, v, mask, seed, lse, o, do, causal=causal, scale=scale,
                                    dropout_rate=dropout_rate, **offsets)
    d = q.shape[-1]
    if d != kernel_head_dim(d) and q.device.type == "cuda":
        grads = flash_backward(*pad_head_dim(q, k, v), mask, seed, lse, *pad_head_dim(o, do),
                               causal=causal, scale=scale, dropout_rate=dropout_rate,
                               **offsets)
        return tuple(g[..., :d].contiguous() for g in grads)
    mask8 = _check("flash_backward", q, k, v, mask)
    _build.require_cuda("flash_backward", q.dtype, o=o, do=do)
    _build.require_cuda("flash_backward", lse=lse)
    if do.data_ptr() % 16:
        raise ValueError("flash_backward: do must start on a 16-byte boundary")
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    _build.require_shapes("flash_backward", lse=(lse, (b, h, n_q)), o=(o, q.shape),
                          do=(do, q.shape))
    delta = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.entry("ns2_flash_bwd", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask8 is None else mask8.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, n_q, n_kv, d, int(causal), float(scale),
        *_dropout_args(seed, dropout_rate, n_kv, b_offset, h_offset), _build.stream(q),
    )
    _build.check(err, "ns2_flash_bwd")
    _build.count(flash_backward, q.dtype)
    return dq, dk, dv


flash_forward.launches = flash_forward.launches_bf16 = 0
flash_backward.launches = flash_backward.launches_bf16 = 0


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, mask, seed, causal, scale,
    dropout_rate, b_offset=0, h_offset=0)`` → o; forward K4, backward K5
    (the twin of `_flash`'s custom_vjp). ``seed`` is two ints or None."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, causal, scale, dropout_rate, b_offset=0, h_offset=0):
        ctx.cfg = dict(causal=causal, scale=scale, dropout_rate=dropout_rate,
                       b_offset=b_offset, h_offset=h_offset)
        o, lse = flash_forward(q, k, v, mask, seed, **ctx.cfg)
        ctx.save_for_backward(q, k, v, lse, o)
        ctx.mask, ctx.seed = mask, seed
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse, o = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, ctx.mask, ctx.seed, lse, o, do.contiguous(),
                                    **ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, *, mask: Optional[torch.Tensor] = None, causal: bool = False,
                    scale: Optional[float] = None, dropout: float = 0.0,
                    generator: Optional[torch.Generator] = None, b_offset: int = 0,
                    h_offset: int = 0) -> torch.Tensor:
    """Differentiable flash attention over ``[b, h, n, d]`` with an optional
    ``[b, n_kv]`` key-padding mask, causal masking and attention dropout,
    whose two seed words are drawn from ``generator``; the mask of batch
    row b and head h is that of row ``b_offset + b`` and head
    ``h_offset + h`` of a larger array."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    seed = None
    if dropout > 0.0:
        device = generator.device if generator is not None else "cpu"
        seed = tuple(torch.randint(0, 2**32, (2,), generator=generator, device=device).tolist())
    return FlashAttention.apply(q, k, v, mask, seed, causal, float(scale), float(dropout),
                                int(b_offset), int(h_offset))


def flash_attention_with_lse(q, k, v, *, mask: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None):
    """Forward only: ``(o, lse [b, h, n_q])``; fully masked rows give o = 0
    and lse = NEG_INF, so they drop out of a logsumexp combination of
    partial results."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        return flash_forward(q, k, v, mask, None, causal=False, scale=float(scale))
