"""Sequence (context) parallel attention over one mesh axis (the port of
`naturalspeech2_tpu/parallel/sp.py`).

Each rank holds its shard of the sequence: q, k and v ``[b, h, n/P, d]``
(shard r holds positions r·n/P .. (r + 1)·n/P), the key mask ``[b, n/P]``.
Each function returns the rank's shard of the output, ``[b, h, n/P, d]``.
JAX runs these bodies under ``shard_map``; here each rank runs its body
and the collectives of `comm` stand for JAX's:

- `sp_attend`: k, v and the mask all-gathered, the local queries against
  every key (K4 / K5 with ``backend="flash"``); differentiable, the
  gather's backward a reduce-scatter of dk and dv over the axis;
- `ulysses_attend`: an all-to-all from sequence shards to head shards,
  plain attention over the whole sequence for h/P heads, and back;
- `ring_attend`: k, v and the mask travel around the ring, P − 1 hops, the
  local chunk first, and each rank's queries accumulate an online softmax
  over the chunks (``"xla"``, differentiable: the shift's backward shifts
  the other way) or combine per-hop K4 results by their log-sum-exp
  (``"flash"``, forward only).

``backend="auto"`` means K4 on a card and plain elsewhere. Causal
attention stays plain with global row offsets: K4's causal mask has no
offset, as in JAX. JAX's whole-denoiser sequence sharding (GSPMD under a
sharding constraint, convs with halo exchanges) is a compiler feature and
no function of this package.
"""

from __future__ import annotations

from typing import Optional

import torch

from naturalspeech2_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_with_lse,
)
from naturalspeech2_tpu_torch.parallel import comm
from naturalspeech2_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def _use_flash(backend: str, causal: bool, device: torch.device) -> bool:
    """K4 for the local attention: with ``"flash"``, or ``"auto"`` on a
    card; never causal (K4's causal mask has no global row offset)."""
    if backend not in ("auto", "flash", "xla"):
        raise ValueError(f"backend must be 'auto', 'flash' or 'xla', got {backend!r}")
    if causal:
        return False
    return backend == "flash" or (backend == "auto" and device.type == "cuda")


class _Gather(torch.autograd.Function):
    """Every rank's shard along ``axis``, concatenated on ``dim``; the
    backward sums each shard's gradient over the ranks and keeps this
    rank's (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return torch.cat(comm.all_gather(mesh, t, axis), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        parts = torch.stack(grad.chunk(ctx.mesh.size(ctx.axis), dim=ctx.dim))
        return comm.reduce_scatter(ctx.mesh, parts, ctx.axis), None, None, None


class _AllToAll(torch.autograd.Function):
    """``t`` cut into P parts on ``split``, part j sent to rank j, the parts
    received concatenated on ``concat`` in rank order; the backward is the
    inverse exchange."""

    @staticmethod
    def forward(ctx, t, mesh, axis, split, concat):
        ctx.args = (mesh, axis, split, concat)
        return _all_to_all(t, mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, split, concat = ctx.args
        return _all_to_all(grad, mesh, axis, concat, split), None, None, None, None


def _all_to_all(t, mesh, axis, split, concat):
    parts = torch.stack(t.chunk(mesh.size(axis), dim=split))
    return torch.cat(comm.all_to_all(mesh, parts, axis).unbind(0), dim=concat)


class _Shift(torch.autograd.Function):
    """The ``t`` of the rank ``step`` places before along ``axis``; the
    backward sends the gradient back the other way."""

    @staticmethod
    def forward(ctx, t, mesh, axis, step):
        ctx.args = (mesh, axis, step)
        return comm.shift(mesh, t, axis, step)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, step = ctx.args
        return comm.shift(mesh, grad.contiguous(), axis, -step), None, None, None


def _shards(q, mask, mesh: Mesh, axis: str):
    """(the axis size, this rank's key mask: all True when None)."""
    p = mesh.size(axis)
    if mask is None:
        mask = torch.ones((q.shape[0], q.shape[2]), dtype=torch.bool, device=q.device)
    return p, mask.to(torch.bool)


def _plain(q, k, v, mask, causal: bool, scale: float, row0: int = 0):
    """softmax(q kᵀ · scale, masked) v with the logits in f32; causal on
    global rows ``row0 ..`` against keys 0 ..."""
    sim = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    sim = torch.where(mask[:, None, None, :], sim, NEG_INF)
    if causal:
        rows = row0 + torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        sim = torch.where(rows >= cols, sim, NEG_INF)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.einsum("bhij,bhjd->bhid", attn, v)


def sp_attend(q, k, v, *, mesh: Mesh, axis: str = DATA_AXIS,
              mask: Optional[torch.Tensor] = None, causal: bool = False,
              scale: Optional[float] = None, backend: str = "auto") -> torch.Tensor:
    """Context-parallel attention: this rank's queries against the gathered
    keys. q, k, v: this rank's ``[b, h, n/P, d]``; mask: its ``[b, n/P]``.
    Returns its ``[b, h, n/P, d]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, mask_l = _shards(q, mask, mesh, axis)
    k_full = _Gather.apply(k, mesh, axis, 2)
    v_full = _Gather.apply(v, mesh, axis, 2)
    mask_full = torch.cat(comm.all_gather(mesh, mask_l, axis), dim=1)
    if _use_flash(backend, causal, q.device):
        return flash_attention(q, k_full, v_full, mask=mask_full if mask is not None else None,
                               scale=scale)
    return _plain(q, k_full, v_full, mask_full, causal, scale, mesh.index(axis) * q.shape[2])


def ulysses_attend(q, k, v, *, mesh: Mesh, axis: str = DATA_AXIS,
                   mask: Optional[torch.Tensor] = None, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: an all-to-all trades the
    sequence shard for h/P whole-sequence heads, plain attention runs
    locally (as JAX runs `attend_xla` here), and a second all-to-all
    restores the sequence shard. Needs h and n divisible by the axis."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, n_local, _ = q.shape
    p, mask_l = _shards(q, mask, mesh, axis)
    if h % p:
        raise ValueError(f"heads {h} must divide over {axis}={p}")
    q_h, k_h, v_h = (_AllToAll.apply(t, mesh, axis, 1, 2) for t in (q, k, v))
    mask_full = torch.cat(comm.all_gather(mesh, mask_l, axis), dim=1)
    o = _plain(q_h, k_h, v_h, mask_full, causal, scale)
    return _AllToAll.apply(o.contiguous(), mesh, axis, 2, 1)


def ring_attend(q, k, v, *, mesh: Mesh, axis: str = DATA_AXIS,
                mask: Optional[torch.Tensor] = None, causal: bool = False,
                scale: Optional[float] = None, backend: str = "auto") -> torch.Tensor:
    """Ring attention (Liu et al. 2023): nothing is gathered whole; each
    hop passes k, v and the mask one rank on, and this rank's queries
    accumulate the softmax over the chunk it holds, its global key
    positions those of the shard it came from. ``backend="flash"`` runs
    each hop on K4 and combines the hops by their log-sum-exp (a fully
    masked chunk arrives as lse = NEG_INF, o = 0 and drops out); forward
    only, as in JAX: take gradients with ``"xla"``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, n_local, d = q.shape
    p, mask_cur = _shards(q, mask, mesh, axis)
    index = mesh.index(axis)
    k_cur, v_cur = k, v
    if _use_flash(backend, causal, q.device):
        with torch.no_grad():
            o, lse = flash_attention_with_lse(q, k, v, mask=mask_cur, scale=scale)
            o = o.float()
            for _ in range(p - 1):
                k_cur, v_cur, mask_cur = (comm.shift(mesh, t, axis) for t in (k_cur, v_cur,
                                                                               mask_cur))
                o_h, lse_h = flash_attention_with_lse(q, k_cur, v_cur, mask=mask_cur,
                                                      scale=scale)
                lse_new = torch.logaddexp(lse, lse_h)
                o = (o * torch.exp(lse - lse_new)[..., None]
                     + o_h.float() * torch.exp(lse_h - lse_new)[..., None])
                lse = lse_new
        return o.to(q.dtype)
    rows = index * n_local + torch.arange(n_local, device=q.device)
    m = torch.full((b, h, n_local), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n_local), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, n_local, d), dtype=torch.float32, device=q.device)
    for hop in range(p):
        if hop:
            k_cur, v_cur = (_Shift.apply(t, mesh, axis, 1) for t in (k_cur, v_cur))
            mask_cur = comm.shift(mesh, mask_cur, axis)
        src = (index - hop) % p  # the shard the chunk came from
        cols = src * n_local + torch.arange(n_local, device=q.device)
        s = torch.einsum("bhid,bhjd->bhij", q.float(), k_cur.float()) * scale
        valid = mask_cur[:, None, None, :].expand(s.shape)
        if causal:
            valid = valid & (rows[:, None] >= cols[None, :])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p_ = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhij,bhjd->bhid", p_.to(v_cur.dtype),
                                                   v_cur).float()
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (acc / safe_l[..., None]).to(q.dtype)
