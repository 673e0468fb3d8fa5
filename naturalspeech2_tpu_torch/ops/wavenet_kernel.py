"""K1 and K1b: the fused WaveNet body (twins of `_wavenet_kernel` and
`_lane_kernel` in `naturalspeech2_tpu/ops/wavenet_kernel.py`).

``wavenet_body`` takes the route that ``wavenet_route``, the JAX
package's dispatch rule, picks for the shape: K1 (``csrc/wavenet.cu``,
every lane of a stack at once), K1b (``csrc/wavenet_lane.cu``, one lane
through every stack at a time), or, past both of the JAX package's
budgets, the plain body ``wavenet_body_torch``, the twin of the
`wavenet_body_xla` that the JAX dispatch calls there, on any device. On a
CPU tensor the kernels' routes run their plain versions.
``wavenet_body_lanes`` runs K1b whatever the shape, and
``wavenet_body_lanes_torch`` on a CPU tensor; with ``bf16_matmul=True``
(the JAX kernel's option, which only its d-512 probe sets, never the
dispatch) K1b's entry point ``ns2_wavenet_lanes_bf16mm`` and, on a CPU
tensor, ``wavenet_body_lanes_bf16mm_torch``. Both are
differentiable: as `_bwd` in the JAX package, the backward is the vjp of
the plain version on the saved inputs widened to f32, each gradient
cast back to its input's dtype (the JAX package has no backward kernel
here, so neither has the port).

Shapes: x [b, n, d]; conv_w [S, L, 3d, d]; conv_b, res_b [S, L, d];
res_w [S, L, d, d]; skip_w [L, d, d]; skip_b [L, d]; film [b, S, L, 2d]
(γ first, β second). Returns the summed skips [b, n, d].

In f32 both kernels run every product on the split-TF32 GEMM core
(``csrc/gemm_tf32x3.cuh``); in bf16 and mixed on the bf16 GEMM core
(``csrc/gemm_bf16.cuh``). They read their weights packed once per
parameter version (``pack_wavenet_weights``): each block's conv and
residual as one B [3d, 2d] whose 64-column groups interleave 32 conv and
32 residual columns, and the skips. ``wavenet_body_packed_torch``
computes the body from that layout in plain PyTorch. The kernels take d %
32 == 0 (the split-TF32 core's chunk; 64 in bf16, the bf16 core's). Other
widths are padded with exact zeros (``pad_wavenet_weights``,
``pad_wavenet_inputs``) and the result is cut back: a padded channel has
zero weights, bias, γ and β, so it stays 0 through the FiLM, tanh·σ, the
residual and the skips.

In bf16 (x, the weights and FiLM bfloat16) each route copies its own JAX
counterpart. The kernels' routes run the JAX kernels' bf16 path: the lanes
stay f32, the products multiply them by the bf16 weights with f32
products, and only the output is rounded to bf16
(``wavenet_body_bf16_torch``, ``wavenet_body_lanes_bf16_torch``). On a card
the kernels' bf16 entry points carry each f32 lane as three bf16 planes,
hi + mid + lo = the lane exactly (``split3``), each part's product with a
bf16 weight exact in f32, three bf16 passes summed in one f32 accumulator
(the weights packed "bf16_sw128"); ``wavenet_body_planes_torch`` is that
scheme in plain PyTorch. The plain route is ``wavenet_body_torch`` on the
bf16 tensors, every lane rounded to bf16 as `wavenet_body_xla` runs at
x.dtype. ``wavenet_route`` decides as in f32: the JAX gates do not depend on
the dtype.

Mixed (x and FiLM float32, the weights and biases bfloat16: AMP training,
whose denoiser promotes its f32 activations against the bf16 copies of
the weights) each route computes the f32 body on the weights' values,
exact in f32, as the JAX kernels' products and `wavenet_body_xla` (which
casts every operand to x.dtype) do, the biases widened, counted in
``launches_mixed``; the plain versions run on the widened weights. The
mixed entry points of K1 and K1b run the bf16 path with x split into three
planes too (a pre-pass) and the gate, biases, FiLM and output in f32, the
weights packed "bf16_sw128" (``wavenet_body_planes_torch`` with three
parts on f32 x is their scheme in plain PyTorch).

``bf16_matmul`` (f32 x, weights and FiLM; `_lane_kernel`'s option,
`naturalspeech2_tpu/ops/wavenet_kernel.py:172`, `:208-217`): every product
reads bf16 operands with f32 accumulation, the lane rounded at each of its
products and the stack's output before the skip product, the lane state,
biases, FiLM, gate and the skips' sum f32, the output f32. A lane enters
the body only through products, so on a card K1b's bf16 path runs it with
one bf16 plane a lane, bf16(v), in place of three (a rounding pre-pass of
x, the gate on the f32 biases and FiLM, the skips summed into the f32
output), against the f32 weights rounded to bf16 as they are packed
("bf16_sw128", under a cache key of their own); counted in
``wavenet_body_lanes.launches_bf16mm``. ``wavenet_body_planes_torch`` with
``parts=1`` is that scheme in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.ops import gemm_cache
from naturalspeech2_tpu_torch.ops.gemm_cache import split3
from naturalspeech2_tpu_torch.utils.helpers import round_bf16, vjp

# The kernels' channel multiple (the GEMM core's chunk), to which other
# widths are padded.
KERNEL_ALIGN = gemm_cache.CHUNK


def _shift(a, rows: int):
    """a [b, n, d] moved ``rows`` later in time, zeros before t = 0."""
    return F.pad(a, (0, 0, rows, 0))[:, :a.shape[1]]


def _block(xin, conv_w, conv_b, res_w, res_b, film, dil: int, operand=None):
    """One WaveNet block on ``xin`` [b, n, d]: the gated, FiLM-conditioned
    causal k=3 conv with dilation ``dil`` plus the 1x1 residual; ``film``
    [b, 2d] holds γ then β. ``operand`` (e.g. ``round_bf16``) is applied
    to both operands of each product."""
    d = xin.shape[-1]
    if operand is not None:
        xin, conv_w, res_w = operand(xin), operand(conv_w), operand(res_w)
    cat = torch.cat([_shift(xin, 2 * dil), _shift(xin, dil), xin], dim=-1)  # [b, n, 3d]
    y = cat @ conv_w + conv_b
    y = y * film[:, None, :d] + film[:, None, d:]
    y = torch.tanh(y) * torch.sigmoid(y)
    return y + (xin @ res_w + res_b)


def wavenet_body_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """Plain PyTorch version, the twin of ``wavenet_body_xla``: stack by
    stack, all lanes of a stack before the next.

    The stacked weights are unbound once rather than indexed per block, so
    that autograd gathers each tensor's gradient with one stack instead of
    a zero-filled full-size tensor per block (the backward of K1 and K1b is
    the vjp of this function)."""
    S, L = conv_w.shape[:2]
    conv_w, conv_b, res_w, res_b = ([w.unbind(0) for w in t.unbind(0)]
                                    for t in (conv_w, conv_b, res_w, res_b))
    film = [f.unbind(1) for f in film.unbind(1)]  # [s][l]: [b, 2d]
    lanes = [x] * L
    for s in range(S):
        lanes = [_block(lanes[l], conv_w[s][l], conv_b[s][l], res_w[s][l], res_b[s][l],
                        film[s][l], 2**l) for l in range(L)]
    return sum(lane @ w + bias for lane, w, bias in zip(lanes, skip_w.unbind(0), skip_b.unbind(0)))


def wavenet_body_lanes_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film,
                             operand=None):
    """Plain PyTorch version of K1b, the twin of `_fused_forward_per_lane`:
    lane by lane, each lane through all S stacks (lane l of stack s reads
    only lane l of stack s − 1), its skip added in lane order. Equal to
    ``wavenet_body_torch`` up to f32 reordering. ``operand`` is applied to
    both operands of every product (``wavenet_body_lanes_bf16mm_torch``)."""
    S, L = conv_w.shape[:2]
    rnd = operand if operand is not None else (lambda t: t)
    out = None
    for l in range(L):
        lane = x
        for s in range(S):
            lane = _block(lane, conv_w[s, l], conv_b[s, l], res_w[s, l], res_b[s, l],
                          film[:, s, l], 2**l, operand)
        skip = rnd(lane) @ rnd(skip_w[l]) + skip_b[l]
        out = skip if out is None else out + skip
    return out


def wavenet_body_lanes_bf16mm_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """Plain version of K1b with ``bf16_matmul`` (`_lane_kernel`'s
    ``dot``): ``wavenet_body_lanes_torch`` with both operands of every
    product rounded to bf16 and the product summed in f32 (exact products
    of bf16 values), the lane state, biases, FiLM, the gate and the skips'
    sum in f32; f32 in, f32 out."""
    return wavenet_body_lanes_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film,
                                    operand=round_bf16)


def wavenet_body_bf16_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """Plain version of K1 in bf16, the rounding points of `_wavenet_kernel`
    at bf16 inputs: the lanes in f32 from the bf16 x, every product of a
    lane and a bf16 weight summed in f32, the biases and FiLM applied in f32,
    the skips summed in f32 and the output rounded once to bf16."""
    return wavenet_body_torch(*(t.float() for t in (x, conv_w, conv_b, res_w, res_b, skip_w,
                                                    skip_b, film))).to(x.dtype)


def wavenet_body_lanes_bf16_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """Plain version of K1b in bf16 (`_lane_kernel` at bf16 inputs without
    ``bf16_matmul``): ``wavenet_body_lanes_torch`` on the f32 values, the
    output rounded once to bf16."""
    return wavenet_body_lanes_torch(*(t.float() for t in (x, conv_w, conv_b, res_w, res_b,
                                                          skip_w, skip_b, film))).to(x.dtype)


# The JAX package's budgets (`naturalspeech2_tpu/ops/wavenet_kernel.py`):
# the whole-stack kernel's, the per-lane kernel's, and the widest d that
# the per-lane kernel takes.
VMEM_SCRATCH_LIMIT_BYTES = 32 * 2**20
LANE_VMEM_LIMIT_BYTES = 64 * 2**20
LANE_MAX_DIM = 256


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _kernel_vmem_bytes(n: int, d: int, L: int) -> int:
    """The JAX package's footprint estimate of its whole-stack kernel."""
    return (L * n * d + n * d) * 4 + L * (3 * d * d + d * d + d * d) * 4


def _lane_vmem_bytes(n: int, d: int, L: int) -> int:
    """The JAX package's footprint estimate of its per-lane kernel."""
    pad = _round_up(max(8, 2 * 2 ** (L - 1)), 8)
    return ((pad + n) * d + n * d) * 4 + 2 * (2 * n * d + (3 * d * d + d * d + d * d)) * 4


def wavenet_route(n: int, d: int, layers: int) -> str:
    """The body's route at sequence length ``n``, width ``d`` and ``layers``
    lanes: ``"stack"`` (K1) within the whole-stack budget, ``"lanes"`` (K1b)
    past it at d ≤ 256 within the per-lane budget, ``"plain"``
    (``wavenet_body_torch``) otherwise. At d 128, L 8: K1 for n ≤ 6,712,
    K1b for 6,713 ≤ n ≤ 21,589; at d 512 the plain body.

    This is the reference's routing rule (the JAX package's
    `_forward_dispatch`, its integer arithmetic unchanged), kept so that
    the port runs the reference's route at every shape. It is not a limit
    of the card."""
    if _kernel_vmem_bytes(n, d, layers) <= VMEM_SCRATCH_LIMIT_BYTES:
        return "stack"
    if d <= LANE_MAX_DIM and _lane_vmem_bytes(n, d, layers) <= LANE_VMEM_LIMIT_BYTES:
        return "lanes"
    return "plain"


def pad_wavenet_weights(conv_w, conv_b, res_w, res_b, skip_w, skip_b, d_p: int):
    """The body's weights with zero channels up to ``d_p`` (conv_w per tap)."""
    S, L, _, d = conv_w.shape
    p = d_p - d
    conv = F.pad(conv_w.reshape(S, L, 3, d, d), (0, p, 0, p)).reshape(S, L, 3 * d_p, d_p)
    return (conv, F.pad(conv_b, (0, p)), F.pad(res_w, (0, p, 0, p)), F.pad(res_b, (0, p)),
            F.pad(skip_w, (0, p, 0, p)), F.pad(skip_b, (0, p)))


def pad_wavenet_inputs(x, film, d_p: int):
    """x and the FiLM γ, β with zero channels up to ``d_p``."""
    (b, S, L), d = film.shape[:3], x.shape[-1]
    film = F.pad(film.reshape(b, S, L, 2, d), (0, d_p - d)).reshape(b, S, L, 2 * d_p)
    return F.pad(x, (0, d_p - d)), film


class WavenetWeights(NamedTuple):
    """The body's weights as K1 or K1b reads them (``pack_wavenet_weights``),
    at the padded width ``d``, packed in ``fmt`` (``gemm_cache.pack_b``)."""
    blocks: torch.Tensor  # [S, L] of Bᵀ [2d, 3d], packed: tile j = conv cols 32j.., then res
    conv_b: torch.Tensor  # [S, L, d]
    res_b: torch.Tensor   # [S, L, d]
    skip: torch.Tensor    # "stack": Bᵀ [d, L·d] packed; "lanes": [L] of Bᵀ [d, d] packed
    skip_b: torch.Tensor  # "stack": Σ_l skip_b[l] [d]; "lanes": skip_b [L, d]
    d: int
    fmt: str = "split"


def block_weights(conv_w, res_w):
    """B [S, L, 3d, 2d] of every block: column 64g + i (i < 32) is conv
    column 32g + i, column 64g + 32 + i the residual's, whose rows are zero
    on taps 0 and 1 (it reads x_t, the last third of K). d % 32 == 0."""
    S, L, _, d = conv_w.shape
    res = F.pad(res_w, (0, 0, 2 * d, 0))
    b = torch.stack([w.reshape(S, L, 3 * d, d // KERNEL_ALIGN, KERNEL_ALIGN)
                     for w in (conv_w, res)], dim=-2)
    return b.reshape(S, L, 3 * d, 2 * d)


def pack_wavenet_weights(conv_w, conv_b, res_w, res_b, skip_w, skip_b,
                         route: str, bias_dtype=None, fmt=None) -> WavenetWeights:
    """The body's weights padded to a multiple of ``fmt``'s chunk (32
    channels, 64 for "bf16_sw128") and packed for the GEMM cores
    (``gemm_cache.pack_b``): the blocks' B, and the skips as K1 (``route``
    "stack": one product over the lanes side by side, the biases summed in
    f32) or K1b ("lanes": one product per lane) reads them. ``fmt``
    (default: "split" for f32 weights; "bf16_sw128", the bf16 core's, for
    bf16 ones, the mixed entry points' too) is "bf16_sw128" for K1b's
    ``bf16_matmul`` as well (f32 weights rounded to bf16). The biases take
    ``bias_dtype`` (default: their own; float32 for the mixed entry points)
    but for that f32 sum."""
    if fmt is None:
        fmt = gemm_cache.fmt_of(conv_w.dtype)
    d = conv_w.shape[-1]
    d_p = _round_up(d, gemm_cache.chunk_of(fmt))
    if d_p != d:
        conv_w, conv_b, res_w, res_b, skip_w, skip_b = pad_wavenet_weights(
            conv_w, conv_b, res_w, res_b, skip_w, skip_b, d_p)
    if bias_dtype is not None:
        conv_b, res_b, skip_b = (t.to(bias_dtype) for t in (conv_b, res_b, skip_b))
    L = skip_w.shape[0]
    blocks = gemm_cache.pack_b(block_weights(conv_w, res_w).transpose(-1, -2), fmt)
    if route == "stack":
        skip = gemm_cache.pack_b(skip_w.reshape(L * d_p, d_p).T, fmt)
        skip_b = skip_b.to(torch.float32).sum(0)
    else:
        skip = gemm_cache.pack_b(skip_w.transpose(-1, -2), fmt)
    return WavenetWeights(blocks, conv_b.contiguous(), res_b.contiguous(), skip,
                          skip_b.contiguous(), d_p, fmt)


def _dense(packed, rows: int, cols: int, fmt: str):
    hi, lo = gemm_cache.unpack_b(packed, fmt)
    return (hi + lo)[..., :rows, :cols]


def wavenet_body_packed_torch(x, film, weights: WavenetWeights, route: str):
    """The kernels' launches in plain PyTorch, from the packed weights and
    as the kernels read them: each block one product of the three dilated
    row views [x_{t−2δ} | x_{t−δ} | x_t] with its interleaved B, the FiLM
    gate on the conv half plus the residual half; the skips as one product
    over the lanes side by side (``route`` "stack", K1) or lane by lane,
    added in order ("lanes", K1b); at the padded width, cut back. Equal to
    ``wavenet_body_torch`` up to f32 reordering: the check of the padding,
    the packed layout and the dilated taps on the CPU. Weights packed
    "bf16_sw128" run ``wavenet_body_planes_torch``: three planes a lane on
    bf16 x and on K1's f32 x (the mixed entry), one on K1b's f32 x
    (``bf16_matmul``: the packed weights do not tell it from K1b's mixed
    entry, whose model is ``wavenet_body_planes_torch`` with three parts)."""
    if weights.fmt == "bf16_sw128":
        parts = 3 if x.dtype == torch.bfloat16 or route == "stack" else 1
        return wavenet_body_planes_torch(x, film, weights, route, parts=parts)[0]
    b, n, d = x.shape
    d_p = weights.d
    x, film = pad_wavenet_inputs(x, film, d_p)
    S, L = weights.blocks.shape[:2]
    bt = _dense(weights.blocks, 2 * d_p, 3 * d_p, weights.fmt)

    def block(a, s, l):
        dil = 2**l
        y = torch.cat([_shift(a, 2 * dil), _shift(a, dil), a], dim=-1) @ bt[s, l].T
        y = y.reshape(b, n, d_p // KERNEL_ALIGN, 2, KERNEL_ALIGN)
        conv, res = (y[..., i, :].reshape(b, n, d_p) for i in (0, 1))
        f = film[:, s, l, None]
        conv = (conv + weights.conv_b[s, l]) * f[..., :d_p] + f[..., d_p:]
        return torch.tanh(conv) * torch.sigmoid(conv) + res + weights.res_b[s, l]

    if route == "stack":
        lanes = [x] * L
        for s in range(S):
            lanes = [block(lanes[l], s, l) for l in range(L)]
        out = (torch.cat(lanes, dim=-1) @ _dense(weights.skip, d_p, L * d_p, weights.fmt).T
               + weights.skip_b)
    else:
        skip = _dense(weights.skip, d_p, d_p, weights.fmt)
        out = None
        for l in range(L):
            lane = x
            for s in range(S):
                lane = block(lane, s, l)
            term = lane @ skip[l].T + weights.skip_b[l]
            out = term if out is None else out + term
    return out[..., :d]


def wavenet_body_planes_torch(x, film, weights: WavenetWeights, route: str, *, parts: int = 3):
    """The bf16 core's WaveNet launches in plain PyTorch (weights packed
    "bf16_sw128"): every lane carried as ``parts`` bf16 planes, each block
    the parts' products with its interleaved B, lo first, summed in f32, the
    gate in f32, the skips over the last stack's planes (``route`` "stack":
    the lanes side by side, the biases' f32 sum; "lanes": lane by lane into
    an f32 sum). ``parts`` 3 (K1, K1b in bf16; x and FiLM bf16): the planes
    are ``split3`` of the f32 lane, each product exact (a part and a bf16
    weight), the biases and FiLM bf16, the output rounded once to bf16; on
    f32 x, FiLM and biases (the mixed entries of K1 and K1b: bf16 weights) x
    is split into three planes too and the output is f32. ``parts`` 1 (K1b's
    ``bf16_matmul``; x, FiLM and the biases f32): the plane is the lane
    rounded to bf16 (and x too), the output f32. Returns (out [b, n, d] at
    x's dtype, the last stack's lanes as the planes' f32 sum [L, b, n,
    d_p])."""
    if parts not in (1, 3):
        raise ValueError(f"wavenet_body_planes_torch: parts must be 3 or 1, got {parts}")
    b, n, d = x.shape
    d_p = weights.d
    x, film = pad_wavenet_inputs(x, film, d_p)
    film = film.float()
    S, L = weights.blocks.shape[:2]
    bt = _dense(weights.blocks, 2 * d_p, 3 * d_p, weights.fmt).float()
    conv_b, res_b = weights.conv_b.float(), weights.res_b.float()
    split = split3 if parts == 3 else (lambda v: (v.to(torch.bfloat16),))
    x_planes = split(x) if x.dtype == torch.float32 else (x,)

    def block(planes, s, l):
        dil = 2**l
        y = 0
        for part in reversed(planes):  # lo first
            a = part.float()
            y = y + torch.cat([_shift(a, 2 * dil), _shift(a, dil), a], dim=-1) @ bt[s, l].T
        y = y.reshape(b, n, d_p // KERNEL_ALIGN, 2, KERNEL_ALIGN)
        conv, res = (y[..., i, :].reshape(b, n, d_p) for i in (0, 1))
        f = film[:, s, l, None]
        conv = (conv + conv_b[s, l]) * f[..., :d_p] + f[..., d_p:]
        return split(torch.tanh(conv) * torch.sigmoid(conv) + res + res_b[s, l])

    def lanes_of(planes):
        return torch.stack([sum(p.float() for p in reversed(lane)) for lane in planes])

    if route == "stack":
        planes = [x_planes] * L
        for s in range(S):
            planes = [block(planes[l], s, l) for l in range(L)]
        skip = _dense(weights.skip, d_p, L * d_p, weights.fmt).float()
        acc = 0
        for q in reversed(range(parts)):  # lo first
            acc = acc + torch.cat([p[q].float() for p in planes], dim=-1) @ skip.T
        out = acc + weights.skip_b
    else:
        skip = _dense(weights.skip, d_p, d_p, weights.fmt).float()
        planes, out = [], None
        for l in range(L):
            lane = x_planes
            for s in range(S):
                lane = block(lane, s, l)
            planes.append(lane)
            term = 0
            for q in reversed(range(parts)):
                term = term + lane[q].float() @ skip[l].T
            term = term + weights.skip_b[l].float()
            out = term if out is None else term + out
    return out[..., :d].to(x.dtype), lanes_of(planes)


# Lanes a launch of K1b's bf16 blocks (``csrc/wavenet_lane.cu``:
# ``kLaneGroup``): the planes' scratch holds that many lanes.
LANE_GROUP = 4
# The bf16 core's chunk: k of one TMA box of A
BF16_CHUNK = gemm_cache.SW128_CHUNK


def split_taps_at(kc: int, t0: int, bi: int, *, w: int, per_lane: int, lane0: int, parts: int,
                  shared: bool, b_block0: int):
    """The twin of the bf16 core's ``SplitTaps::at`` (``csrc/gemm_bf16.cuh``):
    chunk ``kc`` of a block's A for the row tile from t0 of the grid's
    sequence bi is the box of BF16_CHUNK channels from c, rows t onward, of
    plane ``part`` of the planes' sequence ``seq`` ([G·b, parts, n, w]; for
    x, ``shared`` and one part, its batch row), the parts lo first. Returns
    ((c, t, part, seq), the chunk of the packed blocks it multiplies)."""
    per_part = 3 * w // BF16_CHUNK
    p, kb = divmod(kc, per_part)
    k = kb * BF16_CHUNK
    tap, lane = k // w, bi // per_lane
    seq = bi - lane * per_lane if shared else bi
    return (k - tap * w, t0 - ((2 - tap) << (lane0 + lane)), parts - 1 - p, seq), \
        b_block0 + lane * per_part + kb


def split_lanes_at(kc: int, t0: int, bi: int, *, batch: int, w: int, lanes: int, parts: int,
                   slot0: int, b_chunk0: int):
    """The twin of ``SplitLanes::at``: chunk ``kc`` of the skips' A
    (K = parts · lanes · w, lo first) as ``split_taps_at`` returns it."""
    per_part = lanes * w // BF16_CHUNK
    p, kb = divmod(kc, per_part)
    k = kb * BF16_CHUNK
    lane = k // w
    return (k - lane * w, t0, parts - 1 - p, (slot0 + lane) * batch + bi), b_chunk0 + kb


def scratch(b: int, n: int, d_p: int, L: int, route: str, dtype: torch.dtype, device,
            fmt: str | None = None):
    """The scratch of a kernel's entry point, in its argument order, for
    activations of ``dtype`` against weights packed in ``fmt`` (default:
    ``gemm_cache.fmt_of(dtype)``): in f32 on the split-TF32 core the f32
    lanes' ping-pong pair ([L, b, n, d_p] each for K1, [b, n, d_p] for
    K1b); in bf16 the planes' pair ([L·b, 3, n, d_p] bf16 for K1,
    [LANE_GROUP·b, 3, n, d_p] for K1b) and, for K1b, the skips' f32 sum [b,
    n, d_p]; f32 on the bf16 core (the mixed entries) x's three planes [b,
    3, n, d_p] bf16, then the planes' pair (K1's, K1b's, as in bf16; the
    skips are summed into the f32 output); for ``route`` "bf16mm" (K1b's
    ``bf16_matmul``, f32 x, whatever ``dtype``) x rounded to bf16 [b, n,
    d_p] and the one-plane pair [LANE_GROUP·b, 1, n, d_p] bf16."""
    bf16 = torch.bfloat16
    if route in ("stack", "lanes") and dtype == torch.float32 and fmt == "bf16_sw128":
        lanes = LANE_GROUP if route == "lanes" else L
        planes = torch.empty((2, lanes * b, 3, n, d_p), dtype=bf16, device=device)
        return [torch.empty((b, 3, n, d_p), dtype=bf16, device=device), planes[0], planes[1]]
    if route == "bf16mm":
        planes = torch.empty((2, LANE_GROUP * b, 1, n, d_p), dtype=bf16, device=device)
        return [torch.empty((b, n, d_p), dtype=bf16, device=device), planes[0], planes[1]]
    if dtype == bf16:
        lanes = LANE_GROUP if route == "lanes" else L
        planes = torch.empty((2, lanes * b, 3, n, d_p), dtype=dtype, device=device)
        if route == "lanes":
            return [planes[0], planes[1],
                    torch.empty((b, n, d_p), dtype=torch.float32, device=device)]
        return [planes[0], planes[1]]
    lead = (b,) if route == "lanes" else (L, b)
    state = torch.empty((2, *lead, n, d_p), dtype=torch.float32, device=device)
    return [state[0], state[1]]


def _pack_checked(conv_w, conv_b, res_w, res_b, skip_w, skip_b, route: str, bias_dtype,
                  fmt=None):
    """``pack_wavenet_weights`` after the wrapper's checks of the weights,
    which a cache hit then need not repeat."""
    _build.require_cuda("wavenet_body", conv_w.dtype, conv_w=conv_w, conv_b=conv_b, res_w=res_w,
                        res_b=res_b, skip_w=skip_w, skip_b=skip_b)
    S, L, _, d = conv_w.shape
    _build.require_shapes(
        "wavenet_body", conv_w=(conv_w, (S, L, 3 * d, d)), conv_b=(conv_b, (S, L, d)),
        res_w=(res_w, (S, L, d, d)), res_b=(res_b, (S, L, d)), skip_w=(skip_w, (L, d, d)),
        skip_b=(skip_b, (L, d)),
    )
    return pack_wavenet_weights(conv_w, conv_b, res_w, res_b, skip_w, skip_b, route, bias_dtype,
                                fmt)


def _widened(x, *weights):
    """The weights (and FiLM) at x's dtype: exact for bf16 weights against
    f32 x, as the JAX package promotes them."""
    return (x, *(w.to(x.dtype) for w in weights))


def _forward(route, x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """One body through ``route`` ("stack": K1, "lanes": K1b, "bf16mm": K1b
    with ``bf16_matmul``, None: as ``wavenet_route`` picks), or its plain
    version on a CPU tensor."""
    args = (x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)
    if route == "bf16mm":
        return _forward_bf16mm(*args)
    if route is None:
        route = wavenet_route(x.shape[1], x.shape[2], conv_w.shape[1])
    if route == "plain":  # `wavenet_body_xla` runs every operand at x.dtype
        return wavenet_body_torch(*_widened(*args))
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        if bf16:
            plain = wavenet_body_lanes_bf16_torch if route == "lanes" else wavenet_body_bf16_torch
            return plain(*args)
        plain = wavenet_body_lanes_torch if route == "lanes" else wavenet_body_torch
        return plain(*_widened(*args))
    _build.require_cuda("wavenet_body", x.dtype, x=x, film=film)
    _build.suffix("wavenet_body", x.dtype, conv_w.dtype)
    mixed = x.dtype != conv_w.dtype
    b, n, d = x.shape
    S, L = conv_w.shape[:2]
    _build.require_shapes("wavenet_body", conv_w=(conv_w, (S, L, 3 * d, d)),
                          film=(film, (b, S, L, 2 * d)))
    bias_dtype = torch.float32 if mixed else None
    entry, counter = (("ns2_wavenet_lanes", wavenet_body_lanes) if route == "lanes"
                      else ("ns2_wavenet_body", wavenet_body))
    fmt = gemm_cache.fmt_of(x.dtype, conv_w.dtype, entry[len("ns2_"):])
    wt = gemm_cache.cached(f"wavenet_body {route} {mixed}",
                           lambda *w: _pack_checked(*w, route, bias_dtype, fmt),
                           conv_w, conv_b, res_w, res_b, skip_w, skip_b)
    if conv_w.device != x.device:
        raise ValueError(f"wavenet_body: the weights are on {conv_w.device}, x on {x.device}")
    d_p = wt.d
    if d_p != d:
        x, film = pad_wavenet_inputs(x, film, d_p)
    out = torch.empty((b, n, d_p), dtype=x.dtype, device=x.device)
    state = scratch(b, n, d_p, L, route, x.dtype, x.device, fmt)
    err = _build.entry(entry, x.dtype, conv_w.dtype)(
        x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
        wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(), *(t.data_ptr() for t in state),
        out.data_ptr(), b, n, d_p, S, L, _build.stream(x),
    )
    _build.check(err, entry)
    _build.count(counter, x.dtype, conv_w.dtype)
    return out if d_p == d else out[..., :d].contiguous()


def _forward_bf16mm(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """K1b with ``bf16_matmul`` on f32 tensors: ``ns2_wavenet_lanes_bf16mm``
    on a card (the bf16 core, one plane a lane, S·L / LANE_GROUP + L + 1
    launches), ``wavenet_body_lanes_bf16mm_torch`` on the CPU."""
    args = (x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)
    bad = {t.dtype for t in args} - {torch.float32}
    if bad:
        raise TypeError(f"wavenet_body_lanes(bf16_matmul=True) takes float32 x, weights and "
                        f"FiLM (it rounds the operands of each product itself), got {bad}")
    if x.device.type == "cpu":
        return wavenet_body_lanes_bf16mm_torch(*args)
    _build.require_cuda("wavenet_body_lanes", x.dtype, x=x, film=film)
    b, n, d = x.shape
    S, L = conv_w.shape[:2]
    _build.require_shapes("wavenet_body_lanes", conv_w=(conv_w, (S, L, 3 * d, d)),
                          film=(film, (b, S, L, 2 * d)))
    wt = gemm_cache.cached("wavenet_body lanes bf16mm",
                           lambda *w: _pack_checked(*w, "lanes", None, "bf16_sw128"),
                           conv_w, conv_b, res_w, res_b, skip_w, skip_b)
    if conv_w.device != x.device:
        raise ValueError(f"wavenet_body_lanes: the weights are on {conv_w.device}, x on {x.device}")
    d_p = wt.d
    if d_p != d:
        x, film = pad_wavenet_inputs(x, film, d_p)
    out = torch.empty((b, n, d_p), dtype=torch.float32, device=x.device)
    state = scratch(b, n, d_p, L, "bf16mm", x.dtype, x.device)
    entry = "ns2_wavenet_lanes_bf16mm"
    err = getattr(_build.library(), entry)(
        x.data_ptr(), wt.blocks.data_ptr(), wt.conv_b.data_ptr(), wt.res_b.data_ptr(),
        wt.skip.data_ptr(), wt.skip_b.data_ptr(), film.data_ptr(), *(t.data_ptr() for t in state),
        out.data_ptr(), b, n, d_p, S, L, _build.stream(x),
    )
    _build.check(err, entry)
    wavenet_body_lanes.launches_bf16mm += 1
    return out if d_p == d else out[..., :d].contiguous()


def _body_f32(*args):
    """``wavenet_body_torch`` on the inputs widened to f32 (each gradient
    comes back at its input's dtype)."""
    return wavenet_body_torch(*(t.float() for t in args))


class _WavenetBody(torch.autograd.Function):
    @staticmethod
    def forward(ctx, route, *args):
        ctx.save_for_backward(*args)
        ctx.route = route
        return _forward(route, *args)

    @staticmethod
    def backward(ctx, g):
        plain = wavenet_body_lanes_bf16mm_torch if ctx.route == "bf16mm" else _body_f32
        return None, *vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[1:], g.float())


def wavenet_body(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """The WaveNet body, differentiable, by ``wavenet_route``: CUDA tensors
    run K1 (S stack launches and one skip launch of the GEMM core, counted
    as one launch in ``wavenet_body.launches``; mixed: a split pre-pass of x
    before them), K1b (L·S block launches, S·L / LANE_GROUP in bf16 and
    mixed, and L skip launches, counted as one in
    ``wavenet_body_lanes.launches``; mixed: a split pre-pass of x first)
    or the plain body; CPU tensors run ``wavenet_body_torch``. bf16 and
    mixed operands count in ``launches_bf16`` and ``launches_mixed``."""
    args = (x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _WavenetBody.apply(None, *args)
    return _forward(None, *args)  # no graph to record: the autograd Function's overhead spared


def wavenet_body_lanes(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film,
                       bf16_matmul: bool = False):
    """``wavenet_body`` through K1b whatever the shape. ``bf16_matmul``:
    every product on bf16 operands with f32 accumulation (f32 tensors
    only), counted in ``wavenet_body_lanes.launches_bf16mm``; its backward
    is the vjp of ``wavenet_body_lanes_bf16mm_torch``."""
    route = "bf16mm" if bf16_matmul else "lanes"
    args = (x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _WavenetBody.apply(route, *args)
    return _forward(route, *args)  # no graph to record: the autograd Function's overhead spared


wavenet_body.launches = wavenet_body.launches_bf16 = wavenet_body.launches_mixed = 0
wavenet_body_lanes.launches = wavenet_body_lanes.launches_bf16 = 0
wavenet_body_lanes.launches_mixed = wavenet_body_lanes.launches_bf16mm = 0
