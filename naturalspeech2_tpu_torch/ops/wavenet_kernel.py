"""K1 and K1b: the fused WaveNet body (twins of `_wavenet_kernel` and
`_lane_kernel` in `naturalspeech2_tpu/ops/wavenet_kernel.py`).

``wavenet_body`` runs, on a CUDA tensor, K1 (``csrc/wavenet.cu``, every
lane of a stack at once) or, for sequences past ``wavenet_route``'s
length gate, K1b (``csrc/wavenet_lane.cu``, one lane through every stack
at a time); on a CPU tensor it runs the plain version
``wavenet_body_torch``. ``wavenet_body_lanes`` runs K1b whatever the
shape, and ``wavenet_body_lanes_torch`` on a CPU tensor. Both are
differentiable: as `_bwd` in the JAX package, the backward is the vjp of
the plain version on the saved inputs, in f32 (the JAX package has no
backward kernel here, so neither has the port).

Shapes: x [b, n, d]; conv_w [S, L, 3d, d]; conv_b, res_b [S, L, d];
res_w [S, L, d, d]; skip_w [L, d, d]; skip_b [L, d]; film [b, S, L, 2d]
(γ first, β second). Returns the summed skips [b, n, d].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.utils.helpers import vjp


def _block(xin, conv_w, conv_b, res_w, res_b, film, dil: int):
    """One WaveNet block on ``xin`` [b, n, d]: the gated, FiLM-conditioned
    causal k=3 conv with dilation ``dil`` plus the 1x1 residual; ``film``
    [b, 2d] holds γ then β."""
    n, d = xin.shape[1:]
    x1 = F.pad(xin, (0, 0, dil, 0))[:, :n]
    x2 = F.pad(xin, (0, 0, 2 * dil, 0))[:, :n]
    cat = torch.cat([x2, x1, xin], dim=-1)  # [b, n, 3d]
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


def wavenet_body_lanes_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """Plain PyTorch version of K1b, the twin of `_fused_forward_per_lane`:
    lane by lane, each lane through all S stacks (lane l of stack s reads
    only lane l of stack s − 1), its skip added in lane order. Equal to
    ``wavenet_body_torch`` up to f32 reordering."""
    S, L = conv_w.shape[:2]
    out = None
    for l in range(L):
        lane = x
        for s in range(S):
            lane = _block(lane, conv_w[s, l], conv_b[s, l], res_w[s, l], res_b[s, l],
                          film[:, s, l], 2**l)
        skip = lane @ skip_w[l] + skip_b[l]
        out = skip if out is None else out + skip
    return out


def wavenet_route(n: int, d: int, layers: int, l2_bytes: int) -> str:
    """Which kernel runs the body on a card with ``l2_bytes`` of L2 cache:
    ``"lanes"`` (K1b) when one batch row's K1 lanes, 2·L·n·d f32, exceed
    the L2 and its K1b state, 3·n·d f32, fits in it; ``"stack"`` (K1)
    otherwise. Per batch row, as the JAX package's VMEM gate
    (`_kernel_vmem_bytes(n, d, L)`), so that the port runs K1b where that
    package does: long sequences, never large batches. On a 50 MiB L2 at
    d 128, L 8 that is 6,400 < n ≤ 34,133 (the JAX package: n ≥ 6,713).
    The gate follows the reference, not speed: on an H100 K1b is slower
    than K1 at n 9000 (PERF.md)."""
    k1_lanes = 2 * layers * n * d * 4
    k1b_state = 3 * n * d * 4
    return "lanes" if k1_lanes > l2_bytes and k1b_state <= l2_bytes else "stack"


def _forward(route, x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """One body through ``route`` ("stack": K1, "lanes": K1b, None: as
    ``wavenet_route`` picks), or its plain version on a CPU tensor."""
    args = (x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)
    if x.device.type == "cpu":
        return (wavenet_body_lanes_torch if route == "lanes" else wavenet_body_torch)(*args)
    _build.require_cuda_f32(
        "wavenet_body", x=x, conv_w=conv_w, conv_b=conv_b, res_w=res_w, res_b=res_b,
        skip_w=skip_w, skip_b=skip_b, film=film,
    )
    b, n, d = x.shape
    S, L = conv_w.shape[:2]
    _build.require_shapes(
        "wavenet_body", conv_w=(conv_w, (S, L, 3 * d, d)), conv_b=(conv_b, (S, L, d)),
        res_w=(res_w, (S, L, d, d)), res_b=(res_b, (S, L, d)), skip_w=(skip_w, (L, d, d)),
        skip_b=(skip_b, (L, d)), film=(film, (b, S, L, 2 * d)),
    )
    if d % 64 != 0:
        raise ValueError(f"wavenet_body: the CUDA kernel needs d % 64 == 0, got d={d}")
    if route is None:
        route = wavenet_route(n, d, L, torch.cuda.get_device_properties(x.device).L2_cache_size)
    out = torch.empty_like(x)
    if route == "lanes":
        state = torch.empty((2, b, n, d), dtype=torch.float32, device=x.device)
        entry, counter = "ns2_wavenet_lanes", wavenet_body_lanes
    else:
        state = torch.empty((2, L, b, n, d), dtype=torch.float32, device=x.device)
        entry, counter = "ns2_wavenet_body", wavenet_body
    err = getattr(_build.library(), entry)(
        *(a.data_ptr() for a in args),
        state[0].data_ptr(), state[1].data_ptr(), out.data_ptr(), b, n, d, S, L, _build.stream(x),
    )
    _build.check(err, entry)
    counter.launches += 1
    return out


class _WavenetBody(torch.autograd.Function):
    @staticmethod
    def forward(ctx, route, *args):
        ctx.save_for_backward(*args)
        return _forward(route, *args)

    @staticmethod
    def backward(ctx, g):
        return None, *vjp(wavenet_body_torch, ctx.saved_tensors, ctx.needs_input_grad[1:], g)


def wavenet_body(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """The WaveNet body, differentiable. CUDA tensors run K1 (S stack
    launches and one skip launch, counted in ``wavenet_body.launches``) or
    K1b (L·S block launches and L skip launches, counted in
    ``wavenet_body_lanes.launches``), as ``wavenet_route`` picks for the
    card's L2; CPU tensors run ``wavenet_body_torch``."""
    return _WavenetBody.apply(None, x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)


def wavenet_body_lanes(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """``wavenet_body`` through K1b whatever the shape."""
    return _WavenetBody.apply("lanes", x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)


wavenet_body.launches = 0
wavenet_body_lanes.launches = 0
