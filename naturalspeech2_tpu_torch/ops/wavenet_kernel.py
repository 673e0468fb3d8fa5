"""K1: the fused WaveNet body (twin of `naturalspeech2_tpu/ops/wavenet_kernel.py`).

``wavenet_body`` runs the CUDA kernel of ``csrc/wavenet.cu`` on a CUDA
tensor and the plain version ``wavenet_body_torch`` on a CPU tensor. It is
differentiable: as `_bwd` in the JAX package, its backward is the vjp of
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


def wavenet_body_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """Plain PyTorch version, the twin of ``wavenet_body_xla``.

    The stacked weights are unbound once rather than indexed per block, so
    that autograd gathers each tensor's gradient with one stack instead of
    a zero-filled full-size tensor per block (the backward of K1 is the vjp
    of this function)."""
    b, n, d = x.shape
    S, L = conv_w.shape[:2]
    conv_w, conv_b, res_w, res_b = ([w.unbind(0) for w in t.unbind(0)]
                                    for t in (conv_w, conv_b, res_w, res_b))
    film = [f.unbind(1) for f in film.unbind(1)]  # [s][l]: [b, 2d]
    lanes = [x] * L
    for s in range(S):
        new = []
        for l in range(L):
            xin = lanes[l]
            dil = 2**l
            x1 = F.pad(xin, (0, 0, dil, 0))[:, :n]
            x2 = F.pad(xin, (0, 0, 2 * dil, 0))[:, :n]
            cat = torch.cat([x2, x1, xin], dim=-1)  # [b, n, 3d]
            y = cat @ conv_w[s][l] + conv_b[s][l]
            y = y * film[s][l][:, None, :d] + film[s][l][:, None, d:]
            y = torch.tanh(y) * torch.sigmoid(y)
            new.append(y + (xin @ res_w[s][l] + res_b[s][l]))
        lanes = new
    return sum(lane @ w + bias for lane, w, bias in zip(lanes, skip_w.unbind(0), skip_b.unbind(0)))


def _forward(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    if x.device.type == "cpu":
        return wavenet_body_torch(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)
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
    out = torch.empty_like(x)
    lanes = torch.empty((2, L, b, n, d), dtype=torch.float32, device=x.device)
    err = _build.library().ns2_wavenet_body(
        x.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), res_w.data_ptr(),
        res_b.data_ptr(), skip_w.data_ptr(), skip_b.data_ptr(), film.data_ptr(),
        lanes[0].data_ptr(), lanes[1].data_ptr(), out.data_ptr(),
        b, n, d, S, L, _build.stream(x),
    )
    _build.check(err, "ns2_wavenet_body")
    wavenet_body.launches += 1
    return out


class _WavenetBody(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward(*args)

    @staticmethod
    def backward(ctx, g):
        return vjp(wavenet_body_torch, ctx.saved_tensors, ctx.needs_input_grad, g)


def wavenet_body(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film):
    """The WaveNet body, differentiable: the CUDA kernel for CUDA tensors
    (S stack launches and one skip launch, counted as one launch of K1),
    the plain version for CPU tensors."""
    return _WavenetBody.apply(x, conv_w, conv_b, res_w, res_b, skip_w, skip_b, film)


wavenet_body.launches = 0
