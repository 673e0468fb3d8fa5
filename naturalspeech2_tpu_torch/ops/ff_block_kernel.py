"""K3: the fused pre-norm feed-forward block (twin of
`naturalspeech2_tpu/ops/ff_block_kernel.py`).

    y = x + W₂·conv₃(gelu_tanh(n(x)·W_g + b_g) ∘ (n(x)·W_v + b_v)) + b₂

with n(x) the adaptive RMSNorm and conv₃ the causal k=3 conv
a_{t-2}·Wc₀ + a_{t-1}·Wc₁ + a_t·Wc₂ + b_c. ``ff_block`` takes the
`FeedForward` parameter layouts and runs the CUDA kernel of
``csrc/ff_block.cu`` on CUDA tensors and the plain version
``ff_block_torch`` on CPU tensors. It is differentiable: as `_fused_bwd`
in the JAX package, its backward is the vjp of the plain version.

``fits_fused_ff_block`` is the JAX package's shape gate, which
`FeedForward` consults before it takes the block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from naturalspeech2_tpu_torch import _build
from naturalspeech2_tpu_torch.utils.helpers import vjp


def ff_block_torch(x, gamma, beta, w_val, b_val, w_gate, b_gate, wc, bc, w2, b2):
    """Plain PyTorch version, the twin of ``ff_block_xla`` (tanh GELU).

    x: [b, n, dm]; gamma/beta: [b, dm]; w_val/w_gate: [dm, inner];
    wc: [3, inner, inner]; w2: [inner, dm].
    """
    dm = x.shape[-1]
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    xn = x / norm.clamp(min=1e-12) * math.sqrt(dm)
    xn = xn * gamma[:, None, :] + beta[:, None, :]
    val = xn @ w_val + b_val
    gate = xn @ w_gate + b_gate
    a = F.gelu(gate, approximate="tanh") * val
    return x + (causal_conv3(a, wc, bc) @ w2 + b2)


def causal_conv3(a, wc, bc):
    """The causal k=3 conv a_{t-2}·Wc₀ + a_{t-1}·Wc₁ + a_t·Wc₂ + b_c over
    ``a`` [b, n, c], as three shifted matrix products (never cuDNN, whose
    TF32 default would change the function on a card)."""
    n = a.shape[1]
    return (F.pad(a, (0, 0, 2, 0))[:, :n] @ wc[0] + F.pad(a, (0, 0, 1, 0))[:, :n] @ wc[1]
            + a @ wc[2] + bc)


# The JAX package's budget for its fused feed-forward block
# (`VMEM_BUDGET_BYTES` of `naturalspeech2_tpu/ops/ff_block_kernel.py`).
VMEM_BUDGET_BYTES = 80 * 2**20


def _pad128(x: int) -> int:
    return -(-x // 128) * 128


def _vmem_bytes(n: int, dm: int, inner: int) -> int:
    """The JAX package's footprint estimate of its fused block."""
    ip = _pad128(inner)
    acts = 4 * n * dm + n * dm + 4 * n * ip
    weights = 2 * dm * ip + 3 * ip * ip + ip * dm
    return 4 * (acts + weights)


def fits_fused_ff_block(n: int, dm: int, inner: int) -> bool:
    """Whether the feed-forward block runs fused (K3) at sequence length
    ``n``, model width ``dm`` and inner width ``inner``.

    This is the reference's routing rule (the JAX package's
    `fits_fused_ff_block`, its integer arithmetic unchanged), kept so that
    the port runs the reference's route at every shape. It is not a limit
    of the card: past it the port runs the unfused block, as the JAX
    package does."""
    return n % 8 == 0 and _vmem_bytes(n, dm, inner) <= VMEM_BUDGET_BYTES


# The fused kernel's inner width, a multiple of its 16-column thread
# grid, and the one shape it is built for: (dm, padded inner).
_INNER_ALIGN = 16
_FUSED_SHAPE = (128, 352)
# The wide path's tile width: dm and the padded inner are multiples of it.
_WIDE_ALIGN = 64


def ff_block_plain(x, gamma, beta, w1, b1, wc, bc, w2, b2):
    """``ff_block_torch`` on the `FeedForward` layouts (w1/b1 unsplit)."""
    inner = w1.shape[-1] // 2
    return ff_block_torch(x, gamma, beta, w1[:, :inner], b1[:inner], w1[:, inner:], b1[inner:],
                          wc, bc, w2, b2)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _forward(x, gamma, beta, w1, b1, wc, bc, w2, b2):
    if x.device.type == "cpu":
        return ff_block_plain(x, gamma, beta, w1, b1, wc, bc, w2, b2)
    inner = w1.shape[-1] // 2
    w_val, w_gate = w1[:, :inner], w1[:, inner:]
    b_val, b_gate = b1[:inner], b1[inner:]
    _build.require_cuda_f32(
        "ff_block", x=x, gamma=gamma, beta=beta, w1=w1, b1=b1, wc=wc, bc=bc, w2=w2, b2=b2
    )
    b, n, dm = x.shape
    _build.require_shapes(
        "ff_block", gamma=(gamma, (b, dm)), beta=(beta, (b, dm)), w1=(w1, (dm, 2 * inner)),
        b1=(b1, (2 * inner,)), wc=(wc, (3, inner, inner)), bc=(bc, (inner,)),
        w2=(w2, (inner, dm)), b2=(b2, (dm,)),
    )
    fused = (dm, _round_up(inner, _INNER_ALIGN)) == _FUSED_SHAPE
    if not fused and dm % _WIDE_ALIGN != 0:
        raise ValueError(
            f"ff_block: the CUDA kernel takes dim 128 with inner 337..352, or a dim that is a "
            f"multiple of {_WIDE_ALIGN}, got {dm}, {inner}"
        )
    inner_p = _round_up(inner, _INNER_ALIGN if fused else _WIDE_ALIGN)
    # exact zeros in the padded columns and rows change no sum
    pad = inner_p - inner
    w_val_p = F.pad(w_val, (0, pad)).contiguous()
    w_gate_p = F.pad(w_gate, (0, pad)).contiguous()
    b_val_p = F.pad(b_val, (0, pad))
    b_gate_p = F.pad(b_gate, (0, pad))
    wc_p = F.pad(wc, (0, pad, 0, pad))
    bc_p = F.pad(bc, (0, pad))
    w2_p = F.pad(w2, (0, 0, 0, pad))
    out = torch.empty_like(x)
    weights = (w_val_p, b_val_p, w_gate_p, b_gate_p, wc_p, bc_p, w2_p, b2)
    lib = _build.library()
    if fused:
        err = lib.ns2_ff_block(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *(w.data_ptr() for w in weights),
            out.data_ptr(), b, n, dm, inner_p, _build.stream(x),
        )
    else:
        scratch = torch.empty((2, b, n, inner_p), dtype=torch.float32, device=x.device)
        err = lib.ns2_ff_block_wide(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *(w.data_ptr() for w in weights),
            scratch[0].data_ptr(), scratch[1].data_ptr(), out.data_ptr(), b, n, dm, inner_p,
            _build.stream(x),
        )
    _build.check(err, "ns2_ff_block" if fused else "ns2_ff_block_wide")
    ff_block.launches += 1
    return out


class _FFBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return _forward(*args)

    @staticmethod
    def backward(ctx, g):
        return vjp(ff_block_plain, ctx.saved_tensors, ctx.needs_input_grad, g)


def ff_block(x, gamma, beta, w1, b1, wc, bc, w2, b2):
    """``x + FF(adaRMSNorm(x))``, differentiable.

    w1/b1: the GEGLU Dense(2·inner), value half first and gate half
    second; wc/bc: the causal conv [3, inner, inner]; w2/b2: the out
    Dense [inner, dm]. CUDA tensors run the kernel (one launch at dm 128,
    inner 341; three at dims that are multiples of 64, such as the scaled
    config's dm 512, inner 1365; counted as one launch of K3); CPU tensors
    run the plain version.
    """
    return _FFBlock.apply(x, gamma, beta, w1, b1, wc, bc, w2, b2)


ff_block.launches = 0
