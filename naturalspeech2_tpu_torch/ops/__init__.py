"""The port's kernels: each wrapper launches its CUDA kernel on CUDA tensors
and runs its plain PyTorch version on CPU tensors, and counts its kernel
launches in ``<wrapper>.launches`` (f32 entry points; the blocks' products
on the split-TF32 GEMM core), ``<wrapper>.launches_bf16`` (bf16 entry
points; K1, K1b, K2, K2b, K3 and K6 on the bf16 GEMM core) and, where it
has them, ``<wrapper>.launches_mixed`` (f32 activations against bf16
weights: K1, K1b, K2, K2b and K3 under AMP training; K1, K2 and K3 on
the bf16 GEMM core, K1b and K2b on the split-TF32 core's two-pass mode)
and, for K1b's
``bf16_matmul`` option (the bf16 core, one bf16 plane a lane),
``wavenet_body_lanes.launches_bf16mm``. The six noise-schedule functions
are exported here too, as the JAX package's `ops` does."""

import torch

from naturalspeech2_tpu_torch.ops.attn_block_kernel import attn_block, cross_attn_block
from naturalspeech2_tpu_torch.ops.ff_block_kernel import ff_block
from naturalspeech2_tpu_torch.ops.schedules import (  # noqa: F401  (the JAX `ops` exports)
    cosine_schedule,
    gamma_to_alpha_sigma,
    gamma_to_log_snr,
    get_schedule,
    sigmoid_schedule,
    simple_linear_schedule,
)
from naturalspeech2_tpu_torch.ops.flash_attention import flash_backward, flash_forward
from naturalspeech2_tpu_torch.ops.wavenet_kernel import wavenet_body, wavenet_body_lanes

# `ops.rvq` stays the module; its wrapper is `ops.rvq.rvq`
from naturalspeech2_tpu_torch.ops import rvq as _rvq  # noqa: E402

KERNEL_WRAPPERS = (wavenet_body, wavenet_body_lanes, attn_block, cross_attn_block, ff_block,
                   flash_forward, flash_backward, _rvq.rvq)
# The counter of each kind of entry point: f32, bf16, f32 against bf16
# weights, K1b's bf16_matmul.
COUNTERS = {torch.float32: "launches", torch.bfloat16: "launches_bf16", "mixed": "launches_mixed",
            "bf16_matmul": "launches_bf16mm"}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        for attr in COUNTERS.values():
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def launch_counts(kind=torch.float32) -> dict[str, int]:
    """Launches of each wrapper's entry points of ``kind`` (torch.float32,
    torch.bfloat16, "mixed" or "bf16_matmul") since the last reset (0 for a
    wrapper with no such entry point)."""
    attr = COUNTERS[kind]
    return {fn.__name__: getattr(fn, attr, 0) for fn in KERNEL_WRAPPERS}
