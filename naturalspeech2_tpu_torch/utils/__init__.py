"""The port's helpers, under the names the JAX package's `utils` exports."""

from naturalspeech2_tpu_torch.utils.helpers import (
    average_over_durations,
    create_mask,
    default,
    divisible_by,
    exists,
    generate_mask_from_repeats,
    identity,
    lengths_from_mask,
    pad_or_curtail_to_length,
    prob_mask_like,
    right_pad_dims_to,
    safe_div,
    safe_log,
)

__all__ = ["exists", "default", "divisible_by", "identity", "create_mask", "lengths_from_mask",
           "pad_or_curtail_to_length", "prob_mask_like", "generate_mask_from_repeats",
           "average_over_durations", "safe_log", "safe_div", "right_pad_dims_to"]
