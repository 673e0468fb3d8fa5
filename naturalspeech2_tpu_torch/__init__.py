"""PyTorch / CUDA port of naturalspeech2_tpu for one NVIDIA H100.

The JAX package is the reference; this package imports torch, numpy
and (for audio files) scipy only. Its kernels (``ops/``) are hand-written
CUDA for ``sm_90a``, built from ``csrc/`` at first use, and differentiable;
on CPU tensors each runs its plain PyTorch version.
"""

from naturalspeech2_tpu_torch.codec_trainer import CodecTrainer
from naturalspeech2_tpu_torch.models.codec import SoundStream
from naturalspeech2_tpu_torch.models.denoiser import Model
from naturalspeech2_tpu_torch.models.encodec import Encodec
from naturalspeech2_tpu_torch.distill import ProgressiveDistiller, distillation_loss
from naturalspeech2_tpu_torch.models.naturalspeech2 import (
    NaturalSpeech2,
    ddim_sample,
    ddpm_sample,
    dpmpp_sample,
    sample,
)
from naturalspeech2_tpu_torch.params import load_jax_params
from naturalspeech2_tpu_torch.trainer import Trainer

# the reference re-exports a pretrained Encodec as `EncodecWrapper`; the
# JAX package and the port name their Encodec so too
EncodecWrapper = Encodec

__all__ = ["Model", "NaturalSpeech2", "SoundStream", "Encodec", "EncodecWrapper", "Trainer",
           "CodecTrainer", "ProgressiveDistiller", "distillation_loss", "sample", "ddim_sample",
           "ddpm_sample", "dpmpp_sample", "load_jax_params"]
