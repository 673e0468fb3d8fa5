"""PyTorch / CUDA port of naturalspeech2_tpu for one NVIDIA H100.

The JAX package is the reference; this package imports torch, numpy
and (for audio files) scipy only. Its kernels (``ops/``) are hand-written
CUDA for ``sm_90a``, built from ``csrc/`` at first use, and differentiable;
on CPU tensors each runs its plain PyTorch version. The native audio
decoder (``native/``) is built with g++ at first use. The public names are
the JAX package's.
"""

from naturalspeech2_tpu_torch.version import __version__

from naturalspeech2_tpu_torch.models.naturalspeech2 import (
    NaturalSpeech2,
    ddim_sample,
    ddpm_sample,
    dpmpp_sample,
    sample,
)
from naturalspeech2_tpu_torch.models.denoiser import Model, forward_with_cond_scale
from naturalspeech2_tpu_torch.models.transformer import (
    Attention,
    ConditionableTransformer,
    Transformer,
)
from naturalspeech2_tpu_torch.models.wavenet import Wavenet
from naturalspeech2_tpu_torch.models.encoders import (
    DurationPitchPredictor,
    PerceiverResampler,
    PhonemeEncoder,
    SpeechPromptEncoder,
)
from naturalspeech2_tpu_torch.models.aligner import Aligner, BinLoss, ForwardSumLoss
from naturalspeech2_tpu_torch.models.codec import SoundStream
from naturalspeech2_tpu_torch.models.encodec import Encodec
from naturalspeech2_tpu_torch.trainer import Trainer
from naturalspeech2_tpu_torch.codec_trainer import CodecTrainer
from naturalspeech2_tpu_torch.distill import ProgressiveDistiller, distillation_loss
from naturalspeech2_tpu_torch.serve import TTSEngine, TTSServer
from naturalspeech2_tpu_torch.utils.tokenizer import Tokenizer
from naturalspeech2_tpu_torch.utils.phonemizers.espeak_wrapper import ESpeak
from naturalspeech2_tpu_torch.params import load_jax_params

# the reference re-exports a pretrained Encodec as `EncodecWrapper`; the
# JAX package and the port name their Encodec so too
EncodecWrapper = Encodec

__all__ = ["__version__", "NaturalSpeech2", "ddim_sample", "ddpm_sample", "dpmpp_sample",
           "sample", "Model", "forward_with_cond_scale", "Attention", "ConditionableTransformer",
           "Transformer", "Wavenet", "DurationPitchPredictor", "PerceiverResampler",
           "PhonemeEncoder", "SpeechPromptEncoder", "Aligner", "BinLoss", "ForwardSumLoss",
           "SoundStream", "Encodec", "EncodecWrapper", "Trainer", "CodecTrainer",
           "ProgressiveDistiller", "distillation_loss", "TTSEngine", "TTSServer", "Tokenizer",
           "ESpeak", "load_jax_params"]
