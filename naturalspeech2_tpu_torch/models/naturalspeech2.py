"""NaturalSpeech 2: diffusion over codec latents. The training losses
(`NaturalSpeech2.forward`, the twin of `NaturalSpeech2.__call__`), for a
conditional model with the duration, pitch and alignment losses of
`_conditional_inputs_and_losses`, and for a self-conditioned denoiser with
its bootstrap forward; the conditioning stack of zero-shot TTS (prompt and
phoneme encoders, duration / pitch prediction, the aligned frame
condition: `conditioning_for_sample`); and sampling by DDIM, DDPM or
DPM-Solver++(2M) with batch-doubled classifier-free guidance, then codec
decode (twins of `get_sampling_time_pairs`, `_reconstruct_x0`,
`ddim_sample`, `ddpm_sample`, `dpmpp_sample` and `sample()` in
`naturalspeech2_tpu/models/naturalspeech2.py`).

Randomness is explicit: the diffusion times and noise, the random CFG
drop of training, the self-conditioning draw and the samplers' starting
noise (and DDPM's noise at every step) are drawn from a
``torch.Generator`` or taken as ``times=`` / ``noise=`` /
``cond_drop_mask=`` / ``self_cond_mask=`` / ``step_noise=`` (how the tests
inject JAX's draws). Dropout in the encoders draws from torch's default
generator.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from naturalspeech2_tpu_torch.models.aligner import Aligner, BinLoss, ForwardSumLoss
from naturalspeech2_tpu_torch.models.codec import SoundStream
from naturalspeech2_tpu_torch.models.denoiser import Model, forward_with_cond_scale
from naturalspeech2_tpu_torch.models.encoders import (
    DurationPitchPredictor,
    PhonemeEncoder,
    SpeechPromptEncoder,
)
from naturalspeech2_tpu_torch.ops.mel import audio_to_mel
from naturalspeech2_tpu_torch.ops.pitch import compute_pitch, compute_pitch_nccf, f0_to_coarse
from naturalspeech2_tpu_torch.ops.schedules import (
    gamma_to_alpha_sigma,
    gamma_to_log_snr,
    get_schedule,
)
from naturalspeech2_tpu_torch.utils.helpers import (
    average_over_durations,
    create_mask,
    generate_mask_from_repeats,
    prob_mask_like,
    safe_div,
    safe_log,
)

SAMPLERS = ("ddim", "ddpm", "dpmpp")


@contextlib.contextmanager
def _eval_mode(module: nn.Module):
    """Run with every submodule in eval mode (no dropout), then restore
    each one's mode: the JAX package's ``deterministic=True``."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield
    finally:
        for m, training in modes:
            m.training = training


# The dtypes `sample(dtype=)` runs the denoiser in (None: the parameters' own).
SAMPLE_DTYPES = (None, torch.float32, torch.bfloat16)


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``module`` with its float32 parameters and buffers at ``dtype``, as
    the JAX package casts a parameter tree: ``module`` itself when none is
    float32, else a copy holding the cast tensors (without gradients);
    ``module`` is left as it is."""
    f32 = [t for t in (*module.parameters(), *module.buffers()) if t.dtype == torch.float32]
    if not f32 or dtype == torch.float32:
        return module
    memo = {}
    for t in f32:
        cast = t.detach().to(dtype)
        memo[id(t)] = nn.Parameter(cast, requires_grad=False) if isinstance(t, nn.Parameter) else cast
    return copy.deepcopy(module, memo)


def with_denoiser_dtype(ns2: "NaturalSpeech2", dtype: torch.dtype) -> "NaturalSpeech2":
    """A shallow copy of ``ns2`` whose denoiser (``model``) runs in
    ``dtype`` (``cast_floating``); the codec and the conditioning stack are
    shared with ``ns2`` and stay float32. What ``TTSEngine(dtype=)`` holds,
    so that its weights are cast, and packed for the kernels, once."""
    clone = copy.copy(ns2)
    clone._modules = dict(ns2._modules)
    clone._modules["model"] = cast_floating(ns2.model, dtype)
    return clone


class NaturalSpeech2(nn.Module):
    """Holds the denoiser, the codec and the diffusion settings; its
    forward returns the unconditional training losses.

    With ``model.condition_on_prompt`` it also holds the conditioning
    stack, sized as the JAX package's defaults unless the ``*_kwargs``
    override them: `PhonemeEncoder`, `SpeechPromptEncoder`,
    `DurationPitchPredictor`, the `Aligner` and the pitch embedding.
    ``pitch_space="log"`` means the pitch trunk predicts log1p(F0 Hz).
    Training estimates pitch by ACF (``calc_pitch_with_pyworld=True``, the
    JAX package's stand-in for pyworld) or NCCF + Viterbi, and the mel at
    ``mel_hop_length`` (``audio_to_mel_kwargs`` override its settings);
    the conditional losses are weighted by the ``*_loss_weight`` fields,
    the duration and pitch ones masked to real phonemes with
    ``mask_duration_pitch_loss``. ``schedule_kwargs`` go to the γ(t)
    schedule; ``target_sample_hz`` is the audio rate when there is no
    codec. ``tokenizer`` (host-side, `utils.tokenizer.Tokenizer`) lets
    `sample` take raw text. ``sampler`` ("ddim", "ddpm" or "dpmpp"; None:
    DDIM, or DDPM with ``use_ddim=False``) picks `sample`'s sampler. A
    self-conditioned denoiser (``Model(self_cond=True)``) trains on its own
    x̂₀ estimate for a ``train_prob_self_cond`` share of the rows.
    """

    def __init__(
        self,
        model: Model,
        codec: Optional[SoundStream] = None,
        timesteps: int = 1000,
        use_ddim: bool = True,
        sampler: Optional[str] = None,
        noise_schedule: str = "sigmoid",
        objective: str = "v",
        time_difference: float = 0.0,
        scale: float = 1.0,
        min_snr_loss_weight: bool = True,
        min_snr_gamma: float = 5.0,
        rvq_cross_entropy_loss_weight: float = 0.0,
        dim_codebook: int = 128,
        duration_pitch_dim: int = 512,
        aligner_dim_in: int = 80,
        aligner_dim_hidden: int = 512,
        aligner_attn_channels: int = 80,
        num_phoneme_tokens: int = 150,
        pitch_emb_dim: int = 256,
        pitch_emb_pp_hidden_dim: int = 512,
        pitch_space: str = "log",
        mask_phoneme_encoder: bool = False,
        phoneme_enc_kwargs: Optional[dict] = None,
        prompt_enc_kwargs: Optional[dict] = None,
        duration_pitch_kwargs: Optional[dict] = None,
        schedule_kwargs: Optional[dict] = None,
        target_sample_hz: Optional[int] = None,
        calc_pitch_with_pyworld: bool = True,
        mel_hop_length: int = 160,
        audio_to_mel_kwargs: Optional[dict] = None,
        duration_loss_weight: float = 1.0,
        pitch_loss_weight: float = 1.0,
        aligner_loss_weight: float = 1.0,
        aligner_bin_loss_weight: float = 0.0,
        mask_duration_pitch_loss: bool = True,
        tokenizer=None,
        train_prob_self_cond: float = 0.9,
    ):
        super().__init__()
        self.use_ddim = use_ddim
        self.sampler = sampler
        if self.sampler_name not in SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler_name!r}")
        if objective not in {"x0", "eps", "v"}:
            raise ValueError(f"unknown objective {objective!r}")
        if scale > 1.0:
            raise ValueError(f"scale must be <= 1, got {scale}")
        if codec is not None and model.dim != codec.codebook_dim:
            raise ValueError(
                f"model dim {model.dim} must equal codec codebook dim {codec.codebook_dim}"
            )
        get_schedule(noise_schedule)  # validates the name
        self.model = model
        self.codec = codec
        self.tokenizer = tokenizer
        self.timesteps = timesteps
        self.train_prob_self_cond = train_prob_self_cond
        self.noise_schedule = noise_schedule
        self.schedule_kwargs = dict(schedule_kwargs or {})
        self.target_sample_hz = target_sample_hz
        self.objective = objective
        self.time_difference = time_difference
        self.scale = scale
        self.min_snr_loss_weight = min_snr_loss_weight
        self.min_snr_gamma = min_snr_gamma
        self.rvq_cross_entropy_loss_weight = rvq_cross_entropy_loss_weight
        if pitch_space not in ("log", "hz"):
            raise ValueError(f"pitch_space must be 'log' or 'hz', got {pitch_space!r}")
        self.pitch_space = pitch_space
        self.mask_phoneme_encoder = mask_phoneme_encoder
        self.calc_pitch_with_pyworld = calc_pitch_with_pyworld
        self.mel_hop_length = mel_hop_length
        self.audio_to_mel_kwargs = dict(audio_to_mel_kwargs or {})
        self.aligner_dim_in = aligner_dim_in
        self.duration_loss_weight = duration_loss_weight
        self.pitch_loss_weight = pitch_loss_weight
        self.aligner_loss_weight = aligner_loss_weight
        self.aligner_bin_loss_weight = aligner_bin_loss_weight
        self.mask_duration_pitch_loss = mask_duration_pitch_loss
        if self.conditional:
            self.phoneme_enc = PhonemeEncoder(num_tokens=num_phoneme_tokens,
                                              **(phoneme_enc_kwargs or {}))
            self.prompt_enc = SpeechPromptEncoder(
                dim_codebook=codec.codebook_dim if codec is not None else dim_codebook,
                **(prompt_enc_kwargs or {}),
            )
            self.duration_pitch = DurationPitchPredictor(dim=duration_pitch_dim,
                                                         **(duration_pitch_kwargs or {}))
            self.aligner = Aligner(aligner_dim_in, aligner_dim_hidden, aligner_attn_channels)
            self.aligner_loss = ForwardSumLoss()
            self.bin_loss = BinLoss()
            self.pitch_emb = nn.Embedding(pitch_emb_dim, pitch_emb_pp_hidden_dim)
            widths = {"prompt encoding": self.prompt_enc.dim_out,
                      "phoneme encoding": self.phoneme_enc.conv.conv.out_channels,
                      "model's prompt input": model.to_prompt_cond.in_features,
                      "pitch embedding": pitch_emb_pp_hidden_dim,
                      "model's frame condition": model.cond_to_model_dim.in_features}
            if len(set(widths.values())) != 1:
                raise ValueError(f"the conditioning widths must agree: {widths}")

    @property
    def conditional(self) -> bool:
        return self.model.condition_on_prompt

    @property
    def dim(self) -> int:
        return self.codec.codebook_dim if self.codec is not None else self.model.dim

    @property
    def sampler_name(self) -> str:
        """The sampler `sample` runs: ``sampler``, else DDIM (DDPM with
        ``use_ddim=False``)."""
        return self.sampler or ("ddim" if self.use_ddim else "ddpm")

    @property
    def sample_hz(self) -> Optional[int]:
        """The codec's rate, or ``target_sample_hz`` without a codec."""
        return self.codec.target_sample_hz if self.codec is not None else self.target_sample_hz

    def gamma_schedule(self, times: torch.Tensor) -> torch.Tensor:
        return get_schedule(self.noise_schedule)(times, **self.schedule_kwargs)

    def forward(
        self,
        audio: torch.Tensor,
        *,
        text: Optional[torch.Tensor] = None,
        text_lens: Optional[torch.Tensor] = None,
        mel: Optional[torch.Tensor] = None,
        mel_lens: Optional[torch.Tensor] = None,
        codes: Optional[torch.Tensor] = None,
        prompt: Optional[torch.Tensor] = None,
        pitch: Optional[torch.Tensor] = None,
        times: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        cond_drop_mask=None,
        self_cond_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training losses: ``{"loss", "diffusion"}``; a conditional model
        adds ``"duration"``, ``"pitch"`` and ``"align"``, weighted into
        ``"loss"``; a positive ``rvq_cross_entropy_loss_weight`` adds
        ``"rvq_ce"``.

        ``audio`` is raw audio [b, T], encoded by the frozen codec without
        gradient (the RVQ cross-entropy needs its codes), or latents
        [b, n, dim] (with ``codes`` for the cross-entropy). A conditional
        model takes phoneme ids ``text`` [b, t_x] (``text_lens`` [b]) and the
        speech ``prompt`` (raw audio [b, T_p] or latents); the mel [b,
        n_mels, t] (``mel_lens``) and frame pitch [b, 1, t] in Hz are
        computed from raw audio unless given. ``times`` [b] and ``noise``
        [b, n, dim] are drawn from ``generator`` unless given, and in
        training mode the CFG drop masks too unless ``cond_drop_mask`` (as
        `Model` takes it) is given. Dropout is on in training mode only.

        A self-conditioned denoiser first runs a bootstrap forward without
        gradient and conditions the real one on its x̂₀ estimate in the rows
        of ``self_cond_mask`` [b] bool (zeros elsewhere): in training mode
        a Bernoulli(``train_prob_self_cond``) draw from ``generator`` unless
        given, in eval mode every row. Both forwards share one pair of CFG
        drop masks, drawn once before the bootstrap.
        """
        prompt_enc = cond = None
        aux_loss, aux = 0.0, {}
        if self.conditional:
            prompt_enc, cond, aux_loss, aux = self._conditional_inputs_and_losses(
                audio, text, text_lens, mel, mel_lens, prompt, pitch)
        if audio.ndim == 2:
            if self.codec is None:
                raise ValueError("raw audio needs a codec")
            with torch.no_grad():
                audio, codes, _ = self.codec(audio, return_encoded=True)
        b, n, d = audio.shape
        if d != self.dim:
            raise ValueError(f"latents have width {d}, the model takes {self.dim}")
        if times is None:
            times = torch.rand(b, generator=generator, device=audio.device)
        if noise is None:  # at the latents' dtype, as JAX draws it
            noise = torch.randn(audio.shape, generator=generator, device=audio.device,
                                dtype=audio.dtype)

        gamma = self.gamma_schedule(times)[:, None, None]
        alpha, sigma = gamma_to_alpha_sigma(gamma, self.scale)
        # f32 times promote bf16 latents and noise (AMP training): the
        # denoiser's activations stay f32, as in JAX
        noised = alpha * audio + sigma * noise
        x_self_cond = None
        if self.model.self_cond:
            p = self.model.cond_drop_prob
            if cond_drop_mask is None and self.conditional and p > 0.0 and self.training:
                cond_drop_mask = tuple(prob_mask_like((b,), p, generator, audio.device)
                                       for _ in range(2))
            if self_cond_mask is None:
                self_cond_mask = (prob_mask_like((b,), self.train_prob_self_cond, generator,
                                                 audio.device) if self.training else
                                  torch.ones(b, dtype=torch.bool, device=audio.device))
            with torch.no_grad():
                est = self.model(noised, times, prompt=prompt_enc, cond=cond,
                                 cond_drop_mask=cond_drop_mask, generator=generator)
                x0_est = _reconstruct_x0(self.objective, noised, est, alpha, sigma)
                x_self_cond = torch.where(self_cond_mask[:, None, None], x0_est, 0.0)
        pred = self.model(noised, times, prompt=prompt_enc, cond=cond,
                          cond_drop_mask=cond_drop_mask, generator=generator,
                          x_self_cond=x_self_cond)

        if self.objective == "eps":
            target = noise
        elif self.objective == "x0":
            target = audio
        else:  # v
            target = alpha * noise - sigma * audio
        loss = ((pred - target) ** 2).mean(dim=(1, 2))  # per sample

        # min-SNR weighting per sample (PARITY #10)
        snr = ((alpha * alpha) / (sigma * sigma))[:, 0, 0]
        clipped_snr = snr.clamp(max=self.min_snr_gamma) if self.min_snr_loss_weight else snr
        if self.objective == "eps":
            loss_weight = clipped_snr / snr
        elif self.objective == "x0":
            loss_weight = clipped_snr
        else:
            loss_weight = clipped_snr / (snr + 1)
        diffusion = (loss * loss_weight).mean()
        total = diffusion + aux_loss
        losses = {"loss": total, "diffusion": diffusion, **aux}

        if self.rvq_cross_entropy_loss_weight > 0 and codes is not None:
            x_start = _reconstruct_x0(self.objective, audio, pred, alpha, sigma)
            _, ce = self.codec.rq(x_start, codes)
            losses["rvq_ce"] = ce
            losses["loss"] = total + self.rvq_cross_entropy_loss_weight * ce
        return losses

    def _conditional_inputs_and_losses(self, audio, text, text_lens, mel, mel_lens, prompt,
                                       pitch):
        """(prompt encoding, frame condition [b, t, dim_prompt], the weighted
        sum of the conditional losses, {"duration", "pitch", "align"}). The
        frame condition is at the mel's frames (hop ``mel_hop_length``),
        which the denoiser cuts or pads to the latents' length."""
        if prompt is None or text is None:
            raise ValueError("a conditional model trains on prompt= and text=")
        batch, text_max = prompt.shape[0], text.shape[-1]
        if text_lens is None:
            text_lens = torch.full((batch,), text_max, dtype=torch.int64, device=text.device)
        text_lens = text_lens.clamp(max=text_max)
        text_mask = create_mask(text_lens, text_max)

        prompt_enc = self.prompt_enc(self.process_prompt(prompt))
        phoneme_enc = self.phoneme_enc(text, mask=text_mask if self.mask_phoneme_encoder else None)
        if (pitch is None or mel is None) and audio.ndim != 2:
            raise ValueError("pitch and mel are computed from raw audio; pass pitch= and mel= "
                             "with latents")
        if pitch is None:
            estimate = compute_pitch if self.calc_pitch_with_pyworld else compute_pitch_nccf
            pitch = estimate(audio, sample_rate=self.sample_hz,
                             hop_length=self.mel_hop_length)[:, None, :]
        if mel is None:
            mel = audio_to_mel(audio, **{"sample_rate": self.sample_hz,
                                         "n_mels": self.aligner_dim_in,
                                         "hop_length": self.mel_hop_length,
                                         **self.audio_to_mel_kwargs})
            mel = mel[..., : pitch.shape[-1]]
        pitch = pitch[..., : mel.shape[-1]]
        mel_max = mel.shape[-1]
        if mel_lens is None:
            mel_lens = torch.full((batch,), mel_max, dtype=torch.int64, device=mel.device)
        mel_lens = mel_lens.clamp(max=mel_max)
        mel_mask = create_mask(mel_lens, mel_max)

        aln_hard, _, aln_log, aln_mask = self.aligner(phoneme_enc, text_mask, mel, mel_mask)
        duration_pred, pitch_pred = self.duration_pitch(phoneme_enc, prompt_enc)
        pitch_phon = average_over_durations(pitch, aln_hard)  # [b, 1, t_x] in Hz
        cond = self.expand_encodings(phoneme_enc, aln_mask.to(phoneme_enc.dtype), pitch_phon)

        pitch_target = torch.log1p(pitch_phon[:, 0]) if self.pitch_space == "log" else pitch_phon[:, 0]
        duration_err = (aln_hard - duration_pred).abs()
        pitch_err = (pitch_target - pitch_pred).abs()
        if self.mask_duration_pitch_loss:  # real phonemes only (PARITY #12)
            tmask = text_mask.to(duration_pred.dtype)
            denom = tmask.sum().clamp(min=1.0)
            duration_loss = (duration_err * tmask).sum() / denom
            pitch_loss = (pitch_err * tmask).sum() / denom
        else:  # the reference's mean over padding too
            duration_loss, pitch_loss = duration_err.mean(), pitch_err.mean()
        align_loss = self.aligner_loss(aln_log, text_lens, mel_lens)
        if self.aligner_bin_loss_weight > 0.0:
            align_loss = align_loss + (self.bin_loss(aln_mask, aln_log, text_lens)
                                       * self.aligner_bin_loss_weight)
        aux_loss = (duration_loss * self.duration_loss_weight
                    + pitch_loss * self.pitch_loss_weight
                    + align_loss * self.aligner_loss_weight)
        return prompt_enc, cond, aux_loss, {"duration": duration_loss, "pitch": pitch_loss,
                                            "align": align_loss}

    # ------------------------------------------------------------------ #
    # conditioning for sampling
    # ------------------------------------------------------------------ #

    def process_prompt(self, prompt: torch.Tensor) -> torch.Tensor:
        """Raw prompt audio [b, T] → codec latents [b, T // hop, dim]
        (the last whole frames), without gradient; 3-D latents pass
        through."""
        if prompt.ndim == 2:
            if self.codec is None:
                raise ValueError("raw prompt audio needs a codec")
            with torch.no_grad():
                prompt, _, _ = self.codec(prompt, return_encoded=True, curtail_from_left=True)
        return prompt

    def expand_encodings(self, phoneme_enc: torch.Tensor, attn: torch.Tensor,
                         pitch: torch.Tensor) -> torch.Tensor:
        """Phoneme encodings [b, t_x, d] and the pitch embedding of
        ``pitch`` [b, 1, t_x] (Hz), expanded to frames through the alignment
        ``attn`` [b, t_x, n] (float): [b, n, d]."""
        expanded_dur = torch.einsum("btn,btd->bnd", attn, phoneme_enc)
        pitch_emb = self.pitch_emb(f0_to_coarse(pitch[:, 0],
                                                f0_bin=self.pitch_emb.num_embeddings))
        return expanded_dur + torch.einsum("btn,btd->bnd", attn, pitch_emb)

    def conditioning_for_sample(
        self,
        prompt: torch.Tensor,
        text: torch.Tensor,
        text_lens: Optional[torch.Tensor] = None,
        max_frames: Optional[int] = None,
        pitch: Optional[torch.Tensor] = None,
        duration: Optional[torch.Tensor] = None,
    ):
        """Encode the prompt (raw audio [b, T] or latents) and the phoneme
        ids ``text`` [b, t_x], predict duration and pitch, and expand the
        text to ``max_frames`` frames (default 2·t_x): ``(prompt_enc,
        cond, duration)``. ``pitch`` (F0 Hz) and ``duration`` (frames),
        each [b, t_x], replace the predictions. Float durations are
        truncated. Runs without dropout whatever the module's mode."""
        if not self.conditional:
            raise ValueError("conditioning needs a Model with condition_on_prompt=True")
        with _eval_mode(self):
            prompt_enc = self.prompt_enc(self.process_prompt(prompt))
            text_mask = None
            if self.mask_phoneme_encoder and text_lens is not None:
                width = text.shape[-1]
                text_mask = create_mask(text_lens.clamp(max=width), width)
            phoneme_enc = self.phoneme_enc(text, mask=text_mask)
            duration_pred, pitch_pred = self.duration_pitch(phoneme_enc, prompt_enc)
        if duration is None:
            duration = duration_pred
        if pitch is None:  # the prediction → Hz; an explicit pitch is in Hz
            pitch = torch.expm1(pitch_pred) if self.pitch_space == "log" else pitch_pred
        if max_frames is None:
            max_frames = text.shape[-1] * 2
        aln_mask = generate_mask_from_repeats(duration, max_frames).to(phoneme_enc.dtype)
        cond = self.expand_encodings(phoneme_enc, aln_mask, pitch[:, None, :])
        return prompt_enc, cond, duration


def get_sampling_time_pairs(timesteps: int, device=None) -> torch.Tensor:
    """(t, t_next) pairs on linspace 1 → 0, ``[T, 2]``."""
    times = torch.linspace(1.0, 0.0, timesteps + 1, device=device)
    return torch.stack([times[:-1], times[1:]], dim=-1)


def _reconstruct_x0(objective, audio, model_output, alpha, sigma):
    if objective == "x0":
        return model_output
    if objective == "eps":
        return safe_div(audio - sigma * model_output, alpha)
    return alpha * audio - sigma * model_output  # v


def _starting_noise(shape, device, generator, noise):
    if noise is not None:
        if tuple(noise.shape) != tuple(shape):
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {tuple(shape)}")
        if noise.device != device:
            raise ValueError(f"noise is on {noise.device}, the sampler runs on {device}")
        return noise.to(torch.float32)
    return torch.randn(shape, generator=generator, device=device)


def _sampler_device(device, noise) -> torch.device:
    """``device``, else the device of ``noise`` when given, else the current
    CUDA device: the samplers run on the card unless asked for the CPU."""
    if device is None:
        device = noise.device if noise is not None else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _schedule(pairs, gamma_schedule, scale, time_difference):
    """α, σ at each step's t and α, σ at its t_next − ``time_difference``
    (clipped at 0), each [T]; and the two γ."""
    gamma = gamma_schedule(pairs[:, 0])
    gamma_next = gamma_schedule((pairs[:, 1] - time_difference).clamp(min=0.0))
    return (*gamma_to_alpha_sigma(gamma, scale), *gamma_to_alpha_sigma(gamma_next, scale),
            gamma, gamma_next)


def _denoise(denoise_fn, audio, times, self_cond: bool, x_prev):
    return denoise_fn(audio, times, x_prev) if self_cond else denoise_fn(audio, times)


@torch.no_grad()
def ddim_sample(
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    shape: Tuple[int, ...],
    *,
    timesteps: int,
    gamma_schedule: Callable[[torch.Tensor], torch.Tensor],
    objective: str = "v",
    scale: float = 1.0,
    time_difference: float = 0.0,
    self_cond: bool = False,
    device: Optional[torch.device | str] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM from pure noise to latents ``shape`` in ``timesteps`` steps.

    ``denoise_fn(audio, times)`` is the model forward; with ``self_cond``
    it is called as ``denoise_fn(audio, times, x_self_cond)`` with the
    previous step's x̂₀ (zeros at the first step). The starting noise is
    ``noise`` if given, else drawn from ``generator``. It runs on
    ``device``: by default the device of ``noise`` when given, else the
    current CUDA device; a caller asks for the CPU with ``device="cpu"``.
    """
    device = _sampler_device(device, noise)
    audio = _starting_noise(shape, device, generator, noise)
    pairs = get_sampling_time_pairs(timesteps, device=device)
    alpha, sigma, alpha_next, sigma_next, _, _ = _schedule(pairs, gamma_schedule, scale,
                                                           time_difference)
    x_start = torch.zeros_like(audio)
    for i in range(timesteps):
        times = pairs[i, 0].expand(shape[0])
        model_output = _denoise(denoise_fn, audio, times, self_cond, x_start)
        x_start = _reconstruct_x0(objective, audio, model_output, alpha[i], sigma[i])
        pred_noise = safe_div(audio - alpha[i] * x_start, sigma[i])
        audio = x_start * alpha_next[i] + pred_noise * sigma_next[i]
    return audio


@torch.no_grad()
def dpmpp_sample(
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    shape: Tuple[int, ...],
    *,
    timesteps: int,
    gamma_schedule: Callable[[torch.Tensor], torch.Tensor],
    objective: str = "v",
    scale: float = 1.0,
    time_difference: float = 0.0,
    self_cond: bool = False,
    device: Optional[torch.device | str] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M) (Lu et al. 2022): the second-order multistep ODE
    solver in the x̂₀ parameterisation, one model call a step, with
    `ddim_sample`'s arguments.

    With λ = ½·log-SNR and h = λ_next − λ, a step is
    x ← (σ_next/σ)·x − α_next·(e^{−h} − 1)·D, where
    D = x̂₀ + (h / h_prev)·(x̂₀ − x̂₀_prev)/2 extrapolates from the previous
    step's x̂₀ (h_prev = λ − λ_prev, λ_prev starting at λ(1)). It falls
    back to first order, D = x̂₀ (a DDIM step), at the first step, where
    h_prev ≤ 1e-8 (the clipped log-SNR region near t = 1) and where h is
    not finite (the last step of a schedule with γ(0) = 1). The schedule's
    arithmetic, the gate included, is computed for all steps at once on the
    device, so no step waits for the host.
    """
    device = _sampler_device(device, noise)
    audio = _starting_noise(shape, device, generator, noise)
    pairs = get_sampling_time_pairs(timesteps, device=device)
    alpha, sigma, alpha_next, sigma_next, gamma, gamma_next = _schedule(
        pairs, gamma_schedule, scale, time_difference)
    lam = 0.5 * gamma_to_log_snr(gamma, scale)
    lam_next = 0.5 * gamma_to_log_snr(gamma_next, scale)
    lam_one = 0.5 * gamma_to_log_snr(gamma_schedule(torch.ones(1, device=device)), scale)
    h = lam_next - lam
    h_prev = lam - torch.cat([lam_one, lam[:-1]])
    first = torch.arange(timesteps, device=device) == 0
    use_2nd = ~first & torch.isfinite(h) & (h_prev > 1e-8)
    ratio = torch.where(use_2nd, h / h_prev.clamp(min=1e-8), 0.0)
    keep = safe_div(sigma_next, sigma)
    step = alpha_next * torch.expm1(-h)
    x0_prev = torch.zeros_like(audio)
    for i in range(timesteps):
        times = pairs[i, 0].expand(shape[0])
        model_output = _denoise(denoise_fn, audio, times, self_cond, x0_prev)
        x0 = _reconstruct_x0(objective, audio, model_output, alpha[i], sigma[i])
        data = x0 + ratio[i] * (x0 - x0_prev) / 2.0
        audio = keep[i] * audio - step[i] * data
        x0_prev = x0
    return audio


@torch.no_grad()
def ddpm_sample(
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    shape: Tuple[int, ...],
    *,
    timesteps: int,
    gamma_schedule: Callable[[torch.Tensor], torch.Tensor],
    objective: str = "v",
    scale: float = 1.0,
    time_difference: float = 0.0,
    self_cond: bool = False,
    device: Optional[torch.device | str] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The DDPM ancestral sampler, with `ddim_sample`'s arguments.

    Each step's t_next is ``clip(t_next − time_difference, 0)``; with
    c = −expm1(logSNR − logSNR_next) the step is
    x ← α_next·(x·(1 − c)/max(α, 1e-10) + c·x̂₀) + σ_next·√c·z, the variance
    through ``safe_log``, and z = 0 where t_next is 0. The fresh noise z of
    step i is ``step_noise[i]`` (``step_noise`` [timesteps, *shape]) if
    given, else drawn from ``generator`` at that step.
    """
    device = _sampler_device(device, noise)
    audio = _starting_noise(shape, device, generator, noise)
    if step_noise is not None:
        if tuple(step_noise.shape) != (timesteps, *shape):
            raise ValueError(f"step_noise has shape {tuple(step_noise.shape)}, expected "
                             f"{(timesteps, *shape)}")
        if step_noise.device != device:
            raise ValueError(f"step_noise is on {step_noise.device}, the sampler runs on {device}")
        step_noise = step_noise.to(torch.float32)
    pairs = get_sampling_time_pairs(timesteps, device=device)
    t_next = (pairs[:, 1] - time_difference).clamp(min=0.0)
    gamma, gamma_next = gamma_schedule(pairs[:, 0]), gamma_schedule(t_next)
    alpha, sigma = gamma_to_alpha_sigma(gamma, scale)
    alpha_next, sigma_next = gamma_to_alpha_sigma(gamma_next, scale)
    c = -torch.expm1(gamma_to_log_snr(gamma, scale) - gamma_to_log_snr(gamma_next, scale))
    alpha_floor = alpha.clamp(min=1e-10)
    std = torch.exp(0.5 * safe_log(sigma_next**2 * c))
    std = torch.where(t_next > 0, std, 0.0)
    x_start = torch.zeros_like(audio)
    for i in range(timesteps):
        times = pairs[i, 0].expand(shape[0])
        model_output = _denoise(denoise_fn, audio, times, self_cond, x_start)
        x_start = _reconstruct_x0(objective, audio, model_output, alpha[i], sigma[i])
        mean = alpha_next[i] * (audio * (1 - c[i]) / alpha_floor[i] + c[i] * x_start)
        z = (step_noise[i] if step_noise is not None
             else torch.randn(shape, generator=generator, device=device))
        audio = mean + std[i] * z
    return audio


SAMPLER_FNS = {"ddim": ddim_sample, "ddpm": ddpm_sample, "dpmpp": dpmpp_sample}


@torch.no_grad()
def sample(
    ns2: NaturalSpeech2,
    *,
    length: int,
    batch_size: int = 1,
    timesteps: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    prompt: Optional[torch.Tensor] = None,
    text=None,
    text_lens: Optional[torch.Tensor] = None,
    cond_scale: float = 1.0,
    cfg_rescale: float = 0.0,
    cfg_interval: Optional[Tuple[float, float]] = None,
    pitch: Optional[torch.Tensor] = None,
    duration: Optional[torch.Tensor] = None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``ns2``'s sampler (``ns2.sampler_name``: DDIM, DDPM or DPM++) over
    ``[batch_size, length, dim]`` latents, then codec decode to
    ``[batch_size, length·hop]`` audio (the latents if ``ns2`` has no
    codec). Runs on the device of ``ns2``'s parameters, without dropout;
    ``timesteps`` overrides the configured step count. The starting noise
    is ``noise`` or drawn from ``generator``; DDPM's fresh noise at every
    step is ``step_noise`` [timesteps, batch, length, dim] or drawn from
    ``generator``. A self-conditioned denoiser gets the previous step's
    x̂₀ (zeros at the first step) at every step, guided or not.

    A conditional ``ns2`` takes the speech ``prompt`` (raw audio [b, T] or
    latents) and phoneme ids ``text`` [b, t_x], or a list of strings that
    ``ns2.tokenizer`` turns into ids on the host; the batch is the prompt's.
    ``cond_scale`` ≠ 1 guides every step with one batch-doubled forward,
    or only the steps whose time lies in ``cfg_interval=(lo, hi)``;
    ``cfg_rescale``, ``pitch`` and ``duration`` are as in
    `forward_with_cond_scale` and `NaturalSpeech2.conditioning_for_sample`.

    ``dtype=torch.bfloat16`` runs the denoiser, one network forward per
    step, in bf16, as the JAX ``sample(dtype=jnp.bfloat16)``: a bf16 copy
    of its float parameters for the call (none if they are bf16 already,
    as a ``TTSEngine(dtype="bfloat16")`` holds them), the prompt encoding
    and the frame condition cast once, the latent and x_self_cond cast at
    every step and the model output returned as f32; the schedule
    arithmetic, x̂₀, the sampler's update, the conditioning stack and the
    codec decode stay f32.
    """
    device = next(ns2.parameters()).device
    if isinstance(text, (list, tuple)) and text and isinstance(text[0], str):
        assert ns2.tokenizer is not None, "pass tokenizer= to NaturalSpeech2"
        ids = ns2.tokenizer.texts_to_tensor_ids(list(text))
        text = torch.from_numpy(ids).to(device=device, dtype=torch.int64)
    if dtype not in SAMPLE_DTYPES:
        raise ValueError(f"sample: dtype must be one of {SAMPLE_DTYPES}, got {dtype}")
    name = ns2.sampler_name
    if step_noise is not None and name != "ddpm":
        raise ValueError(f"sample: step_noise is DDPM's, the sampler is {name!r}")
    prompt_enc = cond = None
    with _eval_mode(ns2):
        model = ns2.model if dtype is None else cast_floating(ns2.model, dtype)
        if ns2.conditional:
            if prompt is None or text is None:
                raise ValueError("a conditional model samples from prompt= and text=")
            prompt_enc, cond, _ = ns2.conditioning_for_sample(
                prompt, text, text_lens, length, pitch, duration)
            batch_size = prompt.shape[0]
            if dtype is not None:
                prompt_enc, cond = prompt_enc.to(dtype), cond.to(dtype)

        def denoise_fn(audio, times, x_self_cond=None):
            scale = cond_scale
            if cfg_interval is not None and ns2.conditional and cond_scale != 1.0:
                lo, hi = cfg_interval
                if not lo <= times[0].item() <= hi:
                    scale = 1.0  # one conditional forward, no null half
            if dtype is not None:
                audio = audio.to(dtype)
                if x_self_cond is not None:
                    x_self_cond = x_self_cond.to(dtype)
            out = forward_with_cond_scale(model, audio, times, prompt=prompt_enc, cond=cond,
                                          cond_scale=scale, cfg_rescale=cfg_rescale,
                                          x_self_cond=x_self_cond)
            return out if dtype is None else out.to(torch.float32)

        extra = {"step_noise": step_noise} if name == "ddpm" else {}
        latents = SAMPLER_FNS[name](
            denoise_fn,
            (batch_size, length, ns2.dim),
            timesteps=timesteps if timesteps is not None else ns2.timesteps,
            gamma_schedule=ns2.gamma_schedule,
            objective=ns2.objective,
            scale=ns2.scale,
            time_difference=ns2.time_difference,
            self_cond=ns2.model.self_cond,
            device=device,
            generator=generator,
            noise=noise,
            **extra,
        )
        if ns2.codec is None:
            return latents
        return ns2.codec.decode(latents)
