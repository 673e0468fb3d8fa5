"""NaturalSpeech 2: diffusion over codec latents. The unconditional
training losses (`NaturalSpeech2.forward`, the twin of
`NaturalSpeech2.__call__`), and sampling by DDIM then codec decode (twins
of `get_sampling_time_pairs`, `_reconstruct_x0`, `ddim_sample` and the
unconditional `sample()` in `naturalspeech2_tpu/models/naturalspeech2.py`).

Randomness is explicit: the diffusion times and noise, and the samplers'
starting noise, are drawn from a ``torch.Generator`` or taken as
``times=`` / ``noise=`` (how the tests inject JAX's draws).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from naturalspeech2_tpu_torch.models.codec import SoundStream
from naturalspeech2_tpu_torch.models.denoiser import Model, forward_with_cond_scale
from naturalspeech2_tpu_torch.ops.schedules import gamma_to_alpha_sigma, get_schedule
from naturalspeech2_tpu_torch.utils.helpers import safe_div


class NaturalSpeech2(nn.Module):
    """Holds the denoiser, the codec and the diffusion settings; its
    forward returns the training losses."""

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
    ):
        super().__init__()
        name = sampler or ("ddim" if use_ddim else "ddpm")
        if name not in {"ddim", "ddpm", "dpmpp"}:
            raise ValueError(f"unknown sampler {name!r}")
        if name != "ddim":
            raise NotImplementedError(
                f"sampler {name!r} is not ported yet (ROADMAP Queue 1, slice 2 item 8)"
            )
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
        self.timesteps = timesteps
        self.noise_schedule = noise_schedule
        self.objective = objective
        self.time_difference = time_difference
        self.scale = scale
        self.min_snr_loss_weight = min_snr_loss_weight
        self.min_snr_gamma = min_snr_gamma
        self.rvq_cross_entropy_loss_weight = rvq_cross_entropy_loss_weight

    @property
    def dim(self) -> int:
        return self.codec.codebook_dim if self.codec is not None else self.model.dim

    @property
    def sample_hz(self) -> Optional[int]:
        return self.codec.target_sample_hz if self.codec is not None else None

    def gamma_schedule(self, times: torch.Tensor) -> torch.Tensor:
        return get_schedule(self.noise_schedule)(times)

    def forward(
        self,
        audio: torch.Tensor,
        *,
        times: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training losses: ``{"loss", "diffusion"}`` and, with a positive
        ``rvq_cross_entropy_loss_weight``, ``"rvq_ce"``.

        ``audio`` is raw audio [b, T], encoded by the frozen codec without
        gradient (the RVQ cross-entropy needs its codes), or latents
        [b, n, dim]. ``times`` [b] and ``noise`` [b, n, dim] are drawn from
        ``generator`` unless given.
        """
        codes = None
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
        if noise is None:
            noise = torch.randn(audio.shape, generator=generator, device=audio.device)

        gamma = self.gamma_schedule(times)[:, None, None]
        alpha, sigma = gamma_to_alpha_sigma(gamma, self.scale)
        noised = alpha * audio + sigma * noise
        pred = self.model(noised, times)

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
        losses = {"loss": diffusion, "diffusion": diffusion}

        if self.rvq_cross_entropy_loss_weight > 0 and codes is not None:
            x_start = _reconstruct_x0(self.objective, audio, pred, alpha, sigma)
            _, ce = self.codec.rq(x_start, codes)
            losses["rvq_ce"] = ce
            losses["loss"] = diffusion + self.rvq_cross_entropy_loss_weight * ce
        return losses


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
    device: torch.device | str = "cpu",
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM from pure noise to latents ``shape`` in ``timesteps`` steps.

    ``denoise_fn(audio, times)`` is the model forward. The starting noise
    is ``noise`` if given, else drawn from ``generator``.
    """
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    audio = _starting_noise(shape, device, generator, noise)
    pairs = get_sampling_time_pairs(timesteps, device=device)
    gamma = gamma_schedule(pairs[:, 0])
    gamma_next = gamma_schedule((pairs[:, 1] - time_difference).clamp(min=0.0))
    alpha, sigma = gamma_to_alpha_sigma(gamma, scale)
    alpha_next, sigma_next = gamma_to_alpha_sigma(gamma_next, scale)
    for i in range(timesteps):
        times = pairs[i, 0].expand(shape[0])
        model_output = denoise_fn(audio, times)
        x_start = _reconstruct_x0(objective, audio, model_output, alpha[i], sigma[i])
        pred_noise = safe_div(audio - alpha[i] * x_start, sigma[i])
        audio = x_start * alpha_next[i] + pred_noise * sigma_next[i]
    return audio


@torch.no_grad()
def sample(
    ns2: NaturalSpeech2,
    *,
    length: int,
    batch_size: int = 1,
    timesteps: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    prompt=None,
    text=None,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Unconditional sampling: DDIM over ``[batch_size, length, dim]``
    latents, then codec decode to ``[batch_size, length·hop]`` audio (the
    latents if ``ns2`` has no codec). Runs on the device of ``ns2``'s
    parameters; ``timesteps`` overrides the configured step count."""
    if prompt is not None or text is not None:
        raise NotImplementedError(
            "conditional sampling (prompt/text) is not ported yet (ROADMAP Queue 1, slice 4)"
        )
    if dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"sampling in {dtype} is not ported yet (ROADMAP Queue 1, option list)"
        )
    device = next(ns2.parameters()).device
    latents = ddim_sample(
        lambda audio, times: forward_with_cond_scale(ns2.model, audio, times),
        (batch_size, length, ns2.dim),
        timesteps=timesteps if timesteps is not None else ns2.timesteps,
        gamma_schedule=ns2.gamma_schedule,
        objective=ns2.objective,
        scale=ns2.scale,
        time_difference=ns2.time_difference,
        device=device,
        generator=generator,
        noise=noise,
    )
    if ns2.codec is None:
        return latents
    return ns2.codec.decode(latents)
