"""The diffusion denoiser (twin of `Model` and `forward_with_cond_scale` in
`naturalspeech2_tpu/models/denoiser.py`): learned-Fourier time embedding →
Linear(dim·4) → SiLU, then the WaveNet (fused, kernel K1, or with
``use_fused_wavenet=False`` block by block) and the adaptive transformer,
both conditioned on that time embedding.

With ``condition_on_prompt`` the encoded speech prompt conditions it
twice: mean-pooled through ``to_prompt_cond`` and concatenated onto the
time condition (so the WaveNet FiLM and the ada norms take 8·dim), and
resampled to ``num_latents_m`` tokens that every transformer layer
cross-attends to (kernel K2b). The frame-aligned text condition is
projected to ``dim`` and added to the input. Classifier-free guidance
replaces prompt and text by learned null parameters where the drop masks
say so.

With ``self_cond`` the previous x̂₀ estimate ``x_self_cond`` (zeros when
None) enters through ``to_self_cond``, a Linear(dim, dim) initialised to
zero (an exact no-op at init), added to the input before the time
embedding.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import LearnedSinusoidalPosEmb, promoted_linear
from naturalspeech2_tpu_torch.models.encoders import PerceiverResampler
from naturalspeech2_tpu_torch.models.transformer import ConditionableTransformer
from naturalspeech2_tpu_torch.models.wavenet import FusedWavenet, Wavenet
from naturalspeech2_tpu_torch.utils.helpers import pad_or_curtail_to_length, prob_mask_like


class Model(nn.Module):
    def __init__(
        self,
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: int = 4,
        wavenet_layers: int = 8,
        wavenet_stacks: int = 4,
        dim_cond_mult: int = 4,
        use_flash_attn: bool = True,
        dim_prompt: Optional[int] = None,
        num_latents_m: int = 32,
        resampler_depth: int = 2,
        cond_drop_prob: float = 0.0,
        condition_on_prompt: bool = False,
        use_fused_wavenet: bool = True,
        scan_layers: bool = False,
        self_cond: bool = False,
        gelu_approximate: bool = True,
        remat: bool = False,
    ):
        super().__init__()
        self.dim = dim
        self.condition_on_prompt = condition_on_prompt
        self.cond_drop_prob = cond_drop_prob
        self.self_cond = self_cond
        if self_cond:
            self.to_self_cond = nn.Linear(dim, dim)
            nn.init.zeros_(self.to_self_cond.weight)
            nn.init.zeros_(self.to_self_cond.bias)
        dim_time = dim * dim_cond_mult
        # the prompt condition is concatenated onto the time condition
        cond_mult = dim_cond_mult * (2 if condition_on_prompt else 1)
        self.time_pos_emb = LearnedSinusoidalPosEmb(dim)
        self.to_time_hidden = nn.Linear(dim + 1, dim_time)
        nn.init.zeros_(self.to_time_hidden.bias)
        if condition_on_prompt:
            dim_prompt = dim_prompt or dim
            self.null_prompt_cond = nn.Parameter(torch.randn(dim_time) * 0.02)
            self.null_prompt_tokens = nn.Parameter(torch.randn(num_latents_m, dim) * 0.02)
            self.to_prompt_cond = nn.Linear(dim_prompt, dim_time)
            self.perceiver_resampler = PerceiverResampler(
                dim, depth=resampler_depth, dim_context=dim_prompt, num_latents=num_latents_m,
                dim_head=dim_head, heads=heads, use_flash_attn=use_flash_attn,
                gelu_approximate=gelu_approximate,
            )
            # the frame condition is as wide as the prompt encoding (the
            # phoneme encoder's and pitch embedding's width)
            self.cond_to_model_dim = nn.Linear(dim_prompt, dim)
            self.null_cond = nn.Parameter(torch.zeros(dim))
        if use_fused_wavenet:
            self.wavenet = FusedWavenet(dim, wavenet_stacks, wavenet_layers, cond_mult)
        else:
            self.wavenet = Wavenet(dim, wavenet_stacks, wavenet_layers, dim_cond_mult=cond_mult)
        self.transformer = ConditionableTransformer(
            dim, depth, dim_head=dim_head, heads=heads, ff_mult=ff_mult,
            ff_causal_conv=True, dim_cond_mult=cond_mult, cross_attn=condition_on_prompt,
            use_flash=use_flash_attn, scan_layers=scan_layers, gelu_approximate=gelu_approximate,
            remat=remat,
        )

    def _drop_masks(self, b: int, device, cond_drop_prob, cond_drop_mask, generator):
        """(prompt_drop, cond_drop), each [b] bool."""
        if isinstance(cond_drop_mask, tuple):
            return cond_drop_mask
        if cond_drop_mask is not None:
            return cond_drop_mask, cond_drop_mask
        p = self.cond_drop_prob if cond_drop_prob is None else cond_drop_prob
        if p > 0.0 and self.training:  # two independent draws, prompt first
            return (prob_mask_like((b,), p, generator, device),
                    prob_mask_like((b,), p, generator, device))
        full = torch.full((b,), p >= 1.0, dtype=torch.bool, device=device)
        return full, full

    def forward(
        self,
        x: torch.Tensor,
        times: torch.Tensor,
        prompt: Optional[torch.Tensor] = None,
        prompt_mask: Optional[torch.Tensor] = None,
        cond: Optional[torch.Tensor] = None,
        cond_drop_prob: Optional[float] = None,
        cond_drop_mask: Union[None, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        x_self_cond: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x [b, n, dim], times [b] (or a scalar) → prediction [b, n, dim].

        A conditional model also takes the encoded prompt [b, n_p,
        dim_prompt] (``prompt_mask`` [b, n_p] optional) and the aligned
        frame condition ``cond`` [b, n_c, dim_prompt], cut or zero-padded to
        n. ``cond_drop_mask`` ([b] bool, or a (prompt, cond) pair) says
        which rows take the null condition. Without it, a module in
        training mode drops the prompt and the frame condition of each row
        apart, each with probability ``cond_drop_prob``, drawn from
        ``generator`` (torch's default one if None); in eval mode every
        row drops if ``cond_drop_prob`` ≥ 1 and none otherwise, as the JAX
        package's deterministic forward. A ``self_cond`` model adds
        ``to_self_cond(x_self_cond)`` [b, n, dim] (zeros when None) to x.
        """
        b = x.shape[0]
        if self.self_cond:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = x + promoted_linear(self.to_self_cond, x_self_cond)
        if times.ndim == 0:
            times = times.expand(b)
        # f32 times through the (possibly bf16) time MLP: f32, as flax promotes
        t = F.silu(promoted_linear(self.to_time_hidden, self.time_pos_emb(times)))
        context = None
        if self.condition_on_prompt:
            if prompt is None or cond is None:
                raise ValueError("a conditional Model needs prompt= and cond=")
            prompt_drop, cond_drop = self._drop_masks(b, x.device, cond_drop_prob,
                                                      cond_drop_mask, generator)
            prompt_cond = F.silu(promoted_linear(self.to_prompt_cond, prompt.mean(dim=-2)))
            prompt_cond = torch.where(prompt_drop[:, None], self.null_prompt_cond, prompt_cond)
            t = torch.cat([t, prompt_cond], dim=-1)
            resampled = self.perceiver_resampler(prompt, mask=prompt_mask)
            context = torch.where(prompt_drop[:, None, None], self.null_prompt_tokens, resampled)
            cond = promoted_linear(self.cond_to_model_dim, cond)
            cond = torch.where(cond_drop[:, None, None], self.null_cond, cond)
            x = x + pad_or_curtail_to_length(cond, x.shape[1], axis=1)
        # the conditioning in the compute dtype, as the JAX module casts it
        t = t.to(x.dtype)
        if context is not None:
            context = context.to(x.dtype)
        x = self.wavenet(x, t)
        return self.transformer(x, times=t, context=context)


def forward_with_cond_scale(
    model: Model,
    x: torch.Tensor,
    times: torch.Tensor,
    *,
    prompt: Optional[torch.Tensor] = None,
    prompt_mask: Optional[torch.Tensor] = None,
    cond: Optional[torch.Tensor] = None,
    cond_scale: float = 1.0,
    cfg_rescale: float = 0.0,
    x_self_cond: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Classifier-free-guided forward, ``null + (cond − null)·scale``, from
    one batch-doubled forward (the conditioned half, then the null half);
    ``x_self_cond`` is doubled with the batch.

    ``cfg_rescale`` φ ∈ [0, 1] blends in the guided output rescaled to the
    conditioned half's per-sample std (population std, as ``jnp.std``). An
    unconditional model, or ``cond_scale`` 1, runs one plain forward.
    """
    b = x.shape[0]
    if times.ndim == 0:
        times = times.expand(b)
    cfg = dict(prompt=prompt, prompt_mask=prompt_mask, cond=cond, x_self_cond=x_self_cond)
    if not model.condition_on_prompt or cond_scale == 1.0:
        if model.condition_on_prompt:
            cfg["cond_drop_mask"] = torch.zeros(b, dtype=torch.bool, device=x.device)
        return model(x, times, **cfg)

    def dbl(v):
        return None if v is None else torch.cat([v, v], dim=0)

    drop = torch.cat([torch.zeros(b, dtype=torch.bool, device=x.device),
                      torch.ones(b, dtype=torch.bool, device=x.device)])
    out = model(dbl(x), dbl(times), **{k: dbl(v) for k, v in cfg.items()}, cond_drop_mask=drop)
    logits, null_logits = out[:b], out[b:]
    guided = null_logits + (logits - null_logits) * cond_scale
    if cfg_rescale > 0.0:
        dims = tuple(range(1, guided.ndim))
        std_cond = logits.std(dim=dims, keepdim=True, correction=0)
        std_guided = guided.std(dim=dims, keepdim=True, correction=0)
        rescaled = guided * (std_cond / std_guided.clamp(min=1e-8))
        guided = cfg_rescale * rescaled + (1.0 - cfg_rescale) * guided
    return guided
