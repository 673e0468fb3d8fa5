"""Codec training (twin of `CodecTrainer` in `naturalspeech2_tpu/codec_trainer.py`).

Trains either codec (`SoundStream` or `Encodec`) through ``encode_latents``,
``decode`` and ``codebooks``: waveform L1, the multi-resolution STFT loss
and the commitment loss (optionally a log-mel L1) through the
straight-through quantizer, global-norm clipping and Adam (the port
`Trainer`'s copy of optax's clip; torch's Adam, whose update is optax's
``adam``); the codebooks learn by EMA of their assigned residuals, with
dead codes re-seeded from the batch. With ``adversarial_weight > 0`` a
multi-scale STFT discriminator adds hinge and feature-matching terms from
step ``adversarial_warmup`` on, and takes its own hinge step on the
detached reconstruction; before that it neither runs nor moves.

The quantizer is K6 (`ops/rvq.py:rvq`) on the card and its plain version
on the CPU, where the JAX trainer runs ``rvq_xla``: the same first-minimum
codes but for near-ties. The dead-code restart rows, which JAX draws from
``fold_in(PRNGKey(seed ^ 0x5EED), step)``, can be handed to
``train_step``; otherwise they come from a torch generator seeded from the
seed and the step, so a resumed run draws what an unbroken one does.

``amp=True`` runs the codec and the discriminator on bf16 copies of the
f32 parameters (autograd through the cast), the audio in bf16, with the
codebooks, the quantizer, the losses and the codebook statistics in f32.
Checkpoints are ``torch.save`` files of the whole state; ``load`` resumes
bit for bit.

Over a data mesh (``mesh=``, `parallel.make_mesh`) every rank reads the
same global batch and keeps its rows; the losses are the global batch's
(the STFT loss's norms and the feature-matching means from sums over the
ranks, `parallel.comm.global_sum`), both models' gradients are summed
over the ranks before the clip, and the codebooks' counts, sums and
dead-code restart rows are the global batch's (each rank contributes
the rows it holds), so every rank takes the same step; on a model axis
wider than 1 the ranks of a model group hold the same rows and compute
alike. Rank 0 logs and writes checkpoints.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from naturalspeech2_tpu_torch.models.discriminator import (
    DEFAULT_SCALES,
    MultiScaleSTFTDiscriminator,
    discriminator_hinge_loss,
    feature_matching_loss,
    generator_hinge_loss,
)
from naturalspeech2_tpu_torch.ops.mel import audio_to_mel
from naturalspeech2_tpu_torch.ops.rvq import rvq
from naturalspeech2_tpu_torch.ops.stft_loss import multi_resolution_stft_loss
from naturalspeech2_tpu_torch.parallel import comm
from naturalspeech2_tpu_torch.parallel.mesh import Mesh, check_batch_split, make_mesh, shard_batch
from naturalspeech2_tpu_torch.trainer import _cosine, clip_by_global_norm_
from naturalspeech2_tpu_torch.version import __version__


@dataclass
class CodecTrainState:
    """What the modules and optimizers do not hold: the step, the codebook
    statistics, and the discriminator's update count (its schedule's)."""

    step: int
    codebook_ema: torch.Tensor  # [Q, K, d] EMA of assigned residual sums
    codebook_count: torch.Tensor  # [Q, K] EMA of assignment counts
    disc_updates: int = 0


class _Method(nn.Module):
    """Calls a method of ``module`` in ``forward``, so `functional_call` can
    run it on substituted parameters."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, method: str, *args):
        return getattr(self.module, method)(*args)


def _bf16_copies(module: nn.Module, skip=(), detach: bool = False) -> dict:
    """bf16 copies of the f32 parameters (autograd through the cast unless
    ``detach``), for `functional_call`."""
    return {name: (p.detach() if detach else p).to(torch.bfloat16)
            for name, p in module.named_parameters()
            if p.dtype == torch.float32 and name not in skip}


class CodecTrainer:
    def __init__(
        self,
        codec: nn.Module,
        *,
        batches: Iterator[np.ndarray],
        lr: float = 3e-4,
        commitment_weight: float = 0.25,
        stft_weight: float = 1.0,
        wav_weight: float = 1.0,
        mel_weight: float = 0.0,
        lr_schedule: Optional[str] = None,
        decay_steps: Optional[int] = None,
        adversarial_weight: float = 0.0,
        feature_weight: float = 3.0,
        adversarial_warmup: int = 0,
        disc_lr: Optional[float] = None,
        disc_channels: int = 32,
        disc_scales=None,
        codebook_ema_decay: float = 0.99,
        dead_code_threshold: float = 0.5,
        max_grad_norm: float = 1.0,
        amp: bool = False,
        mesh=None,
        results_folder: str = "./results_codec",
        seed: int = 0,
    ):
        """Trains ``codec`` on the device of its parameters; the
        discriminator (with ``adversarial_weight > 0``) is built there.
        ``lr_schedule="cosine"`` decays both learning rates to 10 % over
        ``decay_steps``. ``mesh`` (default: every rank of the initialised
        process group, else this process alone) splits each batch over its
        data axis."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a naturalspeech2_tpu_torch.parallel.Mesh "
                            f"(parallel.make_mesh), got {type(mesh).__name__}")
        if lr_schedule not in (None, "cosine"):
            raise ValueError(f"lr_schedule must be None or 'cosine', got {lr_schedule!r}")
        if lr_schedule == "cosine" and not decay_steps:
            raise ValueError("lr_schedule='cosine' needs decay_steps")
        self.codec = codec
        self.device = codec.codebooks.device
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        if self.mesh.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh trains on the card; the codec is on {self.device}")
        self.batches = batches
        self.commitment_weight = commitment_weight
        self.stft_weight = stft_weight
        self.wav_weight = wav_weight
        self.mel_weight = mel_weight
        self.adversarial_weight = adversarial_weight
        self.feature_weight = feature_weight
        self.adversarial_warmup = adversarial_warmup
        self.decay = codebook_ema_decay
        self.dead_code_threshold = dead_code_threshold
        self.max_grad_norm = max_grad_norm
        self.amp = amp
        disc_lr = disc_lr if disc_lr is not None else lr
        if lr_schedule == "cosine":
            self.lr_at = _cosine(lr, decay_steps, 0.1)
            self.disc_lr_at = _cosine(disc_lr, decay_steps, 0.1)
        else:
            self.lr_at = lambda count: lr
            self.disc_lr_at = lambda count: disc_lr
        self.optimizer = torch.optim.Adam(codec.parameters(), lr=lr, eps=1e-8)
        self.discriminator = self.disc_optimizer = None
        if adversarial_weight > 0.0:
            self.discriminator = MultiScaleSTFTDiscriminator(
                scales=disc_scales or DEFAULT_SCALES, channels=disc_channels).to(self.device)
            self.disc_optimizer = torch.optim.Adam(self.discriminator.parameters(), lr=disc_lr,
                                                   eps=1e-8)
        models = [codec] + ([self.discriminator] if self.discriminator is not None else [])
        with torch.no_grad():  # every rank starts from rank 0's weights
            comm.broadcast_many_(self.mesh, [t for m in models for t in m.state_dict().values()])
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.seed = seed
        self.state: Optional[CodecTrainState] = None

    def init_state(self) -> CodecTrainState:
        """Step 0 from the modules' current parameters: the EMA sums start at
        the codebooks, the EMA counts at one, the optimizers empty."""
        codebooks = self.codec.codebooks.detach()
        self.optimizer.state.clear()
        if self.disc_optimizer is not None:
            self.disc_optimizer.state.clear()
        self.state = CodecTrainState(
            step=0, codebook_ema=codebooks.clone(),
            codebook_count=torch.ones(codebooks.shape[:2], device=codebooks.device))
        return self.state

    # ------------------------------------------------------------------ #

    def _call(self, module: nn.Module, method: str, x: torch.Tensor, params: Optional[dict]):
        if params is None:
            return getattr(module, method)(x)
        return functional_call(_Method(module), {f"module.{k}": v for k, v in params.items()},
                               (method, x))

    def _discriminate(self, audio: torch.Tensor, params: Optional[dict]):
        """The discriminator's (logits, features) in f32 on ``audio`` (bf16
        under ``amp``), on ``params`` if given."""
        if self.amp:
            audio = audio.to(torch.bfloat16)
        logits, features = self._call(self.discriminator, "forward", audio, params)
        return [x.float() for x in logits], [[x.float() for x in fs] for fs in features]

    def _losses(self, audio: torch.Tensor, adv_on: bool):
        """(loss, metrics, flat latents [m, d] f32, codes [m, Q],
        reconstruction [b, T] f32) for the f32 batch ``audio``; over a mesh
        the STFT and feature-matching terms are the global batch's."""
        batch_sum = functools.partial(comm.global_sum, self.mesh)
        codec = self.codec
        cast = _bf16_copies(codec, skip=("codebooks",)) if self.amp else None
        run_audio = audio.to(torch.bfloat16) if self.amp else audio
        latents = self._call(codec, "encode_latents", run_audio, cast)
        b, n, d = latents.shape
        flat = latents.reshape(b * n, d).float()
        quantized, codes = rvq(flat.detach().contiguous(), codec.codebooks)
        quantized_st = flat + (quantized - flat).detach()
        recon = self._call(codec, "decode", quantized_st.reshape(b, n, d).to(latents.dtype),
                           cast).float()
        wav_l1 = (recon - audio).abs().mean()
        stft_l = multi_resolution_stft_loss(recon, audio, batch_sum=batch_sum)
        commit = ((flat - quantized.detach()) ** 2).mean()
        loss = self.wav_weight * wav_l1 + self.stft_weight * stft_l + self.commitment_weight * commit
        metrics = {"wav_l1": wav_l1, "stft": stft_l, "commit": commit}
        if self.mel_weight > 0.0:
            sr = codec.target_sample_hz

            def logmel(a):
                mel = audio_to_mel(a, sample_rate=sr, n_mels=80, n_fft=1024, win_length=1024,
                                   hop_length=256, f_max=sr / 2, log=False)
                return torch.log(mel.clamp(min=1e-5))

            metrics["mel_l1"] = (logmel(recon) - logmel(audio)).abs().mean()
            loss = loss + self.mel_weight * metrics["mel_l1"]
        if self.discriminator is not None:
            adv = feat = torch.zeros((), device=audio.device)
            if adv_on:  # the discriminator frozen inside the generator's loss
                frozen = (_bf16_copies(self.discriminator, detach=True) if self.amp else
                          {k: p.detach() for k, p in self.discriminator.named_parameters()})
                fake_logits, fake_feats = self._discriminate(recon, frozen)
                _, real_feats = self._discriminate(audio, frozen)
                adv = generator_hinge_loss(fake_logits)
                feat = feature_matching_loss([[x.detach() for x in fs] for fs in real_feats],
                                             fake_feats, batch_sum=batch_sum)
                loss = loss + (self.adversarial_weight * adv + self.feature_weight * feat)
            metrics.update({"adv_g": adv, "feat": feat})
        metrics["loss"] = loss
        return loss, metrics, flat.detach(), codes, recon.detach()

    def _grads(self, objective, params: list) -> list:
        """Gradients of ``objective`` (zeros where it does not reach), summed
        over the ranks."""
        grads = torch.autograd.grad(objective, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return comm.all_reduce_many_(self.mesh, grads)

    def _apply(self, optimizer, params: list, grads: list, lr: float) -> None:
        """optax's chain of clip_by_global_norm and adam on ``params``."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        clip_by_global_norm_(grads, self.max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        for p in params:
            p.grad = None

    def restart_rows(self, m: int) -> torch.Tensor:
        """This step's dead-code restart rows [Q, K] in [0, m), from a
        generator seeded by the seed and the step."""
        num_q, size = self.codec.codebooks.shape[:2]
        gen = torch.Generator(self.device).manual_seed(
            ((self.seed ^ 0x5EED) << 32) + self.state.step)
        return torch.randint(0, m, (num_q, size), generator=gen, device=self.device)

    def train_step(self, audio, restart_idx: Optional[torch.Tensor] = None) -> dict:
        """One step on the batch ``audio`` [b, T] (array or tensor): the
        codec's update, the discriminator's (from the warmup on), then the
        codebooks' EMA update with dead-code restarts from ``restart_idx``
        [Q, K] (rows of the flattened latents; drawn by ``restart_rows``
        when None). Returns the metrics as floats."""
        return {k: float(v) for k, v in self._step(audio, restart_idx).items()}

    def _step(self, audio, restart_idx: Optional[torch.Tensor] = None) -> dict:
        """One step; the metrics as device scalars."""
        if self.state is None:
            self.init_state()
        state = self.state
        n = self.mesh.n_data
        check_batch_split(len(audio), n)
        audio = torch.as_tensor(shard_batch(self.mesh, audio)).to(self.device, torch.float32)
        adv_on = state.step >= self.adversarial_warmup
        loss, metrics, flat, codes, recon = self._losses(audio, adv_on)
        params = list(self.codec.parameters())
        # this rank's share: its plain means over n, the global terms whole
        whole = self.stft_weight * metrics["stft"]
        if "feat" in metrics:
            whole = whole + self.feature_weight * metrics["feat"]
        grads = self._grads(loss / n + (1.0 - 1.0 / n) * whole, params)
        codebooks = self.codec.codebooks.detach().clone()  # the statistics' codebooks
        self._apply(self.optimizer, params, grads, self.lr_at(state.step))

        if self.discriminator is not None:
            d_val = torch.zeros((), device=self.device)
            if adv_on:  # the whole D step waits for the warmup
                d_params = list(self.discriminator.parameters())
                run = _bf16_copies(self.discriminator) if self.amp else None
                real_logits, _ = self._discriminate(audio, run)
                fake_logits, _ = self._discriminate(recon, run)
                d_val = discriminator_hinge_loss(real_logits, fake_logits)
                d_grads = self._grads(d_val / n, d_params)
                self._apply(self.disc_optimizer, d_params, d_grads,
                            self.disc_lr_at(state.disc_updates))
                state.disc_updates += 1
            metrics["adv_d"] = d_val

        metrics.update(self._codebook_update(codebooks, flat, codes, restart_idx))
        state.step += 1
        keys = list(metrics)  # each metric's mean over the ranks
        means = comm.all_reduce_(self.mesh, torch.stack([metrics[k].detach().float() for k in keys]))
        return dict(zip(keys, (means / n).unbind(0)))

    @torch.no_grad()
    def _codebook_update(self, codebooks, flat, codes, restart_idx) -> dict:
        """Per stage, on the residual before it: the EMA of the assigned sums
        and counts; live codes move to the EMA mean, dead ones (count below
        the threshold) to a batch residual with their statistics reset.
        Over a mesh the sums, counts and restart rows are the global
        batch's: ``restart_idx`` indexes the flattened latents of the
        global batch, of which this rank holds rows [i·m, (i+1)·m), i its
        data index.
        Writes the codebooks; returns the codebook-health metrics."""
        state = self.state
        num_q, size, _ = codebooks.shape
        decay = self.decay
        m = flat.shape[0]
        offset = self.mesh.data_index * m
        if self.dead_code_threshold > 0 and restart_idx is None:
            restart_idx = self.restart_rows(m * self.mesh.n_data)
        # this rank's statistics of every stage, then one sum over the ranks
        residual = flat
        sums, cnts, seeds = [], [], []
        for qi in range(num_q):
            idx = codes[:, qi].long()
            sums.append(torch.zeros_like(codebooks[qi]).index_add_(0, idx, residual))
            cnts.append(torch.bincount(idx, minlength=size).to(flat.dtype))
            if self.dead_code_threshold > 0:
                rows = restart_idx[qi].long().to(residual.device) - offset
                held = (rows >= 0) & (rows < m)
                seeds.append(torch.where(held[:, None], residual[rows.clamp(0, m - 1)], 0.0))
            residual = residual - codebooks[qi][idx]
        stats = [torch.stack(sums), torch.stack(cnts)] + ([torch.stack(seeds)] if seeds else [])
        comm.all_reduce_many_(self.mesh, stats)
        sums, cnts = stats[0].unbind(0), stats[1].unbind(0)
        seeds = stats[2].unbind(0) if seeds else seeds
        perps, usages, restarts = [], [], []
        for qi in range(num_q):
            e = state.codebook_ema[qi] * decay + sums[qi] * (1 - decay)
            c = state.codebook_count[qi] * decay + cnts[qi] * (1 - decay)
            cb_q = torch.where((c > 1e-3)[:, None], e / c.clamp(min=1e-3)[:, None], codebooks[qi])
            if self.dead_code_threshold > 0:
                dead = c < self.dead_code_threshold
                cb_q = torch.where(dead[:, None], seeds[qi], cb_q)
                e = torch.where(dead[:, None], seeds[qi], e)
                c = torch.where(dead, torch.ones_like(c), c)
                restarts.append(dead.sum())
            state.codebook_ema[qi] = e
            state.codebook_count[qi] = c
            self.codec.codebooks[qi] = cb_q
            p = cnts[qi] / cnts[qi].sum().clamp(min=1.0)
            perps.append(torch.exp(-(p * torch.log(p.clamp(min=1e-10))).sum()))
            usages.append((cnts[qi] > 0).float().mean())
        out = {"perplexity": torch.stack(perps).mean(), "usage": torch.stack(usages).mean()}
        if restarts:
            out["restarts"] = torch.stack(restarts).sum()
        return out

    def train(self, num_steps: int, log_every: int = 50, steps_per_jit: int = 8) -> CodecTrainState:
        """Steps until ``num_steps`` (from the current step) in chunks of
        ``steps_per_jit`` steps, the host waiting for the card once a chunk;
        after a chunk that ends at step s, a line of its last step's metrics
        when ``(s // k) % max(1, log_every // k) == 0``, as the JAX trainer
        logs. Divergence from the JAX trainer: the last chunk is cut at
        ``num_steps``, where JAX pads it with repeats of its last batch to
        keep its compiled scan's length and so may pass ``num_steps`` by
        up to k − 1 steps."""
        batch = next(self.batches)
        if self.state is None:
            self.init_state()
        k = max(1, steps_per_jit)
        while self.state.step < num_steps:
            m = min(k, num_steps - self.state.step)
            for i in range(m):
                metrics = self._step(batch)
                if i < m - 1:
                    batch = next(self.batches)
            step = self.state.step
            if (step // k) % max(1, log_every // k) == 0 and self.mesh.is_main:
                metrics = {name: float(v) for name, v in metrics.items()}
                print(f"codec step {step}: loss {metrics['loss']:.4f} "
                      f"(wav {metrics['wav_l1']:.4f}, stft {metrics['stft']:.4f}, "
                      f"perp {metrics['perplexity']:.1f}, usage {metrics['usage']:.2f}, "
                      f"restarts {int(metrics.get('restarts', 0))})", flush=True)
            batch = next(self.batches)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.state

    # ------------------------------------------------------------------ #

    def save(self, milestone) -> str:
        """The whole training state: codec and discriminator parameters, both
        optimizers' states, the codebook statistics and the step; written
        by rank 0 (the others return "")."""
        if not self.mesh.is_main:
            return ""
        s = self.state
        payload = {"step": s.step, "params": self.codec.state_dict(),
                   "opt_state": self.optimizer.state_dict(), "codebook_ema": s.codebook_ema,
                   "codebook_count": s.codebook_count, "version": __version__}
        if self.discriminator is not None:
            payload.update(disc_params=self.discriminator.state_dict(),
                           disc_opt_state=self.disc_optimizer.state_dict(),
                           disc_updates=s.disc_updates)
        path = self.results_folder / f"codec-{milestone}.ckpt"
        torch.save(payload, path)
        return str(path)

    def latest_checkpoint(self) -> Optional[str]:
        ckpts = sorted(self.results_folder.glob("codec-*.ckpt"), key=lambda p: p.stat().st_mtime)
        return str(ckpts[-1]) if ckpts else None

    def load(self, path) -> CodecTrainState:
        """Restore a ``save()`` checkpoint."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        self.codec.load_state_dict(payload["params"], strict=True)
        self.optimizer.load_state_dict(payload["opt_state"])
        self.state = CodecTrainState(
            step=int(payload["step"]),
            codebook_ema=payload["codebook_ema"].to(self.device),
            codebook_count=payload["codebook_count"].to(self.device),
            disc_updates=int(payload.get("disc_updates", 0)))
        if self.discriminator is not None and "disc_params" in payload:
            self.discriminator.load_state_dict(payload["disc_params"], strict=True)
            self.disc_optimizer.load_state_dict(payload["disc_opt_state"])
        return self.state
