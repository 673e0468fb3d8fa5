"""Training harness (twin of `Trainer` in `naturalspeech2_tpu/trainer.py`).
A batch is raw audio (or latents), or for a conditional model a dict
holding ``"audio"`` and the loss's other arguments (``"text"``,
``"text_lens"``, ``"prompt"``, ``"mel"``, ``"pitch"``, ...).

One optimizer step: grad accumulation over micro-batches (a Python loop;
gradients summed, then divided by their count), global-norm clipping as
optax's ``clip_by_global_norm`` (g·max/‖g‖ when ‖g‖ ≥ max, no ε), Adam
(torch's, whose update equals optax's ``adam``), then the EMA of every
parameter, the frozen codec's included, every ``ema_update_every`` steps.
Checkpoints are ``torch.save`` files of {step, params, opt_state,
ema_params, version}; ``train()`` resumes from the newest one in
``results_folder``.

Over a mesh (``mesh=``, `parallel.make_mesh`) every rank reads the same
global batch and keeps the rows of its data index of each micro-batch;
the draws are made for the global micro-batch and sliced: the loss's
(times, noise, CFG and self-conditioning rows) and every dropout mask
(`ops/dropout.py`, from torch's default generators, the same on every
rank), so a mesh step draws exactly the one-process step's masks. Each
rank's loss is weighted so that the gradients summed over the data axis
are the global batch's (the masked duration / pitch means by their share
of the global phoneme count), and the clip, the skip and the logged
metrics act on the reduced values, so every rank takes the same step.
``param_sharding="fsdp"`` keeps each rank's part of the large
parameters, of Adam's moments and of the EMA at rest (`parallel.fsdp`),
gathering the whole weights for each step's forward and backward only.
``param_sharding="tp"`` on a model axis > 1 runs tensor parallelism
(`parallel.tp`): each attention whose heads divide over the model axis
computes this rank's heads and sums them over the model group, its
projections held cut; the other leaves JAX's rule shards (the
feed-forward's) are held cut, gathered for each step and used whole;
everything else is computed alike on every rank of a model group.
"replicated" and "fsdp" on a model axis > 1 keep JAX's meaning: each
model group holds whole copies (FSDP split over ``data``) and computes
the same rows. Rank 0 logs, samples and writes the whole (gathered)
state, in JAX's layout; every rank loads a checkpoint of any layout and
cuts it for its own. Without a process group every collective is the
identity, and the same code trains one process.

The diffusion times and noise of every micro-batch, a conditional
model's CFG drop masks and a self-conditioned denoiser's bootstrap rows
come from the trainer's own generator (seeded with ``seed + 1``) and are
handed to the loss, so a rematerialised forward (``remat=True``) sees the
same draws; the encoders' dropout draws from torch's default generator,
whose state the rematerialisation restores.

``amp=True`` trains in bf16 as the JAX trainer does (`_loss_fn`): every
forward runs on bf16 copies of the f32 parameters, made per forward with
autograd through the cast (``torch.func.functional_call``), so each f32
``.grad`` is the bf16 cotangent widened, as ``jax.grad`` through
``astype`` gives; every float of the batch is cast to bf16, the noise is
drawn at the latents' bf16 dtype and the times stay f32, so the
denoiser's activations are promoted to f32 against its bf16 weights while
the codec and the conditioning encoders run in bf16. The master
parameters, Adam's state, the EMA and the checkpoints stay f32; the loss
and every metric are returned in f32.
"""

from __future__ import annotations

import copy
import json
import math
import time
import warnings
from pathlib import Path
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.autograd.graph import increment_version
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from naturalspeech2_tpu_torch.data import SoundDataset, data_loader, write_wav
from naturalspeech2_tpu_torch.models.naturalspeech2 import NaturalSpeech2, sample
from naturalspeech2_tpu_torch.ops.dropout import batch_rows
from naturalspeech2_tpu_torch.parallel import comm, fsdp, tp
from naturalspeech2_tpu_torch.parallel.mesh import (
    Mesh,
    check_batch_split,
    make_mesh,
    replicated,
)
from naturalspeech2_tpu_torch.utils.helpers import prob_mask_like
from naturalspeech2_tpu_torch.version import __version__


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {decay_steps}")

    def schedule(count: int) -> float:
        decay = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1 - alpha) * decay + alpha)

    return schedule


def _join(first: Callable, second: Callable, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def clip_by_global_norm_(grads: list, max_norm: float,
                         g_norm: Optional[torch.Tensor] = None) -> None:
    """optax.clip_by_global_norm in place: g / ‖g‖ · max when ‖g‖ ≥ max,
    no ε (where ``clip_grad_norm_`` divides by ‖g‖ + 1e-6); as device
    scalars (1 and 1 when not clipping), so the host never waits. ``g_norm``
    is the norm when ``grads`` hold only a part of the tree (FSDP)."""
    if g_norm is None:
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = g_norm >= max_norm
    torch._foreach_div_(grads, torch.where(clip, g_norm, 1.0))
    torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))


def make_lr_schedule(lr: float, lr_schedule: Optional[str], warmup_steps: int,
                     train_num_steps: int) -> Callable[[int], float]:
    """Learning rate at optimizer-update count c (0 for the first update),
    as the JAX trainer builds it from optax schedules: None → constant
    (after a linear warmup if ``warmup_steps``); "cosine" → warmup, then
    cosine decay to 10 % of ``lr`` at ``train_num_steps``; "linear" →
    warmup, then linear decay to 0."""
    if lr_schedule == "cosine":
        return _join(_linear(0.0, lr, warmup_steps),
                     _cosine(lr, train_num_steps - warmup_steps, 0.1), warmup_steps)
    if lr_schedule == "linear":
        return _join(_linear(0.0, lr, max(warmup_steps, 1)),
                     _linear(lr, 0.0, max(train_num_steps - warmup_steps, 1)), warmup_steps)
    if lr_schedule is not None:
        raise ValueError(f"lr_schedule must be None, 'cosine' or 'linear', got {lr_schedule!r}")
    if warmup_steps > 0:
        return _linear(0.0, lr, warmup_steps)
    return lambda count: lr


class Trainer:
    def __init__(
        self,
        diffusion_model: NaturalSpeech2,
        *,
        folder: Optional[str] = None,
        dataset=None,
        batches: Optional[Iterator[np.ndarray]] = None,
        train_batch_size: int = 16,
        grad_accum_every: int = 1,
        lr: float = 1e-4,
        betas: Tuple[float, float] = (0.9, 0.99),
        max_grad_norm: float = 1.0,
        ema_decay: float = 0.995,
        ema_update_every: int = 10,
        train_num_steps: int = 100_000,
        save_and_sample_every: int = 1000,
        results_folder: str = "./results",
        amp: bool = False,
        remat: bool = False,
        data_max_length: Optional[int] = None,
        data_max_length_seconds: Optional[float] = 2.0,
        sample_length: int = 1024,
        mesh=None,
        seed: int = 0,
        checkpoint_backend: str = "torch",
        param_sharding: str = "tp",
        steps_per_dispatch: int = 1,
        skip_nonfinite_updates: bool = False,
        lr_schedule: Optional[str] = None,
        warmup_steps: int = 0,
        val_batches: Optional[Iterator[np.ndarray]] = None,
        validate_every: int = 500,
        val_fraction: Optional[float] = None,
    ):
        """Trains ``diffusion_model`` on the device of its parameters.
        ``skip_nonfinite_updates`` leaves params and optimizer state as they
        were after a step whose gradients are not finite (reported as
        ``skipped``); ``val_batches`` / ``val_fraction`` add a held-out
        loss every ``validate_every`` steps. ``mesh`` (default: every rank
        of the initialised process group, else this process alone) splits
        each micro-batch over its data axis; ``param_sharding`` lays out
        the state over it: "replicated", "fsdp", or "tp" (tensor
        parallelism over the model axis; replicated on a model axis of 1,
        as in JAX)."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("mesh must be a naturalspeech2_tpu_torch.parallel.Mesh "
                            f"(parallel.make_mesh), got {type(mesh).__name__}")
        if param_sharding not in ("tp", "fsdp", "replicated"):
            raise ValueError("param_sharding must be 'tp', 'fsdp' or 'replicated', "
                             f"got {param_sharding!r}")
        if checkpoint_backend == "orbax":
            raise NotImplementedError(
                "checkpoint_backend='orbax' is not ported (ROADMAP item 22, do not port: the "
                "card's host has no orbax or tensorstore); use 'torch'")
        if checkpoint_backend != "torch":
            raise ValueError(f"checkpoint_backend must be 'torch', got {checkpoint_backend!r}")
        if steps_per_dispatch < 1 or train_num_steps % steps_per_dispatch != 0:
            raise ValueError(f"steps_per_dispatch must be ≥ 1 and divide train_num_steps "
                             f"({train_num_steps}) into whole dispatches, got {steps_per_dispatch}")
        self.steps_per_dispatch = steps_per_dispatch
        self.ns2 = diffusion_model
        self.device = next(diffusion_model.parameters()).device
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        check_batch_split(train_batch_size, self.mesh.n_data)
        if self.mesh.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh trains on the card; the model is on {self.device}")
        if self.ns2.conditional and self.ns2.duration_pitch.to_duration_pred.head_activation == "relu":
            # PARITY #12: once the pre-activation is negative everywhere the
            # masked L1's gradient is 0 and the predictor never recovers
            warnings.warn(
                "duration/pitch predictor head_activation='relu' (the reference default) can go "
                "permanently dead under the L1 loss; pass duration_pitch_kwargs="
                "dict(head_activation='softplus') for a trainable head (PARITY.md defect #12).",
                UserWarning, stacklevel=2)
        self.train_batch_size = train_batch_size
        self.grad_accum_every = grad_accum_every
        self.max_grad_norm = max_grad_norm
        self.ema_decay = ema_decay
        self.ema_update_every = ema_update_every
        self.train_num_steps = train_num_steps
        self.save_and_sample_every = save_and_sample_every
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.remat = remat
        self.amp = amp
        self.sample_length = sample_length
        self.seed = seed
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.val_batches = val_batches
        self.validate_every = validate_every

        if data_max_length is None and data_max_length_seconds is not None:
            data_max_length = int(data_max_length_seconds * self.ns2.sample_hz)
        self.data_max_length = data_max_length
        if batches is not None:
            self.batches = batches
        else:
            if dataset is None:
                if folder is None:
                    raise ValueError("provide folder, dataset or batches")
                codec = self.ns2.codec
                ds_kwargs = dict(
                    max_length=data_max_length, target_sample_hz=self.ns2.sample_hz,
                    seq_len_multiple_of=codec.seq_len_multiple_of if codec is not None else None,
                )
                dataset = SoundDataset(folder, split="train" if val_fraction else None,
                                       val_fraction=val_fraction or 0.05, **ds_kwargs)
                if val_fraction and self.val_batches is None:
                    val_ds = SoundDataset(folder, split="val", val_fraction=val_fraction,
                                          **ds_kwargs)
                    self.val_batches = data_loader(val_ds, train_batch_size, seed=seed + 1)
            self.batches = data_loader(dataset, train_batch_size * grad_accum_every, seed=seed)

        self.lr_at = make_lr_schedule(lr, lr_schedule, warmup_steps, train_num_steps)
        self.params = dict(self.ns2.named_parameters())
        with torch.no_grad():  # every rank starts from rank 0's weights
            comm.broadcast_many_(self.mesh, list(self.ns2.state_dict().values()))
        self._full_shapes = {n: p.shape for n, p in self.params.items()}
        # the names of the parameters the modules themselves hold cut (an
        # attention's projections under tensor parallelism)
        self._held: set = set()
        if param_sharding == "fsdp":
            self.shardings = fsdp.state_shardings(self.mesh, self.params)
        elif param_sharding == "tp" and self.mesh.n_model > 1:
            self.shardings, self._held = tp.shard_model(self.ns2, self.mesh)
        else:
            self.shardings = {name: replicated(self.mesh) for name in self.params}
        # the names of the parameters each rank holds a part of at rest and
        # uses whole: gathered for each step
        self._split = [n for n, sh in self.shardings.items()
                       if sh.dim is not None and n not in self._held]
        # how each gradient is reduced: a held part is this rank's already
        self._grad_shardings = {n: replicated(self.mesh) if n in self._held else sh
                                for n, sh in self.shardings.items()}
        # what the optimizer and the EMA update: each rank's part of a split
        # parameter, the parameter itself otherwise
        self.master = {**self.params, **{
            n: self.shardings[n].shard(self.params[n].detach()).contiguous().clone()
            for n in self._split}}
        self.optimizer = torch.optim.Adam(self.master.values(), lr=lr, betas=betas, eps=1e-8)
        self.ema = {name: p.detach().clone() for name, p in self.master.items()}
        self._release()
        self.step = 0
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        self._resume_checked = False
        # a held-back (prompt, text) pair for conditional milestone samples
        self._holdback: Optional[dict] = None

    # ------------------------------------------------------------------ #

    def draw(self, audio: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(times [b], noise [b, n, dim]) for one micro-batch of raw audio
        [b, T] or latents [b, n, dim], from ``generator`` (the trainer's by
        default)."""
        generator = self.generator if generator is None else generator
        b = audio.shape[0]
        if audio.ndim == 2:
            n = audio.shape[-1] // self.ns2.codec.seq_len_multiple_of
        else:
            n = audio.shape[1]
        times = torch.rand(b, generator=generator, device=self.device)
        noise = torch.randn((b, n, self.ns2.dim), generator=generator, device=self.device)
        if self.amp:  # JAX draws the noise at the latents' dtype
            noise = noise.to(torch.bfloat16)
        return times, noise

    def draw_cond_drop(self, b: int, generator: Optional[torch.Generator] = None):
        """A conditional model's (prompt, cond) CFG drop masks [b] for one
        micro-batch, drawn after ``draw``'s from the same generator; None
        when no row can drop (an unconditional model, a ``cond_drop_prob``
        of 0, or eval mode)."""
        p = self.ns2.model.cond_drop_prob
        if not (self.ns2.conditional and p > 0.0 and self.ns2.training):
            return None
        generator = self.generator if generator is None else generator
        return tuple(prob_mask_like((b,), p, generator, self.device) for _ in range(2))

    def draw_self_cond(self, b: int, generator: Optional[torch.Generator] = None):
        """A self-conditioned denoiser's bootstrap rows [b] for one
        micro-batch, a Bernoulli(``train_prob_self_cond``) draw after
        ``draw_cond_drop``'s (the JAX trainer's ``self_cond`` stream); None
        without self-conditioning or in eval mode (every row then)."""
        if not (self.ns2.model.self_cond and self.ns2.training):
            return None
        generator = self.generator if generator is None else generator
        return prob_mask_like((b,), self.ns2.train_prob_self_cond, generator, self.device)

    def _draws(self, audio, generator: Optional[torch.Generator] = None) -> dict:
        """The loss's draws for ``audio``, this rank's rows of a micro-batch:
        made for the whole micro-batch (as JAX draws over the global
        array) and sliced."""
        b = audio.shape[0]
        rows = b * self.mesh.n_data
        whole = audio[:1].expand(rows, *audio.shape[1:])  # the micro-batch's shape, no copy
        times, noise = self.draw(whole) if generator is None else self.draw(whole, generator)
        draws = {"times": times, "noise": noise}
        drop = self.draw_cond_drop(rows, generator)
        if drop is not None:
            draws["cond_drop_mask"] = drop
        self_cond = self.draw_self_cond(rows, generator)
        if self_cond is not None:
            draws["self_cond_mask"] = self_cond
        index = self.mesh.data_index
        keep = slice(index * b, (index + 1) * b)
        return {k: tuple(m[keep] for m in v) if isinstance(v, tuple) else v[keep]
                for k, v in draws.items()}

    def _tensors(self, batch) -> dict:
        """A batch (an array, or a dict of arrays) as a dict of tensors on
        the device, floats in f32 (bf16 under ``amp``)."""
        if not isinstance(batch, dict):
            batch = {"audio": batch}
        float_dtype = torch.bfloat16 if self.amp else torch.float32
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(np.asarray(v))
            if v.is_floating_point():
                v = v.to(torch.float32).to(float_dtype)
            out[k] = v.to(self.device)
        return out

    def losses(self, audio, extra: dict, draws: dict) -> dict:
        """The loss's components on one micro-batch (``audio`` and the loss's
        other arguments on the device, ``draws`` as ``_draws`` makes them),
        differentiable towards the f32 parameters; under ``amp`` computed
        on their bf16 copies, as the JAX trainer's `_loss_fn`. Every value
        is f32."""
        cast = {}
        if self.amp:
            cast = {name: p.to(torch.bfloat16) for name, p in self.params.items()
                    if p.dtype == torch.float32}

        def forward(a):
            return functional_call(self.ns2, cast, (a,), {**extra, **draws})

        if self.remat:  # recompute the forward in the backward pass
            losses = checkpoint(forward, audio, use_reentrant=False)
        else:
            losses = forward(audio)
        return {k: v.float() for k, v in losses.items()}

    def _update_count(self) -> int:
        """Optimizer updates applied so far (the optax schedule's count)."""
        state = self.optimizer.state.get(next(iter(self.master.values())), {})
        return int(state["step"]) if "step" in state else 0

    def _materialize(self) -> None:
        """The whole weights of the split parameters, gathered into fresh
        tensors; their versions advance, so no layout built from an
        earlier step's weights (`ops/gemm_cache.py`) is reused."""
        if not self._split:
            return
        whole = fsdp.gather_params(self.mesh, {n: self.master[n] for n in self._split},
                                   self.shardings)
        for name in self._split:
            self.params[name].data = whole[name]
            increment_version(self.params[name])

    def _release(self) -> None:
        """Drop the whole weights of the split parameters (FSDP at rest)."""
        for name in self._split:
            p = self.params[name]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            increment_version(p)

    def train_step(self, batch) -> dict:
        """One optimizer step over a batch (an array, or a dict of arrays
        with ``"audio"``) of ``grad_accum_every × train_batch_size``
        examples; returns the metrics as floats."""
        return self.train_chunk([batch])

    def train_chunk(self, batches: list) -> dict:
        """One dispatch: ``len(batches)`` optimizer steps, one per batch, in
        order, with the host waiting for the card once, at the end (the JAX
        trainer's `_train_chunk`, one `lax.scan` program); returns the
        chunk's mean metrics as floats, averaged on the host."""
        steps = [self._step(batch) for batch in batches]
        keys = list(steps[0])
        values = torch.stack([m[k] for m in steps for k in keys]).tolist()  # waits for the chunk
        return {k: sum(values[i::len(keys)]) / len(steps) for i, k in enumerate(keys)}

    def _rank_rows(self, batch, whole: int, count: int):
        """(this rank's rows of each of the first ``count`` micro-batches of
        ``whole`` rows of a global batch, and each micro-batch's phoneme
        counts (this rank's, the whole micro-batch's) when the duration /
        pitch losses are masked means)."""
        per, index = whole // self.mesh.n_data, self.mesh.data_index
        spans = [(i * whole + index * per, i * whole + (index + 1) * per)
                 for i in range(count)]

        def rows(v):
            return np.concatenate([np.asarray(v)[a:b] for a, b in spans])

        if not isinstance(batch, dict):
            return rows(batch), None
        tokens = None
        if "text" in batch and self.ns2.conditional and self.ns2.mask_duration_pitch_loss:
            text_max = np.asarray(batch["text"]).shape[-1]
            lens = (np.asarray(batch["text_lens"]) if "text_lens" in batch
                    else np.full(len(batch["text"]), text_max))
            lens = np.clip(lens, 0, text_max).astype(np.float64)
            tokens = [(float(lens[a:b].sum()), float(lens[i * whole:(i + 1) * whole].sum()))
                      for i, (a, b) in enumerate(spans)]
        return {k: rows(v) for k, v in batch.items()}, tokens

    def _shares(self, losses: dict, tokens) -> dict:
        """This rank's share of each loss component's global value; that of
        ``"loss"`` is what the backward takes. A plain mean over equal
        micro-batches is the mean of the ranks' means; a masked mean is
        theirs weighted by each rank's share of the phonemes."""
        n = self.mesh.n_data
        shares = {k: v / n for k, v in losses.items()}
        if tokens is not None:
            weight = max(tokens[0], 1.0) / max(tokens[1], 1.0)
            masked = (losses["duration"] * self.ns2.duration_loss_weight
                      + losses["pitch"] * self.ns2.pitch_loss_weight)
            shares["loss"] = shares["loss"] + (weight - 1.0 / n) * masked
            shares["duration"] = losses["duration"] * weight
            shares["pitch"] = losses["pitch"] * weight
        return shares

    def _global(self, shares: dict) -> dict:
        """Each metric's shares summed over the ranks, in one all-reduce."""
        keys = list(shares)
        summed = comm.all_reduce_(self.mesh, torch.stack([shares[k].detach() for k in keys]))
        return dict(zip(keys, summed.unbind(0)))

    def _step(self, batch) -> dict:
        """One optimizer step; the metrics as device scalars."""
        batch, tokens = self._rank_rows(batch, self.train_batch_size, self.grad_accum_every)
        per = self.train_batch_size // self.mesh.n_data
        tensors = self._tensors(batch)
        self._materialize()
        params = list(self.params.values())
        for p in params:
            p.grad = None
        sums: dict = {}
        with batch_rows(self.mesh.data_index, self.mesh.n_data):  # the backward's remat too
            for i in range(self.grad_accum_every):
                micro = {k: v[i * per:(i + 1) * per] for k, v in tensors.items()}
                audio = micro.pop("audio")
                losses = self._shares(self.losses(audio, micro, self._draws(audio)),
                                      tokens and tokens[i])
                losses["loss"].backward()
                for k, v in losses.items():
                    sums[k] = sums.get(k, 0.0) + v.detach()
        sums = self._global(sums)
        metrics = {k: v / self.grad_accum_every for k, v in sums.items()}

        # parameters the loss does not reach (the frozen codec) get zero
        # gradients, as jax.grad gives them, so Adam's state covers them too
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in self.params.items()}
        # summed over the data axis; FSDP and tensor parallelism keep each
        # rank's part
        grads = fsdp.reduce_scatter_grads(self.mesh, grads, self._grad_shardings)
        for p in params:
            p.grad = None
        self._release()
        master = list(self.master.values())
        grads = [grads[n] for n in self.master]
        if self.grad_accum_every > 1:
            torch._foreach_div_(grads, self.grad_accum_every)
        skipped = False
        if self.skip_nonfinite_updates:
            bad = torch.stack([(~torch.isfinite(g)).any() for g in grads]).any().float()
            skipped = bool(comm.all_reduce_(self.mesh, bad, None) > 0)  # each checked its parts
        g_norm = None
        if self._split or self._held:
            g_norm = fsdp.global_norm(self.mesh, dict(zip(self.master, grads)), self.shardings)
        clip_by_global_norm_(grads, self.max_grad_norm, g_norm)
        for p, g in zip(master, grads):
            p.grad = g
        if not skipped:
            lr = self.lr_at(self._update_count())
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
        for p in master:
            p.grad = None

        self.step += 1
        if self.step % self.ema_update_every == 0:
            d = self.ema_decay
            with torch.no_grad():
                ema = list(self.ema.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(master, 1 - d))
        if self.skip_nonfinite_updates:
            metrics["skipped"] = torch.tensor(float(skipped), device=self.device)
        return metrics

    def evaluate(self) -> dict:
        """Loss components on one ``val_batches`` batch (an array or a
        dict), with the training weights and fixed draws: the loss's from
        a generator seeded ``seed + 1234``, the dropout's from torch's
        default generators seeded so for the call and restored after. Over
        a mesh each rank computes its rows of the batch's first
        ``train_batch_size``, with the global batch's draws."""
        if self.val_batches is None:
            raise ValueError("pass val_batches= or val_fraction= to Trainer")
        batch = next(self.val_batches)
        whole = min(len(batch["audio"] if isinstance(batch, dict) else batch),
                    self.train_batch_size)
        check_batch_split(whole, self.mesh.n_data)
        batch, tokens = self._rank_rows(batch, whole, 1)
        tensors = self._tensors(batch)
        audio = tensors.pop("audio")
        generator = torch.Generator(self.device).manual_seed(self.seed + 1234)
        devices = [self.device] if self.device.type == "cuda" else []
        self._materialize()
        with torch.no_grad(), torch.random.fork_rng(devices=devices), \
                batch_rows(self.mesh.data_index, self.mesh.n_data):
            torch.manual_seed(self.seed + 1234)
            losses = self.losses(audio, tensors, self._draws(audio, generator))
        self._release()
        losses = self._global(self._shares(losses, tokens and tokens[0]))
        return {f"val_{k}": float(v) for k, v in losses.items()}

    # ------------------------------------------------------------------ #

    def gather(self, tree: dict) -> dict:
        """The whole leaves of a state tree (by parameter name) held as the
        parameters are: under FSDP or tensor parallelism gathered, a
        collective every rank calls."""
        if not (self._split or self._held):
            return tree
        return fsdp.gather_params(self.mesh, tree, self.shardings)

    def full_state(self) -> dict:
        """{step, params, opt_state, ema_params, version}: the whole state
        as a checkpoint holds it (under FSDP or tensor parallelism
        gathered, a collective every rank calls)."""
        params = self.ns2.state_dict()
        opt_state = self.optimizer.state_dict()
        cut = self._split + sorted(self._held)
        if cut:
            params.update(self.gather({n: self.master[n].detach() for n in cut}))
            names = list(self.master)
            moments = opt_state["state"]
            for key in ("exp_avg", "exp_avg_sq"):
                held = {names[i]: s[key] for i, s in moments.items()}
                whole = self.gather(held)
                for i in moments:
                    moments[i] = {**moments[i], key: whole[names[i]]}
        return {"step": self.step, "params": params, "opt_state": opt_state,
                "ema_params": self.gather(self.ema), "version": __version__}

    def save(self, milestone, state: Optional[dict] = None) -> str:
        """Rank 0 writes ``model-{milestone}.ckpt``; the other ranks take
        part in the gather and return ""."""
        state = self.full_state() if state is None else state
        if not self.mesh.is_main:
            return ""
        path = self.results_folder / f"model-{milestone}.ckpt"
        torch.save(state, path)
        return str(path)

    def latest_checkpoint(self) -> Optional[str]:
        ckpts = sorted(self.results_folder.glob("model-*.ckpt"), key=lambda p: p.stat().st_mtime)
        return str(ckpts[-1]) if ckpts else None

    def load(self, path) -> None:
        """Restore a checkpoint (any mesh's: they hold the whole state) and
        lay it out as this trainer's."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        cut = self._split + sorted(self._held)
        for name in cut:
            p = self.params[name]
            p.data = torch.empty(self._full_shapes[name], dtype=p.dtype, device=p.device)
        self.ns2.load_state_dict(payload["params"], strict=True)
        opt_state = payload["opt_state"]
        if cut:  # each rank keeps its parts
            with torch.no_grad():
                for name in self._split:
                    self.master[name].copy_(self.shardings[name].shard(self.params[name]))
                for name in self._held:
                    p = self.params[name]
                    p.data = self.shardings[name].shard(p.data).contiguous().clone()
                    increment_version(p)
            self._release()
            names = list(self.master)
            for i, s in opt_state["state"].items():
                sharding = self.shardings[names[i]]
                opt_state["state"][i] = {k: v if k == "step" else sharding.shard(v)
                                         for k, v in s.items()}
        self.optimizer.load_state_dict(opt_state)  # moves the moments to the params
        with torch.no_grad():
            for name, e in self.ema.items():
                e.copy_(self.shardings[name].shard(payload["ema_params"][name]))
        self.step = int(payload["step"])
        self._resume_checked = True
        if payload.get("version") != __version__:
            print(f"checkpoint saved with version {payload.get('version')}, "
                  f"loading into {__version__}")

    def _agreed_checkpoint(self) -> Optional[str]:
        """The newest checkpoint, if rank 0 has one: the ranks agree by a
        broadcast, and a rank that lacks rank 0's raises."""
        latest = self.latest_checkpoint()
        found = comm.broadcast_(self.mesh, torch.tensor([float(latest is not None)],
                                                        device=self.device))
        if bool(found[0]) and latest is None:
            raise FileNotFoundError(
                "the main process has a checkpoint but this rank's results_folder "
                f"({self.results_folder}) does not — results_folder must be shared storage "
                "for a multi-process restart")
        return latest if bool(found[0]) else None

    # ------------------------------------------------------------------ #

    def train(self, log_every: int = 50, profile_steps: Optional[Tuple[int, int]] = None):
        """Steps until ``train_num_steps``, resuming first from the newest
        checkpoint in ``results_folder``, ``steps_per_dispatch`` steps a
        dispatch (`train_chunk`). Each periodic action fires when its
        boundary falls anywhere inside a dispatch: a line of metrics (the
        dispatch's means, and ``step_time_s``, its wall time on the host
        clock, synchronised, over its steps) to ``metrics.jsonl`` every
        ``log_every`` steps, a validation every ``validate_every``, an EMA
        sample and a checkpoint every ``save_and_sample_every``.
        ``profile_steps=(start, stop)`` traces the dispatches from the
        first at step ≥ ``start`` to the first reaching ≥ ``stop`` with
        torch.profiler (host and CUDA activity) into ``results_folder /
        "profile"``, as a Chrome trace."""
        batch = next(self.batches)
        if (self.ns2.conditional and self._holdback is None and isinstance(batch, dict)
                and "text" in batch and "prompt" in batch):
            self._holdback = {k: np.asarray(batch[k][:1]) for k in ("text", "text_lens", "prompt")
                              if k in batch}
        if not self._resume_checked:
            self._resume_checked = True
            latest = self._agreed_checkpoint()
            if latest is not None:
                print(f"resuming from {latest}")
                self.load(latest)
        metrics_path = self.results_folder / "metrics.jsonl"
        k = self.steps_per_dispatch
        profiler = None
        while self.step < self.train_num_steps:
            prev = self.step
            if profile_steps and profiler is None and prev >= profile_steps[0]:
                profiler = self._start_profile()
            chunk = [batch] + [next(self.batches) for _ in range(k - 1)]
            start = time.perf_counter()
            metrics = self.train_chunk(chunk)
            step_time = (time.perf_counter() - start) / k
            step = self.step
            if profiler is not None and step >= profile_steps[1]:
                self._stop_profile(profiler)
                profiler, profile_steps = None, None
            main = self.mesh.is_main
            if step // log_every > prev // log_every and main:
                print(f"step {step}: loss {metrics['loss']:.4f} ({step_time * 1e3:.0f} ms)")
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({"step": step, "step_time_s": step_time, **metrics}) + "\n")
            if self.val_batches is not None and step // self.validate_every > prev // self.validate_every:
                val = self.evaluate()
                if main:
                    print(f"step {step}: val_loss {val['val_loss']:.4f}")
                    with open(metrics_path, "a") as f:
                        f.write(json.dumps({"step": step, **val}) + "\n")
            if step // self.save_and_sample_every > prev // self.save_and_sample_every:
                self.sample_and_save(step // self.save_and_sample_every)
            batch = next(self.batches)
        if profiler is not None:
            self._stop_profile(profiler)
        if self.mesh.is_main:
            print("training complete")

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        folder = self.results_folder / "profile"
        folder.mkdir(parents=True, exist_ok=True)
        rank = f"-rank{self.mesh.rank}" if self.mesh.world_size > 1 else ""
        path = folder / f"trace-step{self.step}{rank}.json"
        profiler.export_chrome_trace(str(path))
        print(f"profile written to {path}")

    def sample_and_save(self, milestone) -> None:
        """Write ``sample-{milestone}.wav`` (one sample of ``sample_length``
        frames from the EMA weights, seeded with the milestone: a
        conditional model speaks the text of the (prompt, text) pair held
        back from the first batch, and writes no sample without one) and
        ``model-{milestone}.ckpt``; on rank 0 only, after every rank took
        part in gathering the state."""
        state = self.full_state()
        if not self.mesh.is_main:
            return
        cond = {}
        if self.ns2.conditional and self._holdback is not None:
            cond = {k: torch.as_tensor(v).to(self.device) for k, v in self._holdback.items()}
            cond["prompt"] = cond["prompt"].to(torch.float32)
        if self.ns2.codec is not None and (cond or not self.ns2.conditional):
            # one process samples: the copy runs every head
            ema_model = tp.unshard_model(copy.deepcopy(self.ns2), state["ema_params"])
            generator = torch.Generator(self.device).manual_seed(int(milestone))
            audio = sample(ema_model, length=self.sample_length, batch_size=1, generator=generator,
                           **cond)
            write_wav(self.results_folder / f"sample-{milestone}.wav", audio[0].cpu().numpy(),
                      self.ns2.sample_hz)
        self.save(milestone, state)
