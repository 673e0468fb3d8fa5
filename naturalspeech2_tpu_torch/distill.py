"""Progressive distillation for few-step sampling (twin of
`naturalspeech2_tpu/distill.py`; Salimans & Ho 2022, arXiv 2202.00512).

A student denoiser learns to make in ONE DDIM step the move that its
teacher makes in TWO, and the step count halves round by round (N → N/2 →
… → the target). The loss works on an unconditional `Model` with the
v-objective: the target v comes from the x̂₀ that makes one student step
land exactly where the teacher's two half-steps do.

Randomness is explicit: the student's grid index ``i`` and the noise are
drawn from a ``torch.Generator`` or injected (``i=``, ``noise=``), as the
tests inject JAX's draws. The student trains on the card through the
denoiser's kernels: K1, K2 and K3 forward, K2's backward on K4 and K5.
"""

from __future__ import annotations

import copy
from typing import Callable, Iterator, Optional

import torch

from naturalspeech2_tpu_torch.models.denoiser import Model
from naturalspeech2_tpu_torch.models.naturalspeech2 import _eval_mode
from naturalspeech2_tpu_torch.ops.schedules import gamma_to_alpha_sigma
from naturalspeech2_tpu_torch.trainer import clip_by_global_norm_
from naturalspeech2_tpu_torch.utils.helpers import safe_div


def _x0_from_v(audio, v, alpha, sigma):
    return alpha * audio - sigma * v


def _v_from_x0(audio, x0, alpha, sigma):
    noise = safe_div(audio - alpha * x0, sigma)
    return alpha * noise - sigma * x0


def _ddim_step(audio, x0, alpha, sigma, alpha_next, sigma_next):
    pred_noise = safe_div(audio - alpha * x0, sigma)
    return x0 * alpha_next + pred_noise * sigma_next


def x0_target(x_t, x_next, alpha_t, sigma_t, alpha_n, sigma_n):
    """The x̃₀ that makes one DDIM step from (x_t, t) land on ``x_next``:
    x_next = α_n·x̃₀ + (σ_n/σ_t)·(x_t − α_t·x̃₀), solved for x̃₀."""
    denom = alpha_n - safe_div(sigma_n * alpha_t, sigma_t)
    return safe_div(x_next - safe_div(sigma_n, sigma_t) * x_t, denom)


def distillation_loss(
    student: Model,
    teacher: Model,
    x_data: torch.Tensor,
    *,
    num_student_steps: int,
    gamma_schedule: Callable[[torch.Tensor], torch.Tensor],
    scale: float = 1.0,
    i: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The one-step-student against two-step-teacher loss (v-objective) on
    clean latents ``x_data`` [b, n, d], differentiable towards the
    student's parameters.

    The student's times lie on the grid {1/N, …, 1}: t = i/N with ``i`` [b]
    in 1..N, drawn from ``generator`` unless given, then the noise [b, n,
    d] likewise. The teacher takes two DDIM half-steps without gradient,
    t → t − 1/2N → t − 1/N; the target is v of the x̃₀ that makes one step
    land there (`x0_target`), and the loss is the mean of the
    truncated-SNR weight max(α²/σ², 1) times the squared v error. Both
    denoisers run without dropout, as the JAX package's deterministic
    apply."""
    b = x_data.shape[0]
    if i is None:
        i = torch.randint(1, num_student_steps + 1, (b,), generator=generator,
                          device=x_data.device)
    if noise is None:
        noise = torch.randn(x_data.shape, generator=generator, device=x_data.device,
                            dtype=x_data.dtype)
    t = i.to(torch.float32) / num_student_steps
    t_mid = t - 0.5 / num_student_steps
    t_next = t - 1.0 / num_student_steps

    def alpha_sigma(times):
        alpha, sigma = gamma_to_alpha_sigma(gamma_schedule(times), scale)
        return alpha[:, None, None], sigma[:, None, None]

    alpha_t, sigma_t = alpha_sigma(t)
    alpha_m, sigma_m = alpha_sigma(t_mid)
    alpha_n, sigma_n = alpha_sigma(t_next)
    x_t = alpha_t * x_data + sigma_t * noise

    with torch.no_grad(), _eval_mode(teacher):
        v1 = teacher(x_t, t)
        x_mid = _ddim_step(x_t, _x0_from_v(x_t, v1, alpha_t, sigma_t), alpha_t, sigma_t,
                           alpha_m, sigma_m)
        v2 = teacher(x_mid, t_mid)
        x_next = _ddim_step(x_mid, _x0_from_v(x_mid, v2, alpha_m, sigma_m), alpha_m, sigma_m,
                            alpha_n, sigma_n)
        v_target = _v_from_x0(x_t, x0_target(x_t, x_next, alpha_t, sigma_t, alpha_n, sigma_n),
                              alpha_t, sigma_t)

    with _eval_mode(student):
        v_student = student(x_t, t)
    w = ((alpha_t**2) / (sigma_t**2)).clamp(min=1.0)
    return (w * (v_student - v_target) ** 2).mean()


class ProgressiveDistiller:
    """Halves the sampler's step count round by round.

    ``teacher`` is the denoiser to start from (``ns2.model`` by default);
    each round trains a copy of it as the student with optax's
    ``clip_by_global_norm(max_grad_norm)`` then ``adam(lr)`` (torch's Adam,
    whose update equals optax's, after `clip_by_global_norm_`), and the
    student becomes the next round's teacher. The student samples with
    ``sample(..., timesteps=num_student_steps)`` (DDIM: each student step
    stands in for two of its teacher's)."""

    def __init__(self, ns2, teacher: Optional[Model] = None, lr: float = 1e-4,
                 max_grad_norm: float = 1.0):
        self.ns2 = ns2
        self.teacher = ns2.model if teacher is None else teacher
        self.lr = lr
        self.max_grad_norm = max_grad_norm
        self.last_loss: Optional[float] = None

    def update(self, student: Model, optimizer: torch.optim.Optimizer, x_data: torch.Tensor,
               *, num_student_steps: int, i: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One optimizer update of ``student`` on ``x_data``; returns the
        loss (a device scalar)."""
        params = [p for p in student.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        loss = distillation_loss(student, self.teacher, x_data,
                                 num_student_steps=num_student_steps,
                                 gamma_schedule=self.ns2.gamma_schedule, scale=self.ns2.scale,
                                 i=i, noise=noise, generator=generator)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        clip_by_global_norm_(grads, self.max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        for p in params:
            p.grad = None
        return loss.detach()

    def distill_round(self, latent_batches: Iterator, *, num_student_steps: int, n_updates: int,
                      seed: int = 0, updates_per_jit: int = 1) -> Model:
        """One halving round: exactly ``n_updates`` updates of a student
        copied from the teacher, each on the next batch of
        ``latent_batches`` (arrays or tensors [b, n, d]) with its draws from a
        generator seeded with ``seed``. ``updates_per_jit`` is the JAX
        package's dispatch chunking, whose padded tail updates are no-ops:
        it is accepted and changes nothing. The student becomes the
        teacher; ``last_loss`` is its last update's loss."""
        if updates_per_jit < 1:
            raise ValueError(f"updates_per_jit must be >= 1, got {updates_per_jit}")
        student = copy.deepcopy(self.teacher)
        student.requires_grad_(True)
        device = next(student.parameters()).device
        optimizer = torch.optim.Adam(student.parameters(), lr=self.lr, betas=(0.9, 0.999),
                                     eps=1e-8)
        generator = torch.Generator(device).manual_seed(seed)
        loss = None
        for _ in range(n_updates):
            x = torch.as_tensor(next(latent_batches)).to(device, torch.float32)
            loss = self.update(student, optimizer, x, num_student_steps=num_student_steps,
                               generator=generator)
        self.teacher = student
        self.last_loss = float(loss) if loss is not None else None
        return student

    def run_schedule(self, latent_batches: Iterator, *, start_steps: int, target_steps: int,
                     updates_per_round: int, seed: int = 0, updates_per_jit: int = 1):
        """Halve from ``start_steps`` to ``target_steps`` (which must divide
        it by a power of two), one `distill_round` each, seeded ``seed +
        round``: ``(the final student, history)``, history holding each
        round's (num_student_steps, last loss)."""
        ratio = start_steps // target_steps
        assert start_steps % target_steps == 0 and ratio & (ratio - 1) == 0, (
            "start_steps must be target_steps × a power of two")
        history = []
        steps, student, rnd = start_steps, self.teacher, 0
        while steps > target_steps:
            steps //= 2
            student = self.distill_round(latent_batches, num_student_steps=steps,
                                         n_updates=updates_per_round, seed=seed + rnd,
                                         updates_per_jit=updates_per_jit)
            history.append((steps, self.last_loss))
            rnd += 1
        return student, history
