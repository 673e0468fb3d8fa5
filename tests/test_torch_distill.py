"""Port parity for progressive distillation (`naturalspeech2_tpu_torch/
distill.py` against `naturalspeech2_tpu/distill.py`): the one-step-student
against two-step-teacher loss and its gradients with the grid index and
the noise rebuilt from JAX's key, one clip + Adam update against optax,
the x̃₀ target inverting a DDIM step, `distill_round`'s update count and
`run_schedule`'s halving history."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from naturalspeech2_tpu import distill as jdistill
from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, ProgressiveDistiller, load_jax_params
from naturalspeech2_tpu_torch.distill import _ddim_step, distillation_loss, x0_target
from naturalspeech2_tpu_torch.ops.schedules import gamma_to_alpha_sigma, sigmoid_schedule

from torch_parity import assert_close, jitter, normal, numpy_tree, t

# the JAX package's distillation test model (tests/test_distill.py)
MODEL_CFG = dict(dim=8, depth=1, heads=2, dim_head=4, wavenet_layers=1, wavenet_stacks=1,
                 use_flash_attn=False)
B, N, STEPS = 2, 8, 4
KEY = jax.random.PRNGKey(1)
# the loss and gradients through three network evaluations, as
# tests/test_torch_cond_train.py holds a loss and its gradients
LOSS_RTOL, GRAD_RTOL = 2e-5, 2e-4
# Adam's first update is lr·g/(|g| + ε) per entry: f32 differences in g
# move it by far less than lr (1e-3) except where |g| ~ ε
UPDATE_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    model = JModel(**MODEL_CFG)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((B, N, 8)), jnp.zeros((B,)))["params"]
    teacher = jitter(numpy_tree(params), 2, scale=0.1)
    student = jitter(teacher, 3, scale=0.05)
    x = normal(np.random.default_rng(4), B, N, 8)
    ns2_j = jns2.NaturalSpeech2(model=model, timesteps=8)
    loss, grads = jax.value_and_grad(lambda p: jdistill.distillation_loss(
        model, {"params": p}, {"params": teacher}, jnp.asarray(x), KEY,
        num_student_steps=STEPS, gamma_schedule=ns2_j.gamma_schedule))(student)
    return teacher, student, x, loss, grads


def _port(tree) -> Model:
    port = Model(**MODEL_CFG)
    port.load_state_dict(load_jax_params(tree), strict=True)
    return port


def _jax_draws(key, shape):
    """(i, noise) as `distillation_loss` draws them from ``key``."""
    k_t, k_noise = jax.random.split(key)
    i = jax.random.randint(k_t, (shape[0],), 1, STEPS + 1)
    return torch.from_numpy(np.array(i)), t(jax.random.normal(k_noise, shape))


def test_loss_and_gradients_match_jax(setup):
    teacher, student, x, loss_j, grads_j = setup
    port_student, port_teacher = _port(student), _port(teacher)
    i, noise = _jax_draws(KEY, x.shape)
    loss = distillation_loss(port_student, port_teacher, t(x), num_student_steps=STEPS,
                             gamma_schedule=sigmoid_schedule, i=i, noise=noise)
    assert_close(loss, loss_j, atol=0, rtol=LOSS_RTOL)
    loss.backward()
    assert all(p.grad is None for p in port_teacher.parameters())
    expected = load_jax_params(numpy_tree(grads_j))
    for name, p in port_student.named_parameters():
        want = expected[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-6)
        assert_close(p.grad / scale, want / scale, atol=GRAD_RTOL)


def test_one_update_matches_optax(setup):
    """One update: clip_by_global_norm(1.0) then adam(1e-3), as
    `ProgressiveDistiller`'s optimizer; the clip is active (‖g‖ > 1)."""
    teacher, student, x, _, grads_j = setup
    lr, max_norm = 1e-3, 1.0
    assert float(optax.global_norm(grads_j)) > max_norm
    opt = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(lr))
    updates, _ = opt.update(grads_j, opt.init(student), student)
    expected = load_jax_params(numpy_tree(optax.apply_updates(student, updates)))

    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), timesteps=8)
    distiller = ProgressiveDistiller(ns2_t, _port(teacher), lr=lr, max_grad_norm=max_norm)
    port_student = _port(student)
    optimizer = torch.optim.Adam(port_student.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    i, noise = _jax_draws(KEY, x.shape)
    distiller.update(port_student, optimizer, t(x), num_student_steps=STEPS, i=i, noise=noise)
    for name, p in port_student.named_parameters():
        assert_close(p.detach(), expected[name].numpy(), atol=UPDATE_ATOL)


def test_x0_target_inverts_a_ddim_step():
    """One student DDIM step from (x_t, t) with the x̃₀ target lands on the
    teacher's two-step endpoint, as the JAX package's formula (the same
    inputs through `naturalspeech2_tpu.distill._ddim_step`)."""
    rng = np.random.default_rng(5)
    x_t, x_next = t(normal(rng, 3, 5, 4)), t(normal(rng, 3, 5, 4))
    a_t, s_t = gamma_to_alpha_sigma(sigmoid_schedule(torch.tensor(0.7)))
    a_n, s_n = gamma_to_alpha_sigma(sigmoid_schedule(torch.tensor(0.45)))
    target = x0_target(x_t, x_next, a_t, s_t, a_n, s_n)
    assert_close(_ddim_step(x_t, target, a_t, s_t, a_n, s_n), x_next.numpy(), atol=1e-4)
    reached = jdistill._ddim_step(*(jnp.asarray(v.numpy()) for v in (x_t, target, a_t, s_t, a_n,
                                                                     s_n)))
    assert_close(reached, x_next.numpy(), atol=1e-4)


def _batches(seed):
    rng = np.random.default_rng(seed)
    while True:
        yield normal(rng, B, N, 8)


def test_distill_round_runs_exactly_n_updates(setup):
    """2 updates whatever ``updates_per_jit`` (the JAX package's padded tail
    updates are no-ops): the same student, the same two batches consumed,
    and the teacher replaced by the student."""
    teacher = setup[0]
    results = []
    for per_jit in (1, 4):
        ns2_t = NaturalSpeech2(Model(**MODEL_CFG), timesteps=8)
        distiller = ProgressiveDistiller(ns2_t, _port(teacher), lr=1e-3)
        batches = _batches(6)
        student = distiller.distill_round(batches, num_student_steps=STEPS, n_updates=2,
                                          updates_per_jit=per_jit)
        assert distiller.teacher is student and np.isfinite(distiller.last_loss)
        results.append((student.state_dict(), next(batches)))
    (a, next_a), (b, next_b) = results
    assert np.array_equal(next_a, next_b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    moved = _port(teacher).state_dict()
    assert any(not torch.equal(a[k], moved[k]) for k in a)


def test_run_schedule_halves_to_target(setup):
    ns2_t = NaturalSpeech2(Model(**MODEL_CFG), timesteps=8)
    distiller = ProgressiveDistiller(ns2_t, _port(setup[0]), lr=1e-3)
    final, history = distiller.run_schedule(_batches(7), start_steps=8, target_steps=2,
                                            updates_per_round=2)
    assert [s for s, _ in history] == [4, 2]
    assert all(np.isfinite(loss) for _, loss in history)
    assert set(final.state_dict()) == set(ns2_t.model.state_dict())
    with pytest.raises(AssertionError):
        distiller.run_schedule(_batches(7), start_steps=6, target_steps=2, updates_per_round=1)
