"""Port parity for the pieces of conditional training below the model,
each against its JAX twin on numpy inputs from a seed: the mel frontend,
the ACF and NCCF pitch estimators, monotonic alignment search (also
against the JAX package's numpy oracle, ties included), the forward-sum
loss on feasible and infeasible alignments, the binarization loss, the
duration average; then the randomness of training: the plain route's
attention dropout (JAX's keep mask injected, and keep rates), the flash
route's keep rate, the CFG drop, and where the encoders apply dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models import aligner as jaligner
from naturalspeech2_tpu.ops import ctc as jctc
from naturalspeech2_tpu.ops import mas as jmas
from naturalspeech2_tpu.ops import mel as jmel
from naturalspeech2_tpu.ops import pitch as jpitch
from naturalspeech2_tpu.ops.attention import attend_xla
from naturalspeech2_tpu.utils import helpers as jh
from naturalspeech2_tpu_torch import Model
from naturalspeech2_tpu_torch import params as tparams
from naturalspeech2_tpu_torch.models import aligner as taligner
from naturalspeech2_tpu_torch.models import encoders as te
from naturalspeech2_tpu_torch.models import transformer as ttransformer
from naturalspeech2_tpu_torch.ops import ctc as tctc
from naturalspeech2_tpu_torch.ops import mas as tmas
from naturalspeech2_tpu_torch.ops import mel as tmel
from naturalspeech2_tpu_torch.ops import pitch as tpitch
from naturalspeech2_tpu_torch.ops.attention import attend_plain
from naturalspeech2_tpu_torch.ops.flash_attention import flash_attention
from naturalspeech2_tpu_torch.utils import helpers as th

from torch_parity import assert_close, normal, t

SR = 24000
# Mel in dB: one STFT and a filterbank product in f32, by two FFT
# libraries; measured ≤ 2e-4 dB on these signals (levels −30 … 40 dB).
MEL_ATOL_DB = 2e-3
# Pitch in Hz on the frames whose lag both sides pick (a parabola through
# three f32 scores): measured ≤ 3e-4 Hz. A frame may pick another lag only
# where two lags' scores nearly tie; at most 1 frame in 50 may.
PITCH_ATOL_HZ = 1e-2
PITCH_TIE_SHARE = 0.02
# forward-sum loss: the same recursion in f32; on an infeasible alignment
# the log-alphas sit near −1e5, where f32 resolves ~0.008, so that
# example's gradient agrees only to ~3e-3 of the largest entry
CTC_RTOL, CTC_GRAD_ATOL, CTC_INFEASIBLE_GRAD_RTOL = 1e-6, 1e-6, 1e-2


def _voiced(rng, b, samples):
    time = np.arange(samples) / SR
    rows = []
    for _ in range(b):
        phase = 2 * np.pi * rng.uniform(90, 420) * time + 3 * np.sin(2 * np.pi * 5 * time)
        rows.append(0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase)
                    + 0.05 * rng.standard_normal(samples))
    return np.stack(rows)


@pytest.fixture(scope="module")
def audio():
    """Three voiced rows and one of uniform noise, 0.5 s at 24 kHz."""
    rng = np.random.default_rng(0)
    return np.concatenate([_voiced(rng, 3, SR // 2),
                           rng.uniform(-1, 1, (1, SR // 2))]).astype(np.float32)


@pytest.mark.parametrize("kwargs", [dict(n_mels=80), dict(n_mels=100, hop_length=200, f_max=7000.0,
                                                          log=True)], ids=["hop160", "hop200"])
def test_audio_to_mel_matches_jax(audio, kwargs):
    expected = np.asarray(jmel.audio_to_mel(jnp.asarray(audio), **kwargs))
    got = tmel.audio_to_mel(t(audio), **kwargs)
    assert got.shape == expected.shape == (4, kwargs["n_mels"],
                                           1 + audio.shape[1] // kwargs.get("hop_length", 160))
    assert_close(got, expected, atol=MEL_ATOL_DB)
    assert_close(tmel.mel_filterbank(513, 80, SR, f_max=8000.0),
                 jmel.mel_filterbank(513, 80, SR, f_max=8000.0), atol=0)


@pytest.mark.parametrize("estimator", ["compute_pitch", "compute_pitch_nccf"])
def test_pitch_matches_jax(audio, estimator):
    expected = np.asarray(getattr(jpitch, estimator)(jnp.asarray(audio), sample_rate=SR,
                                                     hop_length=160))
    got = getattr(tpitch, estimator)(t(audio), sample_rate=SR, hop_length=160).numpy()
    assert got.shape == expected.shape == (4, 1 + audio.shape[1] // 160)
    close = np.abs(got - expected) <= PITCH_ATOL_HZ
    assert (~close).mean() <= PITCH_TIE_SHARE, np.argwhere(~close)
    assert (expected[:3] > 0).mean() > 0.8  # the tones are voiced


def _path_inputs(seed, text_lens, mel_lens, t_x=7, t_y=20, value=None):
    rng = np.random.default_rng(seed)
    b = len(text_lens)
    if value is None:
        value = rng.standard_normal((b, t_x, t_y)).astype(np.float32)
    mask = ((np.arange(t_x)[None, :, None] < np.asarray(text_lens)[:, None, None])
            & (np.arange(t_y)[None, None, :] < np.asarray(mel_lens)[:, None, None]))
    return value, mask.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "all_equal", "fewer_frames_than_phonemes"])
def test_maximum_path_matches_jax_and_numpy(case):
    lens = {"random": ([7, 5, 7], [20, 14, 9]), "all_equal": ([7, 4, 6], [20, 11, 6]),
            "fewer_frames_than_phonemes": ([7, 7, 4], [3, 2, 5])}[case]
    value = np.full((3, 7, 20), 0.5, np.float32) if case == "all_equal" else None
    value, mask = _path_inputs(1, *lens, value=value)
    got = tmas.maximum_path(t(value), t(mask)).numpy()
    assert np.array_equal(got, np.asarray(jmas.maximum_path(jnp.asarray(value),
                                                            jnp.asarray(mask))))
    assert np.array_equal(got, jmas.maximum_path_numpy(value, mask))
    if case != "fewer_frames_than_phonemes":  # every masked frame has one phoneme
        assert np.array_equal(got.sum(axis=1), mask[:, 0, :])


def test_forward_sum_loss_matches_jax():
    """Feasible, and infeasible (key_len 5 over 3 frames): there the JAX
    package gives ≈ 1e4 (optax's finite log(0)), not torch CTC's 0."""
    rng = np.random.default_rng(2)
    logp = (rng.standard_normal((2, 1, 6, 5)) * 2).astype(np.float32)
    for key_lens, query_lens, feasible in (([5, 3], [6, 4], True), ([5, 3], [3, 6], False)):
        k, q = np.asarray(key_lens), np.asarray(query_lens)
        value_j, grad_j = jax.value_and_grad(
            lambda x: jctc.forward_sum_loss(x, jnp.asarray(k), jnp.asarray(q)))(jnp.asarray(logp))
        x = t(logp).requires_grad_()
        loss = tctc.forward_sum_loss(x, torch.from_numpy(k), torch.from_numpy(q))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(value_j), rtol=CTC_RTOL)
        grad_j = np.asarray(grad_j)
        if feasible:
            assert 0 < float(value_j) < 10
            assert_close(x.grad, grad_j, atol=CTC_GRAD_ATOL)
        else:
            assert float(value_j) > 1e3
            scale = np.abs(grad_j).max()
            assert_close(x.grad / scale, grad_j / scale, atol=CTC_INFEASIBLE_GRAD_RTOL)
            assert_close(x.grad[1], grad_j[1], atol=CTC_GRAD_ATOL)  # the feasible example


def test_aligner_and_bin_loss_match_jax():
    rng = np.random.default_rng(3)
    b, t_x, t_y = 2, 5, 9
    x, y = normal(rng, b, t_x, 24), normal(rng, b, 8, t_y)
    x_mask = np.arange(t_x)[None] < np.array([[5], [3]])
    y_mask = np.arange(t_y)[None] < np.array([[9], [7]])
    mod = jaligner.Aligner(dim_in=8, dim_hidden=24, attn_channels=8)
    args = tuple(map(jnp.asarray, (x, x_mask, y, y_mask)))
    params = mod.init(jax.random.PRNGKey(0), *args)
    hard_j, soft_j, logp_j, path_j = mod.apply(params, *args)
    port = taligner.Aligner(8, 24, 8)
    conv = tparams._Converter({"m": jax.tree_util.tree_map(np.asarray, params["params"])})
    tparams._aligner_net(conv, "m/aligner", "aligner")
    port.load_state_dict(conv.finish(), strict=True)
    with torch.no_grad():
        hard, soft, logp, path = port(t(x), torch.from_numpy(x_mask), t(y),
                                      torch.from_numpy(y_mask))
    assert hard.dtype == torch.int32 and np.array_equal(hard.numpy(), np.asarray(hard_j))
    assert np.array_equal(path.numpy(), np.asarray(path_j))
    assert_close(soft, soft_j, atol=1e-6)
    assert_close(logp, logp_j, atol=1e-4)
    key_lens = np.array([5, 3])
    expected = jaligner.BinLoss()(path_j, logp_j, jnp.asarray(key_lens))
    got = taligner.BinLoss()(path, logp, torch.from_numpy(key_lens))
    np.testing.assert_allclose(float(got), float(expected), rtol=1e-5)
    assert float(got) > 0  # sign-corrected: a loss to minimise


def test_average_over_durations_matches_jax():
    rng = np.random.default_rng(4)
    values = rng.uniform(80, 300, (2, 1, 30)).astype(np.float32)
    values[:, :, 5:9] = 0.0  # unvoiced frames count as missing
    durs = rng.integers(0, 6, (2, 8)).astype(np.int32)
    durs[0, 2] = durs[1, 0] = 0  # zero durations give 0
    durs[1, -1] = 30  # past the frames
    expected = np.asarray(jh.average_over_durations(jnp.asarray(values), jnp.asarray(durs)))
    got = th.average_over_durations(t(values), torch.from_numpy(durs))
    assert got.shape == (2, 1, 8)
    assert_close(got, expected, atol=1e-4)
    assert got[0, 0, 2] == 0 and got[1, 0, 0] == 0


def test_plain_attention_dropout_matches_jax_keep_mask():
    """The plain route with JAX's keep mask injected gives `attend_xla`'s
    output with dropout; drawn from a generator, it keeps 1 − p."""
    rng = np.random.default_rng(5)
    q, k, v = (normal(rng, 2, 2, 9, 8) for _ in range(3))
    mask = np.arange(9)[None] < np.array([[9], [6]])
    key, p = jax.random.PRNGKey(3), 0.2
    expected = attend_xla(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask), dropout=p,
                          dropout_key=key)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - p, (2, 2, 9, 9))))
    got = attend_plain(t(q), t(k), t(v), mask=torch.from_numpy(mask), dropout=p, keep=keep)
    assert_close(got, expected, atol=1e-6)

    # keep rate: with q = k = 0 and v the identity, o[i, j] = keep[i, j] / (n (1 − p))
    n = 256
    zeros, eye = torch.zeros(4, 2, n, n), torch.eye(n).expand(4, 2, n, n)
    out = attend_plain(zeros, zeros, eye, dropout=p, generator=torch.Generator().manual_seed(0))
    assert abs((out != 0).float().mean().item() - (1 - p)) < 0.005
    assert_close(out[out != 0], torch.full_like(out[out != 0], 1 / (n * (1 - p))), atol=1e-7)


def test_flash_attention_dropout_keep_rate():
    p, n = 0.2, 256
    zeros, eye = torch.zeros(4, 2, n, n), torch.eye(n).expand(4, 2, n, n).contiguous()
    a = flash_attention(zeros, zeros, eye, dropout=p, generator=torch.Generator().manual_seed(1))
    b = flash_attention(zeros, zeros, eye, dropout=p, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert abs((a != 0).float().mean().item() - (1 - p)) < 0.005


def test_cfg_drop_rates():
    """Training mode draws the prompt and frame-condition drops apart, each
    at cond_drop_prob, from the caller's generator; eval mode drops none."""
    model = Model(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
                  condition_on_prompt=True, dim_prompt=24, num_latents_m=4, resampler_depth=1,
                  cond_drop_prob=0.25)
    b = 4000
    gen = torch.Generator().manual_seed(0)
    prompt_drop, cond_drop = model._drop_masks(b, "cpu", None, None, gen)
    for m in (prompt_drop, cond_drop):
        assert abs(m.float().mean().item() - 0.25) < 0.025
    assert abs((prompt_drop & cond_drop).float().mean().item() - 0.25**2) < 0.015
    again = model._drop_masks(b, "cpu", None, None, torch.Generator().manual_seed(0))
    assert torch.equal(prompt_drop, again[0]) and torch.equal(cond_drop, again[1])
    rate = th.prob_mask_like((b,), 0.7, torch.Generator().manual_seed(2)).float().mean().item()
    assert abs(rate - 0.7) < 0.025
    model.eval()
    assert not any(m.any() for m in model._drop_masks(b, "cpu", None, None, gen))


def test_encoders_apply_dropout_in_training_only(monkeypatch):
    """Where each encoder drops in training (JAX's rates and routes): the
    phoneme encoder's conv output at 0.2 (its attention at 0), the speech
    prompt encoder's attention at 0.2 on flash attention, the duration /
    pitch trunks' attention at 0.2 on the plain route; nothing in eval."""
    calls = []
    real = ttransformer.attend

    def spy(*args, dropout=0.0, backend="xla", **kwargs):
        calls.append((dropout, backend))
        return real(*args, dropout=dropout, backend=backend, **kwargs)

    monkeypatch.setattr(ttransformer, "attend", spy)
    rng = np.random.default_rng(6)
    phonemes = te.PhonemeEncoder(20, dim=24, dim_hidden=24, depth=1, heads=2, dim_head=8)
    prompt_enc = te.SpeechPromptEncoder(16, dims=(24, 24), depth=1, heads=2, dim_head=8)
    trunk = te.DurationPitchPredictor(24, dim_hidden=24, depth=1, heads=2, dim_head=8,
                                      dim_encoded_prompts=24)
    text = torch.from_numpy(rng.integers(0, 20, (2, 300)))
    latents, encoded = t(normal(rng, 2, 10, 16)), t(normal(rng, 2, 10, 24))
    for training in (True, False):
        for m in (phonemes, prompt_enc, trunk):
            m.train(training)
        calls.clear()
        conv_out = []
        hook = phonemes.dropout.register_forward_hook(lambda m, i, o: conv_out.append(o))
        phonemes(text)
        hook.remove()
        prompt_enc(latents)
        trunk(t(normal(rng, 2, 7, 24)), encoded)
        p = 0.2 if training else 0.0
        assert calls == [(0.0, "xla"), (p, "flash"), (p, "xla"), (p, "xla")]
        zeros = (conv_out[0] == 0).float().mean().item()
        assert abs(zeros - p) < 0.01
