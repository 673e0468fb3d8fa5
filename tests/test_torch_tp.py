"""Tensor parallelism in the port (`naturalspeech2_tpu_torch/parallel/tp.py`,
`Trainer(param_sharding="tp")` on a model axis, `TTSEngine(mesh=)`,
`serve --tp`) on gloo ranks, held against the port's own one-process runs
(which tests/test_torch_trainer.py and tests/test_torch_cond_train.py hold
against JAX) and against the JAX trainer's own tensor-parallel step; the
rule's leaves against JAX's `state_shardings`; the kernels' options for
it (K2 / K2b without the residual, K4 / K5 dropout keyed on global rows
and heads) against their plain versions.

The ranks are two groups of worker processes (tests/_torch_tp_worker.py):
two ranks on a (1, 2) mesh and four on a (2, 2) mesh, started once for
the module with a time limit, one torch thread each, meeting through a
file (tests/_rank_groups.py). The one-process references run here
meanwhile. Tolerances are
tests/test_torch_parallel.py's: FLOOR_FACTOR times the reference's own
change under a one-ulp move of its audio, relative to each tensor's
largest entry, or 1e-6 where that is larger.
"""

import base64
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from naturalspeech2_tpu.models import naturalspeech2 as jns2
from naturalspeech2_tpu.models.aligner import AlignerNet as JAlignerNet
from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from naturalspeech2_tpu.parallel.tp import shard_state as jax_shard_state
from naturalspeech2_tpu.parallel.tp import state_shardings as jax_state_shardings
from naturalspeech2_tpu.trainer import Trainer as JTrainer
from naturalspeech2_tpu.trainer import TrainState as JTrainState
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params
from naturalspeech2_tpu_torch.data import write_wav
from naturalspeech2_tpu_torch.ops import attn_block_kernel as abk
from naturalspeech2_tpu_torch.ops import flash_attention as fa
from naturalspeech2_tpu_torch.ops.dropout import Dropout, batch_rows
from naturalspeech2_tpu_torch.parallel import Mesh, tp

import _torch_tp_worker as worker
from _rank_groups import RankGroups
from test_torch_parallel import Held, _scale
from torch_parity import jitter, normal, numpy_tree

WORKER = Path(__file__).with_name("_torch_tp_worker.py")
ROOT = Path(__file__).resolve().parents[1]
GROUP_LIMIT_S = 300
GROUPS = {"model": 2, "grid": 4}


class Ranks(RankGroups):
    """Both worker groups (tests/_rank_groups.py), their results read once
    every rank is done."""

    def __init__(self, out: Path):
        super().__init__(WORKER, out, GROUPS, limit_s=GROUP_LIMIT_S)

    def result(self, name: str):
        self.wait()
        return torch.load(self.out / f"{name}.pt", weights_only=False)

    def held(self, name: str, rank: int):
        self.wait()
        return torch.load(self.out / f"{name}-rank{rank}.pt", weights_only=False)


def _jax_inputs():
    """A jittered JAX tree of the unconditional model, a batch and the
    draws of one step."""
    tree = {
        "model": JModel(**worker.MODEL_CFG).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16)),
                                                 jnp.zeros((1,)))["params"],
        "codec": JSoundStream(**worker.CODEC_CFG).init(jax.random.PRNGKey(1),
                                                       jnp.zeros((1, 640)))["params"],
    }
    params = jitter(numpy_tree(tree), 3, scale=0.1)
    rng = np.random.default_rng(11)
    audio = np.tanh(normal(rng, worker.BATCH, worker.FRAMES * 320))
    times = rng.uniform(0.05, 0.95, worker.BATCH).astype(np.float32)
    noise = normal(rng, worker.BATCH, worker.FRAMES, 16)
    return params, audio, times, noise


@pytest.fixture(scope="module")
def jax_case():
    return _jax_inputs()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_case):
    out = tmp_path_factory.mktemp("tp_ranks")
    params, audio, times, noise = jax_case
    torch.save({"state": load_jax_params(params), "audio": audio, "times": torch.from_numpy(times),
                "noise": torch.from_numpy(noise)}, out / "jax_inputs.pt")
    worker.write_serving_files(out)
    group = Ranks(out)
    yield group
    group.kill()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The one-process runs and their floors, computed once (while the ranks
    run), on two threads; the thread count is restored after the module, so
    that it does not leak into the files a worker runs next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("tp_one_process")
    yield {
        "root": root,
        "uncond": Held(lambda m: worker.run_uncond(None, root / f"uncond-{m}", m)[0]),
        "cond": Held(lambda m: worker.run_cond(None, root / f"cond-{m}", m)[0]),
        "resume": Held(lambda m: worker.run_resume(None, root / f"resume-{m}", "replicated",
                                                   "replicated", m)[0]),
    }
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# the rule against JAX's
# --------------------------------------------------------------------- #


def _flagship_trees():
    """The unconditional flagship at a small width: (JAX tree, port model)."""
    cfg = dict(dim=32, depth=2, heads=4, dim_head=8, wavenet_layers=2, wavenet_stacks=1)
    codec = dict(codebook_dim=32, channels=4, num_quantizers=2, codebook_size=16)
    tree = {"model": JModel(**cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 32)),
                                        jnp.zeros((1,)))["params"],
            "codec": JSoundStream(**codec, use_pallas_rvq=False).init(
                jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"]}
    return tree, NaturalSpeech2(Model(**cfg), SoundStream(**codec))


def _config2_trees():
    """README config 2 (prompt-conditioned, with the conditioning stack) at
    tests/test_torch_conditional.py's widths: (JAX tree, port model)."""
    cfg = dict(dim=16, depth=2, heads=2, dim_head=8, wavenet_layers=2, wavenet_stacks=2,
               condition_on_prompt=True, dim_prompt=24, num_latents_m=8, resampler_depth=1)
    codec = dict(codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16)
    ns2_cfg = dict(
        timesteps=1000, num_phoneme_tokens=20, duration_pitch_dim=24, aligner_dim_in=8,
        aligner_dim_hidden=24, aligner_attn_channels=8, pitch_emb_pp_hidden_dim=24,
        phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, depth=1, heads=2, dim_head=8),
        prompt_enc_kwargs=dict(dims=(24, 24), depth=1, heads=2, dim_head=8),
        duration_pitch_kwargs=dict(dim_hidden=24, depth=1, heads=2, dim_head=8,
                                   dim_encoded_prompts=24))
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(0)
    prompt = jnp.asarray(rng.uniform(-1, 1, (1, 4 * 320)).astype(np.float32))
    text = jnp.asarray(rng.integers(0, 20, (1, 6)).astype(np.int32))
    duration, pitch = jnp.full((1, 6), 2.0), jnp.full((1, 6), 150.0)
    jmodel, jcodec = JModel(**cfg), JSoundStream(**codec, use_pallas_rvq=False)
    ns2_j = jns2.NaturalSpeech2(model=jmodel, codec=jcodec, **ns2_cfg)
    init = jax.jit(lambda: ns2_j.init(key, prompt, text, None, 16, pitch, duration,
                                      method=ns2_j.conditioning_for_sample))
    cond_vars = init()
    prompt_enc, cond, _ = jax.jit(lambda v: ns2_j.apply(
        v, prompt, text, None, 16, pitch, duration,
        method=ns2_j.conditioning_for_sample))(cond_vars)
    tree = dict(cond_vars["params"])
    tree["model"] = jmodel.init(key, jnp.zeros((1, 16, 16)), jnp.zeros((1,)), prompt=prompt_enc,
                                cond=cond)["params"]
    tree["codec"] = jcodec.init(key, jnp.zeros((1, 640)))["params"]
    tree["aligner"] = {"aligner": JAlignerNet(dim_in=8, dim_hidden=24, attn_channels=8).init(
        key, jnp.zeros((1, 5, 8)), jnp.zeros((1, 3, 24)))["params"]}
    return tree, NaturalSpeech2(Model(**cfg), SoundStream(**codec), **ns2_cfg)


@pytest.fixture(scope="module")
def rule_trees():
    return {"flagship": _flagship_trees(), "config2": _config2_trees()}


def _jax_specs(tree, n_model: int) -> dict:
    """Per port parameter name, the spec JAX's `state_shardings` gives its
    leaf on a (1, n_model) mesh and the leaf's shape: each JAX leaf filled
    with its index, carried through `load_jax_params` and read back."""
    mesh = jax_make_mesh(n_data=1, n_model=n_model, devices=jax.devices()[:n_model])
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    specs = jax.tree_util.tree_leaves(jax_state_shardings(mesh, tree))
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    out = {}
    for name, t in load_jax_params(marked).items():
        ids = torch.unique(t)
        assert ids.numel() == 1, f"{name} carries several JAX leaves"
        i = int(ids.item())
        out[name] = (tuple(specs[i].spec), tuple(np.shape(leaves[i])))
    return out


def _mesh_of(n_data: int, n_model: int, rank: int = 0) -> Mesh:
    """A mesh as rank ``rank`` sees it, without a group."""
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("config", ["flagship", "config2"])
def test_sharded_leaves_equal_jax_state_shardings(rule_trees, config, n_model):
    """`tp.state_shardings` over the port's parameters shards exactly the
    leaves JAX's `state_shardings` shards, over a dimension of the same
    extent, for the flagship and README config 2 at small widths."""
    tree, model = rule_trees[config]
    want = _jax_specs(tree, n_model)
    got = tp.state_shardings(_mesh_of(1, n_model), model)
    assert got.keys() == want.keys()
    sharded = 0
    for name, (spec, shape) in want.items():
        spec = tuple(a for a in spec)
        dim = got[name].dim
        if "model" in spec:
            assert dim is not None, name
            assert model.get_parameter(name).shape[dim] == shape[spec.index("model")], name
            sharded += 1
        else:
            assert dim is None, (name, got[name].spec)
    assert sharded >= 6, sharded


def test_each_rank_holds_its_heads(ranks):
    """(1, 2): each rank holds H/P heads of to_q, to_kv and to_out, to_kv's
    its heads' k columns and their v columns, as tests/test_tensor_parallel.py
    asks of JAX; the feed-forward's sharded leaves at rest its half, used
    whole; Adam's moments and the EMA follow."""
    whole = ranks.result("uncond12")["state"]["params"]
    prefix = "model.transformer.attn.0."
    for rank in range(2):
        held = ranks.held("uncond12", rank)
        assert held["heads"]["model.transformer.attn.0"] == (1, rank)
        assert held[prefix + "to_q"]["module"] == (16, 8)
        assert held[prefix + "to_kv"]["module"] == (16, 16)
        assert held[prefix + "to_out"]["module"] == (8, 16)
        for name in (prefix + "to_q", prefix + "to_kv", prefix + "to_out"):
            assert held[name]["master"] == held[name]["ema"] == held[name]["module"]
        ff = "model.transformer.ff.0."
        assert held[ff + "w1"]["master"] == (16, 42) and held[ff + "w1"]["module"] == (0,)
        assert held[ff + "w2"]["master"] == (21, 16)
    cut = tp.plan(worker.uncond_model(0), _mesh_of(1, 2, 1))[0][prefix + "to_kv"]
    k, v = whole[prefix + "to_kv"].chunk(2, dim=1)
    assert torch.equal(cut.shard(whole[prefix + "to_kv"]), torch.cat([k[:, 8:], v[:, 8:]], 1))


# --------------------------------------------------------------------- #
# tensor-parallel steps against one process
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["uncond12", "uncond22"])
def test_unconditional_tp_steps_equal_one_process(ranks, reference, name):
    """Two clipped steps on the (1, 2) and (2, 2) meshes, the self-attention
    on K2's route: each step's gradient, the parameters, Adam's moments,
    the EMA, every metric and the held-out loss equal the one-process
    run's."""
    reference["uncond"].check(ranks.result(name))


@pytest.mark.parametrize("name", ["cond12", "cond22"])
def test_conditional_tp_step_with_dropout_equals_one_process(ranks, reference, name):
    """A conditional step of two micro-batches with every dropout on (the
    masks drawn for the global batch and, in the attentions, for every
    head) on the (1, 2) and (2, 2) meshes equals the one-process step."""
    reference["cond"].check(ranks.result(name))


def test_replicated_activations_are_bitwise_equal(ranks):
    """The ranks of a model group feed their replicated modules (the
    encoders, the duration / pitch trunks, the WaveNet, the resampler's
    output, the codec) the same inputs and the same draws: their outputs
    are equal bit for bit."""
    for name, groups in (("cond12", [(0, 1)]), ("cond22", [(0, 1), (2, 3)])):
        for a, b in groups:
            seen_a = ranks.held(name, a)["activations"]
            seen_b = ranks.held(name, b)["activations"]
            assert len(seen_a) >= 5 and seen_a.keys() == seen_b.keys()
            for module, outs in seen_a.items():
                assert all(torch.equal(x, y) for x, y in zip(outs, seen_b[module])), module
    # the two data ranks hold other rows
    assert not torch.equal(ranks.held("cond22", 0)["activations"]["model.wavenet"][0],
                           ranks.held("cond22", 2)["activations"]["model.wavenet"][0])


def test_tp_step_equals_the_jax_tp_step(ranks, jax_case, tmp_path):
    """One clipped step on (1, 2) against the JAX `Trainer` on
    ``make_mesh(n_data=1, n_model=2)``, same weights, batch and draws
    (handed to both as the loss's times and noise), at
    tests/test_tensor_parallel.py's tolerances."""
    params, audio, times, noise = jax_case
    mesh = jax_make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    ns2_j = jns2.NaturalSpeech2(model=JModel(**worker.MODEL_CFG),
                                codec=JSoundStream(**worker.CODEC_CFG), timesteps=4)
    trainer = JTrainer(ns2_j, batches=iter(()), train_batch_size=worker.BATCH, lr=1e-3,
                       max_grad_norm=0.05, ema_decay=0.9, ema_update_every=1, mesh=mesh,
                       results_folder=str(tmp_path))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax_shard_state(mesh, JTrainState(step=jnp.zeros((), jnp.int32), params=p,
                                              opt_state=trainer.optimizer.init(p),
                                              ema_params=jax.tree_util.tree_map(jnp.copy, p)))
    assert state.params["model"]["transformer"]["attn_0"]["to_q"]["kernel"].sharding.spec == \
        P(None, "model")
    batch = {"audio": audio[None], "times": times[None], "noise": noise[None]}
    batch = jax.device_put(batch, NamedSharding(mesh, P(None, "data")))
    state, metrics = trainer.build_train_step()(state, batch, jax.random.PRNGKey(7))
    got = ranks.result("jax_step")
    assert got["metrics"][0]["loss"] == pytest.approx(float(metrics["loss"]), rel=2e-4)
    want = load_jax_params(numpy_tree(state.params))
    for name, w in want.items():
        np.testing.assert_allclose(got["state"]["params"][name].numpy(), w.numpy(), atol=2e-4,
                                   err_msg=name)


@pytest.mark.parametrize("trap", ["trap_no_f", "trap_residual"])
def test_tp_done_wrong_is_caught(ranks, reference, trap):
    """The step's gradient without *f* in front of the heads (the norm's γ /
    β, the time MLP and all before it get one rank's share), or with the
    residual added on every rank, lies a hundredfold past the bound these
    tests hold tensor parallelism to."""
    held = reference["uncond"]
    rel = held.bound("grads")
    got = ranks.result(trap)["grads"][0]
    worst = max((got[n] - g).abs().max().item() / _scale(g)
                for n, g in held.ref["grads"][0].items() if _scale(g) > 0)
    assert worst > 100 * rel, (worst, rel)


@pytest.mark.parametrize("name", ["resume_tp_rep", "resume_rep_tp"])
def test_checkpoints_resume_across_layouts(ranks, reference, name):
    """A tensor-parallel checkpoint resumed replicated, and a replicated one
    resumed tensor-parallel, on the (1, 2) mesh: step 3 equals that of one
    process saving and resuming at the same step (the trainer's draws start
    again from its seed on a resume, in JAX too); the checkpoint holds the
    whole state."""
    reference["resume"].check(ranks.result(name), ("state",))
    ckpt = torch.load(ranks.out / name / "model-1.ckpt", weights_only=True)
    assert ckpt["params"]["model.transformer.attn.0.to_kv"].shape == (16, 32)
    heads = ranks.held(name, 1)["heads"]["model.transformer.attn.0"]
    assert heads == ((1, 1) if name.endswith("tp") else (2, 0))


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #


def test_tp_engine_equals_one_process(ranks):
    """`cli.build_engine(tp=2)` on two ranks, rank 0 leading: three batches
    (of two requests, of one, and one whose length the duration predictor
    chooses) equal the one-process engine's within 2e-4 in f32 and 1e-2 of
    the largest entry in bf16."""
    got = ranks.result("engine")
    want = worker.run_engine(None, ranks.out)
    for dtype, bound in (("float32", None), ("bfloat16", 1e-2)):
        assert len(got[dtype]) == len(want[dtype]) == 4
        for a, b in zip(got[dtype], want[dtype]):
            assert a.shape == b.shape and np.isfinite(a).all()
            tol = 2e-4 if bound is None else bound * np.abs(b).max()
            np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def test_serve_tp_over_http(ranks, tmp_path):
    """`serve --tp 2 --device cpu` starts two ranks: one POST /tts answers
    with a WAV, and an interrupt stops both ranks cleanly."""
    ranks.wait()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "naturalspeech2_tpu_torch", "serve", "--tp", "2", "--device", "cpu",
         "--config", str(ranks.out / "serve.json"), "--checkpoint", str(ranks.out / "serve.ckpt"),
         "--no-warmup", "--timesteps", "2", "--port", "0"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True)
    lines = []
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on"):
                break
        match = re.search(r"http://127\.0\.0\.1:(\d+)", lines[-1] if lines else "")
        assert match, "".join(lines)
        buf = io.BytesIO()
        write_wav(buf, np.zeros(640, np.float32), 24000)
        body = json.dumps({"text": "hello world", "seconds": 8 * 320 / 24000,
                           "prompt_wav_base64": base64.b64encode(buf.getvalue()).decode()})
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{match.group(1)}/tts", data=body.encode()), timeout=120) as r:
            assert r.read()[:4] == b"RIFF"
        os.killpg(proc.pid, signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
        assert proc.returncode == 0, "".join(lines)
        assert "Traceback" not in out, out
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


# --------------------------------------------------------------------- #
# the kernels' options, against their plain versions
# --------------------------------------------------------------------- #


def _block_inputs(seed, b=2, n=8, dm=16, heads=4, dh=8, m=None):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    x, gamma, beta = r(b, n, dm), 1 + 0.1 * r(b, dm), 0.1 * r(b, dm)
    dc = dm if m is None else 12
    ctx = None if m is None else r(b, m, dc)
    return x, ctx, gamma, beta, r(dm, heads * dh) / 4, r(dc, 2 * heads * dh) / 4, \
        r(heads * dh, dm) / 4


@pytest.mark.parametrize("block", ["K2", "K2b"])
def test_blocks_without_residual_sum_to_the_block(block):
    """K2 / K2b with the residual off give y − x of the plain version, and
    the partial sums of two halves of the heads (each half's columns of
    to_q, k and v columns of to_kv, rows of to_out) add up to it; the
    residual on is the default, bit for bit."""
    x, ctx, gamma, beta, wq, wkv, wo = _block_inputs(1, m=None if block == "K2" else 8)
    cfg = dict(dim_head=8, scale=8 ** -0.5)

    def run(wq, wkv, wo, heads, **kw):
        if block == "K2":
            return abk.attn_block(x, gamma, beta, wq, wkv, wo, heads=heads, **cfg, **kw)
        return abk.cross_attn_block(x, ctx, gamma, beta, wq, wkv, wo, heads=heads, **cfg, **kw)

    whole = run(wq, wkv, wo, 4)
    assert torch.equal(whole, run(wq, wkv, wo, 4, residual=True))
    part = run(wq, wkv, wo, 4, residual=False)
    torch.testing.assert_close(part + x, whole, rtol=0, atol=1e-6)
    halves = []
    for r in range(2):
        mesh = _mesh_of(1, 2, r)
        cut = lambda w, spec, blocks=1: tp.Sharding(mesh, spec, blocks).shard(w)  # noqa: E731
        halves.append(run(cut(wq, (None, "model")), cut(wkv, (None, "model"), 2),
                          cut(wo, ("model", None)), 2, residual=False))
    torch.testing.assert_close(halves[0] + halves[1], part, rtol=0, atol=1e-6)


def test_flash_dropout_offsets_give_the_slice_of_the_whole():
    """K4 / K5 with dropout keyed on global rows and heads: the forward and
    backward of batch rows 2-3 and heads 2-3, offsets (2, 2), equal those
    rows and heads of the whole array's, bit for bit; their masks are
    the whole mask's slice."""
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(4, 4, 20, 8, generator=gen) for _ in range(4))
    mask = torch.arange(20)[None, :] < torch.tensor([20, 13, 20, 7])[:, None]
    cfg = dict(causal=False, scale=0.35, dropout_rate=0.3)
    seed = (12345, 678)
    o, lse = fa.flash_forward(q, k, v, mask, seed, **cfg)
    grads = fa.flash_backward(q, k, v, mask, seed, lse, o, do, **cfg)
    rows, heads = slice(2, 4), slice(2, 4)
    part = lambda t: t[rows, heads].contiguous()  # noqa: E731
    o_p, lse_p = fa.flash_forward(part(q), part(k), part(v), mask[rows], seed, b_offset=2,
                                  h_offset=2, **cfg)
    grads_p = fa.flash_backward(part(q), part(k), part(v), mask[rows], seed, lse_p, o_p, part(do),
                                b_offset=2, h_offset=2, **cfg)
    assert torch.equal(o_p, o[rows, heads]) and torch.equal(lse_p, lse[rows, heads])
    for g_p, g in zip(grads_p, grads):
        assert torch.equal(g_p, g[rows, heads])
    keep = fa.dropout_keep_scaled(seed, 4, 4, 20, 20, 0.3)
    assert torch.equal(fa.dropout_keep_scaled(seed, 2, 2, 20, 20, 0.3, b_offset=2, h_offset=2),
                       keep[rows, heads])
    # the default offsets are the whole array's own masks
    assert torch.equal(fa.dropout_keep_scaled(seed, 4, 4, 20, 20, 0.3, b_offset=0, h_offset=0),
                       keep)


def test_dropout_draws_the_global_rows():
    """`ops.dropout`: with one row block the module is ``nn.Dropout`` bit
    for bit; a rank holding rows 2-3 of a batch of 4 draws those rows of
    the one-process mask, also where the input is laid out transposed in
    memory (a conv's output, whose mask ``F.dropout`` draws in that
    layout)."""
    for x in (torch.randn(4, 6, 5), torch.randn(4, 5, 6).transpose(1, 2)):
        torch.manual_seed(9)
        want = torch.nn.Dropout(0.2).train()(x)
        torch.manual_seed(9)
        assert torch.equal(Dropout(0.2).train()(x), want)
        torch.manual_seed(9)
        with batch_rows(1, 2):
            assert torch.equal(Dropout(0.2).train()(x[2:]), want[2:])
