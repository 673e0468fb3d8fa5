"""Data-parallel and FSDP training in the port (`naturalspeech2_tpu_torch/
parallel/`, `Trainer(mesh=, param_sharding=)`, `CodecTrainer(mesh=)`) on
two gloo ranks, held against the port's own one-process runs at the same
global batch (which tests/test_torch_trainer.py and
tests/test_torch_cond_train.py hold against the JAX trainer), and the
FSDP layout rule against JAX's `fsdp_spec`.

The two ranks are one group of worker processes
(tests/_torch_parallel_worker.py) started once for the module, with a
time limit, meeting through a file (tests/_rank_groups.py): past the
limit, or once a rank fails, both are killed and the tests fail. The one-process
references are computed here while the ranks run.

Tolerances: the ranks sum the same products in another order, which moves
the result within the reference's own noise. Each tensor (metric) is held
within FLOOR_FACTOR times the one-process run's own change when its audio
moves by one f32 ulp, relative to each tensor's largest entry (to each
metric), the largest over a part's tensors and FLOOR_DRAWS draws, or 1e-6
where that is larger; tests/test_torch_codec_trainer.py holds codec steps
to such a floor. The floor is real:
the conditional gradient moves by ~1e-5 of its largest entry under a
one-ulp move, so a fixed 1e-6 would fail on rounding alone; averaging
the halves' own masked means moves it a hundredfold past the bound
(checked here).
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from naturalspeech2_tpu_torch import load_jax_params
from naturalspeech2_tpu_torch.parallel import (
    MIN_WEIGHT_SIZE,
    Mesh,
    batch_sharding,
    fsdp_spec,
    is_main_process,
    make_mesh,
    replicated,
    shard_batch,
    state_shardings,
)

import _torch_parallel_worker as worker
from _rank_groups import RankGroups

WORKER = Path(__file__).with_name("_torch_parallel_worker.py")
WORLD = 2
GROUP_LIMIT_S = 300
RTOL = 1e-6
FLOOR_DRAWS, FLOOR_FACTOR = 3, 10.0


class Ranks(RankGroups):
    """The worker group (tests/_rank_groups.py), its results read once both
    ranks are done."""

    def __init__(self, out: Path):
        super().__init__(WORKER, out, None, world=WORLD, limit_s=GROUP_LIMIT_S)

    def result(self, name: str) -> dict:
        self.wait()
        return torch.load(self.out / f"{name}.pt", weights_only=False)

    def layout(self, name: str, rank: int) -> dict:
        self.wait()
        return torch.load(self.out / f"{name}-rank{rank}.pt", weights_only=False)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    group = Ranks(tmp_path_factory.mktemp("ranks"))
    yield group
    group.kill()


def _scale(t: torch.Tensor) -> float:
    return t.abs().max().item() if t.numel() else 0.0


def _floor(expected: dict, moved: list) -> float:
    """The reference's own change under a one-ulp move of its audio, relative
    to each tensor's largest entry: the largest over the tensors and draws."""
    return max([(m[name] - e).abs().max().item() / _scale(e)
                for name, e in expected.items() if _scale(e) > 0 for m in moved], default=0.0)


def _within(actual: dict, expected: dict, moved: list, what: str) -> None:
    assert actual.keys() == expected.keys(), what
    rel = max(FLOOR_FACTOR * _floor(expected, moved), RTOL)
    for name, e in expected.items():
        a = actual[name]
        assert a.shape == e.shape, f"{what} {name}: {tuple(a.shape)} vs {tuple(e.shape)}"
        err = (a - e).abs().max().item() if e.numel() else 0.0
        assert err <= rel * _scale(e), f"{what} {name}: {err:.3e} past {rel:.1e} of {_scale(e):.3e}"


class Held:
    """A one-process result and its noise floor: the same run with the
    audio moved by one ulp, FLOOR_DRAWS times."""

    def __init__(self, run):
        self.ref = run(None)
        self.moved = [run(1000 + s) for s in range(FLOOR_DRAWS)]

    def check(self, got: dict, parts=("state", "metrics", "grads")) -> None:
        ref, moved = self.ref, self.moved
        if "state" in parts:
            assert got["state"]["step"] == ref["state"]["step"]
            for part in ("params", "moments", "ema"):
                _within(got["state"][part], ref["state"][part],
                        [m["state"][part] for m in moved], part)
        if "grads" in parts:
            assert len(got["grads"]) == len(ref["grads"])
            for i, g in enumerate(ref["grads"]):
                _within(got["grads"][i], g, [m["grads"][i] for m in moved], f"step {i} gradient")
        if "metrics" in parts:
            assert len(got["metrics"]) == len(ref["metrics"])
            for i, e in enumerate(ref["metrics"]):
                a = got["metrics"][i]
                assert a.keys() == e.keys()
                rel = max(FLOOR_FACTOR * max(abs(m["metrics"][i][k] - e[k]) / abs(e[k])
                                             for m in moved for k in e if e[k]), RTOL)
                for k in e:
                    assert abs(a[k] - e[k]) <= rel * abs(e[k]), (i, k, a[k], e[k], rel)

    def bound(self, part: str, i: int = 0) -> float:
        """The bound, relative to each tensor's largest entry, of a part of
        the state (``grads``: of step i's gradient)."""
        pick = (lambda r: r["grads"][i]) if part == "grads" else (lambda r: r["state"][part])
        return max(FLOOR_FACTOR * _floor(pick(self.ref), [pick(m) for m in self.moved]), RTOL)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The one-process runs and their floors, computed once (while the ranks
    run), on two threads; the thread count is restored after the module, so
    that it does not leak into the files a worker runs next."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("one_process")

    def folder(name, move):
        return root / f"{name}-{move}"

    def resume_step2(move):
        first = worker.resume_trainer(None, folder("resume", move), 8, 2, 0, move)
        first.train(log_every=1)
        return {"state": worker.state_of(first)}

    yield {
        "root": root,
        "replicated": Held(lambda m: worker.run_replicated(None, folder("rep", m), m)[0]),
        "fsdp64": Held(lambda m: worker.run_fsdp(None, folder("fsdp", m), "replicated", m)[0]),
        "conditional": Held(lambda m: worker.run_conditional(None, folder("cond", m), m)[0]),
        "conditional_dropout": Held(lambda m: worker.run_conditional(
            None, folder("cond_dropout", m), m, ns2=worker.COND_NS2_DROPOUT)[0]),
        "accum_dispatch": Held(lambda m: worker.run_accum_dispatch(None, folder("acc", m), m)[0]),
        "codec": Held(lambda m: worker.run_codec(None, folder("codec", m), m)[0]),
        "losses": Held(lambda m: worker.run_losses(None, m)),
        "resume_step2": Held(resume_step2),
    }
    torch.set_num_threads(threads)


# --------------------------------------------------------------------- #
# the layout rule against JAX's
# --------------------------------------------------------------------- #

SPEC_CASES = {  # tests/test_fsdp.py:22-31
    "big": ((48, 1024), 8, 1024),
    "taller": ((2048, 96), 8, 1024),
    "small": ((16, 16), 8, MIN_WEIGHT_SIZE),
    "indivisible": ((33, 341 * 33), 8, 16),
    "scalar": ((), 8, MIN_WEIGHT_SIZE),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_fsdp_spec_equals_jax(case):
    shape, axis, min_size = SPEC_CASES[case]
    expected = jax_fsdp_spec(jnp.zeros(shape), axis, min_size=min_size)
    assert fsdp_spec(shape, axis, min_size) == tuple(expected)
    assert fsdp_spec(torch.zeros(shape), axis, min_size) == tuple(expected)


@pytest.fixture(scope="module")
def jax_fsdp_tree():
    """The JAX tree of the dim-64 model (tests/test_fsdp.py's widths)."""
    model = JModel(**worker.FSDP_MODEL).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 64)),
                                             jnp.zeros((1,)))["params"]
    codec = JSoundStream(**worker.FSDP_CODEC, use_pallas_rvq=False).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 640)))["params"]
    return {"model": model, "codec": codec}


def _jax_choice(tree, axis: int) -> dict:
    """Per port parameter name, the JAX leaf's (sharded extent or None,
    elements): each JAX leaf is filled with its index, carried through
    `load_jax_params` (the weight-carry name map) and read back."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    out = {}
    for name, t in load_jax_params(marked).items():
        ids = torch.unique(t)
        assert ids.numel() == 1, f"{name} carries several JAX leaves"
        leaf = leaves[int(ids.item())]
        spec = tuple(jax_fsdp_spec(leaf, axis))
        extent = leaf.shape[spec.index("data")] if "data" in spec else None
        out[name] = (extent, int(np.size(leaf)))
    return out


def _mesh_of(n_data: int, rank: int = 0) -> Mesh:
    """A mesh as rank ``rank`` of ``n_data`` sees it, without a group."""
    return Mesh(n_data=n_data, n_model=1, rank=rank, group=None, device=torch.device("cpu"))


@pytest.mark.parametrize("axis", [2, 8])
def test_state_shardings_choose_jax_leaves(jax_fsdp_tree, axis):
    """Every leaf of the dim-64 model: `fsdp_spec` on the JAX leaf's shape is
    JAX's, and `state_shardings` over the port's parameters shards exactly
    the leaves JAX shards, over a dimension of the same extent."""
    for leaf in jax.tree_util.tree_leaves(jax_fsdp_tree):
        assert fsdp_spec(leaf.shape, axis) == tuple(jax_fsdp_spec(leaf, axis))
    params = dict(worker.ns2_model(0, worker.FSDP_MODEL, worker.FSDP_CODEC).named_parameters())
    shardings = state_shardings(_mesh_of(axis), params)
    choice = _jax_choice(jax_fsdp_tree, axis)
    assert choice.keys() == params.keys()
    sharded = 0
    for name, (extent, size) in choice.items():
        dim = shardings[name].dim
        assert params[name].numel() == size, name
        assert (dim is None) == (extent is None), name
        if dim is not None:
            assert params[name].shape[dim] == extent, name
            sharded += 1
    assert sharded >= 3, sharded


# --------------------------------------------------------------------- #
# one process: the mesh of one rank
# --------------------------------------------------------------------- #


def test_one_rank_mesh_without_a_group():
    """No process group: a one-rank mesh, its rows the whole batch, and a
    wider data axis or a model axis refused by name (they need the ranks)."""
    mesh = make_mesh(device="cpu")
    assert (mesh.n_data, mesh.n_model, mesh.rank, mesh.group) == (1, 1, 0, None)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.backend is None and is_main_process()
    batch = {"audio": np.arange(12.0).reshape(4, 3), "text_lens": np.arange(4)}
    assert all(np.array_equal(shard_batch(mesh, batch)[k], v) for k, v in batch.items())
    assert batch_sharding(mesh).dim is None and replicated(mesh).dim is None
    with pytest.raises(ValueError, match="2×1 mesh does not cover 1 ranks"):
        make_mesh(n_data=2)
    with pytest.raises(ValueError, match="1×2 mesh does not cover 1 ranks"):
        make_mesh(n_model=2)


def test_rows_of_a_rank():
    """`shard_batch` keeps rank r's contiguous rows, as JAX lays P('data')."""
    x = np.arange(8).reshape(4, 2)
    for rank in range(2):
        two = _mesh_of(2, rank)
        assert np.array_equal(shard_batch(two, {"x": x})["x"], x[2 * rank:2 * rank + 2])
        with pytest.raises(ValueError, match="does not split over 2 ranks"):
            shard_batch(two, np.zeros((3, 1)))


# --------------------------------------------------------------------- #
# two ranks against one process
# --------------------------------------------------------------------- #


def test_two_ranks_replicated_equal_one_process(ranks, reference):
    """Two clipped steps: each step's reduced gradient, parameters, Adam's
    moments, the EMA, every metric and the held-out loss after them equal
    the one-process run's at the same global batch, and each rank holds
    every leaf whole."""
    reference["replicated"].check(ranks.result("replicated"))
    for rank in range(WORLD):
        layout = ranks.layout("replicated", rank)
        assert all(len(set(v.values())) == 1 for v in layout.values())


def test_fsdp_equals_replicated(ranks, reference):
    """FSDP on two ranks: the gradients and the state after two clipped
    steps equal the replicated two-rank run's and the one-process run's."""
    held = reference["fsdp64"]
    fsdp, rep = ranks.result("fsdp64_fsdp"), ranks.result("fsdp64_replicated")
    held.check(fsdp)
    held.check(rep)
    for part in ("params", "moments", "ema"):
        rel = held.bound(part)
        for name, e in rep["state"][part].items():
            err = (fsdp["state"][part][name] - e).abs().max().item() if e.numel() else 0.0
            assert err <= rel * _scale(e), (part, name, err, rel)


def test_fsdp_holds_half_of_every_leaf_jax_shards(ranks, jax_fsdp_tree):
    """At rest each rank holds half of every leaf JAX's rule shards (its
    parameters, Adam's moments, the EMA) and the module none of it; the
    other leaves whole."""
    choice = _jax_choice(jax_fsdp_tree, WORLD)
    sharded = [n for n, (extent, _) in choice.items() if extent is not None]
    assert len(sharded) >= 3, sharded
    for rank in range(WORLD):
        layout = ranks.layout("fsdp64_fsdp", rank)
        assert layout.keys() == choice.keys()
        for name, (extent, size) in choice.items():
            held = layout[name]
            if extent is None:
                assert set(held.values()) == {size}, (name, held)
            else:
                assert held["module"] == 0, name
                assert {held[k] for k in ("master", "ema", "exp_avg", "exp_avg_sq")} == \
                    {size // WORLD}, (name, held)


def _naive_gradient(folder: Path) -> dict:
    """What averaging the two halves' own masked means would give: each
    half's loss on its rows, with the global draws sliced, averaged."""
    trainer = worker.Trainer(worker.cond_model(4), batches=iter(()),
                             train_batch_size=worker.BATCH, results_folder=str(folder))
    batch = trainer._tensors(worker.cond_batch(5))
    audio = batch.pop("audio")
    draws = trainer._draws(audio)
    for half in (slice(0, 2), slice(2, 4)):
        part = {k: tuple(m[half] for m in v) if isinstance(v, tuple) else v[half]
                for k, v in draws.items()}
        trainer.losses(audio[half], {k: v[half] for k, v in batch.items()}, part)["loss"] \
            .backward()
    return {name: (p.grad if p.grad is not None else torch.zeros_like(p)) / 2
            for name, p in trainer.params.items()}


def test_masked_means_use_the_global_phoneme_count(ranks, reference):
    """A conditional step whose halves hold 10 and 3 phonemes: the reduced
    gradient, the metrics and the state equal the one-process step; the
    average of the halves' own masked means is another gradient, a
    hundredfold past the bound, so this test sees that fault."""
    held = reference["conditional"]
    held.check(ranks.result("conditional"))
    naive = _naive_gradient(reference["root"] / "naive")
    rel = held.bound("grads")
    worst = max((naive[n] - g).abs().max().item() / _scale(g)
                for n, g in held.ref["grads"][0].items() if n.startswith("duration_pitch."))
    assert worst > 100 * rel, (worst, rel)


def test_grad_accum_and_steps_per_dispatch(ranks, reference):
    """`train()` at grad_accum_every=2 and steps_per_dispatch=2 on the mesh:
    each micro-batch split over the ranks, the gradients and the state
    equal the one-process run's."""
    reference["accum_dispatch"].check(ranks.result("accum_dispatch"), ("state", "grads"))


def test_resume_resharded_equals_unbroken(ranks, reference):
    """FSDP: rank 0's checkpoint at step 2 holds the whole state, equal to the
    one-process run's at step 2; a fresh pair of ranks resumes from it
    re-sharded and takes step 3 as one process resuming from it does."""
    ckpt = ranks.out / "resume" / "model-1.ckpt"
    assert (ranks.out / "resume" / "sample-1.wav").exists()
    payload = torch.load(ckpt, weights_only=True)
    names = list(payload["ema_params"])
    step2 = {"step": payload["step"], "params": payload["params"],
             "moments": {f"{names[i]}.{k}": v for i, s in payload["opt_state"]["state"].items()
                         for k, v in s.items() if k != "step"},
             "ema": payload["ema_params"]}
    reference["resume_step2"].check({"state": step2}, ("state",))

    def resumed(move):
        folder = reference["root"] / f"resume_from_ranks-{move}"
        folder.mkdir()
        shutil.copy(ckpt, folder / "model-1.ckpt")
        one = worker.resume_trainer(None, folder, 99, 3, 2, move)
        one.train(log_every=1)
        return {"state": worker.state_of(one)}

    Held(resumed).check(ranks.result("resume"), ("state",))
    layout = ranks.layout("resume", 1)
    assert any(v["module"] == 0 for v in layout.values())  # re-sharded


def test_rank_without_the_checkpoint_raises(ranks):
    """Rank 0 resumes from its checkpoint; rank 1, whose results_folder lacks
    it, raises, as the JAX trainer's non-main hosts do."""
    ranks.wait()
    assert torch.load(ranks.out / "unshared-rank0.pt") == "resumed"
    outcome = torch.load(ranks.out / "unshared-rank1.pt")
    assert outcome.startswith("FileNotFoundError: the main process has a checkpoint"), outcome


def test_codec_trainer_two_ranks_equal_one_process(ranks, reference):
    """Three adversarial `CodecTrainer` steps re-seeding unused codes from
    the batch: codec, codebooks, discriminator, codebook statistics and
    the last step's metrics equal the one-process run's."""
    got, held = ranks.result("codec"), reference["codec"]
    ref = held.ref
    assert got["state"]["step"] == ref["state"]["step"] == 3
    assert ref["metrics"][0]["restarts"] > 0
    for part in ("codec", "disc"):
        _within(got["state"][part], ref["state"][part], [m["state"][part] for m in held.moved],
                part)
    stats = ("codebook_ema", "codebook_count")
    _within({k: got["state"][k] for k in stats}, {k: ref["state"][k] for k in stats},
            [{k: m["state"][k] for k in stats} for m in held.moved], "codebook statistics")
    held.check(got, ("metrics",))


def test_global_stft_and_feature_matching_losses(ranks, reference):
    """The multi-resolution STFT loss and the feature-matching loss summed
    over the ranks: their values and their gradients towards every row
    equal the one-process losses on the whole batch."""
    reference["losses"].check(ranks.result("losses"), ("metrics", "grads"))


def test_ranks_draw_their_own_dropout_masks(ranks, tmp_path):
    """Ranks seeded alike draw different dropout masks for their rows once
    their `Trainer` is made: each its rows of one global mask, which is the
    one-process mask of the global batch."""
    masks = ranks.result("dropout")["masks"]
    assert len(masks) == WORLD and not torch.equal(masks[0], masks[1])
    want = worker.run_dropout(None, tmp_path)["masks"]
    assert all(torch.equal(m, w) for m, w in zip(masks, want))


def test_data_parallel_step_with_dropout_equals_one_process(ranks, reference):
    """A conditional step with every dropout on (the phoneme encoder's conv,
    the prompt encoder's flash attention, the duration / pitch trunks'
    plain attention): each rank draws its rows of the global batch's masks,
    so the reduced gradient, the metrics and the state equal the
    one-process step at the same global batch."""
    reference["conditional_dropout"].check(ranks.result("conditional_dropout"))
