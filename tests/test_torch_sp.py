"""Sequence-parallel attention in the port (`naturalspeech2_tpu_torch/parallel/
sp.py`: `sp_attend`, `ulysses_attend`, `ring_attend`) on four gloo ranks,
at P = 2 and 4, against the JAX functions (`naturalspeech2_tpu/parallel/
sp.py`) on the 8-device CPU mesh for the same global inputs: plain,
masked (one shard of a row fully masked at P = 4), causal, and a fully
masked batch row; the flash backends (K4's plain version on the CPU)
against the plain ones; `sp_attend`'s and the ring's gradients against
full attention's.

The ranks are one group of worker processes (tests/_torch_sp_worker.py),
started once for the module with a time limit, one torch thread each,
meeting through a file (tests/_rank_groups.py);
the JAX results are computed here meanwhile. ATOL is
tests/test_sequence_parallel.py's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.parallel.mesh import make_mesh
from naturalspeech2_tpu.parallel.sp import ring_attend, sp_attend, ulysses_attend
from naturalspeech2_tpu_torch.ops.attention import attend_plain
from naturalspeech2_tpu_torch.parallel import Mesh
from naturalspeech2_tpu_torch.parallel.sp import _use_flash

import _torch_sp_worker as worker
from _rank_groups import RankGroups

WORKER = Path(__file__).with_name("_torch_sp_worker.py")
WORLD, GROUP_LIMIT_S = 4, 200
ATOL = 2e-5
JAX_FUNCTIONS = {"sp_xla": sp_attend, "sp_flash": sp_attend, "ulysses": ulysses_attend,
                 "ring_xla": ring_attend, "ring_flash": ring_attend}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = RankGroups(WORKER, tmp_path_factory.mktemp("sp_ranks"), None, world=WORLD,
                       limit_s=GROUP_LIMIT_S)
    state = {}

    def results():
        if "out" not in state:
            group.wait()
            state["out"] = torch.load(group.out / "sp.pt", weights_only=False)
        return state["out"]

    yield results
    group.kill()


@pytest.fixture(scope="module")
def jax_results():
    """The JAX functions (their plain backend) on each case at P = 2 and 4."""
    out = {}
    for p in (2, 4):
        mesh = make_mesh(n_data=p, devices=jax.devices()[:p])
        for case, (_, causal) in worker.CASES.items():
            q, k, v, _, mask = (None if t is None else jnp.asarray(t.numpy())
                                for t in worker.inputs(case))
            out[("sp", case, p)] = sp_attend(q, k, v, mesh=mesh, mask=mask, causal=causal,
                                             backend="xla")
            out[("ulysses", case, p)] = ulysses_attend(q, k, v, mesh=mesh, mask=mask,
                                                       causal=causal)
            out[("ring", case, p)] = ring_attend(q, k, v, mesh=mesh, mask=mask, causal=causal,
                                                 backend="xla")
    return {key: np.asarray(v) for key, v in out.items()}


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", list(worker.CASES))
@pytest.mark.parametrize("name", [f[0] for f in worker.FUNCTIONS])
def test_equals_the_jax_function(ranks, jax_results, name, case, p):
    """Each function and backend, gathered from the ranks, against JAX's
    function on the same global inputs. A fully masked row is zero on the
    flash routes (K4 gives o = 0, as JAX's flash kernel does) where JAX's
    plain `sp_attend` averages v; there the other row is compared."""
    got = ranks()[(name, case, p)].numpy()
    want = jax_results[(name.split("_")[0], case, p)]
    causal = worker.CASES[case][1]
    if case == "dead_row" and name == "sp_flash" and not causal:
        assert np.array_equal(got[1], np.zeros_like(got[1]))
        got, want = got[:1], want[:1]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", ["plain", "masked"])
@pytest.mark.parametrize("name", ["sp", "ring"])
def test_flash_equals_plain(ranks, name, case, p):
    """The flash backend (K4's plain version on the CPU, K4 itself on a
    card) against the plain one, a fully masked shard of a row included
    (it arrives in the ring as lse = NEG_INF, o = 0 and drops out)."""
    out = ranks()
    np.testing.assert_allclose(out[(f"{name}_flash", case, p)].numpy(),
                               out[(f"{name}_xla", case, p)].numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", ["plain", "masked", "causal"])
@pytest.mark.parametrize("name", ["sp_xla", "sp_flash", "ring_xla"])
def test_gradients_equal_full_attention(ranks, name, case, p):
    """dq, dk and dv of sum(o · dO), gathered from the ranks (the gather's
    backward a reduce-scatter, the ring's shift sending gradients back),
    against full attention's, autograd through the plain version."""
    q, k, v, do, mask = worker.inputs(case)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = attend_plain(*leaves, mask=mask, causal=worker.CASES[case][1])
    (o * do).sum().backward()
    for got, want in zip(ranks()[(name, case, p, "grads")], leaves):
        torch.testing.assert_close(got, want.grad, atol=ATOL, rtol=0)


def test_backend_choice():
    """``"auto"``: K4 on a card and plain elsewhere; causal stays plain (K4's
    causal mask has no global row offset); anything else is refused."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not _use_flash("auto", False, cpu) and _use_flash("auto", False, cuda)
    assert _use_flash("flash", False, cpu) and not _use_flash("flash", True, cuda)
    with pytest.raises(ValueError, match="backend"):
        _use_flash("pallas", False, cpu)
    with pytest.raises(ValueError, match="heads 4 must divide over data=3"):
        from naturalspeech2_tpu_torch.parallel.sp import ulysses_attend as port_ulysses

        mesh = Mesh(n_data=3, n_model=1, rank=0, group=None, device=cpu)
        port_ulysses(*(torch.zeros(1, 4, 2, 8) for _ in range(3)), mesh=mesh)
