"""The port's sequence-parallel attention on gloo ranks, for
tests/test_torch_sp.py:

    python _torch_sp_worker.py <rank> <world=4> <init method> <out_dir>

Four ranks make two meshes: (4, 1), whose data axis shards a sequence
over four ranks, and (2, 2), whose model axis shards it over two (each
model group of two computing the same). Every rank runs every case of
`CASES` through `sp_attend`, `ulysses_attend` and `ring_attend` on its
shard of the same global inputs; rank 0 writes each output (and the
gradients where they are taken) gathered whole to ``<out_dir>/sp.pt``.
Imports torch, numpy and the port only.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from naturalspeech2_tpu_torch.parallel import (  # noqa: E402
    comm,
    ring_attend,
    sp_attend,
    ulysses_attend,
)

SHAPE = (2, 4, 32, 8)  # [b, h, n, d]
# (mask lengths per row or None, causal); at P = 4 row 0 of "masked" has
# its last shard (keys 24-31) fully masked, and "dead_row" masks all of
# row 1
CASES = {"plain": (None, False), "masked": ((20, 32), False), "causal": (None, True),
         "dead_row": ((32, 0), False)}
# (name, function, backend, differentiable)
FUNCTIONS = [("sp_xla", sp_attend, "xla", True), ("sp_flash", sp_attend, "flash", True),
             ("ulysses", ulysses_attend, None, False), ("ring_xla", ring_attend, "xla", True),
             ("ring_flash", ring_attend, "flash", False)]


def inputs(case: str):
    """The global (q, k, v, d_out, mask) of a case, from a seed."""
    rng = np.random.default_rng(list(CASES).index(case))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
                   for _ in range(4))
    lens, _ = CASES[case]
    mask = None if lens is None else torch.arange(SHAPE[2])[None, :] < torch.tensor(lens)[:, None]
    return q, k, v, do, mask


def run(mesh, axis: str) -> dict:
    """Every case and function on this rank's shard; the outputs (and dq,
    dk, dv) gathered whole along the sequence."""
    p, index = mesh.size(axis), mesh.index(axis)
    n_local = SHAPE[2] // p
    rows = slice(index * n_local, (index + 1) * n_local)

    def whole(t):
        return torch.cat(comm.all_gather(mesh, t.detach().contiguous(), axis), dim=2)

    out = {}
    for case, (_, causal) in CASES.items():
        q, k, v, do, mask = inputs(case)
        for name, fn, backend, grad in FUNCTIONS:
            local = [t[:, :, rows].clone().requires_grad_(grad) for t in (q, k, v)]
            kwargs = dict(mesh=mesh, axis=axis, causal=causal,
                          mask=None if mask is None else mask[:, rows])
            if backend is not None:
                kwargs["backend"] = backend
            o = fn(*local, **kwargs)
            out[(name, case, p)] = whole(o)
            if grad:
                (o * do[:, :, rows]).sum().backward()
                out[(name, case, p, "grads")] = tuple(whole(t.grad) for t in local)
    return out


def main() -> None:
    import torch.distributed as dist

    from naturalspeech2_tpu_torch.parallel import make_mesh

    rank, world, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    results = run(make_mesh(n_data=4, device="cpu"), "data")
    results.update(run(make_mesh(n_data=2, n_model=2, device="cpu"), "model"))
    if rank == 0:
        torch.save(results, out / "sp.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
