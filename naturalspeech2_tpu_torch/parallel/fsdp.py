"""FSDP / ZeRO-3 sharding of the training state (twin of
`naturalspeech2_tpu/parallel/fsdp.py`).

Every large parameter is split over the data axis along its largest
dimension that the axis divides; Adam's moments and the EMA follow it, the
rule being a function of the shape alone. Each rank keeps its part at
rest; `gather_params` assembles the whole weights (fresh tensors) for a
forward and backward, and `reduce_scatter_grads` leaves each rank the sum
over ranks of its part of every gradient. XLA inserts these collectives
for JAX's sharding annotations; here the trainer calls them. Each is one
collective for the whole tree: the parts are concatenated, exchanged and
split again.
"""

from __future__ import annotations

from typing import Dict

import torch

from naturalspeech2_tpu_torch.parallel import comm
from naturalspeech2_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, Sharding

# leaves smaller than this stay replicated: sharding tiny vectors buys
# nothing and costs a collective per use
MIN_WEIGHT_SIZE = 16_384


def fsdp_spec(leaf, axis_size: int, min_size: int = MIN_WEIGHT_SIZE) -> tuple:
    """The ``PartitionSpec`` JAX's rule gives a leaf (a tensor, an array or
    a shape), as a tuple: the largest dimension the axis divides split
    over ``data``; scalars, leaves under ``min_size`` elements and leaves
    with no divisible dimension replicated (``()``)."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
    size = 1
    for s in shape:
        size *= s
    if not shape or size < min_size:
        return ()
    best, best_extent = -1, 0
    for i, s in enumerate(shape):
        if s % axis_size == 0 and s > best_extent:
            best, best_extent = i, s
    if best < 0:
        return ()
    return tuple(DATA_AXIS if i == best else None for i in range(len(shape)))


def state_shardings(mesh: Mesh, tree: Dict[str, torch.Tensor],
                    min_size: int = MIN_WEIGHT_SIZE) -> Dict[str, Sharding]:
    """The `Sharding` of each leaf of a flat state tree (parameters, EMA or
    Adam moments by name); all replicated on a data axis of 1."""
    if mesh.n_data == 1:
        return {name: Sharding(mesh, ()) for name in tree}
    return {name: Sharding(mesh, fsdp_spec(leaf, mesh.n_data, min_size))
            for name, leaf in tree.items()}


def shard_state(mesh: Mesh, tree: Dict[str, torch.Tensor],
                min_size: int = MIN_WEIGHT_SIZE) -> Dict[str, torch.Tensor]:
    """This rank's part of each whole leaf, as its own tensor (so the whole
    can be freed); replicated leaves as they are."""
    out = {}
    for name, sharding in state_shardings(mesh, tree, min_size).items():
        x = tree[name]
        out[name] = x if sharding.dim is None else sharding.shard(x).detach().clone()
    return out


def _split_groups(names: list, tensors: Dict[str, torch.Tensor]) -> list:
    """``names`` grouped by dtype, in order."""
    groups: dict = {}
    for name in names:
        groups.setdefault(tensors[name].dtype, []).append(name)
    return list(groups.values())


def gather_params(mesh: Mesh, shards: Dict[str, torch.Tensor],
                  shardings: Dict[str, Sharding]) -> Dict[str, torch.Tensor]:
    """The whole leaves from every rank's parts: split leaves as new
    tensors (one all-gather a dtype), replicated ones as they are."""
    out = dict(shards)
    split = [n for n in shards if shardings[n].dim is not None]
    for names in _split_groups(split, shards):
        moved = [shards[n].movedim(shardings[n].dim, 0) for n in names]
        parts = comm.all_gather(mesh, torch.cat([m.reshape(-1) for m in moved]))
        pieces = [p.split([m.numel() for m in moved]) for p in parts]
        for j, (name, m) in enumerate(zip(names, moved)):
            whole = torch.cat([pieces[r][j].view(m.shape) for r in range(mesh.n_data)])
            out[name] = whole.movedim(0, shardings[name].dim).contiguous()
    return out


def reduce_scatter_grads(mesh: Mesh, grads: Dict[str, torch.Tensor],
                         shardings: Dict[str, Sharding]) -> Dict[str, torch.Tensor]:
    """Each rank's part of the sum over ranks of every whole gradient: one
    reduce-scatter a dtype for the split leaves, one all-reduce (in place)
    for the replicated ones."""
    out = dict(grads)
    split = [n for n in grads if shardings[n].dim is not None]
    for names in _split_groups(split, grads):
        moved = [grads[n].movedim(shardings[n].dim, 0) for n in names]
        rows = torch.cat([m.reshape(mesh.n_data, -1) for m in moved], dim=1)
        mine = comm.reduce_scatter(mesh, rows)
        for name, m, part in zip(names, moved, mine.split([m.numel() // mesh.n_data
                                                            for m in moved])):
            local = part.view(m.shape[0] // mesh.n_data, *m.shape[1:])
            out[name] = local.movedim(0, shardings[name].dim).contiguous()
    whole = [n for n in grads if shardings[n].dim is None]
    for names in _split_groups(whole, grads):
        comm.all_reduce_many_(mesh, [grads[n] for n in names])
    return out


def global_norm(mesh: Mesh, grads: Dict[str, torch.Tensor],
                shardings: Dict[str, Sharding]) -> torch.Tensor:
    """The global L2 norm of a tree held as `reduce_scatter_grads` leaves
    it: the split leaves' squares summed over the ranks, each replicated
    leaf counted once."""
    device = next(iter(grads.values())).device

    def squares(names):
        if not names:
            return torch.zeros((), device=device)
        return torch.stack(torch._foreach_norm([grads[n] for n in names])).square().sum()

    split = squares([n for n in grads if shardings[n].dim is not None])
    whole = squares([n for n in grads if shardings[n].dim is None])
    return torch.sqrt(comm.all_reduce_(mesh, split.float()) + whole.float())
