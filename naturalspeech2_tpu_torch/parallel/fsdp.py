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
from naturalspeech2_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, Sharding

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


def _split_groups(names: list, tensors: Dict[str, torch.Tensor], key=lambda n: None) -> list:
    """``names`` grouped by dtype (and ``key``), in order."""
    groups: dict = {}
    for name in names:
        groups.setdefault((tensors[name].dtype, key(name)), []).append(name)
    return list(groups.values())


def gather_params(mesh: Mesh, shards: Dict[str, torch.Tensor],
                  shardings: Dict[str, Sharding]) -> Dict[str, torch.Tensor]:
    """The whole leaves from every rank's parts: split leaves as new
    tensors (one all-gather a dtype and axis), replicated ones as they
    are."""
    out = dict(shards)
    split = [n for n in shards if shardings[n].dim is not None]
    for names in _split_groups(split, shards, lambda n: shardings[n].axis):
        axis = shardings[names[0]].axis
        parts = comm.all_gather(mesh, torch.cat([shards[n].reshape(-1) for n in names]), axis)
        pieces = [p.split([shards[n].numel() for n in names]) for p in parts]
        for j, name in enumerate(names):
            held = [piece[j].view(shards[name].shape) for piece in pieces]
            out[name] = shardings[name].unshard(held).contiguous()
    return out


def reduce_scatter_grads(mesh: Mesh, grads: Dict[str, torch.Tensor],
                         shardings: Dict[str, Sharding]) -> Dict[str, torch.Tensor]:
    """Each rank's part of the sum over the data axis of every whole
    gradient: one reduce-scatter a dtype for the leaves split over ``data``,
    one all-reduce (in place) for the others. A leaf split over ``model``
    is used whole on every rank of a model group, on the same inputs, so
    each of them holds its whole gradient: a rank keeps its part of it,
    which is then summed over ``data``."""
    out = dict(grads)
    split = [n for n in grads if shardings[n].axis == DATA_AXIS]
    for names in _split_groups(split, grads):
        moved = [grads[n].movedim(shardings[n].dim, 0) for n in names]
        rows = torch.cat([m.reshape(mesh.n_data, -1) for m in moved], dim=1)
        mine = comm.reduce_scatter(mesh, rows, DATA_AXIS)
        for name, m, part in zip(names, moved, mine.split([m.numel() // mesh.n_data
                                                            for m in moved])):
            local = part.view(m.shape[0] // mesh.n_data, *m.shape[1:])
            out[name] = local.movedim(0, shardings[name].dim).contiguous()
    for n in grads:
        if shardings[n].axis == MODEL_AXIS:
            out[n] = shardings[n].shard(grads[n]).contiguous()
    rest = [n for n in grads if shardings[n].axis != DATA_AXIS]
    for names in _split_groups(rest, out):
        comm.all_reduce_many_(mesh, [out[n] for n in names], DATA_AXIS)
    return out


def global_norm(mesh: Mesh, grads: Dict[str, torch.Tensor],
                shardings: Dict[str, Sharding]) -> torch.Tensor:
    """The global L2 norm of a tree of which each rank holds its parts (as
    `reduce_scatter_grads` leaves it, or tensor parallelism): each split
    leaf's squares summed over the ranks of its axis, each replicated leaf
    counted once."""
    device = next(iter(grads.values())).device

    def squares(names):
        if not names:
            return torch.zeros((), device=device)
        return torch.stack(torch._foreach_norm([grads[n] for n in names])).square().sum().float()

    total = squares([n for n in grads if shardings[n].axis is None])
    for axis in (DATA_AXIS, MODEL_AXIS):
        split = squares([n for n in grads if shardings[n].axis == axis])
        total = total + comm.all_reduce_(mesh, split, axis)
    return torch.sqrt(total)
