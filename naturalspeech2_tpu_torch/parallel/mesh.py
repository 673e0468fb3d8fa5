"""The data mesh (twin of `naturalspeech2_tpu/parallel/mesh.py`).

A `Mesh` is this process's place in a ``(data, model)`` grid of ranks:
its rank, the axis sizes, the process group and the rank's device. JAX
lays a global array over its devices; here each rank holds its own rows
of every global batch (`shard_batch`) and the trainers reduce what the
rows give (`comm`). The main process (rank 0) alone writes logs,
samples and checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _second_half(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item 21's second half: tensor and "
        "sequence parallelism over the model axis)")


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. ``group`` is None for a one-rank mesh
    made without ``torch.distributed``."""

    n_data: int
    n_model: int
    rank: int
    group: Optional[Any]
    device: torch.device

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as `jax.sharding.Mesh.shape`."""
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def backend(self) -> Optional[str]:
        """"nccl", "gloo" or None (one rank, no group)."""
        return None if self.group is None else str(dist.get_backend(self.group))

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _default_device(backend: Optional[str]) -> torch.device:
    if backend == "nccl" or (backend is None and torch.cuda.is_available()):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh over the ranks of the default process
    group when one is initialised, else this one process; ``n_data``
    defaults to the world size over ``n_model``. ``device`` is the rank's
    device (default: the current CUDA device under NCCL, the CPU under
    gloo)."""
    if n_model != 1:
        raise _second_half(f"a model axis of {n_model}")
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"{n_data}×{n_model} mesh does not cover {world} ranks "
                         f"({'the process group' if group is not None else 'no process group'})")
    backend = None if group is None else str(dist.get_backend(group))
    device = torch.device(device) if device is not None else _default_device(backend)
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, group=group, device=device)


@dataclass(frozen=True)
class Sharding:
    """A tensor's layout over the mesh: ``spec`` names, per dimension, the
    mesh axis it is split over or None, as a JAX ``PartitionSpec`` (``()``
    replicated). A split dimension is cut into ``n_data`` equal, contiguous
    parts, rank r holding part r."""

    mesh: Mesh
    spec: tuple = ()

    @property
    def dim(self) -> Optional[int]:
        """The split dimension, or None when every rank holds the whole."""
        if DATA_AXIS not in self.spec or self.mesh.n_data == 1:
            return None
        return self.spec.index(DATA_AXIS)

    def shard(self, x):
        """This rank's part of the whole ``x`` (a tensor or an array)."""
        dim = self.dim
        if dim is None:
            return x
        n = x.shape[dim]
        if n % self.mesh.n_data:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{self.mesh.n_data} ranks")
        size = n // self.mesh.n_data
        index = [slice(None)] * x.ndim
        index[dim] = slice(self.mesh.rank * size, (self.mesh.rank + 1) * size)
        return x[tuple(index)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) dimension split over the data axis."""
    return Sharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch: an array or tensor, or a dict of
    them, each split along its leading dimension."""
    sharding = batch_sharding(mesh)
    if isinstance(batch, dict):
        return {k: sharding.shard(v if hasattr(v, "shape") else np.asarray(v))
                for k, v in batch.items()}
    return sharding.shard(batch if hasattr(batch, "shape") else np.asarray(batch))


def check_batch_split(train_batch_size: int, n_data: int) -> None:
    """Raise unless a batch of ``train_batch_size`` rows splits evenly over
    a data axis of ``n_data`` ranks (JAX's assertion and message)."""
    if train_batch_size % n_data:
        raise ValueError(
            f"train_batch_size ({train_batch_size}) must be divisible by the mesh's data axis "
            f"({n_data} devices) — pass a smaller mesh (make_mesh(n_data=...)) or a larger "
            "batch")


def seed_ranks_apart(mesh: Mesh) -> None:
    """Offset torch's default generators (CPU and CUDA) by the rank, rank 0
    keeping its own: ranks seeded alike then draw different dropout masks
    for their rows, as JAX draws them over the global array."""
    if mesh.rank:
        torch.manual_seed((torch.initial_seed() + mesh.rank) % 2**63)


def is_main_process() -> bool:
    """Rank 0 of the default group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
