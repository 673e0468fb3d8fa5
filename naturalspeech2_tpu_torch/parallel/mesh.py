"""The ``(data, model)`` mesh (twin of `naturalspeech2_tpu/parallel/mesh.py`).

A `Mesh` is this process's place in a ``(data, model)`` grid of ranks:
its rank, the axis sizes, the process groups and the rank's device. Ranks
are laid out as JAX lays out its devices (``np.array(devices).reshape(
n_data, n_model)``): rank = data_index · n_model + model_index. JAX lays a
global array over its devices; here each rank holds its own rows of every
global batch (`shard_batch`), the ranks of one model group holding the
same rows, and the trainers reduce what the rows give over the ``data``
axis (`comm`); tensor parallelism (`tp`) sums each attention's heads over
the ``model`` axis. The main process (rank 0) alone writes logs, samples
and checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. ``group`` is every rank's (None for a
    one-rank mesh made without ``torch.distributed``); ``data_group`` and
    ``model_group`` are this rank's groups along each axis where both axes
    exceed 1 (otherwise an axis of one rank has no group and the other is
    ``group``). A deep copy of a module that holds a mesh shares it."""

    n_data: int
    n_model: int
    rank: int
    group: Optional[Any]
    device: torch.device
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    def __deepcopy__(self, memo):
        return self

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as `jax.sharding.Mesh.shape`."""
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def size(self, axis: Optional[str]) -> int:
        """The ranks along ``axis`` (None: every rank)."""
        return self.world_size if axis is None else self.shape[axis]

    def index(self, axis: Optional[str]) -> int:
        """This rank's place along ``axis`` (None: its rank)."""
        if axis is None:
            return self.rank
        return self.data_index if axis == DATA_AXIS else self.model_index

    def group_of(self, axis: Optional[str]):
        """The process group along ``axis`` (None: every rank's), or None
        when the axis has one rank."""
        if self.group is None or self.size(axis) == 1:
            return None
        if axis is None or self.size(axis) == self.world_size:
            return self.group
        return self.data_group if axis == DATA_AXIS else self.model_group

    @property
    def backend(self) -> Optional[str]:
        """"nccl", "gloo" or None (one rank, no group)."""
        return None if self.group is None else str(dist.get_backend(self.group))

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _default_device() -> torch.device:
    """The current CUDA device, whatever the backend; raises where there is
    none, as `serve.resolve_device` does: the CPU is only ever asked for."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device: the port's ranks run on the card (pass "
                           "device='cpu' to run the plain PyTorch versions on the CPU)")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh over the ranks of the default process
    group when one is initialised, else this one process; ``n_data``
    defaults to the world size over ``n_model``. ``device`` is the rank's
    device (default: the current CUDA device under either backend; without
    a card that raises, and the CPU needs ``device="cpu"``). Where both axes exceed one rank, every rank makes every group
    of each axis, in the same order (``dist.new_group`` asks for it): the
    data groups (one per model index), then the model groups."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if n_model < 1:
        raise ValueError(f"the model axis needs at least one rank, got {n_model}")
    if n_data is None:
        n_data = max(world // n_model, 1)
    if n_data * n_model != world:
        raise ValueError(f"{n_data}×{n_model} mesh does not cover {world} ranks "
                         f"({'the process group' if group is not None else 'no process group'})")
    device = torch.device(device) if device is not None else _default_device()
    data_group = model_group = None
    if n_data > 1 and n_model > 1:
        grid = np.arange(world).reshape(n_data, n_model)
        for m in range(n_model):
            g = dist.new_group(grid[:, m].tolist())
            if rank % n_model == m:
                data_group = g
        for d in range(n_data):
            g = dist.new_group(grid[d].tolist())
            if rank // n_model == d:
                model_group = g
    return Mesh(n_data=n_data, n_model=n_model, rank=rank, group=group, device=device,
                data_group=data_group, model_group=model_group)


@dataclass(frozen=True)
class Sharding:
    """A tensor's layout over the mesh: ``spec`` names, per dimension, the
    mesh axis it is split over or None, as a JAX ``PartitionSpec`` (``()``
    replicated). A split dimension is cut into as many equal, contiguous
    parts as its axis has ranks, the rank at index r along the axis holding
    part r; with ``blocks`` > 1 the dimension is that many equal blocks,
    each cut so, and a rank holds its part of every block (a ``to_kv``
    projection split by heads: its heads' k columns and their v columns)."""

    mesh: Mesh
    spec: tuple = ()
    blocks: int = 1

    @property
    def axis(self) -> Optional[str]:
        """The mesh axis the tensor is split over, or None when every rank
        holds the whole."""
        for ax in self.spec:
            if ax is not None and self.mesh.size(ax) > 1:
                return ax
        return None

    @property
    def dim(self) -> Optional[int]:
        """The split dimension, or None when every rank holds the whole."""
        axis = self.axis
        return None if axis is None else self.spec.index(axis)

    def _blocked(self, x, parts: int):
        """``x`` with its split dimension first, as [blocks, parts, size, ...]."""
        dim = self.dim
        n = x.shape[dim]
        if n % (parts * self.blocks):
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{parts} ranks" + (f" in {self.blocks} blocks" if self.blocks > 1
                                                 else ""))
        moved = x.movedim(dim, 0) if isinstance(x, torch.Tensor) else np.moveaxis(x, dim, 0)
        return moved.reshape(self.blocks, parts, n // (parts * self.blocks), *moved.shape[1:])

    def shard(self, x):
        """This rank's part of the whole ``x`` (a tensor or an array)."""
        if self.dim is None:
            return x
        parts = self.mesh.size(self.axis)
        mine = self._blocked(x, parts)[:, self.mesh.index(self.axis)]
        mine = mine.reshape(-1, *mine.shape[2:])
        if isinstance(x, torch.Tensor):
            return mine.movedim(0, self.dim)
        return np.moveaxis(mine, 0, self.dim)

    def unshard(self, parts: list) -> torch.Tensor:
        """The whole tensor from every rank's part, in axis order."""
        if self.dim is None:
            return parts[0]
        moved = [p.movedim(self.dim, 0) for p in parts]
        size = moved[0].shape[0] // self.blocks
        whole = torch.cat([m[i * size:(i + 1) * size] for i in range(self.blocks)
                           for m in moved])
        return whole.movedim(0, self.dim)


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


def is_main_process() -> bool:
    """Rank 0 of the default group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
