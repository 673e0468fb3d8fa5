"""Every collective the trainers use, over a `Mesh`'s process group.

NCCL takes the CUDA tensors as they are. Under gloo a CUDA tensor goes
through a host copy (gloo reduces on the CPU), and a reduce-scatter is an
all-reduce of which each rank keeps its part. The route follows the
group's backend, so the CPU tests and two ranks sharing one card run the
same code. On a one-rank mesh every collective is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from naturalspeech2_tpu_torch.parallel.mesh import Mesh


def _host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type != "cpu"


def all_reduce_(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced (summed) over the ranks, in place."""
    if mesh.group is None:
        return t
    if _host(mesh, t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=mesh.group)
        return t.copy_(h)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def broadcast_(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` set to rank ``src``'s, in place."""
    if mesh.group is None:
        return t
    if _host(mesh, t):
        h = t.cpu()
        dist.broadcast(h, src, group=mesh.group)
        return t.copy_(h)
    dist.broadcast(t, src, group=mesh.group)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor) -> list:
    """Every rank's ``t`` (equal shapes), in rank order, as new tensors."""
    if mesh.group is None:
        return [t.clone()]
    src = t.contiguous()
    if _host(mesh, src):
        parts = [torch.empty_like(src, device="cpu") for _ in range(mesh.world_size)]
        dist.all_gather(parts, src.cpu(), group=mesh.group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(parts, src, group=mesh.group)
    return parts


def reduce_scatter(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Part ``rank`` of the sum over ranks of ``t`` [world_size, ...]."""
    if mesh.group is None:
        return t[0].clone()
    t = t.contiguous()
    if mesh.backend == "gloo":
        return all_reduce_(mesh, t.clone())[mesh.rank]
    out = torch.empty_like(t[0])
    dist.reduce_scatter(out, list(t.unbind(0)), group=mesh.group)
    return out


def _flat_(mesh: Mesh, tensors: list, collective) -> list:
    """``collective`` on the concatenation of ``tensors``, one call a dtype,
    written back into them."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = collective(mesh, torch.cat([t.reshape(-1) for t in group]))
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))
    return tensors


def all_reduce_many_(mesh: Mesh, tensors: list) -> list:
    """Each of ``tensors`` summed over the ranks in place, by one all-reduce
    a dtype."""
    return tensors if mesh.group is None else _flat_(mesh, tensors, all_reduce_)


def broadcast_many_(mesh: Mesh, tensors: list) -> list:
    """Each of ``tensors`` set to rank 0's in place, by one broadcast a
    dtype."""
    return tensors if mesh.group is None else _flat_(mesh, tensors, broadcast_)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(mesh, x.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, whose gradient towards this rank's
    ``x`` is the identity: a loss built from it is the global batch's on
    every rank, and its gradients, summed over the ranks, are the global
    batch's gradient."""
    if mesh.group is None:
        return x
    return _GlobalSum.apply(x, mesh)
