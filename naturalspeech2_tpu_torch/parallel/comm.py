"""Every collective the trainers and tensor parallelism use, over one axis
of a `Mesh` (``"data"``, ``"model"``, or None for every rank).

NCCL takes the CUDA tensors as they are. Under gloo a CUDA tensor goes
through a host copy (gloo reduces on the CPU), and a reduce-scatter is an
all-reduce of which each rank keeps its part. The route follows the
group's backend, so the CPU tests and two ranks sharing one card run the
same code. Along an axis of one rank every collective is the identity.

`tp_copy` and `tp_reduce` are Megatron's two operators of a tensor-parallel
region over the ``model`` axis: *f*, the identity whose backward sums the
gradient over the model group, in front of every column-parallel input,
and *g*, the sum over the model group whose backward is the identity,
after every row-parallel output.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from naturalspeech2_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def _host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type != "cpu"


def all_reduce_(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = DATA_AXIS,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced (summed) over the ranks along ``axis``, in place."""
    group = mesh.group_of(axis)
    if group is None:
        return t
    if _host(mesh, t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        return t.copy_(h)
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = None,
               src: int = 0) -> torch.Tensor:
    """``t`` set, in place, to that of the rank at index ``src`` along
    ``axis`` (None, the default: rank ``src`` of every rank)."""
    group = mesh.group_of(axis)
    if group is None:
        return t
    src = dist.get_global_rank(group, src) if group is not dist.group.WORLD else src
    if _host(mesh, t):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        return t.copy_(h)
    dist.broadcast(t, src, group=group)
    return t


def all_gather(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> list:
    """Every rank's ``t`` (equal shapes) along ``axis``, in axis order, as
    new tensors."""
    group = mesh.group_of(axis)
    if group is None:
        return [t.clone()]
    src = t.contiguous()
    size = mesh.size(axis)
    if _host(mesh, src):
        parts = [torch.empty_like(src, device="cpu") for _ in range(size)]
        dist.all_gather(parts, src.cpu(), group=group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return parts


def reduce_scatter(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """Part ``index`` (this rank's along ``axis``) of the sum over the
    axis of ``t`` [axis size, ...]."""
    group = mesh.group_of(axis)
    if group is None:
        return t[0].clone()
    t = t.contiguous()
    if mesh.backend == "gloo":
        return all_reduce_(mesh, t.clone(), axis)[mesh.index(axis)]
    out = torch.empty_like(t[0])
    dist.reduce_scatter(out, list(t.unbind(0)), group=group)
    return out


def all_to_all(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """``t`` [axis size, ...]: part j goes to the rank at index j along
    ``axis``; returns the parts received, [axis size, ...], part i from the
    rank at index i. Gloo has no all-to-all: there each rank gathers every
    rank's parts and keeps those sent to it."""
    group = mesh.group_of(axis)
    if group is None:
        return t.clone()
    t = t.contiguous()
    if mesh.backend == "gloo":
        return torch.stack([p[mesh.index(axis)] for p in all_gather(mesh, t, axis)])
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def shift(mesh: Mesh, t: torch.Tensor, axis: Optional[str] = DATA_AXIS,
          step: int = 1) -> torch.Tensor:
    """The ``t`` of the rank ``step`` places before this one along ``axis``
    (a ring: each rank sends its ``t`` ``step`` places on), by one
    ``batch_isend_irecv``."""
    group = mesh.group_of(axis)
    if group is None:
        return t.clone()
    size, index = mesh.size(axis), mesh.index(axis)
    to = dist.get_global_rank(group, (index + step) % size)
    frm = dist.get_global_rank(group, (index - step) % size)
    src = t.contiguous()
    if _host(mesh, src):
        src = src.cpu()
    out = torch.empty_like(src)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, to, group),
                                       dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out.to(t.device)


def _flat_(mesh: Mesh, tensors: list, collective) -> list:
    """``collective`` on the concatenation of ``tensors``, one call a dtype,
    written back into them."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = collective(torch.cat([t.reshape(-1) for t in group]))
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))
    return tensors


def all_reduce_many_(mesh: Mesh, tensors: list, axis: Optional[str] = DATA_AXIS) -> list:
    """Each of ``tensors`` summed over ``axis`` in place, by one all-reduce
    a dtype."""
    if mesh.group_of(axis) is None:
        return tensors
    return _flat_(mesh, tensors, lambda t: all_reduce_(mesh, t, axis))


def broadcast_many_(mesh: Mesh, tensors: list, axis: Optional[str] = None) -> list:
    """Each of ``tensors`` set to that of index 0 along ``axis`` (None: rank
    0) in place, by one broadcast a dtype."""
    if mesh.group_of(axis) is None:
        return tensors
    return _flat_(mesh, tensors, lambda t: broadcast_(mesh, t, axis))


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(mesh, x.detach().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def global_sum(mesh: Mesh, x: torch.Tensor, axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, whose gradient
    towards this rank's ``x`` is the identity: a loss built from it is the
    global batch's on every rank, and its gradients, summed over the ranks,
    are the global batch's gradient."""
    if mesh.group_of(axis) is None:
        return x
    return _GlobalSum.apply(x, mesh, axis)


class _Copy(torch.autograd.Function):
    """*f*: identity forward, gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(ctx.mesh, grad.contiguous().clone(), MODEL_AXIS), None


class _Reduce(torch.autograd.Function):
    """*g*: summed over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(mesh, x.detach().contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def tp_copy(mesh: Mesh, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """*f* of a tensor-parallel region: ``x`` as it is, its gradient summed
    over the model group, so that what lies before the region gets the
    gradient of every rank's heads. None stays None."""
    if x is None or mesh.group_of(MODEL_AXIS) is None or not torch.is_grad_enabled():
        return x
    return _Copy.apply(x, mesh)


def tp_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """*g* of a tensor-parallel region: the sum over the model group of
    each rank's partial ``x`` (its heads' share), whose gradient is handed
    to every rank's partial as it is."""
    if mesh.group_of(MODEL_AXIS) is None:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return all_reduce_(mesh, x.contiguous().clone(), MODEL_AXIS)
    return _Reduce.apply(x, mesh)
