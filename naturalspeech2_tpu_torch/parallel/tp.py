"""Tensor parallelism over the ``model`` axis (the port of
`naturalspeech2_tpu/parallel/tp.py`).

Which leaves a rank shards is JAX's rule (`TP_RULES`, first match wins,
replicated where a dimension does not divide), applied to the JAX path of
each of the port's parameters (`jax_leaves`): the attention projections
``to_q`` / ``to_kv`` column-parallel and ``to_out`` row-parallel, the
feed-forward's ``Dense_0`` column- and ``Dense_1`` row-parallel. Adam's
moments and the EMA follow their parameter.

How a rank computes with them is the port's. JAX's partitioner derives
every activation's layout from these specs; here:

- an attention whose heads divide over the axis (`plan`) runs
  this rank's heads only: the module holds its columns of ``to_q``, the k
  and the v columns of its heads in ``to_kv`` (``to_kv`` is k's heads,
  then v's: a contiguous cut would give one rank every k and the other
  every v, so it is cut as two blocks) and its rows of ``to_out``, and
  sums its heads' output over the model group (`comm.tp_copy` in front,
  `comm.tp_reduce` behind; `models/transformer.py`);
- every other leaf the rule shards (the feed-forward's, whose causal conv
  needs every inner channel, and an attention whose heads do not divide)
  is held as the rule cuts it, gathered whole before each forward and
  used whole on every rank; each rank then keeps its part of the
  gradient;
- everything else is replicated and computed alike on every rank of a
  model group, on the same inputs and the same draws (`ops/dropout.py`).

Checkpoints hold the whole state in JAX's layout: `Trainer` gathers it to
save and cuts it again for any layout when it loads.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
from torch import nn
from torch.autograd.graph import increment_version

from naturalspeech2_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, Sharding

# (path regex, ndim, spec) — first match wins (JAX's `TP_RULES`)
TP_RULES = [
    # column-parallel: output features sharded
    (re.compile(r"(to_q|to_kv)/kernel$"), 2, (None, MODEL_AXIS)),
    (re.compile(r"ff_\d+/Dense_0/kernel$"), 2, (None, MODEL_AXIS)),
    (re.compile(r"ff_\d+/Dense_0/bias$"), 1, (MODEL_AXIS,)),
    # row-parallel: input features sharded, output all-reduced
    (re.compile(r"to_out/kernel$"), 2, (MODEL_AXIS, None)),
    (re.compile(r"ff_\d+/Dense_1/kernel$"), 2, (MODEL_AXIS, None)),
]

# the JAX leaf of each of the port's feed-forward and attention tensors
_LEAF = {"w1": "Dense_0/kernel", "b1": "Dense_0/bias", "w2": "Dense_1/kernel",
         "b2": "Dense_1/bias", "wc": "CausalConv1d_0/Conv_0/kernel",
         "bc": "CausalConv1d_0/Conv_0/bias", "to_q": "to_q/kernel", "to_kv": "to_kv/kernel",
         "to_out": "to_out/kernel"}


def spec_for_path(path_str: str, leaf, axis_size: int = 1) -> tuple:
    """The spec of a parameter path (a ``PartitionSpec`` as a tuple; ``leaf``
    a tensor, an array or a shape). Dimensions that do not divide by the
    model axis size fall back to replication, as in JAX."""
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
    for pattern, want_ndim, spec in TP_RULES:
        if pattern.search(path_str) and len(shape) == want_ndim:
            if axis_size > 1 and any(ax is not None and shape[i] % axis_size
                                     for i, ax in enumerate(spec)):
                return ()
            return spec
    return ()


def jax_path(name: str) -> str:
    """The JAX tree path of a port parameter name, as `params.py` maps the
    trees (a ModuleList index joins its name, ``attn.0`` → ``attn_0``)."""
    parts = name.split(".")
    out = []
    for part in parts:
        if part.isdigit() and out:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    if len(out) > 1 and out[-1] in _LEAF and re.fullmatch(r"(\w+_)?(attn|ff)_\d+", out[-2]):
        out[-1] = _LEAF[out[-1]]
    return "/".join(out)


def jax_leaves(model: nn.Module) -> Dict[str, Tuple[str, tuple]]:
    """Per parameter name, the JAX leaf it is (path, whole shape). A
    ``scan_layers=True`` transformer's layers are one leaf stacked on a
    leading depth axis in JAX (``layers/attn/to_q/kernel`` [depth, ...]),
    which no rule matches: JAX keeps them replicated, and so does the port."""
    stacked = {prefix: m.depth for prefix, m in model.named_modules()
               if getattr(m, "scan_layers", False)}
    whole = getattr(model, "_tp_whole", {})
    out = {}
    for name, p in model.named_parameters():
        path, shape = jax_path(name), tuple(whole.get(name, p.shape))
        for prefix, depth in stacked.items():
            rest = name[len(prefix) + 1:] if prefix else name
            layer = re.fullmatch(r"(attn|cross_attn|ff)\.\d+\.(\w+)", rest)
            if (not prefix or name.startswith(prefix + ".")) and layer and layer[2] in _LEAF:
                path = "/".join(filter(None, [jax_path(prefix), "layers", layer[1],
                                              _LEAF[layer[2]]]))
                shape = (depth, *shape)
        out[name] = (path, shape)
    return out


def state_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, Sharding]:
    """The `Sharding` JAX's rule gives each of the model's parameters (by
    name) on ``mesh``'s model axis; all replicated on a model axis of 1."""
    if mesh.n_model == 1:
        return {name: Sharding(mesh, ()) for name, _ in model.named_parameters()}
    return {name: Sharding(mesh, spec_for_path(path, shape, mesh.n_model))
            for name, (path, shape) in jax_leaves(model).items()}


def plan(model: nn.Module, mesh: Mesh) -> Tuple[Dict[str, Sharding], set, Dict[str, nn.Module]]:
    """(the `Sharding` of each parameter as the port holds it, the names the
    modules themselves hold cut, those modules by name): the attentions
    whose heads split are those whose head count the model axis divides
    and whose three projections JAX's rule shards (not a ``scan_layers``
    transformer's); ``to_kv`` is cut as its two blocks."""
    shardings = state_shardings(mesh, model)
    attns, held = {}, set()
    for prefix, m in model.named_modules():
        names = {proj: ".".join(filter(None, [prefix, proj]))
                 for proj in ("to_q", "to_kv", "to_out")}
        if (mesh.n_model > 1 and hasattr(m, "to_kv") and m.all_heads % mesh.n_model == 0
                and all(shardings[n].axis == MODEL_AXIS for n in names.values())):
            attns[prefix] = m
            shardings[names["to_kv"]] = Sharding(mesh, shardings[names["to_kv"]].spec, blocks=2)
            held.update(names.values())
    return shardings, held, attns


def _set(p: torch.Tensor, value: torch.Tensor) -> None:
    """``p``'s data replaced, its version advanced so that no layout built
    from the old data (`ops/gemm_cache.py`) is reused."""
    p.data = value
    increment_version(p)


def shard_model(model: nn.Module, mesh: Mesh) -> Tuple[Dict[str, Sharding], set]:
    """Cut ``model`` (whole weights, the same on every rank) for tensor
    parallelism on ``mesh``: each attention whose heads split keeps this
    rank's heads and sums them over the model group. Returns `plan`'s
    (shardings, held names); the other sharded leaves stay whole in the
    module, for the caller to hold cut (the trainer) or to keep whole (the
    serving engine, which keeps no optimizer state)."""
    shardings, held, attns = plan(model, mesh)
    params = dict(model.named_parameters())
    model._tp_whole = {name: tuple(params[name].shape) for name in held}
    with torch.no_grad():
        for name in held:
            _set(params[name], shardings[name].shard(params[name].data).contiguous().clone())
    for attn in attns.values():
        local = attn.heads // mesh.n_model
        attn.all_heads, attn.heads = attn.heads, local
        attn.head_offset = mesh.model_index * local
        attn.tp = mesh
    return shardings, held


def unshard_model(model: nn.Module, state: dict) -> nn.Module:
    """``model`` (a copy of a cut one) made whole, with the values of
    ``state`` (whole tensors by parameter name): every attention runs all
    its heads in one process."""
    for m in model.modules():
        if getattr(m, "tp", None) is not None:
            m.heads, m.head_offset, m.tp = m.all_heads, 0, None
    model._tp_whole = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            _set(p, state[name].detach().clone().to(p.device, p.dtype))
    return model
