"""Loads the JAX package's parameter trees into the port's modules.

The tree comes as nested dicts of numpy arrays (for instance
``jax.tree_util.tree_map(np.asarray, variables["params"])``), so this
module never sees JAX. Layout rules:

- a Dense kernel [in, out] becomes a Linear weight [out, in];
- a Conv kernel [k, in, out] becomes a Conv1d weight [out, in, k];
- a ConvTranspose kernel [k, in, out] becomes a ConvTranspose1d weight
  [in, out, k] with k reversed (see `models/codec.py`);
- the weights a kernel consumes keep their JAX layouts: the stacked
  WaveNet tensors, ``ada_norm_w``/``ada_norm_b``, the attention
  projections and the feed-forward tree.

Every leaf must be consumed and every expected leaf present; otherwise
``load_jax_params`` raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


class _Converter:
    """Pops leaves from a flattened JAX tree into a torch state dict."""

    def __init__(self, tree: Mapping):
        self.leaves = _flatten(tree)
        self.state: dict[str, torch.Tensor] = {}

    def _take(self, path: str) -> torch.Tensor:
        if path not in self.leaves:
            raise KeyError(f"JAX tree lacks the leaf {path!r}")
        return torch.from_numpy(np.array(self.leaves.pop(path), dtype=np.float32))

    def raw(self, src: str, dst: str) -> None:
        self.state[dst] = self._take(src)

    def dense(self, src: str, dst: str, bias: bool = True) -> None:
        self.state[f"{dst}.weight"] = self._take(f"{src}/kernel").T.contiguous()
        if bias:
            self.raw(f"{src}/bias", f"{dst}.bias")

    def conv(self, src: str, dst: str) -> None:
        kernel = self._take(f"{src}/kernel")
        self.state[f"{dst}.weight"] = kernel.permute(2, 1, 0).contiguous()
        self.raw(f"{src}/bias", f"{dst}.bias")

    def conv_transpose(self, src: str, dst: str) -> None:
        kernel = self._take(f"{src}/kernel")
        self.state[f"{dst}.weight"] = kernel.flip(0).permute(1, 2, 0).contiguous()
        self.raw(f"{src}/bias", f"{dst}.bias")

    def count(self, pattern: str) -> int:
        """Number of consecutive indices i with a leaf under ``pattern.format(i)``."""
        i = 0
        while any(p.startswith(pattern.format(i) + "/") for p in self.leaves):
            i += 1
        return i

    def finish(self) -> dict[str, torch.Tensor]:
        if self.leaves:
            raise ValueError(f"JAX tree has leaves the port does not take: {sorted(self.leaves)}")
        return self.state


def _model(conv: _Converter) -> None:
    conv.raw("time_pos_emb/weights", "time_pos_emb.weights")
    conv.dense("to_time_hidden", "to_time_hidden")
    conv.conv("wavenet/init_conv/Conv_0", "wavenet.init_conv.conv")
    for name in ("conv_w", "conv_b", "res_w", "res_b", "skip_w", "skip_b", "film_w", "film_b"):
        conv.raw(f"wavenet/{name}", f"wavenet.{name}")
    conv.conv("wavenet/final_conv/Conv_0", "wavenet.final_conv.conv")
    conv.raw("transformer/ada_norm_w", "transformer.ada_norm_w")
    conv.raw("transformer/ada_norm_b", "transformer.ada_norm_b")
    depth = conv.count("transformer/attn_{}")
    for i in range(depth):
        for proj in ("to_q", "to_kv", "to_out"):
            conv.raw(f"transformer/attn_{i}/{proj}/kernel", f"transformer.attn.{i}.{proj}")
        ff = f"transformer/ff_{i}"
        conv.raw(f"{ff}/Dense_0/kernel", f"transformer.ff.{i}.w1")
        conv.raw(f"{ff}/Dense_0/bias", f"transformer.ff.{i}.b1")
        conv.raw(f"{ff}/CausalConv1d_0/Conv_0/kernel", f"transformer.ff.{i}.wc")
        conv.raw(f"{ff}/CausalConv1d_0/Conv_0/bias", f"transformer.ff.{i}.bc")
        conv.raw(f"{ff}/Dense_1/kernel", f"transformer.ff.{i}.w2")
        conv.raw(f"{ff}/Dense_1/bias", f"transformer.ff.{i}.b2")
    conv.raw("transformer/pred_norm/gamma", "transformer.pred_norm.gamma")
    conv.dense("transformer/to_pred", "transformer.to_pred", bias=False)


def _residual_units(conv: _Converter, src: str, dst: str) -> None:
    for unit in (0, 1):
        conv.conv(f"{src}/ResidualUnit_{unit}/Conv_0", f"{dst}.res{unit + 1}.conv1")
        conv.conv(f"{src}/ResidualUnit_{unit}/Conv_1", f"{dst}.res{unit + 1}.conv2")


def _codec(conv: _Converter) -> None:
    conv.conv("encoder_stem", "encoder_stem")
    for i in range(conv.count("encoder_blocks_{}")):
        src, dst = f"encoder_blocks_{i}", f"encoder_blocks.{i}"
        _residual_units(conv, src, dst)
        conv.conv(f"{src}/Conv_0", f"{dst}.down")
    conv.conv("encoder_head", "encoder_head")
    conv.conv("decoder_stem", "decoder_stem")
    for i in range(conv.count("decoder_blocks_{}")):
        src, dst = f"decoder_blocks_{i}", f"decoder_blocks.{i}"
        conv.conv_transpose(f"{src}/ConvTranspose_0", f"{dst}.up")
        _residual_units(conv, src, dst)
    conv.conv("decoder_head", "decoder_head")
    conv.raw("codebooks", "codebooks")


def load_jax_params(tree: Mapping) -> dict[str, torch.Tensor]:
    """JAX param tree → state dict of the matching port module.

    ``tree`` is one of: a `NaturalSpeech2` tree ``{"model": ..., "codec":
    ...}`` (codec optional), a `Model` tree (it has ``"wavenet"``), or a
    `SoundStream` tree (it has ``"codebooks"``). Load the result with
    ``module.load_state_dict(state, strict=True)``.
    """
    keys = set(tree)
    if "model" in keys and keys <= {"model", "codec"}:
        state = load_jax_params(tree["model"])
        out = {f"model.{k}": v for k, v in state.items()}
        if "codec" in tree:
            out.update({f"codec.{k}": v for k, v in load_jax_params(tree["codec"]).items()})
        return out
    conv = _Converter(tree)
    if "wavenet" in keys:
        _model(conv)
    elif "codebooks" in keys:
        _codec(conv)
    else:
        raise ValueError(f"not a Model, SoundStream or NaturalSpeech2 tree: keys {sorted(keys)}")
    return conv.finish()
