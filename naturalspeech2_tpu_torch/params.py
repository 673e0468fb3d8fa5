"""Loads the JAX package's parameter trees into the port's modules.

The tree comes as nested dicts of numpy arrays (for instance
``jax.tree_util.tree_map(np.asarray, variables["params"])``), so this
module never sees JAX. Layout rules:

- a Dense kernel [in, out] becomes a Linear weight [out, in];
- a Conv kernel [k, in, out] becomes a Conv1d weight [out, in, k];
- a ConvTranspose kernel [k, in, out] becomes a ConvTranspose1d weight
  [in, out, k] with k reversed (see `models/codec.py`);
- a 2-D Conv kernel [kh, kw, in, out] becomes a Conv2d weight
  [out, in, kh, kw];
- an LSTM's ``w_ih_{l}`` / ``w_hh_{l}`` [d, 4d] become ``weight_ih_l{l}`` /
  ``weight_hh_l{l}`` [4d, d], its biases as they are;
- an Embed table [num, dim] is an Embedding weight as it is, and a
  GroupNorm's scale/bias are its weight/bias;
- the weights a kernel consumes keep their JAX layouts: the stacked
  WaveNet tensors, ``ada_norm_w``/``ada_norm_b``, the attention
  projections and the feed-forward tree;
- a ``scan_layers=True`` tree's ``transformer/layers/{attn,cross_attn,ff}``
  leaves, stacked on a leading depth axis, are unbound along that axis
  into the same per-layer modules as the unrolled ``attn_{i}`` / ``ff_{i}``;
- an unfused WaveNet tree (``use_fused_wavenet=False``, and what
  `utils/torch_import.py` maps a reference checkpoint to:
  ``wavenet/stack_{s}/block_{l}/...``) is stacked into the fused layout
  of `FusedWavenet`, or with ``fused_wavenet=False`` mapped one to one
  onto the port's unfused `Wavenet` (a fused tree cannot be unstacked).

Every leaf must be consumed and every expected leaf present; otherwise
``load_jax_params`` raises.
"""

from __future__ import annotations

import re
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

    def conv2d(self, src: str, dst: str) -> None:
        self.state[f"{dst}.weight"] = self._take(f"{src}/kernel").permute(3, 2, 0, 1).contiguous()
        self.raw(f"{src}/bias", f"{dst}.bias")

    def transposed(self, src: str, dst: str) -> None:
        self.state[dst] = self._take(src).T.contiguous()

    def embed(self, src: str, dst: str) -> None:
        self.raw(f"{src}/embedding", f"{dst}.weight")

    def group_norm(self, src: str, dst: str) -> None:
        self.raw(f"{src}/scale", f"{dst}.weight")
        self.raw(f"{src}/bias", f"{dst}.bias")

    def has(self, prefix: str) -> bool:
        return any(p.startswith(prefix + "/") for p in self.leaves)

    def count(self, pattern: str) -> int:
        """Number of consecutive indices i with a leaf under ``pattern.format(i)``."""
        i = 0
        while any(p.startswith(pattern.format(i) + "/") for p in self.leaves):
            i += 1
        return i

    def attention(self, src: str, dst: str) -> None:
        for proj in ("to_q", "to_kv", "to_out"):
            self.raw(f"{src}/{proj}/kernel", f"{dst}.{proj}")

    def plain_ff(self, src: str, dst: str) -> None:
        self.raw(f"{src}/Dense_0/kernel", f"{dst}.w1")
        self.raw(f"{src}/Dense_0/bias", f"{dst}.b1")
        self.raw(f"{src}/Dense_1/kernel", f"{dst}.w2")
        self.raw(f"{src}/Dense_1/bias", f"{dst}.b2")

    def unstack(self, src: str, dst: str) -> None:
        """Rewrites the leaves ``{src}/{name}/...`` of a `nn.scan` tree,
        stacked on a leading depth axis, as the unrolled leaves
        ``{dst}/{name}_{i}/...`` (``{name}_{i}/...`` if ``dst`` is
        empty); the depth is that leading axis."""
        stacked = {p: v for p, v in self.leaves.items() if p.startswith(src + "/")}
        depths = {v.shape[0] if v.ndim else None for v in stacked.values()}
        if len(depths) != 1 or None in depths:
            raise ValueError(f"the leaves under {src!r} disagree on their depth axis: {depths}")
        depth = depths.pop()
        for path, value in stacked.items():
            name, rest = path[len(src) + 1:].split("/", 1)
            for i in range(depth):
                unrolled = f"{dst}/{name}_{i}/{rest}".lstrip("/")
                if unrolled in self.leaves:
                    raise ValueError(f"JAX tree has both {path!r} and {unrolled!r}")
                self.leaves[unrolled] = value[i]
            del self.leaves[path]

    def finish(self) -> dict[str, torch.Tensor]:
        if self.leaves:
            raise ValueError(f"JAX tree has leaves the port does not take: {sorted(self.leaves)}")
        return self.state


def _fuse_wavenet(conv: _Converter) -> None:
    """Rewrites an unfused WaveNet's per-block leaves as the fused layout:
    conv_w[s, l] [3d, d] the causal conv's taps stacked (x_{t−2δ} ‖ x_{t−δ}
    ‖ x_t), res_w / skip_w the 1×1 kernels, film_w / film_b the blocks'
    time-conditioning Dense (skips from the last stack only)."""
    stacks = conv.count("wavenet/stack_{}")
    layers = conv.count("wavenet/stack_0/block_{}")
    fused = {name: [] for name in ("conv_w", "conv_b", "res_w", "res_b", "film_w", "film_b")}
    for s in range(stacks):
        rows = {name: [] for name in fused}
        for layer in range(layers):
            base = f"wavenet/stack_{s}/block_{layer}"
            kernel = conv.leaves.pop(f"{base}/conv/Conv_0/kernel")  # [3, d, d]
            rows["conv_w"].append(kernel.reshape(-1, kernel.shape[-1]))
            rows["conv_b"].append(conv.leaves.pop(f"{base}/conv/Conv_0/bias"))
            rows["res_w"].append(conv.leaves.pop(f"{base}/res_conv/Conv_0/kernel")[0])
            rows["res_b"].append(conv.leaves.pop(f"{base}/res_conv/Conv_0/bias"))
            rows["film_w"].append(conv.leaves.pop(f"{base}/to_time_cond/kernel"))
            rows["film_b"].append(conv.leaves.pop(f"{base}/to_time_cond/bias"))
        for name in fused:
            fused[name].append(np.stack(rows[name]))
    last = f"wavenet/stack_{stacks - 1}"
    for name in fused:
        conv.leaves[f"wavenet/{name}"] = np.stack(fused[name])
    conv.leaves["wavenet/skip_w"] = np.stack([conv.leaves.pop(f"{last}/block_{layer}/skip_conv/Conv_0/kernel")[0]
                                              for layer in range(layers)])
    conv.leaves["wavenet/skip_b"] = np.stack([conv.leaves.pop(f"{last}/block_{layer}/skip_conv/Conv_0/bias")
                                              for layer in range(layers)])


def _unfused_wavenet(conv: _Converter) -> None:
    """An unfused WaveNet's per-block leaves onto the port's `Wavenet`, one
    to one (skip convs in the last stack only)."""
    for s in range(conv.count("wavenet/stack_{}")):
        for layer in range(conv.count(f"wavenet/stack_{s}/block_{{}}")):
            src, dst = f"wavenet/stack_{s}/block_{layer}", f"wavenet.stack_{s}.block_{layer}"
            for name in ("res_conv", "conv", "skip_conv"):
                if conv.has(f"{src}/{name}"):
                    conv.conv(f"{src}/{name}/Conv_0", f"{dst}.{name}.conv")
            if conv.has(f"{src}/to_time_cond"):
                conv.dense(f"{src}/to_time_cond", f"{dst}.to_time_cond")


def _model(conv: _Converter, fused_wavenet: bool) -> None:
    unfused_tree = conv.has("wavenet/stack_0")
    if unfused_tree and fused_wavenet:
        _fuse_wavenet(conv)
    if conv.has("to_self_cond"):  # self_cond=True
        conv.dense("to_self_cond", "to_self_cond")
    conv.raw("time_pos_emb/weights", "time_pos_emb.weights")
    conv.dense("to_time_hidden", "to_time_hidden")
    conv.conv("wavenet/init_conv/Conv_0", "wavenet.init_conv.conv")
    if fused_wavenet:
        for name in ("conv_w", "conv_b", "res_w", "res_b", "skip_w", "skip_b", "film_w",
                     "film_b"):
            conv.raw(f"wavenet/{name}", f"wavenet.{name}")
    elif unfused_tree:
        _unfused_wavenet(conv)
    else:
        raise ValueError("fused_wavenet=False needs an unfused WaveNet tree "
                         "(wavenet/stack_{s}/block_{l}); a fused one is not unstacked")
    conv.conv("wavenet/final_conv/Conv_0", "wavenet.final_conv.conv")
    _conditionable_transformer(conv, "transformer/", "transformer.")
    if conv.has("perceiver_resampler"):  # condition_on_prompt=True
        for name in ("null_prompt_cond", "null_prompt_tokens", "null_cond"):
            conv.raw(name, name)
        conv.dense("to_prompt_cond", "to_prompt_cond")
        conv.dense("cond_to_model_dim", "cond_to_model_dim")
        _resampler(conv, "perceiver_resampler", "perceiver_resampler")


def _conditionable_transformer(conv: _Converter, src: str, dst: str) -> None:
    """A `ConditionableTransformer`, adaptive (the denoiser's) or plain,
    unrolled or with ``scan_layers=True``; ``src`` and ``dst`` are path
    prefixes ("" for a bare tree)."""
    if f"{src}ada_norm_w" in conv.leaves:  # the adaptive layer
        conv.raw(f"{src}ada_norm_w", f"{dst}ada_norm_w")
        conv.raw(f"{src}ada_norm_b", f"{dst}ada_norm_b")
    if conv.has(f"{src}layers"):  # scan_layers=True
        conv.unstack(f"{src}layers", src.rstrip("/"))
    for i in range(conv.count(f"{src}attn_{{}}")):
        for block in ("attn", "cross_attn", "ff"):
            if conv.has(f"{src}{block}_norm_{i}"):  # the plain layer's norms
                conv.raw(f"{src}{block}_norm_{i}/gamma", f"{dst}{block}_norm.{i}.gamma")
        conv.attention(f"{src}attn_{i}", f"{dst}attn.{i}")
        if conv.has(f"{src}cross_attn_{i}"):
            conv.attention(f"{src}cross_attn_{i}", f"{dst}cross_attn.{i}")
        ff = f"{src}ff_{i}"
        conv.plain_ff(ff, f"{dst}ff.{i}")
        if conv.has(f"{ff}/CausalConv1d_0"):  # ff_causal_conv=True
            conv.raw(f"{ff}/CausalConv1d_0/Conv_0/kernel", f"{dst}ff.{i}.wc")
            conv.raw(f"{ff}/CausalConv1d_0/Conv_0/bias", f"{dst}ff.{i}.bc")
    conv.raw(f"{src}pred_norm/gamma", f"{dst}pred_norm.gamma")
    conv.dense(f"{src}to_pred", f"{dst}to_pred", bias=False)


def _resampler(conv: _Converter, src: str, dst: str) -> None:
    if conv.has(f"{src}/proj_context"):
        conv.dense(f"{src}/proj_context", f"{dst}.proj_context")
    conv.raw(f"{src}/latents", f"{dst}.latents")
    for i in range(conv.count(f"{src}/attn_{{}}")):
        conv.attention(f"{src}/attn_{i}", f"{dst}.attn.{i}")
        conv.plain_ff(f"{src}/ff_{i}", f"{dst}.ff.{i}")
    conv.raw(f"{src}/norm/gamma", f"{dst}.norm.gamma")


def _transformer(conv: _Converter, src: str, dst: str) -> None:
    """The encoders' `Transformer`."""
    for i in range(conv.count(f"{src}/attn_{{}}")):
        conv.raw(f"{src}/attn_norm_{i}/gamma", f"{dst}.attn_norm.{i}.gamma")
        conv.attention(f"{src}/attn_{i}", f"{dst}.attn.{i}")
        conv.raw(f"{src}/ff_norm_{i}/gamma", f"{dst}.ff_norm.{i}.gamma")
        conv.plain_ff(f"{src}/ff_{i}", f"{dst}.ff.{i}")
    if conv.has(f"{src}/final_norm"):
        conv.raw(f"{src}/final_norm/gamma", f"{dst}.final_norm.gamma")


def _trunk(conv: _Converter, src: str, dst: str) -> None:
    """`DurationPitchPredictorTrunk`: ResnetBlocks (ConvUnit_j: Conv_0 +
    GroupNorm_0, and a 1×1 Conv_0 where the widths differ) or ConvBlocks
    (Conv_0)."""
    for i in range(conv.count(f"{src}/norm_{{}}")):
        for c in range(conv.count(f"{src}/conv_{i}_{{}}")):
            block, out = f"{src}/conv_{i}_{c}", f"{dst}.convs.{i}.{c}"
            units = conv.count(f"{block}/ConvUnit_{{}}")
            for j in range(units):
                conv.conv(f"{block}/ConvUnit_{j}/Conv_0", f"{out}.units.{j}.conv")
                conv.group_norm(f"{block}/ConvUnit_{j}/GroupNorm_0", f"{out}.units.{j}.norm")
            if conv.has(f"{block}/Conv_0"):
                conv.conv(f"{block}/Conv_0", f"{out}.res_conv" if units else f"{out}.conv")
        conv.raw(f"{src}/norm_{i}/gamma", f"{dst}.norms.{i}.gamma")
        conv.attention(f"{src}/attn_{i}", f"{dst}.attn.{i}")
    conv.dense(f"{src}/to_pred", f"{dst}.to_pred")


def _phoneme_enc(conv: _Converter, src: str, dst: str) -> None:
    conv.embed(f"{src}/token_emb", f"{dst}.token_emb")
    conv.conv(f"{src}/conv/Conv_0", f"{dst}.conv.conv")
    _transformer(conv, f"{src}/transformer", f"{dst}.transformer")


def _prompt_enc(conv: _Converter, src: str, dst: str) -> None:
    for i in range(conv.count(f"{src}/conv_{{}}")):
        conv.conv(f"{src}/conv_{i}", f"{dst}.convs.{i}")
    _transformer(conv, f"{src}/transformer", f"{dst}.transformer")


def _duration_pitch(conv: _Converter, src: str, dst: str) -> None:
    for trunk in ("to_duration_pred", "to_pitch_pred"):
        _trunk(conv, f"{src}/{trunk}", f"{dst}.{trunk}")


def _aligner_net(conv: _Converter, src: str, dst: str) -> None:
    for name in ("key_conv1", "key_conv2", "query_conv1", "query_conv2", "query_conv3"):
        conv.conv(f"{src}/{name}", f"{dst}.{name}")


def _conditioning(conv: _Converter) -> None:
    """The conditional `NaturalSpeech2`'s own submodules."""
    _phoneme_enc(conv, "phoneme_enc", "phoneme_enc")
    _prompt_enc(conv, "prompt_enc", "prompt_enc")
    _duration_pitch(conv, "duration_pitch", "duration_pitch")
    _aligner_net(conv, "aligner/aligner", "aligner.aligner")
    conv.embed("pitch_emb", "pitch_emb")


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


def _encodec_conv(conv: _Converter, src: str, dst: str, transposed: bool = False) -> None:
    (conv.conv_transpose if transposed else conv.conv)(f"{src}/conv", f"{dst}.conv")
    if conv.has(f"{src}/norm"):  # norm_type="time_group_norm"
        conv.group_norm(f"{src}/norm", f"{dst}.norm")


def _encodec(conv: _Converter) -> None:
    """`Encodec`: ``encoder`` / ``decoder`` ``layer_{i}`` at the torch
    ModuleList's indices (an LSTM holds ``w_ih_0``, a residual unit
    ``block_1``). A decoder conv right after an ELU slot (an index with no
    layer) is transposed, but for the first and the last layer."""
    for mod in ("encoder", "decoder"):
        rx = re.compile(rf"{mod}/layer_(\d+)/")
        indices = sorted({int(m.group(1)) for p in conv.leaves if (m := rx.match(p))})
        for i in indices:
            src, dst = f"{mod}/layer_{i}", f"{mod}.layer_{i}"
            if f"{src}/w_ih_0" in conv.leaves:
                layer = 0
                while f"{src}/w_ih_{layer}" in conv.leaves:
                    for w in ("ih", "hh"):
                        conv.transposed(f"{src}/w_{w}_{layer}", f"{dst}.lstm.weight_{w}_l{layer}")
                        conv.raw(f"{src}/b_{w}_{layer}", f"{dst}.lstm.bias_{w}_l{layer}")
                    layer += 1
            elif conv.has(f"{src}/block_1"):
                for name in ("block_1", "block_3", "shortcut"):
                    if conv.has(f"{src}/{name}"):
                        _encodec_conv(conv, f"{src}/{name}", f"{dst}.{name}")
            else:
                transposed = (mod == "decoder" and 0 < i != indices[-1]
                              and i - 1 not in indices)
                _encodec_conv(conv, src, dst, transposed)
    conv.raw("codebooks", "codebooks")


def _discriminator(conv: _Converter) -> None:
    """`MultiScaleSTFTDiscriminator`: ``disc_{n_fft}/Conv_{j}``."""
    for disc in sorted({p.split("/")[0] for p in conv.leaves}):
        for j in range(conv.count(f"{disc}/Conv_{{}}")):
            conv.conv2d(f"{disc}/Conv_{j}", f"{disc}.convs.{j}")


def load_jax_params(tree: Mapping, fused_wavenet: bool = True) -> dict[str, torch.Tensor]:
    """JAX param tree → state dict of the matching port module.

    ``tree`` is one of: a `NaturalSpeech2` tree ``{"model": ..., "codec":
    ...}`` (codec optional; a conditional one also holds ``phoneme_enc``,
    ``prompt_enc``, ``duration_pitch``, ``aligner`` and ``pitch_emb``), a
    `Model` tree (it has ``"wavenet"``), an `Encodec` tree (``"encoder"``,
    ``"decoder"`` and ``"codebooks"``), a `SoundStream` tree (other
    ``"codebooks"``), a `MultiScaleSTFTDiscriminator` tree (only
    ``"disc_{n_fft}"``) or a `ConditionableTransformer` tree (it has
    ``"ada_norm_w"``); `Model` and `ConditionableTransformer` trees may
    come from ``scan_layers=True``, and a `ConditionableTransformer` may be
    the plain one (``dim_cond_mult=None``: ``attn_norm_{i}`` and its kin in
    place of ``ada_norm_w``). ``fused_wavenet=False`` targets a
    ``Model(use_fused_wavenet=False)``, whose tree must then be unfused.
    Load the result with ``module.load_state_dict(state, strict=True)``.
    """
    keys = set(tree)
    if "model" in keys and not keys & {"wavenet", "codebooks"}:
        out = {f"model.{k}": v
               for k, v in load_jax_params(tree["model"], fused_wavenet).items()}
        if "codec" in tree:
            out.update({f"codec.{k}": v for k, v in load_jax_params(tree["codec"]).items()})
        rest = {k: v for k, v in tree.items() if k not in ("model", "codec")}
        if rest:
            conv = _Converter(rest)
            _conditioning(conv)
            out.update(conv.finish())
        return out
    conv = _Converter(tree)
    if "wavenet" in keys:
        _model(conv, fused_wavenet)
    elif {"encoder", "decoder", "codebooks"} <= keys:
        _encodec(conv)
    elif "codebooks" in keys:
        _codec(conv)
    elif keys and all(k.startswith("disc_") for k in keys):
        _discriminator(conv)
    elif "ada_norm_w" in keys or "to_pred" in keys:
        _conditionable_transformer(conv, "", "")
    else:
        raise ValueError(f"not a Model, Encodec, SoundStream, discriminator, "
                         f"ConditionableTransformer or NaturalSpeech2 tree: keys {sorted(keys)}")
    return conv.finish()
