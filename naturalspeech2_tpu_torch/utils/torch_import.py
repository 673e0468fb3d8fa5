"""Import reference (lucidrains/naturalspeech2-pytorch) torch checkpoints
and HuggingFace Encodec weights (the port's copy of
`naturalspeech2_tpu/utils/torch_import.py`, numpy only in its mappers).

Every mapper returns the JAX package's parameter tree as nested dicts of
numpy arrays, array for array what the JAX package's importer returns on
the same state dict; ``params.load_jax_params`` turns such a tree into the
port's state dict. Structure (depth, stack / layer counts, conditioning)
is inferred from the state dict's keys. Layouts of the reference modules:
Model :811-1000, Wavenet :597-725, ConditionableTransformer :748-809,
PerceiverResampler :532-579, PhonemeEncoder :228-287, SpeechPromptEncoder
:289-341, DurationPitchPredictor :412-527, Transformer :1073-1115 of
``naturalspeech2_pytorch.py``, and aligner.py AlignerNet :17-81.

Checkpoints are read with ``torch.load(weights_only=True)``, which
rebuilds tensors and plain containers and refuses any other global (no
arbitrary code runs); nested dicts are flattened with dotted keys and bf16
tensors widened to f32 (exactly).

Layout rules (inverse of torch's):
  torch Linear weight [out, in]   -> Dense kernel [in, out]
  torch Conv1d weight [out,in,k]  -> Conv kernel [k, in, out]
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = [
    "load_torch_checkpoint",
    "model_params_from_torch",
    "phoneme_encoder_params_from_torch",
    "speech_prompt_encoder_params_from_torch",
    "duration_pitch_predictor_params_from_torch",
    "aligner_net_params_from_torch",
    "naturalspeech2_params_from_torch",
    "encodec_params_from_hf",
]


def load_torch_checkpoint(path) -> Dict[str, np.ndarray]:
    """Read a ``torch.save`` checkpoint into ``{name: numpy array}``: nested
    dicts flattened (``{"model": sd}`` → ``model.*``), bf16 widened to f32.
    Raises ``pickle.UnpicklingError`` on a global other than a tensor's or
    a plain container's."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in _flatten_state_dict(obj).items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            v = v.float() if v.dtype == torch.bfloat16 else v
            out[k] = v.numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _flatten_state_dict(obj, prefix="") -> Dict[str, Any]:
    """Flatten possibly-nested checkpoint dicts ({'model': sd, ...})."""
    out = {}
    if isinstance(obj, Mapping):
        for k, v in obj.items():
            if isinstance(v, Mapping):
                out.update(_flatten_state_dict(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
    return out


# --------------------------------------------------------------------- #
# state_dict -> JAX param tree converters
# --------------------------------------------------------------------- #


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _lin(sd, name):
    p = {"kernel": _np(sd[f"{name}.weight"]).T.copy()}
    if f"{name}.bias" in sd:
        p["bias"] = _np(sd[f"{name}.bias"])
    return p


def _conv(sd, name):
    p = {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 1, 0).copy()}
    if f"{name}.bias" in sd:
        p["bias"] = _np(sd[f"{name}.bias"])
    return p


def _attn(sd, name):
    return {
        "to_q": _lin(sd, f"{name}.to_q"),
        "to_kv": _lin(sd, f"{name}.to_kv"),
        "to_out": _lin(sd, f"{name}.to_out"),
    }


def _ff(sd, name, causal_conv):
    p = {"Dense_0": _lin(sd, f"{name}.0")}
    if causal_conv:
        p["CausalConv1d_0"] = {"Conv_0": _conv(sd, f"{name}.2.1")}
        p["Dense_1"] = _lin(sd, f"{name}.3")
    else:
        p["Dense_1"] = _lin(sd, f"{name}.2")
    return p


def _sub(sd, prefix) -> Dict[str, Any]:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


def _count(sd, pattern) -> int:
    rx = re.compile(pattern)
    idx = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    return (max(idx) + 1) if idx else 0


def _wavenet(sd):
    stacks = _count(sd, r"stacks\.(\d+)\.")
    p = {
        "init_conv": {"Conv_0": _conv(sd, "init_conv")},
        "final_conv": {"Conv_0": _conv(sd, "final_conv")},
    }
    for s in range(stacks):
        layers = _count(sd, rf"stacks\.{s}\.blocks\.(\d+)\.")
        blocks = {}
        for l in range(layers):
            base = f"stacks.{s}.blocks.{l}"
            bp = {
                "to_time_cond": _lin(sd, f"{base}.to_time_cond"),
                "conv": {"Conv_0": _conv(sd, f"{base}.conv")},
                "res_conv": {"Conv_0": _conv(sd, f"{base}.res_conv")},
            }
            if f"{base}.skip_conv.weight" in sd:
                bp["skip_conv"] = {"Conv_0": _conv(sd, f"{base}.skip_conv")}
            blocks[f"block_{l}"] = bp
        p[f"stack_{s}"] = blocks
    return p


def _conditionable_transformer(sd):
    depth = _count(sd, r"layers\.(\d+)\.")
    cross = "layers.0.3.to_q.weight" in sd
    order = ("attn", "cross", "ff") if cross else ("attn", "ff")
    slots = {"attn": 0, "cross": 2, "ff": 4}
    ada_w, ada_b = [], []
    p = {}
    for i in range(depth):
        for which in order:
            name = f"layers.{i}.{slots[which]}.to_gamma_beta"
            ada_w.append(_np(sd[f"{name}.weight"]).T)
            ada_b.append(_np(sd[f"{name}.bias"]))
        p[f"attn_{i}"] = _attn(sd, f"layers.{i}.1")
        if cross:
            p[f"cross_attn_{i}"] = _attn(sd, f"layers.{i}.3")
        p[f"ff_{i}"] = _ff(sd, f"layers.{i}.5", causal_conv=True)
    p["ada_norm_w"] = np.stack(ada_w)
    p["ada_norm_b"] = np.stack(ada_b)
    p["pred_norm"] = {"gamma": _np(sd["to_pred.0.gamma"])}
    p["to_pred"] = {"kernel": _np(sd["to_pred.1.weight"]).T.copy()}
    return p


def _plain_transformer(sd):
    depth = _count(sd, r"layers\.(\d+)\.")
    p = {}
    for i in range(depth):
        p[f"attn_norm_{i}"] = {"gamma": _np(sd[f"layers.{i}.0.gamma"])}
        p[f"attn_{i}"] = _attn(sd, f"layers.{i}.1")
        p[f"ff_norm_{i}"] = {"gamma": _np(sd[f"layers.{i}.2.gamma"])}
        p[f"ff_{i}"] = _ff(sd, f"layers.{i}.3", causal_conv=False)
    return p


def _perceiver(sd):
    depth = _count(sd, r"layers\.(\d+)\.")
    p = {
        "latents": _np(sd["latents"]),
        "proj_context": _lin(sd, "proj_context"),
        "norm": {"gamma": _np(sd["norm.gamma"])},
    }
    for i in range(depth):
        p[f"attn_{i}"] = _attn(sd, f"layers.{i}.0")
        p[f"ff_{i}"] = _ff(sd, f"layers.{i}.1", causal_conv=False)
    return p


def model_params_from_torch(sd) -> Dict[str, Any]:
    """Reference ``Model`` (:811-1000) state_dict -> JAX
    ``models.denoiser.Model`` param tree.  Conditioning is inferred from
    the presence of the null-prompt parameters."""
    sd = {k: v for k, v in sd.items()}
    p = {
        "time_pos_emb": {"weights": _np(sd["to_time_cond.0.weights"])},
        "to_time_hidden": _lin(sd, "to_time_cond.1"),
        "wavenet": _wavenet(_sub(sd, "wavenet.")),
        "transformer": _conditionable_transformer(_sub(sd, "transformer.")),
    }
    if "null_prompt_cond" in sd:
        p["null_prompt_cond"] = _np(sd["null_prompt_cond"])
        p["null_prompt_tokens"] = _np(sd["null_prompt_tokens"])
        p["null_cond"] = _np(sd["null_cond"]).reshape(-1)
        p["to_prompt_cond"] = _lin(sd, "to_prompt_cond.1")
        p["perceiver_resampler"] = _perceiver(
            _sub(sd, "perceiver_resampler.")
        )
        w = _np(sd["cond_to_model_dim.weight"])  # [out, in, 1]
        p["cond_to_model_dim"] = {
            "kernel": w[:, :, 0].T.copy(),
            "bias": _np(sd["cond_to_model_dim.bias"]),
        }
    return p


# --------------------------------------------------------------------- #
# HuggingFace Encodec (facebook/encodec_24khz) -> models.encodec.Encodec
# --------------------------------------------------------------------- #


def _wn_weight(sd, base):
    """Resolve a possibly weight-normed torch conv weight: plain
    ``.weight``, legacy ``.weight_g``/``.weight_v``, or parametrized
    ``.parametrizations.weight.original0/1``. Weight-norm is fused at
    import (``g · v / ‖v‖``, norm over all dims but 0 — torch dim=0)."""
    if f"{base}.weight" in sd:
        return _np(sd[f"{base}.weight"])
    if f"{base}.weight_v" in sd:
        v, g = _np(sd[f"{base}.weight_v"]), _np(sd[f"{base}.weight_g"])
    else:
        v = _np(sd[f"{base}.parametrizations.weight.original1"])
        g = _np(sd[f"{base}.parametrizations.weight.original0"])
    norm = np.sqrt(
        (v.astype(np.float64) ** 2).sum(
            axis=tuple(range(1, v.ndim)), keepdims=True
        )
    )
    return (g * v / norm).astype(v.dtype)


def _enc_conv(sd, base, transposed=False):
    """EncodecConv1d/-Transpose1d module subtree (``{base}.conv.*`` plus
    optional ``{base}.norm.*`` GroupNorm for the time_group_norm models)
    -> JAX {"conv": ..., ["norm": ...]}."""
    conv_base = f"{base}.conv" if base else "conv"
    w = _wn_weight(sd, conv_base)
    if transposed:
        # torch ConvTranspose1d [in, out, k] -> JAX ConvTranspose kernel
        # [k, in, out], spatially flipped (lax.conv_transpose correlates
        # with the kernel as given; torch's adjoint flips it)
        kernel = w.transpose(2, 0, 1)[::-1].copy()
    else:
        kernel = w.transpose(2, 1, 0).copy()
    p = {"conv": {"kernel": kernel}}
    if f"{conv_base}.bias" in sd:
        p["conv"]["bias"] = _np(sd[f"{conv_base}.bias"])
    norm_base = f"{base}.norm" if base else "norm"
    if f"{norm_base}.weight" in sd:
        p["norm"] = {
            "scale": _np(sd[f"{norm_base}.weight"]),
            "bias": _np(sd[f"{norm_base}.bias"]),
        }
    return p


def _enc_lstm(sd, base):
    p = {}
    layer = 0
    while f"{base}.weight_ih_l{layer}" in sd:
        p[f"w_ih_{layer}"] = _np(sd[f"{base}.weight_ih_l{layer}"]).T.copy()
        p[f"w_hh_{layer}"] = _np(sd[f"{base}.weight_hh_l{layer}"]).T.copy()
        p[f"b_ih_{layer}"] = _np(sd[f"{base}.bias_ih_l{layer}"])
        p[f"b_hh_{layer}"] = _np(sd[f"{base}.bias_hh_l{layer}"])
        layer += 1
    return p


def _enc_resnet(sd, prefix):
    p = {
        "block_1": _enc_conv(sd, f"{prefix}block.1"),
        "block_3": _enc_conv(sd, f"{prefix}block.3"),
    }
    if any(k.startswith(f"{prefix}shortcut.") for k in sd):
        p["shortcut"] = _enc_conv(sd, f"{prefix}shortcut")
    return p


def encodec_params_from_hf(
    sd, num_quantizers: int = 8, upsampling_ratios=(8, 5, 4, 2),
    num_residual_layers: int = 1,
) -> Dict[str, Any]:
    """`transformers.EncodecModel` state_dict (e.g. `facebook/encodec_24khz`)
    -> JAX `models.encodec.Encodec` param tree.

    ``num_quantizers`` selects the first Q codebooks (8 ⇒ 6 kbps at the
    24 kHz model's 75 Hz frame rate, the bandwidth the reference's
    `EncodecWrapper` uses); the checkpoint carries 32.
    """
    sd = {k: v for k, v in sd.items()}
    if any(k.startswith("encodec.") for k in sd):  # nested under a head
        sd = _sub(sd, "encodec.")

    n_up = len(tuple(upsampling_ratios))
    # decoder ModuleList indices occupied by ConvTranspose1d: conv0, lstm1,
    # then per ratio [ELU, ConvTranspose, resnet×R]
    tconv_idx = {
        2 + r * (2 + num_residual_layers) + 1 for r in range(n_up)
    }

    out: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    for mod in ("encoder", "decoder"):
        sub = _sub(sd, f"{mod}.layers.")
        for i in sorted({int(k.split(".")[0]) for k in sub}):
            prefix = f"{i}."
            lsub = _sub(sub, prefix)
            name = f"layer_{i}"
            if any(k.startswith("lstm.") for k in lsub):
                out[mod][name] = _enc_lstm(lsub, "lstm")
            elif any(k.startswith("block.") for k in lsub):
                out[mod][name] = _enc_resnet(lsub, "")
            else:
                transposed = mod == "decoder" and i in tconv_idx
                out[mod][name] = _enc_conv(lsub, "", transposed=transposed)

    embeds = []
    for q in range(num_quantizers):
        embeds.append(_np(sd[f"quantizer.layers.{q}.codebook.embed"]))
    out["codebooks"] = np.stack(embeds)
    return out


def phoneme_encoder_params_from_torch(sd) -> Dict[str, Any]:
    """Reference ``PhonemeEncoder`` (:228-287) -> JAX param tree."""
    return {
        "token_emb": {"embedding": _np(sd["token_emb.weight"])},
        "conv": {"Conv_0": _conv(sd, "conv.1")},
        "transformer": _plain_transformer(_sub(sd, "transformer.")),
    }


def speech_prompt_encoder_params_from_torch(sd) -> Dict[str, Any]:
    """Reference ``SpeechPromptEncoder`` (:289-341) -> JAX param tree."""
    p = {"transformer": _plain_transformer(_sub(sd, "transformer."))}
    rx = re.compile(r"conv\.(\d+)\.weight")
    conv_idx = sorted(int(m.group(1)) for k in sd if (m := rx.match(k)))
    for i, ci in enumerate(conv_idx):
        p[f"conv_{i}"] = _conv(sd, f"conv.{ci}")
    return p


def _dp_trunk(sd):
    depth = _count(sd, r"layers\.(\d+)\.")
    p = {}
    for i in range(depth):
        j = 0
        while f"layers.{i}.0.{j}.blocks.0.proj.weight" in sd:
            units = {}
            u = 0
            while f"layers.{i}.0.{j}.blocks.{u}.proj.weight" in sd:
                base = f"layers.{i}.0.{j}.blocks.{u}"
                units[f"ConvUnit_{u}"] = {
                    "Conv_0": _conv(sd, f"{base}.proj"),
                    "GroupNorm_0": {
                        "scale": _np(sd[f"{base}.norm.weight"]),
                        "bias": _np(sd[f"{base}.norm.bias"]),
                    },
                }
                u += 1
            p[f"conv_{i}_{j}"] = units
            j += 1
        p[f"norm_{i}"] = {"gamma": _np(sd[f"layers.{i}.1.gamma"])}
        p[f"attn_{i}"] = _attn(sd, f"layers.{i}.2")
    p["to_pred"] = _lin(sd, "to_pred.0")
    return p


def duration_pitch_predictor_params_from_torch(sd) -> Dict[str, Any]:
    """Reference ``DurationPitchPredictor`` (:468-527) -> JAX tree."""
    return {
        "to_duration_pred": _dp_trunk(_sub(sd, "to_duration_pred.")),
        "to_pitch_pred": _dp_trunk(_sub(sd, "to_pitch_pred.")),
    }


def aligner_net_params_from_torch(sd) -> Dict[str, Any]:
    """Reference ``AlignerNet`` (aligner.py:17-81) -> JAX tree."""
    return {
        "key_conv1": _conv(sd, "key_layers.0"),
        "key_conv2": _conv(sd, "key_layers.2"),
        "query_conv1": _conv(sd, "query_layers.0"),
        "query_conv2": _conv(sd, "query_layers.2"),
        "query_conv3": _conv(sd, "query_layers.4"),
    }


def naturalspeech2_params_from_torch(sd) -> Dict[str, Any]:
    """Full reference ``NaturalSpeech2`` state_dict -> JAX
    ``models.naturalspeech2.NaturalSpeech2`` param tree (conditional
    sub-modules included only when present in the checkpoint)."""
    sd = {k: v for k, v in sd.items()}
    p = {"model": model_params_from_torch(_sub(sd, "model."))}
    if "phoneme_enc.token_emb.weight" in sd:
        p["phoneme_enc"] = phoneme_encoder_params_from_torch(
            _sub(sd, "phoneme_enc.")
        )
        p["prompt_enc"] = speech_prompt_encoder_params_from_torch(
            _sub(sd, "prompt_enc.")
        )
        p["duration_pitch"] = duration_pitch_predictor_params_from_torch(
            _sub(sd, "duration_pitch.")
        )
        p["aligner"] = {
            "aligner": aligner_net_params_from_torch(
                _sub(sd, "aligner.aligner.")
            )
        }
        p["pitch_emb"] = {"embedding": _np(sd["pitch_emb.weight"])}
    return p
