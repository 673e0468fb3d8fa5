"""EnCodec (twin of `Encodec` in `naturalspeech2_tpu/models/encodec.py`).

SEANet encoder / decoder with Encodec's causal (or split) reflect-padded
convs and a residual LSTM bottleneck, and a Euclidean residual VQ over
``[Q, K, d]`` codebooks (kernel K6). The defaults are
`facebook/encodec_24khz`'s; `utils/torch_import.py:encodec_params_from_hf`
imports its weights. The 48 kHz model's knobs (``norm_type=
"time_group_norm"``, ``causal=False``, stereo, ``normalize``, chunked
encode and overlap-add decode) are here too.

Codec contract (as `SoundStream`): ``forward(audio, return_encoded=True)``
→ (latents [b, n, d] unquantized, codes [b, n, Q], None); ``decode(latents)``
→ audio [b, n·hop]; ``rq(latents, codes)`` → (quantized, cross-entropy).

The convs run channels-first inside; submodules keep the JAX module's
``layer_{i}`` indices, gaps for the ELU and LSTM slots included, so the
JAX tree and a HuggingFace state dict map onto them mechanically. The LSTM
is ``nn.LSTM`` (cuDNN on the card): the JAX module scans it in XLA, no
Pallas kernel. bf16 inputs (AMP codec training) run the convs in bf16 and
the LSTM and GroupNorm in f32 on the bf16 values, rounded once.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from naturalspeech2_tpu_torch.models.blocks import promoted_conv1d
from naturalspeech2_tpu_torch.ops.rvq import rvq_cross_entropy, rvq_quantize, rvq_reference
from naturalspeech2_tpu_torch.utils.helpers import promoted

# flax's GroupNorm eps (torch's default is 1e-5)
GROUP_NORM_EPS = 1e-6
NORM_TYPES = ("weight_norm", "time_group_norm")


def _pad1d(x: torch.Tensor, left: int, right: int, mode: str) -> torch.Tensor:
    """Pad the time axis of ``[b, c, t]``; reflect mode reproduces the HF
    small-input guard: where t ≤ the larger pad, zeros first, then the
    reflection, then the zeros trimmed (``F.pad`` refuses a reflection as
    long as the input)."""
    if left == 0 and right == 0:
        return x
    if mode != "reflect":
        return F.pad(x, (left, right))
    t = x.shape[-1]
    extra = max(left, right) - t + 1 if t <= max(left, right) else 0
    if extra:
        x = F.pad(x, (0, extra))
    x = F.pad(x, (left, right), mode="reflect")
    return x[..., : x.shape[-1] - extra] if extra else x


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm(1 group) over (c, t) in f32 at flax's eps, rounded once to
    the promoted dtype of x and the norm's scale."""
    dtype = promoted(x, norm.weight)[0].dtype
    return F.group_norm(x.float(), 1, norm.weight.float(), norm.bias.float(),
                        GROUP_NORM_EPS).to(dtype)


def _check_norm(norm_type: str) -> None:
    if norm_type not in NORM_TYPES:
        raise ValueError(f"norm_type must be one of {NORM_TYPES}, got {norm_type!r}")


class EncodecConv(nn.Module):
    """Conv1d with Encodec's padding: effective kernel (k−1)·d+1, fixed pad
    k_eff − stride (left when causal, else split with the larger half on the
    left), plus right padding up to the next stride multiple, so the output
    length is ceil(t / stride). Weight norm is fused at import."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, causal: bool = True, pad_mode: str = "reflect",
                 norm_type: str = "weight_norm"):
        super().__init__()
        _check_norm(norm_type)
        self.causal, self.pad_mode = causal, pad_mode
        self.pad_total = (kernel_size - 1) * dilation + 1 - stride
        self.conv = nn.Conv1d(dim_in, dim_out, kernel_size, stride=stride, dilation=dilation)
        self.norm = nn.GroupNorm(1, dim_out, eps=GROUP_NORM_EPS) if norm_type == "time_group_norm" \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stride = self.conv.stride[0]
        extra = (-x.shape[-1]) % stride
        if self.causal:
            left, right = self.pad_total, extra
        else:
            r = self.pad_total // 2
            left, right = self.pad_total - r, r + extra
        x = promoted_conv1d(self.conv, _pad1d(x, left, right, self.pad_mode))
        return x if self.norm is None else _group_norm(self.norm, x)


class EncodecConvTranspose(nn.Module):
    """ConvTranspose1d (output (t−1)·s + k), the optional GroupNorm, then
    Encodec's trim: ceil(pad·trim_right_ratio) on the right when causal,
    else ⌊pad/2⌋, the rest on the left (pad = k − s). The weight holds the
    flax kernel reversed, [in, out, k] (see `params.py`)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int = 1,
                 causal: bool = True, trim_right_ratio: float = 1.0,
                 norm_type: str = "weight_norm"):
        super().__init__()
        _check_norm(norm_type)
        self.conv = nn.ConvTranspose1d(dim_in, dim_out, kernel_size, stride=stride)
        self.norm = nn.GroupNorm(1, dim_out, eps=GROUP_NORM_EPS) if norm_type == "time_group_norm" \
            else None
        pad_total = kernel_size - stride
        self.right = math.ceil(pad_total * trim_right_ratio) if causal else pad_total // 2
        self.left = pad_total - self.right

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = promoted(x, self.conv.weight, self.conv.bias)
        if x.dtype == torch.bfloat16 and x.device.type == "cpu":
            # oneDNN's bf16 conv is not trusted on the CPU (`promoted_conv1d`)
            y = F.conv_transpose1d(x.float(), weight.float(), bias.float(),
                                   self.conv.stride).to(torch.bfloat16)
        else:
            y = F.conv_transpose1d(x, weight, bias, self.conv.stride)
        if self.norm is not None:
            y = _group_norm(self.norm, y)
        return y[..., self.left: y.shape[-1] - self.right]


class EncodecLSTM(nn.Module):
    """Stacked LSTM (gate order i, f, g, o; both biases as given) with one
    residual around the whole stack: x + LSTM(x). Input and output [b, c, t].
    Runs in f32 on the values of bf16 weights or inputs, rounded once."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = [getattr(self.lstm, name) for name in self.lstm._flat_weights_names]
        dtype = promoted(x, weights[0])[0].dtype
        seq = x.transpose(1, 2).float()
        h0 = seq.new_zeros(self.lstm.num_layers, seq.shape[0], self.lstm.hidden_size)
        # torch._VF.lstm is nn.LSTM's own call (cuDNN on the card), here with
        # the weights widened to f32 (a no-op on f32 weights)
        h, _, _ = torch._VF.lstm(seq, (h0, h0), [w.float() for w in weights], True,
                                 self.lstm.num_layers, 0.0, self.training, False, True)
        return x + h.transpose(1, 2).to(dtype)


class EncodecResnetBlock(nn.Module):
    """SEANet residual unit: ELU → conv(k, dilated, dim → dim/compress) →
    ELU → conv(1, → dim), plus a 1×1 conv shortcut."""

    def __init__(self, dim: int, dilation: int, kernel_size: int = 3, compress: int = 2,
                 use_conv_shortcut: bool = True, **conv_kw):
        super().__init__()
        hidden = dim // compress
        self.block_1 = EncodecConv(dim, hidden, kernel_size, dilation=dilation, **conv_kw)
        self.block_3 = EncodecConv(hidden, dim, 1, **conv_kw)
        self.shortcut = EncodecConv(dim, dim, 1, **conv_kw) if use_conv_shortcut else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block_3(F.elu(self.block_1(F.elu(x))))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class _Layers(nn.Module):
    """Submodules ``layer_{i}`` at the torch ModuleList's indices, run in
    order with an ELU at each index left empty."""

    def __init__(self):
        super().__init__()
        self.plan: list[Optional[str]] = []

    def add(self, module: Optional[nn.Module]) -> None:
        """The next index: ``module``, or an ELU slot for None."""
        if module is not None:
            self.add_module(f"layer_{len(self.plan)}", module)
        self.plan.append(None if module is None else f"layer_{len(self.plan)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.plan:
            x = F.elu(x) if name is None else getattr(self, name)(x)
        return x


class EncodecEncoder(_Layers):
    """SEANet encoder: conv(k) → per ratio (reversed) residual units, ELU,
    strided conv (k = 2·ratio, width doubled) → LSTM → ELU → conv to
    ``hidden_size``. [b, C, T] → [b, hidden_size, ceil(T / hop)]."""

    def __init__(self, num_filters: int = 32, upsampling_ratios: Sequence[int] = (8, 5, 4, 2),
                 num_residual_layers: int = 1, hidden_size: int = 128, kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_growth_rate: int = 2, compress: int = 2, causal: bool = True,
                 pad_mode: str = "reflect", num_lstm_layers: int = 2,
                 norm_type: str = "weight_norm", audio_channels: int = 1):
        super().__init__()
        kw = dict(causal=causal, pad_mode=pad_mode, norm_type=norm_type)
        self.add(EncodecConv(audio_channels, num_filters, kernel_size, **kw))
        width = num_filters
        for ratio in reversed(tuple(upsampling_ratios)):
            for j in range(num_residual_layers):
                self.add(EncodecResnetBlock(width, dilation_growth_rate ** j,
                                            residual_kernel_size, compress, **kw))
            self.add(None)
            self.add(EncodecConv(width, width * 2, ratio * 2, stride=ratio, **kw))
            width *= 2
        self.add(EncodecLSTM(width, num_lstm_layers))
        self.add(None)
        self.add(EncodecConv(width, hidden_size, last_kernel_size, **kw))


class EncodecDecoder(_Layers):
    """SEANet decoder, the encoder's mirror: conv(k) → LSTM → per ratio ELU,
    transposed conv (×ratio, width halved), residual units → ELU → conv to
    ``audio_channels``. [b, hidden_size, n] → [b, C, n · hop]."""

    def __init__(self, num_filters: int = 32, upsampling_ratios: Sequence[int] = (8, 5, 4, 2),
                 num_residual_layers: int = 1, hidden_size: int = 128, kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_growth_rate: int = 2, compress: int = 2, causal: bool = True,
                 pad_mode: str = "reflect", trim_right_ratio: float = 1.0,
                 num_lstm_layers: int = 2, audio_channels: int = 1,
                 norm_type: str = "weight_norm"):
        super().__init__()
        kw = dict(causal=causal, pad_mode=pad_mode, norm_type=norm_type)
        width = num_filters * 2 ** len(tuple(upsampling_ratios))
        self.add(EncodecConv(hidden_size, width, kernel_size, **kw))
        self.add(EncodecLSTM(width, num_lstm_layers))
        for ratio in upsampling_ratios:
            self.add(None)
            self.add(EncodecConvTranspose(width, width // 2, ratio * 2, stride=ratio, causal=causal,
                                          trim_right_ratio=trim_right_ratio, norm_type=norm_type))
            width //= 2
            for j in range(num_residual_layers):
                self.add(EncodecResnetBlock(width, dilation_growth_rate ** j,
                                            residual_kernel_size, compress, **kw))
        self.add(None)
        self.add(EncodecConv(width, audio_channels, last_kernel_size, **kw))


class Encodec(nn.Module):
    """EnCodec with the codec contract; defaults are `facebook/encodec_24khz`
    at 6 kbps (8 codebooks). ``latents`` are the unquantized encoder
    outputs; ``decode`` runs the decoder on latents as given (``quantize=
    True`` snaps them through the codebooks first). With ``use_pallas_rvq``
    the quantizer is K6 (``rvq_quantize``); without it the twin of
    ``rvq_xla`` with the same explicit straight-through as the JAX module.
    Audio is [b, T] mono or [b, C, T] at ``target_sample_hz``."""

    def __init__(
        self,
        codebook_dim: int = 128,
        num_filters: int = 32,
        upsampling_ratios: Sequence[int] = (8, 5, 4, 2),
        num_residual_layers: int = 1,
        num_quantizers: int = 8,
        codebook_size: int = 1024,
        target_sample_hz: int = 24000,
        kernel_size: int = 7,
        last_kernel_size: int = 7,
        residual_kernel_size: int = 3,
        dilation_growth_rate: int = 2,
        compress: int = 2,
        causal: bool = True,
        pad_mode: str = "reflect",
        trim_right_ratio: float = 1.0,
        num_lstm_layers: int = 2,
        use_pallas_rvq: bool = True,
        norm_type: str = "weight_norm",
        audio_channels: int = 1,
        normalize: bool = False,
        chunk_length_s: Optional[float] = None,
        overlap: Optional[float] = None,
    ):
        super().__init__()
        self.codebook_dim = codebook_dim
        self.num_quantizers = num_quantizers
        self.target_sample_hz = target_sample_hz
        self.use_pallas_rvq = use_pallas_rvq
        self.normalize = normalize
        self.chunk_length_s, self.overlap = chunk_length_s, overlap
        self.upsampling_ratios = tuple(upsampling_ratios)
        self.seq_len_multiple_of = math.prod(self.upsampling_ratios)  # the hop
        kw = dict(num_filters=num_filters, upsampling_ratios=self.upsampling_ratios,
                  num_residual_layers=num_residual_layers, hidden_size=codebook_dim,
                  kernel_size=kernel_size, last_kernel_size=last_kernel_size,
                  residual_kernel_size=residual_kernel_size,
                  dilation_growth_rate=dilation_growth_rate, compress=compress, causal=causal,
                  pad_mode=pad_mode, num_lstm_layers=num_lstm_layers, norm_type=norm_type,
                  audio_channels=audio_channels)
        self.encoder = EncodecEncoder(**kw)
        self.decoder = EncodecDecoder(trim_right_ratio=trim_right_ratio, **kw)
        self.codebooks = nn.Parameter(torch.randn(num_quantizers, codebook_size, codebook_dim))

    @property
    def chunk_length(self) -> Optional[int]:
        """Samples per chunk (a hop multiple), or None unchunked."""
        if self.chunk_length_s is None:
            return None
        hop = self.seq_len_multiple_of
        return int(self.chunk_length_s * self.target_sample_hz) // hop * hop

    @property
    def chunk_stride(self) -> Optional[int]:
        if self.chunk_length is None:
            return None
        return max(1, int((1.0 - (self.overlap or 0.0)) * self.chunk_length))

    @staticmethod
    def _channels_first(audio: torch.Tensor) -> torch.Tensor:
        """[b, T] mono or [b, C, T] → [b, C, T]."""
        return audio[:, None, :] if audio.ndim == 2 else audio

    def encode_latents(self, audio: torch.Tensor) -> torch.Tensor:
        """audio [b, T] or [b, C, T] → unquantized latents [b, ceil(T / hop), d]."""
        return self.encoder(self._channels_first(audio)).transpose(1, 2)

    def quantize(self, latents: torch.Tensor):
        """latents [b, n, d] → (quantized [b, n, d], codes [b, n, Q] int32),
        straight-through to the latents."""
        b, n, d = latents.shape
        flat = latents.reshape(b * n, d).contiguous()
        if self.use_pallas_rvq:
            quantized, codes = rvq_quantize(flat, self.codebooks)
        else:
            quantized, codes = rvq_reference(flat, self.codebooks)
            quantized = flat + (quantized - flat).detach()
        return quantized.reshape(b, n, d), codes.reshape(b, n, self.num_quantizers)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [b, n, Q] → Σ_q codebooks[q][codes[..., q]], [b, n, d]."""
        codes = codes.long()
        total = torch.zeros((*codes.shape[:2], self.codebook_dim), dtype=self.codebooks.dtype,
                            device=codes.device)
        for qi in range(self.num_quantizers):
            total = total + self.codebooks[qi][codes[..., qi]]
        return total

    def _decode_channels(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [b, n, d] → audio [b, C, n · hop]."""
        return self.decoder(latents.transpose(1, 2))

    def decode(self, latents: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        """latents [b, n, d] → audio [b, n · hop] (the first channel)."""
        if quantize:
            latents, _ = self.quantize(latents)
        return self._decode_channels(latents)[:, 0]

    def decode_from_codes(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decode(self.dequantize(codes))

    def rq(self, latents: torch.Tensor, codes: torch.Tensor):
        """(quantized, cross-entropy) of the latents against given codes."""
        b, n, d = latents.shape
        ce = rvq_cross_entropy(latents.reshape(b * n, d), self.codebooks, codes.reshape(b * n, -1))
        return self.dequantize(codes), ce

    def forward(self, audio: torch.Tensor, return_encoded: bool = False,
                curtail_from_left: bool = False):
        """Trims T to a hop multiple (from the left for prompts), encodes and
        quantizes. With ``return_encoded``: ``(latents, codes, None)``, the
        latents unquantized; without: the decoded quantized latents."""
        hop = self.seq_len_multiple_of
        t = audio.shape[-1]
        t_use = (t // hop) * hop
        if t_use != t:
            audio = audio[..., t - t_use:] if curtail_from_left else audio[..., :t_use]
        latents = self.encode_latents(audio)
        quantized, codes = self.quantize(latents)
        if return_encoded:
            return latents, codes, None
        return self.decode(quantized)

    # ------------------------------------------------------------------ #
    # chunked / normalized API (the 48 kHz model's encode and decode)
    # ------------------------------------------------------------------ #

    def _encode_frame(self, frame: torch.Tensor):
        """One chunk [b, C, t] → (codes [b, n, Q], scale [b, 1] or None): with
        ``normalize``, divided first by the RMS of its channel mean + 1e-8."""
        scale = None
        if self.normalize:
            mono = frame.sum(dim=1, keepdim=True) / frame.shape[1]
            scale = torch.sqrt((mono**2).mean(dim=2)) + 1e-8  # [b, 1]
            frame = frame / scale[:, :, None]
        _, codes = self.quantize(self.encoder(frame).transpose(1, 2))
        return codes, scale

    def encode_chunked(self, audio: torch.Tensor):
        """audio [b, T] or [b, C, T] → (codes [F, b, n, Q], scales (F entries,
        [b, 1] or None), last_frame_pad_length). Chunks of ``chunk_length``
        at ``chunk_stride`` (one chunk when unset), a partial last chunk
        included, its codes zero-padded to the full frame length."""
        x = self._channels_first(audio)
        t = x.shape[-1]
        chunk, stride = self.chunk_length or t, self.chunk_stride or t
        frames, scales = [], []
        for off in range(0, t, stride):
            codes, scale = self._encode_frame(x[..., off: off + chunk])
            frames.append(codes)
            scales.append(scale)
        last_pad = frames[0].shape[1] - frames[-1].shape[1]
        if last_pad:
            frames[-1] = F.pad(frames[-1], (0, 0, 0, last_pad))
        return torch.stack(frames), scales, last_pad

    def decode_chunked(self, codes: torch.Tensor, scales=None,
                       last_frame_pad_length: int = 0) -> torch.Tensor:
        """(codes [F, b, n, Q], scales) → waveform [b, C, T]: each frame
        decoded (the last one's padding dropped) and scaled, then a linear
        overlap-add with triangular weights at ``chunk_stride``."""
        outs = []
        for f in range(codes.shape[0]):
            frame = codes[f]
            if f == codes.shape[0] - 1 and last_frame_pad_length > 0:
                frame = frame[:, :-last_frame_pad_length]
            wav = self._decode_channels(self.dequantize(frame))
            if scales is not None and scales[f] is not None:
                wav = wav * scales[f][:, :, None]
            outs.append(wav)
        if len(outs) == 1:
            return outs[0]
        stride = self.chunk_stride or self.seq_len_multiple_of
        t_frame = outs[0].shape[-1]
        total = stride * (len(outs) - 1) + outs[-1].shape[-1]
        tvec = torch.linspace(0.0, 1.0, t_frame + 2, device=codes.device)[1:-1]
        weight = 0.5 - (tvec - 0.5).abs()
        acc = outs[0].new_zeros((*outs[0].shape[:2], total))
        norm = weight.new_zeros(total)
        for i, wav in enumerate(outs):
            tl, off = wav.shape[-1], i * stride
            acc[..., off: off + tl] += weight[:tl] * wav
            norm[off: off + tl] += weight[:tl]
        return acc / norm
