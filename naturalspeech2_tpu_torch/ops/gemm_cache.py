"""Weights laid out once for the kernels, and the split-TF32 GEMM core's
operand format.

The split-TF32 GEMM core (``csrc/gemm_tf32x3.cuh``) of K1, K1b, K2, K2b,
K3 and K6 in f32 reads its B operand, a weight (K6: a codebook), from a packed tensor: Bᵀ
padded with zeros to 64-row tiles and 32-column chunks, each element
split into TF32 hi and lo as the kernels
split their operands (flash.cuh: hi = x rounded half away from zero at
mantissa bit 13, lo = x - hi), and each (tile, chunk) laid out as the
K-major core matrices that ``wgmma`` reads, hi then lo. A chunk is then
one contiguous 16 KB run that the kernel copies into shared memory as it
stands. ``pack_b`` builds it and ``unpack_b`` inverts it (hi + lo gives
the weight back exactly).

``"bf16_sw128"`` (``pack_b(bt, fmt)``) is the operand format of the bf16
GEMM core (``csrc/gemm_bf16.cuh``: K1, K1b, K2, K2b, K3 and K6 in bf16,
the mixed entry points of K1, K1b, K2, K2b and K3, whose f32 operands it
carries as three bf16 parts (``split3``), and K1b's ``bf16_matmul``, whose
f32 weights it rounds to bf16 as it packs them): Bᵀ
[N, K] padded with zeros to multiples of 64 in both, laid out chunk by
chunk as [K / 64, N, 64], each row of a chunk (64 bf16, 128 bytes) in the
128-byte swizzle that ``wgmma`` reads: its 16-byte piece p holds the eight
values of piece p ^ (n % 8). Rows n0 .. n0 + R of a chunk are then one
contiguous run, whatever the kernel's tile width R, that it copies into
shared memory as it stands.

``cached(name, build, *tensors)`` keeps what ``build`` made from the
tensors (packed, padded or concatenated weights) until one of them changes:
the key is each tensor object, its data pointer (which a move between
devices changes) and its dtype, checked against its version counter, which every
in-place update (an optimizer step, ``copy_``, ``load_state_dict``)
advances. An entry dies with its tensors: a weak reference's callback
drops it while the tensor is freed, before its id or its memory can be
handed to a new tensor, so the per-step bf16 copies of AMP training pack
once a step and never hit an entry of an earlier step's copy. So a layer
pays for its layout once, not on every call, and a hit costs a few
microseconds of Python.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

TILE_ROWS = 64    # rows of Bᵀ (columns of C) per tile: wgmma's n
CHUNK = 32        # k per staged chunk: four k-steps of 8

_entries: dict = {}


def round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = x rounded to TF32 half away from zero, on the int32
    view as the kernels do it, and lo = x - hi (exact in f32)."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


# The shape of a chunk's 32 k in the TF32 K-major order: (k-steps, halves,
# values a core-matrix row), and the permutation that takes (tile, row
# group, row, chunk, k-step, half, k) to the packed order (tile, chunk,
# k-step, half, row group, row, k).
_K_SPLIT = (4, 2, 4)
_TO_PACKED = (0, 3, 4, 5, 1, 2, 6)
FORMATS = ("split", "bf16_sw128")
SW128_CHUNK = 64  # k per chunk of the bf16 core, and what it pads N to


def chunk_of(fmt: str) -> int:
    """The k of one chunk of ``fmt``: what K (and a block's inner width)
    is padded to."""
    return SW128_CHUNK if fmt == "bf16_sw128" else CHUNK


def _sw128_index(n: int, device) -> torch.Tensor:
    """[n, 8]: the 16-byte piece of row r that piece p of its packed row
    holds, p ^ (r % 8) (the swizzle is its own inverse)."""
    return torch.arange(8, device=device)[None, :] ^ (torch.arange(n, device=device)[:, None] % 8)


def _pack_sw128(bt: torch.Tensor) -> torch.Tensor:
    *lead, n, k = bt.shape
    bt = torch.nn.functional.pad(bt.to(torch.bfloat16), (0, round_up(k, SW128_CHUNK) - k,
                                                         0, round_up(n, SW128_CHUNK) - n))
    n, k = bt.shape[-2:]
    t = bt.reshape(*lead, n, k // SW128_CHUNK, 8, 8).movedim(-3, -4)  # [..., chunks, n, 8, 8]
    rows = torch.arange(n, device=bt.device)[:, None]
    return t[..., rows, _sw128_index(n, bt.device), :].reshape(*lead, k // SW128_CHUNK, n,
                                                                SW128_CHUNK).contiguous()


def _unpack_sw128(packed: torch.Tensor) -> torch.Tensor:
    *lead, chunks, n, _ = packed.shape
    t = packed.reshape(*lead, chunks, n, 8, 8)
    rows = torch.arange(n, device=packed.device)[:, None]
    t = t[..., rows, _sw128_index(n, packed.device), :]  # [..., chunks, n, 8, 8]
    return t.movedim(-4, -3).reshape(*lead, n, chunks * SW128_CHUNK)


def pack_b(bt: torch.Tensor, fmt: str = "split") -> torch.Tensor:
    """Bᵀ [..., N, K] → [..., N_tiles, K_chunks, parts, 2048], each Bᵀ
    padded with zeros to 64-row tiles and 32-column chunks (leading dims:
    one packed B each). ``fmt`` "split": f32, parts hi and lo; element (r,
    k) of tile j, chunk c lies at ks·512 + half·256 + (r // 8)·32 + (r %
    8)·4 + k4 with k = 8·ks + 4·half + k4: `kmajor<64>` of
    ``csrc/wgmma.cuh``. "bf16_sw128": bf16, [..., K_chunks, N_rows, 64], N
    and K padded to 64 (see the module's docstring)."""
    if fmt not in FORMATS:
        raise ValueError(f"pack_b: fmt must be one of {FORMATS}, got {fmt!r}")
    if fmt == "bf16_sw128":
        return _pack_sw128(bt)
    *lead, n, k = bt.shape
    bt = torch.nn.functional.pad(bt.to(torch.float32),
                                 (0, round_up(k, CHUNK) - k, 0, round_up(n, TILE_ROWS) - n))
    tiles, chunks = bt.shape[-2] // TILE_ROWS, bt.shape[-1] // CHUNK
    nl = len(lead)
    t = bt.reshape(*lead, tiles, 8, 8, chunks, *_K_SPLIT).permute(
        *range(nl), *(nl + i for i in _TO_PACKED))
    hi, lo = tf32_split(t)
    return torch.stack([hi.reshape(*lead, tiles, chunks, -1), lo.reshape(*lead, tiles, chunks, -1)],
                       dim=-2)


# The entry points with a mixed call (f32 activations against bf16
# weights, ``ns2_<entry>_mixed``), all on the bf16 core, their f32 operands
# carried as three bf16 parts.
MIXED_ENTRIES = frozenset({"wavenet_body", "wavenet_lanes", "attn_block", "cross_attn_block",
                           "ff_block"})


def fmt_of(dtype: torch.dtype, weight_dtype: torch.dtype | None = None,
           entry: str | None = None) -> str:
    """The weight format, and so the GEMM core, for a kernel's activation
    dtype and its weights' (default: the same): "split" for f32 (the
    split-TF32 core), "bf16_sw128" for bf16 (the bf16 core), and for f32
    activations against bf16 weights "bf16_sw128" too, for any C ``entry``
    point that has a mixed call (``ns2_<entry>_mixed``: "wavenet_body", K1;
    "wavenet_lanes", K1b; "attn_block", "cross_attn_block", "ff_block");
    another entry raises."""
    if dtype == torch.bfloat16:
        return "bf16_sw128"
    if weight_dtype != torch.bfloat16:
        return "split"
    if entry not in MIXED_ENTRIES:
        raise ValueError(f"fmt_of: mixed operands need one of the entry points "
                         f"{sorted(MIXED_ENTRIES)}, got {entry!r}")
    return "bf16_sw128"


def split3(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hi, mid, lo), bf16 parts of the f32 ``v`` as the bf16 core carries
    an f32 operand (``csrc/gemm_bf16.cuh``: ``split3``): hi = bf16(v), mid
    = bf16(v − hi), lo = bf16(v − hi − mid), each rounded to nearest even;
    lo + mid + hi == v exactly (the differences are exact in f32, and what
    hi and mid leave has at most 8 significant bits)."""
    hi = v.to(torch.bfloat16)
    rest = v - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def parts_product(parts, b: torch.Tensor) -> torch.Tensor:
    """Σ_part part · b in f32 over the bf16 ``parts`` of an f32 operand,
    lo first, as the bf16 core issues them: each part's product with a bf16
    ``b`` is exact in f32, so the sum is the f32 product up to the order of
    its additions."""
    out = 0
    for p in reversed(parts):
        out = out + p.float() @ b.float()
    return out


def unpack_b(packed: torch.Tensor, fmt: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), each the padded Bᵀ [..., N_tiles·64, K_chunks·32] back from
    ``pack_b``'s layout in ``fmt`` (default "split"); "bf16_sw128" gives
    [..., N_rows, K_chunks·64] and lo zeros."""
    if fmt is not None and fmt not in FORMATS:
        raise ValueError(f"unpack_b: fmt must be one of {FORMATS}, got {fmt!r}")
    if fmt == "bf16_sw128":
        hi = _unpack_sw128(packed)
        return hi, torch.zeros_like(hi)
    *lead, tiles, chunks, _ = packed.shape[:-1]
    nl = len(lead)

    def dense(p):
        ks, half, kk = _K_SPLIT
        t = p.reshape(*lead, tiles, chunks, ks, half, 8, 8, kk).permute(
            *range(nl), *(nl + i for i in (0, 4, 5, 1, 2, 3, 6)))
        return t.reshape(*lead, tiles * TILE_ROWS, chunks * CHUNK)

    return dense(packed[..., 0, :]), dense(packed[..., 1, :])


def cached(name: str, build: Callable, *tensors: torch.Tensor):
    """``build(*tensors)`` under no_grad, made once per ``name`` and
    tensors, and again after any of them changes in place."""
    key = (name, *[(id(t), t.data_ptr(), t.dtype) for t in tensors])
    versions = tuple([t._version for t in tensors])
    entry = _entries.get(key)
    if entry is not None and entry[0] == versions:
        return entry[1]
    with torch.no_grad():
        value = build(*tensors)

    def drop(_, key=key):
        _entries.pop(key, None)

    # the weak references drop the entry when a tensor dies, before its id
    # can be reused
    _entries[key] = (versions, value, tuple(weakref.ref(t, drop) for t in tensors))
    return value


def clear() -> None:
    """Forget every cached layout."""
    _entries.clear()
