"""Weights laid out once for the kernels, and the split-TF32 GEMM core's
operand format.

The GEMM core (``csrc/gemm_tf32x3.cuh``) of K1, K1b, K2, K2b, K3 and K6
reads its B operand, a weight (K6: a codebook), from a packed tensor: Bᵀ
padded with zeros to 64-row tiles and 32-column chunks, each element
split into TF32 hi and lo as the kernels
split their operands (flash.cuh: hi = x rounded half away from zero at
mantissa bit 13, lo = x - hi), and each (tile, chunk) laid out as the
K-major core matrices that ``wgmma`` reads, hi then lo. A chunk is then
one contiguous 16 KB run that the kernel copies into shared memory as it
stands. ``pack_b`` builds it and ``unpack_b`` inverts it (hi + lo gives
the weight back exactly).

``cached(name, build, *tensors)`` keeps what ``build`` made from the
tensors (packed, padded or concatenated weights) until one of them changes:
the key is each tensor object and its data pointer (which a move between
devices changes), checked against its version counter, which every
in-place update (an optimizer step, ``copy_``, ``load_state_dict``)
advances. An entry dies with its tensors. So a layer pays for its layout
once, not on every call, and a hit costs a few microseconds of Python.
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


def pack_b(bt: torch.Tensor) -> torch.Tensor:
    """Bᵀ [..., N, K] → [..., N_tiles, K_chunks, 2 (hi, lo), 2048], each Bᵀ
    padded with zeros to 64-row tiles and 32-column chunks (leading dims:
    one packed B each). Element (r, k) of tile j, chunk c lies at ks·512 +
    half·256 + (r // 8)·32 + (r % 8)·4 + k4 with k = 8·ks + 4·half + k4:
    `kmajor<64>` of ``csrc/wgmma.cuh``."""
    *lead, n, k = bt.shape
    bt = torch.nn.functional.pad(bt.to(torch.float32),
                                 (0, round_up(k, CHUNK) - k, 0, round_up(n, TILE_ROWS) - n))
    tiles, chunks = bt.shape[-2] // TILE_ROWS, bt.shape[-1] // CHUNK
    # (j, rg, ri, c, ks, half, k4) -> (j, c, ks, half, rg, ri, k4)
    nl = len(lead)
    t = bt.reshape(*lead, tiles, 8, 8, chunks, 4, 2, 4).permute(
        *range(nl), *(nl + i for i in (0, 3, 4, 5, 1, 2, 6)))
    hi, lo = tf32_split(t)
    return torch.stack([hi.reshape(*lead, tiles, chunks, -1), lo.reshape(*lead, tiles, chunks, -1)],
                       dim=-2)


def unpack_b(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), each the padded Bᵀ [..., N_tiles·64, K_chunks·32] back from
    ``pack_b``'s layout."""
    *lead, tiles, chunks = packed.shape[:-2]
    nl = len(lead)

    def dense(p):
        t = p.reshape(*lead, tiles, chunks, 4, 2, 8, 8, 4).permute(
            *range(nl), *(nl + i for i in (0, 4, 5, 1, 2, 3, 6)))
        return t.reshape(*lead, tiles * TILE_ROWS, chunks * CHUNK)

    return dense(packed[..., 0, :]), dense(packed[..., 1, :])


def cached(name: str, build: Callable, *tensors: torch.Tensor):
    """``build(*tensors)`` under no_grad, made once per ``name`` and
    tensors, and again after any of them changes in place."""
    key = (name, *[(id(t), t.data_ptr()) for t in tensors])
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
