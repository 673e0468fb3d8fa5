"""Builds the port's CUDA kernels at first use and binds them with ctypes.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface. The library's file name carries
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded from ``_build/`` (listed in .gitignore). Nothing
here runs at import: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float
# the flash kernels' scale and dropout arguments: scale, seed words, rate,
# counter stride, keep threshold, keep scale, batch and head offsets
_FLASH_TAIL = [_F, _U, _U, _F, _I, _U, _F, _I, _I, _P]
# C signature of every entry point: pointers and the stream as c_void_p
# (ctypes would otherwise pass 32-bit ints and cut them), sizes as c_int.
# A bf16 entry point is a symbol of its own (``<name>_bf16``), and so is
# a mixed one (``<name>_mixed``: f32 activations against bf16 weights), so
# that a call can never reach a kernel of other operand types.
SIGNATURES = {
    "ns2_wavenet_body": [_P] * 10 + [_I] * 5 + [_P],
    "ns2_wavenet_body_bf16": [_P] * 10 + [_I] * 5 + [_P],
    "ns2_wavenet_body_mixed": [_P] * 11 + [_I] * 5 + [_P],
    "ns2_wavenet_lanes": [_P] * 10 + [_I] * 5 + [_P],
    "ns2_wavenet_lanes_bf16": [_P] * 11 + [_I] * 5 + [_P],
    "ns2_wavenet_lanes_mixed": [_P] * 11 + [_I] * 5 + [_P],
    "ns2_wavenet_lanes_bf16mm": [_P] * 11 + [_I] * 5 + [_P],
    "ns2_attn_block": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    "ns2_attn_block_bf16": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    "ns2_attn_block_mixed": [_P] * 9 + [_I] * 5 + [_F, _I, _P],
    "ns2_cross_attn_block": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
    "ns2_cross_attn_block_bf16": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
    "ns2_cross_attn_block_mixed": [_P] * 12 + [_I] * 7 + [_F, _I, _P],
    "ns2_ff_block": [_P] * 13 + [_I] * 4 + [_P],
    "ns2_ff_block_bf16": [_P] * 13 + [_I] * 4 + [_P],
    "ns2_ff_block_mixed": [_P] * 13 + [_I] * 4 + [_P],
    "ns2_flash_fwd": [_P] * 6 + [_I] * 6 + _FLASH_TAIL,
    "ns2_flash_fwd_bf16": [_P] * 6 + [_I] * 6 + _FLASH_TAIL,
    "ns2_flash_bwd": [_P] * 10 + [_I] * 6 + _FLASH_TAIL,
    "ns2_flash_bwd_bf16": [_P] * 10 + [_I] * 6 + _FLASH_TAIL,
    "ns2_rvq": [_P] * 8 + [_I] * 4 + [_P],
    "ns2_rvq_bf16": [_P] * 10 + [_I] * 4 + [_P],
}
# The kernels' (activation, weight) types, and the suffix of their entry
# points: f32, bf16, and f32 activations against bf16 weights (what AMP
# training runs where JAX promotes f32 activations against bf16 weights).
KERNEL_DTYPES = {
    (torch.float32, torch.float32): "",
    (torch.bfloat16, torch.bfloat16): "_bf16",
    (torch.float32, torch.bfloat16): "_mixed",
}
# The launch counter of each kind of entry point on a wrapper.
COUNTERS = {"": "launches", "_bf16": "launches_bf16", "_mixed": "launches_mixed"}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last nvcc run, if any
build_log = ""  # nvcc's output of that run: ptxas registers, spills, shared memory


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _run_all(cmds: list[list[str]]) -> list[tuple[int, str]]:
    """Run the commands in parallel; (return code, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outputs = [p.communicate(timeout=900)[0] for p in procs]
        return [(p.returncode, out) for p, out in zip(procs, outputs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _compile(target: Path) -> None:
    global build_seconds, build_log
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = sorted(CSRC.glob("*.cu"))
        objects = [str(Path(tmp) / f"{u.stem}.o") for u in units]
        start = time.perf_counter()
        compiled = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(u)]
                             for u, o in zip(units, objects)])
        build_log = "".join(out for _, out in compiled)
        failed = [u.name for u, (rc, _) in zip(units, compiled) if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        lib = str(Path(tmp) / "lib.so")
        (rc, out), = _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]])
        build_seconds = time.perf_counter() - start
        build_log += out
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{out}")
        os.replace(lib, target)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"ns2_kernels_{_digest()}.so"
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ns2_error_name.argtypes = [ctypes.c_int]
            lib.ns2_error_name.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        err_name = library().ns2_error_name(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({err_name})")


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, dtype: torch.dtype = torch.float32,
                 **tensors: torch.Tensor) -> torch.device:
    """Check that every tensor is a contiguous ``dtype`` tensor on one CUDA
    device; return that device. ``dtype`` is float32 or bfloat16. A kernel
    with a mixed entry point checks its activations at their dtype and its
    weights at theirs, in two calls."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernels take float32 or bfloat16, not {dtype}")
    device = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected a CUDA device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, other inputs on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}; the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    return device


def suffix(name: str, dtype: torch.dtype, weight_dtype: torch.dtype | None = None) -> str:
    """The entry-point suffix for activations of ``dtype`` against weights
    of ``weight_dtype`` (default: ``dtype``); raises for a pair no kernel
    takes."""
    key = (dtype, dtype if weight_dtype is None else weight_dtype)
    if key not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernels take float32 or bfloat16 activations against "
                        f"weights of the same type, or float32 against bfloat16; got {key}")
    return KERNEL_DTYPES[key]


def entry(name: str, dtype: torch.dtype, weight_dtype: torch.dtype | None = None):
    """The entry point ``name`` for activations of ``dtype`` against weights
    of ``weight_dtype`` (``<name>_bf16`` for bf16, ``<name>_mixed`` for f32
    against bf16)."""
    return getattr(library(), name + suffix(name, dtype, weight_dtype))


def count(wrapper, dtype: torch.dtype, weight_dtype: torch.dtype | None = None) -> None:
    """One launch of ``wrapper``'s kernel through its entry point for those
    types: ``wrapper.launches``, ``launches_bf16`` or ``launches_mixed``."""
    attr = COUNTERS[suffix(wrapper.__name__, dtype, weight_dtype)]
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def require_shapes(name: str, **pairs: tuple[torch.Tensor, tuple[int, ...]]) -> None:
    """Check ``tensor.shape == shape`` for every ``arg=(tensor, shape)``."""
    for arg, (t, shape) in pairs.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
