"""Native audio decoding: WAV, FLAC, MP3 and Ogg/Vorbis → float32 mono, and
a windowed-sinc resampler (the port's copy of `native/audioio.cpp`, bound
with ctypes as `naturalspeech2_tpu/native/audioio.py` binds it).

``audioio.cpp`` beside this file is compiled with g++ at first use into
``naturalspeech2_tpu_torch/_build/libaudioio_<hash>.so`` (git ignores it);
the hash covers the source and the flags, so an edited source is rebuilt.
Nothing is compiled at import. MP3 and Ogg decode through ``dlopen`` of
``libmpg123.so.0`` and ``libvorbisfile.so.3``; a host without them gets a
``ValueError`` naming the library when it reads such a file. A decoder
that cannot be built (no source beside this file, no g++, a failed
compile) raises `DecoderUnavailable`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "audioio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-ldl",)

# audio_load's error codes (native/audioio.cpp)
ERRORS = {
    -1: "cannot read the file",
    -2: "not a decodable WAV, FLAC, MP3 or Ogg/Vorbis stream",
    -3: "the stream's header names no channels, rate or samples",
    -4: "unsupported WAV sample format",
    -5: "the FLAC stream holds no decodable frame",
    -6: "out of memory",
    -7: "the decoder failed on corrupt input",
    -8: "the codec library (libmpg123.so.0 for MP3, libvorbisfile.so.3 for Ogg) "
        "is not installed on this host",
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class DecoderUnavailable(RuntimeError):
    """The native decoder cannot be built or loaded on this host, so only
    WAV (the Python reader) can be read."""


def _target() -> Path:
    if not SOURCE.is_file():
        raise DecoderUnavailable(f"the decoder's source {SOURCE} is missing")
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libaudioio_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise DecoderUnavailable("g++ not found: the native audio decoder cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / "libaudioio.so"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE), *LIBS],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise DecoderUnavailable(
                f"g++ failed ({proc.returncode}) on {SOURCE.name}:\n{proc.stdout}")
        os.replace(lib, target)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The decoder library, built from ``audioio.cpp`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _compile(target)
            try:
                lib = ctypes.CDLL(str(target))
            except OSError as e:
                raise DecoderUnavailable(f"cannot load {target}: {e}") from e
            lib.audio_load.restype = ctypes.c_int
            lib.audio_load.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.audio_resample.restype = ctypes.c_int
            lib.audio_resample.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.audio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        return _lib


def _take(lib: ctypes.CDLL, ptr, length: int) -> np.ndarray:
    try:
        return np.ctypeslib.as_array(ptr, shape=(length,)).copy()
    finally:
        lib.audio_free(ptr)


def load(path) -> Tuple[np.ndarray, int]:
    """Decode a WAV, FLAC, MP3 or Ogg/Vorbis file (the container sniffed from
    its first bytes) → (float32 mono in [-1, 1], sample rate); raises
    ValueError naming the failure, `DecoderUnavailable` where the decoder
    cannot be built."""
    lib = library()
    samples = ctypes.POINTER(ctypes.c_float)()
    length = ctypes.c_int64()
    sr = ctypes.c_int()
    rc = lib.audio_load(os.fsencode(path), ctypes.byref(samples), ctypes.byref(length),
                        ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"cannot decode {path}: {ERRORS.get(rc, 'decoder error')} (code {rc})")
    return _take(lib, samples, length.value), sr.value


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Windowed-sinc (Blackman) resampling, 32 taps per output sample."""
    lib = library()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    out_len = ctypes.c_int64()
    rc = lib.audio_resample(audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(audio),
                            sr_in, sr_out, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"audio_resample failed with code {rc}")
    return _take(lib, out, out_len.value)
