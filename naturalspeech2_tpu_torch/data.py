"""Host-side audio data (twin of `naturalspeech2_tpu/data.py` and of
`write_wav` in `naturalspeech2_tpu/trainer.py`).

A folder of audio files → load → resample to the codec rate → random crop
to ``max_length`` → trim to a multiple of the hop → fixed-shape float32
numpy batches. The crop and shuffle draws use the same
``random.Random(seed)`` streams as the JAX package, so both give the same
batches for the same folder and seed. WAV is read in Python (scipy, else
the ``wave`` module) from a file or from bytes (`decode_audio_bytes`);
FLAC, MP3 and Ogg/Vorbis go to the native decoder (`native/audioio.py`,
built with g++ at first use). Divergence from the JAX loader, which
decodes WAV natively too: PCM16 WAV is scaled by 32767 here (its Python
fallback's scale) and by 32768 there, so that one WAV file gives one
scale in the port; FLAC keeps the native 32768.
"""

from __future__ import annotations

import io
import os
import queue
import random
import tempfile
import threading
import wave
import zlib
from math import gcd
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

# the extensions the JAX package lists, so both see the same files
AUDIO_EXTS = (".wav", ".flac", ".mp3", ".ogg")


def pcm16(audio: np.ndarray) -> bytes:
    """Float audio in [-1, 1] → little-endian 16-bit PCM, clipped, ×32767."""
    return (np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def write_wav(target, audio: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1, 1] audio as 16-bit WAV; ``target`` is a path
    or a binary file."""
    if isinstance(target, (str, os.PathLike)):
        target = os.fspath(target)
    with wave.open(target, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm16(audio))


def _read_wav(source):
    """A WAV file's samples and rate; ``source`` is a path or a binary file."""
    try:
        from scipy.io import wavfile
    except ImportError:
        wavfile = None
    if wavfile is not None:
        sr, data = wavfile.read(source)
        return np.asarray(data), sr
    with wave.open(source, "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[w.getsampwidth()]
        return np.frombuffer(raw, dtype=dtype).reshape(-1, w.getnchannels()), sr


def _decode_wav(source, name: str) -> tuple[np.ndarray, int]:
    """WAV → (float32 mono in [-1, 1], sample rate); PCM16 is scaled by
    32767, as the JAX package's fallback reader scales it."""
    try:
        data, sr = _read_wav(source)
    except (ValueError, OSError, EOFError, wave.Error, KeyError) as e:
        raise ValueError(f"cannot decode {name}: {e}") from e
    if data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    elif np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / float(np.iinfo(data.dtype).max)
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=-1)
    return data, sr


def load_audio(path) -> tuple[np.ndarray, int]:
    """An audio file → (float32 mono in [-1, 1], sample rate): WAV through
    the Python reader, anything else through the native decoder, which
    sniffs FLAC, MP3 and Ogg from the first bytes."""
    path = str(path)
    if path.lower().endswith(".wav"):
        return _decode_wav(path, path)
    from naturalspeech2_tpu_torch.native import audioio

    return audioio.load(path)


def decode_audio_bytes(raw: bytes, suffix: str = ".wav") -> tuple[np.ndarray, int]:
    """An in-memory audio blob (e.g. an HTTP upload) → (float32 mono, sr). A
    RIFF/WAVE blob goes to the Python reader; any other goes through a
    temporary file to the native decoder (``suffix`` names that file), which
    raises ValueError for a blob that is no container it knows."""
    if raw[:4] == b"RIFF" and raw[8:12] == b"WAVE":
        return _decode_wav(io.BytesIO(raw), "the upload")
    from naturalspeech2_tpu_torch.native import audioio

    with tempfile.NamedTemporaryFile(suffix=suffix) as f:
        f.write(raw)
        f.flush()
        try:
            return audioio.load(f.name)
        except ValueError as e:
            raise ValueError(f"cannot decode the {suffix} upload: {e}") from e


def resample(audio: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


class SoundDataset:
    """Folder of audio → fixed-length float32 crops: resample, random crop
    (or zero-pad) to ``max_length``, trim to a multiple of
    ``seq_len_multiple_of``. ``split`` None takes every file; "train" or
    "val" takes a stable per-file-name hash split, ``val_fraction`` of the
    files going to "val"."""

    def __init__(
        self,
        folder,
        max_length: int,
        target_sample_hz: int = 24000,
        seq_len_multiple_of: Optional[int] = None,
        seed: int = 0,
        split: Optional[str] = None,
        val_fraction: float = 0.05,
    ):
        self.paths: List[Path] = sorted(
            p for p in Path(folder).rglob("*") if p.suffix.lower() in AUDIO_EXTS
        )
        if split is not None:
            if split not in ("train", "val"):
                raise ValueError(f"split must be 'train' or 'val', got {split!r}")
            if not 0.0 < val_fraction < 1.0:
                raise ValueError(f"val_fraction must be in (0, 1), got {val_fraction}")
            self.paths = [
                p for p in self.paths
                if (zlib.crc32(p.name.encode()) / 0xFFFFFFFF < val_fraction) == (split == "val")
            ]
        if not self.paths:
            where = f" for split={split!r} (val_fraction={val_fraction})" if split else ""
            raise ValueError(f"no audio files found in {folder}{where}")
        self.max_length = max_length
        self.target_sample_hz = target_sample_hz
        self.seq_len_multiple_of = seq_len_multiple_of
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        audio, sr = load_audio(self.paths[idx])
        audio = resample(audio, sr, self.target_sample_hz)
        target = self.max_length
        if len(audio) > target:
            start = self.rng.randint(0, len(audio) - target)
            audio = audio[start:start + target]
        elif len(audio) < target:
            audio = np.pad(audio, (0, target - len(audio)))
        if self.seq_len_multiple_of:
            m = self.seq_len_multiple_of
            audio = audio[:(len(audio) // m) * m]
        return audio.astype(np.float32)


def data_loader(
    dataset: SoundDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    prefetch: int = 2,
) -> Iterator[np.ndarray]:
    """Infinite iterator of ``[batch, max_length]`` float32 batches, the
    order reshuffled every epoch; with ``prefetch`` > 0 a daemon thread
    decodes that many batches ahead, and a decode error it meets is raised
    here."""
    if drop_last and len(dataset) < batch_size:
        raise ValueError(
            f"dataset has {len(dataset)} items < batch_size={batch_size} with drop_last=True: "
            "no batch can ever be produced"
        )

    def produce() -> Iterator[np.ndarray]:
        rng = random.Random(seed)
        order = list(range(len(dataset)))
        while True:
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
                idxs = order[i:i + batch_size]
                if len(idxs) < batch_size:
                    idxs = idxs + order[:batch_size - len(idxs)]
                yield np.stack([dataset[j] for j in idxs])

    if prefetch <= 0:
        yield from produce()
        return

    q: queue.Queue = queue.Queue(maxsize=prefetch)

    def worker():
        try:
            for batch in produce():
                q.put(batch)
        except Exception as e:  # handed to the consumer, which raises it
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, Exception):
            raise item
        yield item
