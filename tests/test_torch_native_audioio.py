"""Port parity for the native audio decoder (`naturalspeech2_tpu_torch/native/`):
the port compiles its own copy of `audioio.cpp` and must decode FLAC, MP3
and Ogg/Vorbis exactly as `naturalspeech2_tpu.native.audioio.load` does
(bit for bit: the same C++ on the same bytes), refuse what that refuses,
resample as it does, and feed `SoundDataset` and `decode_audio_bytes`.
WAV never reaches the native decoder in the port: it keeps the Python
reader's 32767 scale (the JAX native loader scales by 32768).

The FLAC fixtures come from the verbatim encoder of
tests/test_native_audioio.py; the MP3 and Ogg fixtures from the system's
lame / vorbis encoders where they are installed (skipped otherwise)."""

import ctypes
import random
import time
import wave

import numpy as np
import pytest

from naturalspeech2_tpu import data as jdata
from naturalspeech2_tpu.native import audioio as jaudioio
from naturalspeech2_tpu_torch import data
from naturalspeech2_tpu_torch.native import audioio

from test_native_audioio import _encode_mp3, _encode_ogg, _tone, encode_flac_verbatim

SR = 24000


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """The JAX package's decoder, loaded once; its `make -C native` may be
    writing the library in another test worker, so a half-written file is
    waited for."""
    for _ in range(60):
        try:
            return jaudioio._load_lib()
        except OSError:
            time.sleep(1.0)
    return jaudioio._load_lib()


def _pcm(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "sine":
        x = 0.5 * np.sin(2 * np.pi * 440.0 * np.arange(n) / SR)
    elif kind == "noise":
        x = np.clip(rng.standard_normal(n) * 0.3, -1, 1)
    else:  # the extremes of the 16-bit range
        return rng.choice(np.array([-32768, -1, 0, 1, 32767], np.int16), n)
    return (x * 32767).astype(np.int16)


@pytest.mark.parametrize("kind,n", [("sine", 1200), ("noise", 4000), ("extremes", 333)])
def test_flac_equals_jax_native(tmp_path, kind, n):
    pcm = _pcm(kind, n, seed=n)
    path = tmp_path / f"{kind}.flac"
    path.write_bytes(encode_flac_verbatim(pcm))
    ours, sr = audioio.load(path)
    theirs, jsr = jaudioio.load(str(path))
    assert sr == jsr == SR and ours.dtype == np.float32
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, pcm.astype(np.float32) / 32768.0)
    loaded, _ = data.load_audio(path)  # FLAC goes to the native decoder
    assert np.array_equal(loaded, ours)
    blob, _ = data.decode_audio_bytes(path.read_bytes())
    assert np.array_equal(blob, ours)


def test_truncated_flac_raises_in_both(tmp_path):
    path = tmp_path / "trunc.flac"
    path.write_bytes(b"fLaC" + bytes([0x80, 0, 0, 34]) + b"\x01" * 40)
    with pytest.raises(ValueError, match="cannot decode"):
        audioio.load(path)
    with pytest.raises(ValueError):
        jaudioio.load(str(path))
    with pytest.raises(ValueError, match="cannot decode"):
        data.load_audio(path)


def test_corrupt_flac_as_jax(tmp_path):
    """Fuzzed FLAC with frame-sync pairs (tests/test_native_audioio.py's
    corpus): the port raises ValueError where JAX does, and decodes the
    same finite samples where JAX decodes."""
    rng = random.Random(0)
    refused = 0
    for trial in range(60):
        body = bytes(rng.randrange(256) for _ in range(rng.randint(50, 400)))
        path = tmp_path / f"fuzz{trial}.flac"
        path.write_bytes((b"fLaC" + bytes([0x80, 0, 0, 34]) + body).replace(b"\x00\x00",
                                                                             b"\xff\xf8"))
        try:
            theirs = jaudioio.load(str(path))
        except ValueError:
            with pytest.raises(ValueError, match="cannot decode"):
                audioio.load(path)
            refused += 1
            continue
        ours = audioio.load(path)
        assert ours[1] == theirs[1] and np.array_equal(ours[0], theirs[0])
        assert np.isfinite(ours[0]).all()
    assert refused > 0


def _have(*libs: str) -> bool:
    try:
        for lib in libs:
            ctypes.CDLL(lib)
    except OSError:
        return False
    return True


@pytest.mark.parametrize("fmt", ["mp3", "ogg"])
def test_mp3_and_ogg_equal_jax(tmp_path, fmt):
    libs = {"mp3": ("libmp3lame.so.0", "libmpg123.so.0"),
            "ogg": ("libvorbisenc.so.2", "libvorbisfile.so.3")}[fmt]
    if not _have(*libs):
        pytest.skip(f"system {fmt} codecs not present")
    tone = _tone(SR)
    path = tmp_path / f"tone.{fmt}"
    (_encode_mp3 if fmt == "mp3" else _encode_ogg)(str(path), tone, SR)
    ours, sr = data.load_audio(path)
    theirs, jsr = jaudioio.load(str(path))
    assert sr == jsr == SR and np.array_equal(ours, theirs)
    spec = np.abs(np.fft.rfft(ours * np.hanning(len(ours))))
    assert abs(np.argmax(spec) * sr / len(ours) - 440.0) < 10.0
    blob, _ = data.decode_audio_bytes(path.read_bytes(), suffix=f".{fmt}")
    assert np.array_equal(blob, ours)


def test_corrupt_mp3_raises(tmp_path):
    path = tmp_path / "junk.mp3"
    path.write_bytes(b"ID3" + b"\x00" * 64)
    with pytest.raises(ValueError, match="cannot decode"):
        data.load_audio(path)


@pytest.mark.parametrize("split", [None, "train"])
def test_flac_dataset_matches_jax(tmp_path, split):
    for i in range(6):
        pcm = _pcm("noise" if i % 2 else "sine", 3000 + 700 * i, seed=i)
        (tmp_path / f"clip{i}.flac").write_bytes(encode_flac_verbatim(pcm))
    kwargs = dict(max_length=4000, target_sample_hz=SR, seq_len_multiple_of=320, seed=2,
                  split=split, val_fraction=0.3)
    ours, theirs = data.SoundDataset(tmp_path, **kwargs), jdata.SoundDataset(str(tmp_path), **kwargs)
    assert [p.name for p in ours.paths] == [p.name for p in theirs.paths] != []
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.shape == (3840,) and np.array_equal(a, b)


def test_wav_never_reaches_the_native_decoder(tmp_path, monkeypatch):
    """WAV files and blobs stay on the Python reader (PCM16 / 32767), where
    the JAX native loader divides by 32768."""
    pcm = _pcm("extremes", 500, seed=9)
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.astype("<i2").tobytes())

    def refuse(path):
        raise AssertionError(f"{path} reached the native decoder")

    monkeypatch.setattr(audioio, "load", refuse)
    loaded, sr = data.load_audio(tmp_path / "a.wav")
    assert sr == SR and np.array_equal(loaded, pcm.astype(np.float32) / 32767.0)
    blob, _ = data.decode_audio_bytes((tmp_path / "a.wav").read_bytes())
    assert np.array_equal(blob, loaded)
    native, _ = jaudioio.load(str(tmp_path / "a.wav"))
    assert np.array_equal(native, pcm.astype(np.float32) / 32768.0)


def test_resample_equals_jax():
    x = (0.5 * np.sin(2 * np.pi * 440.0 * np.arange(SR // 2) / SR)).astype(np.float32)
    for sr_out in (16000, 22050, SR):
        ours = audioio.resample(x, SR, sr_out)
        assert np.array_equal(ours, jaudioio.resample(x, SR, sr_out))
        assert len(ours) == len(x) * sr_out // SR


def test_unreadable_file_and_failed_build(tmp_path, monkeypatch):
    """A missing file is a named ValueError; a source g++ cannot compile
    raises with g++'s output instead of falling back."""
    with pytest.raises(ValueError, match="cannot read the file"):
        audioio.load(tmp_path / "missing.flac")
    bad = tmp_path / "audioio.cpp"
    bad.write_text("int audio_load( { this is not C++\n")
    monkeypatch.setattr(audioio, "SOURCE", bad)
    monkeypatch.setattr(audioio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(audioio, "_lib", None)
    with pytest.raises(audioio.DecoderUnavailable, match="(?s)g\\+\\+ failed.*error"):
        audioio.library()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("cause", ["no source", "no g++"])
def test_decoder_unavailable_is_named(tmp_path, monkeypatch, cause):
    """An installed port without ``audioio.cpp``, or a host without g++,
    raises `DecoderUnavailable` (which the server answers with a 415) on
    the first non-WAV file, not a FileNotFoundError; WAV still reads."""
    import shutil

    from naturalspeech2_tpu_torch.data import load_audio, write_wav

    monkeypatch.setattr(audioio, "_lib", None)
    monkeypatch.setattr(audioio, "BUILD_DIR", tmp_path / "build")
    if cause == "no source":
        monkeypatch.setattr(audioio, "SOURCE", tmp_path / "audioio.cpp")
    else:
        monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(audioio.DecoderUnavailable, match="missing" if cause == "no source"
                       else "g\\+\\+ not found"):
        load_audio(tmp_path / "a.flac")
    write_wav(tmp_path / "a.wav", np.zeros(8, np.float32), SR)
    assert load_audio(tmp_path / "a.wav")[1] == SR


def test_the_port_keeps_its_own_copy():
    """The port compiles its own audioio.cpp, a verbatim copy of the JAX
    package's source, and reads nothing of the JAX package's build."""
    from pathlib import Path

    ours = Path(audioio.__file__).with_name("audioio.cpp")
    assert audioio.SOURCE == ours.resolve()
    assert ours.read_bytes() == (Path(jaudioio.__file__).parents[2] / "native" /
                                 "audioio.cpp").read_bytes()
    assert "naturalspeech2_tpu_torch" in str(audioio._target())
