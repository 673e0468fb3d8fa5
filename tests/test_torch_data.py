"""Port parity for the data pipeline: `write_wav`, `load_audio`,
`SoundDataset` (resample, crop, trim, split) and `data_loader` against
`naturalspeech2_tpu/data.py` on a folder of WAVs, for the same seed."""

import numpy as np
import pytest

from naturalspeech2_tpu import data as jdata
from naturalspeech2_tpu.trainer import write_wav as jwrite_wav
from naturalspeech2_tpu_torch import data

# The JAX package reads 16-bit PCM through its native decoder (÷32768) when
# that is built and through scipy (÷32767) otherwise; the port reads as the
# latter, so samples may differ by 1/32767 of their value.
ATOL = 5e-5


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    # lengths below and above the crop, and two files at 16 kHz (resampled)
    for i, (seconds, sr) in enumerate([(0.3, 24000), (0.05, 24000), (0.2, 16000), (0.4, 24000),
                                       (0.15, 16000), (0.25, 24000), (0.35, 24000)]):
        audio = 0.8 * np.tanh(rng.standard_normal(int(seconds * sr))).astype(np.float32)
        data.write_wav(path / f"clip{i}.wav", audio, sr)
    return path


def test_write_wav_matches_jax(tmp_path):
    audio = np.sin(np.linspace(0, 60, 999)).astype(np.float32) * 1.3  # clipped
    data.write_wav(tmp_path / "port.wav", audio, 22050)
    jwrite_wav(str(tmp_path / "jax.wav"), audio, 22050)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_load_audio_reads_what_write_wav_wrote(tmp_path):
    audio = np.linspace(-1, 1, 501).astype(np.float32)
    data.write_wav(tmp_path / "a.wav", audio, 24000)
    loaded, sr = data.load_audio(tmp_path / "a.wav")
    assert sr == 24000 and loaded.dtype == np.float32
    np.testing.assert_allclose(loaded, audio, atol=1 / 32767)
    expected, _ = jdata.load_audio(str(tmp_path / "a.wav"))
    np.testing.assert_allclose(loaded, expected, atol=ATOL)


def test_load_audio_refuses_what_it_cannot_read(tmp_path):
    """A broken WAV, a missing file and a blob that is neither WAV nor a
    container the native decoder knows raise ValueError (FLAC, MP3 and Ogg
    decode: tests/test_torch_native_audioio.py)."""
    (tmp_path / "bad.wav").write_bytes(b"RIFF....not a wave file")
    with pytest.raises(ValueError, match="cannot decode"):
        data.load_audio(tmp_path / "bad.wav")
    with pytest.raises(ValueError, match="cannot decode"):
        data.load_audio(tmp_path / "clip.mp3")
    (tmp_path / "noise.ogg").write_bytes(b"neither a WAV nor a known container" * 4)
    with pytest.raises(ValueError, match="not a decodable"):
        data.load_audio(tmp_path / "noise.ogg")
    with pytest.raises(ValueError, match="cannot decode the .bin upload"):
        data.decode_audio_bytes((tmp_path / "noise.ogg").read_bytes(), suffix=".bin")


@pytest.mark.parametrize("split", [None, "train", "val"])
def test_dataset_items_match_jax(folder, split):
    kwargs = dict(max_length=4800, target_sample_hz=24000, seq_len_multiple_of=320, seed=3,
                  split=split, val_fraction=0.3)
    ours, theirs = data.SoundDataset(folder, **kwargs), jdata.SoundDataset(str(folder), **kwargs)
    assert [p.name for p in ours.paths] == [p.name for p in theirs.paths]
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.shape == b.shape == (4800,)
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_data_loader_matches_jax(folder):
    kwargs = dict(max_length=3200, target_sample_hz=24000, seq_len_multiple_of=320)
    ours = data.data_loader(data.SoundDataset(folder, **kwargs), 3, seed=5)
    theirs = jdata.data_loader(jdata.SoundDataset(str(folder), **kwargs), 3, seed=5)
    for _ in range(6):  # past an epoch boundary (7 files, 2 batches each)
        a, b = next(ours), next(theirs)
        assert a.shape == b.shape == (3, 3200)
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_data_loader_raises_a_decode_error(tmp_path):
    (tmp_path / "bad.wav").write_bytes(b"RIFF....not a wave file")
    loader = data.data_loader(data.SoundDataset(tmp_path, max_length=320), 1)
    with pytest.raises(ValueError, match="cannot decode"):
        next(loader)


def test_data_loader_needs_a_full_batch(folder):
    with pytest.raises(ValueError, match="batch_size"):
        next(data.data_loader(data.SoundDataset(folder, max_length=320), 8))
