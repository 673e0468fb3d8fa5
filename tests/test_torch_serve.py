"""Port parity for serving: the port's `TTSEngine` against the JAX
package's on the same weights (every leaf jittered), at the widths of the
JAX serving demo (`naturalspeech2_tpu/serve.py:_demo_engine`), guided
with cond_scale 2.5: `_prepare` (ids, buckets, prompt crop, frames from
``seconds`` and from the duration predictor) and `_run_batch` on three
requests padded to four, from JAX's starting noise. Then the port's own
serving behaviour as `tests/test_serve.py` drives the JAX one: seeds, the
micro-batcher, long-form chunking and streaming, the HTTP server, a FLAC
prompt and its 400s, and the named refusals."""

import base64
import io
import json
import sys
import threading
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naturalspeech2_tpu.models.codec import SoundStream as JSoundStream
from naturalspeech2_tpu.models.denoiser import Model as JModel
from naturalspeech2_tpu.models.naturalspeech2 import NaturalSpeech2 as JNaturalSpeech2
from naturalspeech2_tpu.serve import TTSEngine as JTTSEngine
from naturalspeech2_tpu.utils.tokenizer import Tokenizer as JTokenizer
from naturalspeech2_tpu_torch import Model, NaturalSpeech2, SoundStream, load_jax_params, sample
from naturalspeech2_tpu_torch.data import decode_audio_bytes
from naturalspeech2_tpu_torch.parallel import Mesh
from naturalspeech2_tpu_torch.models.naturalspeech2 import _eval_mode
from naturalspeech2_tpu_torch.serve import TTSEngine, TTSServer, _demo_engine, _wav_bytes
from naturalspeech2_tpu_torch.utils.tokenizer import Tokenizer

from test_native_audioio import encode_flac_verbatim
from torch_parity import jitter, numpy_tree

# the JAX serving demo's widths (serve.py:_demo_engine)
CODEC_CFG = dict(codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16,
                 use_pallas_rvq=False)
MODEL_CFG = dict(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=1, wavenet_stacks=1,
                 condition_on_prompt=True, dim_prompt=24, num_latents_m=4, resampler_depth=1,
                 use_flash_attn=False)
NS2_CFG = dict(
    timesteps=4, duration_pitch_dim=24, aligner_dim_in=8, aligner_dim_hidden=24,
    aligner_attn_channels=8, pitch_emb_dim=32, pitch_emb_pp_hidden_dim=24,
    phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, kernel_size=3, depth=1, dim_head=8, heads=2,
                            use_flash=False),
    prompt_enc_kwargs=dict(dims=(24, 24), depth=1, heads=2, dim_head=8, kernel_size=3,
                           use_flash_attn=False),
    duration_pitch_kwargs=dict(dim_encoded_prompts=24, depth=1, kernel_size=3, heads=2,
                               dim_head=8, dim_hidden=24, use_flash_attn=False,
                               num_convolutions_per_block=1, num_convs_per_resnet_block=1),
)
ENGINE_CFG = dict(text_buckets=(16, 32), frame_buckets=(8, 16), prompt_samples=640, timesteps=2,
                  cond_scale=2.5)
HOP, SR = 320, 24000
SECONDS = 8 * HOP / SR
# two guided steps chained through the DDIM update, then the codec decode,
# as tests/test_torch_conditional.py's SAMPLE_ATOL holds the conditional
# sample
SAMPLE_ATOL = 1e-3
# the duration predictor's raw output (frames): a few f32 layers
DURATION_ATOL = 1e-4
PROMPT = np.sin(np.linspace(0, 40, 960)).astype(np.float32)
TEXTS = ("hello world", "hi there", "good morning")  # each under 16 tokens


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same jittered weights."""
    jns2 = JNaturalSpeech2(model=JModel(**MODEL_CFG), codec=JSoundStream(**CODEC_CFG),
                           tokenizer=JTokenizer(), **NS2_CFG)
    key = jax.random.PRNGKey(0)
    audio = jax.random.uniform(key, (1, 2 * HOP), minval=-1, maxval=1)
    text = jnp.asarray(jns2.tokenizer.texts_to_tensor_ids(["hi"]))
    mel = jax.random.normal(key, (1, 8, 10))
    pitch = 100.0 + 50.0 * jax.random.uniform(key, (1, 1, 10))
    init = jax.jit(lambda k: jns2.init({"params": k, "times": k, "noise": k}, audio, text=text,
                                       mel=mel, pitch=pitch, prompt=audio))
    params = dict(init(key)["params"])
    params["codec"] = jax.jit(jns2.codec.init)(key, audio)["params"]
    params = jitter(numpy_tree(params), 5)
    jengine = JTTSEngine(jns2, {"params": params}, **ENGINE_CFG)

    ns2 = NaturalSpeech2(Model(**MODEL_CFG), SoundStream(**CODEC_CFG), tokenizer=Tokenizer(),
                         **NS2_CFG)
    ns2.load_state_dict(load_jax_params(params), strict=True)
    return jengine, TTSEngine(ns2, device="cpu", **ENGINE_CFG)


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


@pytest.mark.parametrize("seconds", [SECONDS, 5 * HOP / SR, None], ids=["8f", "5f", "predicted"])
def test_prepare_matches_jax(engines, seconds):
    jengine, engine = engines
    for i, text in enumerate(TEXTS):
        req = engine._prepare(text, PROMPT, seconds, seed=i)
        jreq = jengine._prepare(text, PROMPT, seconds, seed=i)
        assert req.n_tokens == jreq.n_tokens < req.t_bucket == jreq.t_bucket
        np.testing.assert_array_equal(req.ids, jreq.ids)
        assert (req.ids[req.n_tokens:] == engine.ns2.tokenizer.pad_id).all()
        np.testing.assert_array_equal(req.prompt, jreq.prompt)
        assert (req.frames, req.f_bucket, req.seed) == (jreq.frames, jreq.f_bucket, jreq.seed)
    if seconds is None:
        # the predictor's durations themselves, over the padded ids with
        # no text mask, as the JAX engine's duration program computes them
        ns2 = engine.ns2
        with torch.inference_mode(), _eval_mode(ns2):
            text = torch.from_numpy(req.ids)[None].long()
            prompt_enc = ns2.prompt_enc(ns2.process_prompt(torch.from_numpy(req.prompt)[None]))
            d, _ = ns2.duration_pitch(ns2.phoneme_enc(text), prompt_enc)
        jd = jengine.ns2.apply(
            jengine.variables, jnp.asarray(req.prompt)[None], jnp.asarray(req.ids)[None],
            method=lambda m, p, t: m.duration_pitch(
                m.phoneme_enc(t, deterministic=True),
                m.prompt_enc(m.process_prompt(p), deterministic=True), deterministic=True)[0])
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=DURATION_ATOL)
        assert req.frames == max(1, int(d[0, :req.n_tokens].int().sum()))
        assert req.frames > 1  # the jittered predictor speaks, not a floor of one frame


def test_run_batch_matches_jax(engines):
    """Three same-bucket requests in one call, padded to four rows that
    repeat row 0, from the noise JAX draws for the first request's seed."""
    jengine, engine = engines
    reqs = [engine._prepare(text, PROMPT * (1 - 0.2 * i), SECONDS, seed=11 + i)
            for i, text in enumerate(TEXTS)]
    jreqs = [jengine._prepare(text, PROMPT * (1 - 0.2 * i), SECONDS, seed=11 + i)
             for i, text in enumerate(TEXTS)]
    noise = jax.random.normal(jax.random.PRNGKey(11), (4, reqs[0].f_bucket, 16))
    calls = engine._device_calls
    waves = engine._run_batch(reqs, noise=torch.from_numpy(np.array(noise)))
    assert engine._device_calls == calls + 1
    expected = jengine._run_batch(jreqs)
    for w, e in zip(waves, expected):
        assert w.shape == e.shape == (8 * HOP,)
        np.testing.assert_allclose(w, e, atol=SAMPLE_ATOL)
    assert np.abs(waves[0] - waves[1]).max() > 10 * SAMPLE_ATOL  # rows differ


def test_same_seed_same_audio(engine):
    a, sr = engine.tts("hello", PROMPT, seconds=SECONDS, seed=3)
    b, _ = engine.tts("hello", PROMPT, seconds=SECONDS, seed=3)
    c, _ = engine.tts("hello", PROMPT, seconds=SECONDS, seed=4)
    assert sr == SR and a.shape == (8 * HOP,) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3


def test_warmup_and_buckets(engine):
    assert (16, 8) in engine.warmup(buckets=[(16, 8)])
    with pytest.raises(ValueError, match="bucket"):
        engine.tts("x " * 200, PROMPT)  # text exceeds the largest bucket
    wav, _ = engine.tts("hello there", PROMPT)  # length from the duration predictor
    assert 1 * HOP <= wav.shape[0] <= max(engine.frame_buckets) * HOP
    assert wav.shape[0] % HOP == 0


def test_dynamic_batching_shares_device_calls(engine):
    """Four concurrent same-bucket requests run as ONE batched call."""
    engine.batch_window_ms = 2000.0
    engine.start_batcher()
    try:
        calls_before = engine._device_calls
        results = [None] * 4

        def worker(i):
            results[i] = engine.tts("hello", PROMPT, seconds=SECONDS, seed=7)[0]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a request was not answered in 120 s"
        assert engine._device_calls - calls_before == 1
        for wav in results:
            assert wav.shape == (8 * HOP,) and np.isfinite(wav).all()
        # the batch's rows all start from the first request's noise rows,
        # which differ, so identical requests give different audio
        assert np.abs(results[0] - results[1]).max() > 1e-3 or np.abs(
            results[0] - results[2]).max() > 1e-3
    finally:
        engine.stop_batcher()
        engine.batch_window_ms = 8.0
    wav, _ = engine.tts("hi again", np.zeros(320, np.float32), seconds=SECONDS)
    assert wav.shape == (8 * HOP,)  # the direct path still works after stop


def test_concurrent_requests_lose_no_update(engine):
    """More request threads than cores through the micro-batcher, with a
    short switch interval: every request is answered and counted, and the
    device calls are the batches the batcher formed."""
    n, switch = 24, sys.getswitchinterval()
    engine.start_batcher()
    sys.setswitchinterval(1e-6)
    try:
        requests, calls = engine._requests, engine._device_calls
        results = [None] * n

        def worker(i):
            results[i] = engine.tts("hi", PROMPT, seconds=SECONDS, seed=i)[0]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        engine.stop_batcher()
    assert all(r is not None and r.shape == (8 * HOP,) for r in results)
    stats = engine.stats()
    assert stats["requests"] == engine._requests == requests + n
    assert n // engine.max_batch <= engine._device_calls - calls <= n


def test_long_form_chunks_as_jax_and_streams(engines):
    jengine, engine = engines
    for text in ("hello there. " * 6, "One. Two! Three? " * 5 + "a " * 40,
                 "no sentence end but many many words " * 4):
        chunks = engine._split_text(text)
        assert chunks == jengine._split_text(text)
        for c in chunks:
            assert engine.ns2.tokenizer.texts_to_tensor_ids([c]).shape[1] <= 32
    text = "hello there. " * 6
    whole, sr = engine.tts_long(text, PROMPT, seed=5, crossfade_ms=10.0)
    assert sr == SR and np.isfinite(whole).all()
    streamed = np.concatenate(list(engine.tts_long_stream(text, PROMPT, seed=5,
                                                          crossfade_ms=10.0)))
    np.testing.assert_allclose(streamed, whole, atol=1e-5)


def _post(base, payload):
    return urllib.request.Request(f"{base}/tts", data=json.dumps(payload).encode(),
                                  headers={"Content-Type": "application/json"})


def test_http_server_roundtrip(engine):
    server = TTSServer(engine)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(f"{base}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["sample_rate"] == SR
        assert health["device"] == "cpu"
        prompt_b64 = base64.b64encode(_wav_bytes(PROMPT, SR)).decode()

        with urllib.request.urlopen(_post(base, {"text": "hello world", "seconds": SECONDS,
                                                 "prompt_wav_base64": prompt_b64})) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            body = r.read()
        with wave.open(io.BytesIO(body)) as w:
            assert w.getframerate() == SR and w.getnframes() == 8 * HOP

        with urllib.request.urlopen(_post(base, {"text": "hello there. " * 4, "stream": True,
                                                 "prompt_wav_base64": prompt_b64})) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            streamed = r.read()
        assert streamed[:4] == b"RIFF" and streamed[8:12] == b"WAVE"
        assert np.frombuffer(streamed[44:], dtype="<i2").size > HOP

        # past the largest text bucket: long-formed, not refused
        with urllib.request.urlopen(_post(base, {"text": "hello there. " * 6,
                                                 "prompt_wav_base64": prompt_b64})) as r:
            with wave.open(io.BytesIO(r.read())) as w:
                assert w.getnframes() > 0

        with urllib.request.urlopen(f"{base}/metrics") as r:
            stats = json.loads(r.read())
        assert stats["requests"] >= 1 and stats["device_calls"] >= 1
        assert stats["latency_ms"]["p50"] is not None

        for bad in ({"text": "x"},  # no prompt
                    {"text": "x", "prompt_wav_base64": base64.b64encode(b"fLaC" + bytes(60))
                     .decode()},  # a FLAC header with no stream
                    {"text": "x", "prompt_path": "voice.mp3"}):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(_post(base, bad))
            assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope")
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def test_http_flac_prompt(engine):
    """POST /tts with a FLAC prompt (the verbatim encoder of
    tests/test_native_audioio.py) answers 200 with a PCM16 WAV: the reply
    to the prompt the native decoder gives (PCM16 / 32768)."""
    pcm = (np.clip(PROMPT, -1, 1) * 32767).astype(np.int16)
    flac = encode_flac_verbatim(pcm, sr=SR)
    decoded, sr = decode_audio_bytes(flac)
    assert sr == SR and np.array_equal(decoded, pcm.astype(np.float32) / 32768.0)
    server = TTSServer(engine)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        payload = {"text": "hello world", "seconds": SECONDS, "seed": 3,
                   "prompt_wav_base64": base64.b64encode(flac).decode()}
        with urllib.request.urlopen(_post(f"http://127.0.0.1:{server.port}", payload)) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
            body = r.read()
    finally:
        server.shutdown()
        server.server_close()
    with wave.open(io.BytesIO(body)) as w:
        assert w.getframerate() == SR and w.getsampwidth() == 2
        assert w.getnframes() == 8 * HOP
    assert body == _wav_bytes(*engine.tts("hello world", decoded, seconds=SECONDS, seed=3))


def test_http_non_wav_prompt_without_the_decoder(engine, monkeypatch):
    """A host where the native decoder cannot be built still starts the
    server (the build is tried at start, not inside a request) and serves
    WAV prompts; a FLAC prompt then gets a 415 naming the cause, not an
    unhandled exception."""
    from naturalspeech2_tpu_torch.native import audioio

    monkeypatch.setattr(audioio, "_lib", None)
    monkeypatch.setattr(audioio, "SOURCE", audioio.SOURCE.with_name("missing.cpp"))
    server = TTSServer(engine)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        flac = encode_flac_verbatim((PROMPT * 32767).astype(np.int16), sr=SR)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(_post(base, {"text": "hi", "seconds": SECONDS,
                                                "prompt_wav_base64": base64.b64encode(flac)
                                                .decode()}))
        assert err.value.code == 415 and "missing.cpp" in json.loads(err.value.read())["error"]
        wav = base64.b64encode(_wav_bytes(PROMPT, SR)).decode()
        with urllib.request.urlopen(_post(base, {"text": "hi", "seconds": SECONDS,
                                                 "prompt_wav_base64": wav})) as r:
            assert r.status == 200
    finally:
        server.shutdown()
        server.server_close()


def test_server_start_builds_the_decoder(engine, monkeypatch):
    """`TTSServer` loads the native decoder when it starts, so the first
    FLAC upload pays no g++ build."""
    from naturalspeech2_tpu_torch.native import audioio

    monkeypatch.setattr(audioio, "_lib", None)
    server = TTSServer(engine)
    server.server_close()
    assert audioio._lib is not None


def test_sample_takes_raw_text(engine):
    """`sample(text=[str])` tokenizes through ``ns2.tokenizer`` and equals
    sampling from the ids; without a tokenizer it asserts, as JAX does."""
    ns2 = engine.ns2
    prompt = torch.from_numpy(PROMPT[:640])[None]
    noise = torch.randn(1, 6, 16, generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(ns2.tokenizer.texts_to_tensor_ids(["hello world"])).long()
    kw = dict(length=6, prompt=prompt, timesteps=2, cond_scale=2.5, noise=noise)
    from_text = sample(ns2, text=["hello world"], **kw)
    torch.testing.assert_close(from_text, sample(ns2, text=ids, **kw), rtol=0, atol=0)
    assert from_text.shape == (1, 6 * HOP)
    tokenizer, ns2.tokenizer = ns2.tokenizer, None
    try:
        with pytest.raises(AssertionError, match="tokenizer="):
            sample(ns2, text=["hello world"], **kw)
    finally:
        ns2.tokenizer = tokenizer


def test_engine_bf16(engine):
    """`TTSEngine(dtype="bfloat16")` holds a bf16 copy of the denoiser, cast
    once (the caller's module and the conditioning stay f32), and a batch
    from it equals `sample(dtype=torch.bfloat16)` on the f32 module; it
    tracks the f32 engine (correlation ≥ 0.98, JAX's bf16 bound)."""
    ns2 = engine.ns2
    bf16 = TTSEngine(ns2, dtype="bfloat16", device="cpu", **ENGINE_CFG)
    assert {p.dtype for p in bf16.ns2.model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in ns2.parameters()} == {torch.float32}
    assert bf16.ns2.prompt_enc is ns2.prompt_enc and bf16.ns2.codec is ns2.codec
    req = bf16._prepare(TEXTS[0], PROMPT, SECONDS, seed=3)
    noise = torch.randn(1, req.f_bucket, 16, generator=torch.Generator().manual_seed(3))
    wave = bf16._run_batch([req], noise=noise)[0]
    assert wave.shape == (8 * HOP,) and np.isfinite(wave).all()
    direct = sample(ns2, length=req.f_bucket, prompt=torch.from_numpy(req.prompt)[None],
                    text=torch.from_numpy(req.ids)[None].long(),
                    text_lens=torch.tensor([req.n_tokens]), cond_scale=ENGINE_CFG["cond_scale"],
                    timesteps=ENGINE_CFG["timesteps"], noise=noise, dtype=torch.bfloat16)
    np.testing.assert_array_equal(wave, direct[0, :wave.shape[0]].numpy())
    f32 = engine._run_batch([req], noise=noise)[0]
    assert np.corrcoef(wave, f32)[0, 1] >= 0.98


def test_engine_refusals(engine):
    ns2 = engine.ns2
    with pytest.raises(ValueError, match="dtype"):
        TTSEngine(ns2, dtype="float16", device="cpu")
    # tensor-parallel serving runs on a mesh of one data rank
    # (tests/test_torch_tp.py); a data axis is refused by name
    with pytest.raises(ValueError, match="one data rank"):
        TTSEngine(ns2, mesh=Mesh(n_data=2, n_model=1, rank=0, group=None,
                                 device=torch.device("cpu")), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TTSEngine(ns2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _demo_engine()
    with pytest.raises(ValueError, match="conditional"):
        TTSEngine(NaturalSpeech2(Model(dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=1,
                                       wavenet_stacks=1), SoundStream(**CODEC_CFG),
                                 tokenizer=Tokenizer()), device="cpu")
    tokenizer, ns2.tokenizer = ns2.tokenizer, None
    try:
        with pytest.raises(ValueError, match="tokenizer="):
            TTSEngine(ns2, device="cpu")
    finally:
        ns2.tokenizer = tokenizer


def test_demo_engine_serves_on_cpu():
    demo = _demo_engine("cpu")
    assert demo.warmup() == [(16, 8), (16, 16), (32, 8), (32, 16)]
    wav, sr = demo.tts("hello", PROMPT, seconds=SECONDS)
    assert sr == SR and wav.shape == (8 * HOP,) and np.isfinite(wav).all()
