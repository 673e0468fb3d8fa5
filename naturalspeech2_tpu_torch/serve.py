"""TTS serving: bucketed inference on the card + a stdlib HTTP server (the
port of `naturalspeech2_tpu/serve.py`, with the same structure and names).

1. **Shape buckets.** `TTSEngine` pads text ids and latent lengths up to a
   fixed bucket grid. The port compiles no programs per shape, but the grid
   still fixes the shapes the kernels see and the output lengths, and
   `warmup()` runs each bucket once ahead of traffic: that builds the
   kernel library and the packed weight layouts (`ops/gemm_cache.py`).
2. **Serialized device access + dynamic batching.** One engine owns the
   card; a lock serializes every device call (the sample and the
   duration predictor), while the host-side text frontend runs
   concurrently in request threads. With `start_batcher()`, concurrent
   same-bucket requests arriving within `batch_window_ms` share ONE
   batched device call (batch dim padded to a power of two ≤ `max_batch`).
3. **A transport.** `TTSServer` is a dependency-free `http.server`
   endpoint: `POST /tts {"text": "...", "seconds": 2.0,
   "prompt_wav_base64": "<base64 wav>"}` (or ``"prompt_path"``) →
   `audio/wav` bytes, ``"stream": true`` for chunked audio (a WAV, FLAC,
   MP3 or Ogg prompt; 415 for a non-WAV one where the native decoder, built
   when the server starts, is unavailable); `GET /healthz`
   → build/bucket info; `GET /metrics` → latency percentiles. Run:
   ``python -m naturalspeech2_tpu_torch.serve --demo`` (tiny random model)
   or construct `TTSServer(TTSEngine(ns2))` around a trained one.

The engine runs on the card: ``device=None`` means CUDA, and without a
card it raises. ``device="cpu"`` runs the plain PyTorch versions of the
kernels (the tests' route).

Tensor-parallel serving (``mesh=``, a ``(1, P)`` mesh, or ``serve --tp
P``) is SPMD: every rank builds the engine from the same checkpoint, cut
for its heads (`parallel.tp.shard_model`, after the bf16 cast), and runs
every device call with the same inputs. Rank 0 alone takes requests,
forms batches and draws the noise; it broadcasts each device call to the
other ranks (tokens, prompts, lengths, buckets, the noise, the steps and
the dtype) before it runs it, and they run it too (`follow`) until rank 0
broadcasts a stop (`stop_followers`). No rank draws a number of its own.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from naturalspeech2_tpu_torch.data import decode_audio_bytes, load_audio, pcm16, write_wav
from naturalspeech2_tpu_torch.native import audioio

# what rank 0 of a tensor-parallel engine announces to the other ranks
_STOP, _SAMPLE, _DURATIONS = 0, 1, 2
_DTYPES = (None, torch.float32, torch.bfloat16)

__all__ = ["TTSEngine", "TTSServer"]


def _wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """float waveform [-1, 1] → 16-bit PCM WAV bytes."""
    buf = io.BytesIO()
    write_wav(buf, audio, sample_rate)
    return buf.getvalue()


def resolve_device(device: Optional[str]) -> torch.device:
    """``None`` → the card; raises when CUDA is asked for and absent."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the card (pass device='cpu' to run the "
            "plain PyTorch versions on the CPU)"
        )
    return device


@dataclass
class _Request:
    """A prepared request travelling through the batcher."""

    ids: np.ndarray          # [t_bucket] int token ids (padded)
    n_tokens: int
    prompt: np.ndarray       # [prompt_samples] float32
    frames: int
    t_bucket: int
    f_bucket: int
    seed: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None


@dataclass
class TTSEngine:
    """Bucketed inference around the port's `NaturalSpeech2` module.

    ``text_buckets`` are token-length ceilings, ``frame_buckets`` latent
    frame counts; every (text_bucket, frame_bucket) pair is one shape the
    sampler runs at. ``prompt_samples`` fixes the conditioning prompt crop.
    The module is moved to ``device`` (``None``: the card). ``dtype=
    "bfloat16"`` runs the denoiser in bf16: the engine holds a bf16 copy of
    its parameters, cast once here (the codec and the conditioning stack
    stay f32), so the kernels' packed weights are built once too.
    ``mesh`` (a `parallel.Mesh` of one data rank) serves tensor-parallel
    over its model axis (see the module's docstring).
    """

    ns2: object
    text_buckets: Sequence[int] = (32, 64, 128)
    frame_buckets: Sequence[int] = (256, 512, 1024)
    prompt_samples: int = 32768
    cond_scale: float = 2.5
    cfg_rescale: float = 0.0
    # (t_lo, t_hi): limited-interval CFG — guidance (the batch-doubled
    # forward) only at diffusion times inside the interval; outside, one
    # conditional forward.
    cfg_interval: Optional[Tuple[float, float]] = None
    timesteps: Optional[int] = 100
    max_batch: int = 4
    batch_window_ms: float = 8.0
    mesh: Optional[object] = None
    dtype: Optional[str] = None
    device: Optional[str] = None
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _stats_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def __post_init__(self):
        from naturalspeech2_tpu_torch.models.naturalspeech2 import sample as _sample
        from naturalspeech2_tpu_torch.models.naturalspeech2 import with_denoiser_dtype

        self._dtype = None
        if self.dtype:
            self._dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
                str(self.dtype).removeprefix("torch."))
            if self._dtype is None:
                raise ValueError(f"TTSEngine: dtype must be 'float32' or 'bfloat16', "
                                 f"got {self.dtype!r}")
        if self.mesh is not None and self.mesh.n_data != 1:
            raise ValueError(f"TTSEngine serves tensor-parallel over a mesh of one data rank, "
                             f"got {self.mesh.shape}")
        if not self.ns2.conditional:
            raise ValueError("TTSEngine serves conditional (text+prompt) models")
        if self.ns2.tokenizer is None:
            raise ValueError("NaturalSpeech2 needs tokenizer= for raw text")
        self.device = resolve_device(self.device)
        self.ns2 = self.ns2.to(self.device)
        if self._dtype is not None:
            # cast the denoiser ONCE: sample() then finds it in its dtype
            # and casts nothing per call
            self.ns2 = with_denoiser_dtype(self.ns2, self._dtype)
        if self.mesh is not None and self.mesh.n_model > 1:
            from naturalspeech2_tpu_torch.parallel import tp

            tp.shard_model(self.ns2, self.mesh)  # cast first, then cut, as JAX does
        self._sample = _sample
        # observability ring buffer: (wall_seconds, bucket) per request
        self._latencies: list = []
        self._requests = 0
        self._warm: set = set()  # buckets sampled at least once
        self._hop = (
            self.ns2.codec.seq_len_multiple_of
            if self.ns2.codec is not None
            else 320
        )
        self._sr = self.ns2.sample_hz
        self._queue = None
        self._batcher = None
        self._device_calls = 0  # observability: batched sampling calls issued

    # ------------------------------------------------------------------ #

    def _bucket(self, value: int, buckets: Sequence[int], what: str) -> int:
        for b in sorted(buckets):
            if value <= b:
                return b
        raise ValueError(
            f"{what}={value} exceeds the largest serving bucket "
            f"{max(buckets)}; raise {what}_buckets"
        )

    def _durations(self, prompt: np.ndarray, ids: np.ndarray) -> torch.Tensor:
        """The duration predictor's frames per token [1, t_bucket] for one
        request, on the host: `process_prompt`, the prompt encoder, the
        phoneme encoder over the padded ids without a text mask, then the
        duration trunk, in eval mode under the engine's lock."""
        from naturalspeech2_tpu_torch.models.naturalspeech2 import _eval_mode

        ns2 = self.ns2
        # grad mode is per thread: the batcher's and the handlers' threads
        # run this too
        with self._lock, torch.inference_mode(), _eval_mode(ns2):
            p = torch.from_numpy(prompt)[None].to(self.device)
            text = torch.from_numpy(ids)[None].to(self.device, torch.int64)
            if self._leads():
                self._announce([_DURATIONS, text.shape[1], p.shape[1]], [p, text])
            prompt_enc = ns2.prompt_enc(ns2.process_prompt(p))
            phoneme_enc = ns2.phoneme_enc(text)
            d, _ = ns2.duration_pitch(phoneme_enc, prompt_enc)
            return d.cpu()

    def _predicted_frames(self, prompt: np.ndarray, ids: np.ndarray, n_tokens: int) -> int:
        """Total predicted frames of one request: the NaturalSpeech 2 way to
        choose output length when the caller gives no ``seconds`` (durations
        truncated to int as the sampler's `generate_mask_from_repeats` does,
        summed over the real tokens)."""
        d = self._durations(prompt, ids)
        keep = torch.arange(d.shape[-1])[None, :] < n_tokens
        return int(torch.where(keep, d.to(torch.int32), 0).sum(dim=-1)[0].item())

    def _sample_device(self, ids: torch.Tensor, prompts: torch.Tensor, lens: torch.Tensor,
                       f_bucket: int, noise: torch.Tensor,
                       timesteps: Optional[int] = None) -> np.ndarray:
        """One sampling call on the device (the caller holds the lock);
        rank 0 of a tensor-parallel engine announces it first."""
        timesteps = self.timesteps if timesteps is None else timesteps
        if self._leads():
            self._announce([_SAMPLE, ids.shape[0], ids.shape[1], f_bucket, prompts.shape[1],
                            timesteps or 0, _DTYPES.index(self._dtype)],
                           [ids, prompts, lens, noise])
        wav = self._sample(
            self.ns2, length=f_bucket, prompt=prompts, text=ids, text_lens=lens,
            cond_scale=self.cond_scale, cfg_rescale=self.cfg_rescale,
            cfg_interval=self.cfg_interval, timesteps=timesteps, noise=noise,
            dtype=self._dtype,
        )
        self._warm.add((ids.shape[1], f_bucket))
        return wav.cpu().numpy()

    def warmup(self, buckets: Optional[Sequence[Tuple[int, int]]] = None):
        """Run serving buckets once ahead of traffic (all pairs by default):
        builds the kernels and the packed weight layouts."""
        pairs = buckets or [
            (t, f) for t in self.text_buckets for f in self.frame_buckets
        ]
        dev = self.device
        for t_bucket, f_bucket in pairs:
            with self._lock:
                prompt = torch.zeros((1, self.prompt_samples), dtype=torch.float32, device=dev)
                ids = torch.zeros((1, t_bucket), dtype=torch.int64, device=dev)
                lens = torch.ones((1,), dtype=torch.int64, device=dev)
                noise = torch.randn((1, f_bucket, self.ns2.dim),
                                    generator=torch.Generator(dev).manual_seed(0), device=dev)
                self._sample_device(ids, prompt, lens, f_bucket, noise)
        return sorted(self._warm)

    # ------------------------------------------------------------------ #

    def _prepare(self, text: str, prompt_audio: np.ndarray,
                 seconds: Optional[float], seed: int) -> "_Request":
        """Host-side frontend: clean/phonemize/tokenize, pad to buckets."""
        ids = np.asarray(self.ns2.tokenizer.texts_to_tensor_ids([text]))[0]
        n_tokens = ids.shape[0]
        t_bucket = self._bucket(n_tokens, self.text_buckets, "text tokens")
        ids = np.concatenate([
            ids,
            np.full((t_bucket - n_tokens,), self.ns2.tokenizer.pad_id,
                    dtype=ids.dtype),
        ])

        prompt = np.zeros((self.prompt_samples,), np.float32)
        crop = np.asarray(prompt_audio, np.float32).reshape(-1)[-self.prompt_samples:]
        prompt[: crop.shape[0]] = crop

        if seconds is None:
            # no duration requested → ask the model: the prompt-conditioned
            # duration predictor decides the output length (one extra small
            # device call)
            frames = max(1, self._predicted_frames(prompt, ids, n_tokens))
            frames = min(frames, max(self.frame_buckets))
        else:
            frames = int(round(seconds * self._sr / self._hop))
        f_bucket = self._bucket(frames, self.frame_buckets, "frames")
        return _Request(ids, n_tokens, prompt, frames, t_bucket, f_bucket, seed)

    def _run_batch(self, reqs: Sequence["_Request"], noise: Optional[torch.Tensor] = None):
        """Run same-bucket requests as ONE device call. The batch dim is
        padded to the next power of two (≤ max_batch) so the set of shapes
        stays small; padding rows repeat row 0 and are dropped.

        Batched randomness: the starting noise [b, f_bucket, dim] is drawn
        from a generator seeded with the FIRST request's seed, unless given
        as ``noise``; per-request `seed` is only reproducible at batch
        size 1 (single-request traffic or batcher off)."""
        t_bucket, f_bucket = reqs[0].t_bucket, reqs[0].f_bucket
        n = len(reqs)
        b = 1
        while b < n:
            b *= 2
        rows = list(reqs) + [reqs[0]] * (b - n)
        ids = torch.from_numpy(np.stack([r.ids for r in rows])).long()
        prompts = torch.from_numpy(np.stack([r.prompt for r in rows]))
        lens = torch.tensor([r.n_tokens for r in rows], dtype=torch.int64)
        dev = self.device
        with self._lock:
            self._device_calls += 1
            ids, prompts, lens = ids.to(dev), prompts.to(dev), lens.to(dev)
            if noise is None:
                gen = torch.Generator(dev).manual_seed(reqs[0].seed)
                noise = torch.randn((b, f_bucket, self.ns2.dim), generator=gen, device=dev)
            wav = self._sample_device(ids, prompts, lens, f_bucket, noise.to(dev))
        return [wav[i, : r.frames * self._hop] for i, r in enumerate(reqs)]

    # ------------------------------------------------------------------ #
    # tensor parallelism: rank 0 leads, the other ranks follow
    # ------------------------------------------------------------------ #

    def _leads(self) -> bool:
        return self.mesh is not None and self.mesh.world_size > 1 and self.mesh.is_main

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        from naturalspeech2_tpu_torch.parallel import comm

        return comm.broadcast_(self.mesh, t.contiguous(), None)

    def _announce(self, header: list, tensors: list) -> None:
        """Rank 0: the next device call's header (kind and sizes, eight
        ints), then its inputs, to every rank."""
        self._broadcast(torch.tensor(header + [0] * (8 - len(header)), dtype=torch.int64,
                                     device=self.device))
        for t in tensors:
            self._broadcast(t)

    def follow(self) -> None:
        """A rank > 0 of a tensor-parallel engine: run each device call that
        rank 0 announces, with its inputs, until rank 0 announces a stop."""
        if self.mesh is None or self.mesh.is_main:
            raise RuntimeError("follow() is for the ranks > 0 of a tensor-parallel engine")
        dev, dim = self.device, self.ns2.dim
        while True:
            head = self._broadcast(torch.zeros(8, dtype=torch.int64, device=dev)).tolist()
            kind = head[0]
            if kind == _STOP:
                return
            if kind == _DURATIONS:
                t, samples = head[1:3]
                prompt = self._broadcast(torch.empty((1, samples), device=dev))
                ids = self._broadcast(torch.empty((1, t), dtype=torch.int64, device=dev))
                self._durations(prompt[0].cpu().numpy(), ids[0].cpu().numpy())
                continue
            b, t, f_bucket, samples, steps, dtype = head[1:7]
            if _DTYPES[dtype] != self._dtype:
                raise RuntimeError(f"rank 0 samples in {_DTYPES[dtype]}, this rank's engine "
                                   f"in {self._dtype}")
            ids = self._broadcast(torch.empty((b, t), dtype=torch.int64, device=dev))
            prompts = self._broadcast(torch.empty((b, samples), device=dev))
            lens = self._broadcast(torch.empty((b,), dtype=torch.int64, device=dev))
            noise = self._broadcast(torch.empty((b, f_bucket, dim), device=dev))
            with self._lock:
                self._sample_device(ids, prompts, lens, f_bucket, noise, steps or None)

    def stop_followers(self) -> None:
        """Rank 0: end the other ranks' `follow`."""
        if self._leads():
            with self._lock:
                self._announce([_STOP], [])

    def tts(
        self,
        text: str,
        prompt_audio: np.ndarray,
        seconds: Optional[float] = None,
        seed: int = 0,
    ) -> Tuple[np.ndarray, int]:
        """text + prompt waveform → (waveform float32 [-1,1], sample_rate).

        With the batcher running (`start_batcher`), concurrent requests
        that land in the same (text, frame) bucket share one device call;
        otherwise each request dispatches directly.
        """
        t0 = time.monotonic()
        req = self._prepare(text, prompt_audio, seconds, seed)
        if self._queue is not None:
            self._queue.put(req)
            req.done.wait()
            if req.error is not None:
                raise req.error
            result = req.result
        else:
            result = self._run_batch([req])[0]
        self._record(time.monotonic() - t0, req)
        return result, self._sr

    def _record(self, wall_s: float, req: "_Request"):
        with self._stats_lock:  # request threads record concurrently
            self._requests += 1
            self._latencies.append((wall_s, (req.t_bucket, req.f_bucket)))
            if len(self._latencies) > 1024:  # bounded ring
                del self._latencies[: len(self._latencies) - 1024]

    def stats(self) -> dict:
        """Serving metrics: request/device-call counts and end-to-end
        latency percentiles (over the last ≤1024 requests), per bucket."""
        with self._stats_lock:
            latencies, requests = list(self._latencies), self._requests
        lats = sorted(w for w, _ in latencies)

        def pct(p):
            if not lats:
                return None
            return round(lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3, 1)

        by_bucket: dict = {}
        for _, b in latencies:
            by_bucket[str(b)] = by_bucket.get(str(b), 0) + 1
        return {
            "requests": requests,
            "device_calls": self._device_calls,
            "latency_ms": {"p50": pct(0.5), "p95": pct(0.95), "p99": pct(0.99)},
            "requests_by_bucket": by_bucket,
            "compiled_buckets": sorted(self._warm),
        }

    def tts_long(
        self,
        text: str,
        prompt_audio: np.ndarray,
        seed: int = 0,
        crossfade_ms: float = 20.0,
    ) -> Tuple[np.ndarray, int]:
        """Long-form TTS: split ``text`` at sentence boundaries into chunks
        that fit the text buckets, synthesize each (duration-predictor
        length), and join with a short equal-power crossfade.

        Chunks are independently sampled — the shared prompt keeps the
        voice consistent (the zero-shot premise); the crossfade removes
        boundary clicks. With the batcher running, chunks are submitted
        concurrently and same-bucket chunks share device calls.
        """
        chunks = self._split_text(text)
        if len(chunks) == 1:
            return self.tts(chunks[0], prompt_audio, seed=seed)

        results: list = [None] * len(chunks)
        if self._queue is not None:
            # concurrent submission → the batcher groups same-bucket chunks
            errors: list = [None] * len(chunks)

            def worker(i):
                try:
                    results[i] = self.tts(
                        chunks[i], prompt_audio, seed=seed + i
                    )[0]
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errors[i] = e

            threads = [
                threading.Thread(target=worker, args=(i,))
                for i in range(len(chunks))
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for e in errors:
                if e is not None:
                    raise e
        else:
            for i, c in enumerate(chunks):
                results[i] = self.tts(c, prompt_audio, seed=seed + i)[0]

        fade = int(self._sr * crossfade_ms / 1e3)
        out = results[0]
        for nxt in results[1:]:
            f = min(fade, len(out), len(nxt))
            if f > 0:
                ramp = np.sin(
                    np.linspace(0, np.pi / 2, f, dtype=np.float32)
                )
                mixed = out[-f:] * np.flip(ramp) + nxt[:f] * ramp
                out = np.concatenate([out[:-f], mixed, nxt[f:]])
            else:
                out = np.concatenate([out, nxt])
        return out, self._sr

    def tts_long_stream(
        self,
        text: str,
        prompt_audio: np.ndarray,
        seed: int = 0,
        crossfade_ms: float = 20.0,
    ):
        """Generator of float32 waveform chunks — the streaming form of
        `tts_long`: each sentence chunk is emitted as soon as it is
        synthesized (time-to-first-audio ≈ one chunk's latency instead of
        the whole utterance), with the crossfade applied at boundaries by
        holding back ``fade`` samples between chunks. Concatenating the
        yields equals `tts_long`'s output for the same seeds."""
        chunks = self._split_text(text)
        fade = int(self._sr * crossfade_ms / 1e3)
        held: Optional[np.ndarray] = None
        for i, c in enumerate(chunks):
            wav = self.tts(c, prompt_audio, seed=seed + i)[0]
            if held is not None:
                f = min(fade, len(held), len(wav))
                if f > 0:
                    r = np.sin(np.linspace(0, np.pi / 2, f, dtype=np.float32))
                    mixed = held[-f:] * np.flip(r) + wav[:f] * r
                    yield np.concatenate([held[:-f], mixed])
                    wav = wav[f:]
                elif len(held):
                    yield held
            if i < len(chunks) - 1:
                k = min(fade, len(wav))
                held, emit = wav[len(wav) - k:], wav[: len(wav) - k]
            else:
                held, emit = None, wav
            if len(emit):
                yield emit
        if held is not None and len(held):
            yield held

    def _split_text(self, text: str) -> list:
        """Sentence-boundary split, greedily re-packed so every chunk fits
        the largest text bucket (token count measured with the real
        tokenizer)."""
        import re

        budget = max(self.text_buckets)
        pieces = [
            p.strip() for p in re.split(r"(?<=[.!?;:])\s+", text) if p.strip()
        ]

        def n_tok(s: str) -> int:
            return np.asarray(
                self.ns2.tokenizer.texts_to_tensor_ids([s])
            ).shape[1]

        chunks, current = [], ""
        for p in pieces:
            candidate = f"{current} {p}".strip() if current else p
            if current and n_tok(candidate) > budget:
                chunks.append(current)
                current = p
            else:
                current = candidate
        if current:
            chunks.append(current)

        # a single sentence can still overflow: split it on whitespace
        final = []
        for c in chunks:
            if n_tok(c) <= budget:
                final.append(c)
                continue
            words = c.split()
            cur = ""
            for w in words:
                cand = f"{cur} {w}".strip() if cur else w
                if cur and n_tok(cand) > budget:
                    final.append(cur)
                    cur = w
                else:
                    cur = cand
            if cur:
                final.append(cur)
        return final or [text]

    # ------------------------------------------------------------------ #
    # dynamic batching
    # ------------------------------------------------------------------ #

    def start_batcher(self):
        """Spawn the micro-batching worker: requests arriving within
        ``batch_window_ms`` of each other in the same bucket run as one
        batched device call (up to ``max_batch``)."""
        import queue

        if self._batcher is not None:
            return
        self._queue = queue.Queue()
        self._stop = threading.Event()
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self._batcher.start()

    def stop_batcher(self):
        if self._batcher is None:
            return
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._batcher.join()
        self._batcher = None
        self._queue = None

    def _batch_loop(self):
        import queue

        while not self._stop.is_set():
            first = self._queue.get()
            if first is None:
                continue
            group, holdback = [first], []
            deadline = time.monotonic() + self.batch_window_ms / 1e3
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                if (nxt.t_bucket, nxt.f_bucket) == (
                    first.t_bucket, first.f_bucket
                ):
                    group.append(nxt)
                else:
                    holdback.append(nxt)
            for item in holdback:  # different bucket: next rounds
                self._queue.put(item)
            try:
                outs = self._run_batch(group)
                for r, out in zip(group, outs):
                    r.result = out
            except Exception as e:  # surface to every waiter
                for r in group:
                    r.error = e
            for r in group:
                r.done.set()


class TTSServer(ThreadingHTTPServer):
    """`POST /tts` + `GET /healthz` around a `TTSEngine` (stdlib only)."""

    daemon_threads = True

    def __init__(self, engine: TTSEngine, address: Tuple[str, int] = ("127.0.0.1", 0)):
        self.engine = engine
        try:  # build the FLAC/MP3/Ogg decoder now, not inside the first such request
            audioio.library()
        except audioio.DecoderUnavailable as e:
            print(f"non-WAV prompts will be refused (415): {e}", flush=True)
        super().__init__(address, _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def _wav_stream_header(sample_rate: int) -> bytes:
    """WAV header with unknown (maximal) length — for chunked streaming."""
    import struct

    return (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                sample_rate * 2, 2, 16)
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 for Transfer-Encoding: chunked (every non-streaming response
    # sets Content-Length, so keep-alive stays correct)
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet
        pass

    def _stream_tts(self, engine, text, prompt, seed):
        """Chunked audio/wav: each sentence chunk is flushed as soon as it
        is synthesized — time-to-first-audio ≈ one chunk's latency."""
        gen = engine.tts_long_stream(text, np.asarray(prompt), seed=seed)
        first = next(gen)  # synthesize before headers so errors still 400
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(b: bytes):
            self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

        chunk(_wav_stream_header(engine._sr))
        chunk(pcm16(first))
        for wav in gen:
            chunk(pcm16(wav))
        self.wfile.write(b"0\r\n\r\n")

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            return self._json(200, self.server.engine.stats())
        if self.path != "/healthz":
            return self._json(404, {"error": "not found"})
        eng = self.server.engine
        self._json(200, {
            "status": "ok",
            "sample_rate": eng._sr,
            "device": str(eng.device),
            "compiled_buckets": sorted(map(list, eng._warm)),
            "text_buckets": list(eng.text_buckets),
            "frame_buckets": list(eng.frame_buckets),
            "batching": eng._batcher is not None,
            "device_calls": eng._device_calls,
        })

    def do_POST(self):
        if self.path != "/tts":
            return self._json(404, {"error": "not found"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            text = req["text"]
            if "prompt_wav_base64" in req:
                raw = base64.b64decode(req["prompt_wav_base64"])
                prompt, _sr = decode_audio_bytes(raw)
            elif "prompt_path" in req:
                prompt, _sr = load_audio(req["prompt_path"])
            else:
                raise KeyError("prompt_wav_base64 or prompt_path required")
            engine = self.server.engine
            if req.get("stream"):
                return self._stream_tts(
                    engine, text, prompt, int(req.get("seed", 0))
                )
            n_tokens = np.asarray(
                engine.ns2.tokenizer.texts_to_tensor_ids([text])
            ).shape[1]
            if n_tokens > max(engine.text_buckets) or req.get("long"):
                # long-form: sentence-chunked synthesis instead of a 400
                wav, sr = engine.tts_long(
                    text, np.asarray(prompt), seed=int(req.get("seed", 0))
                )
            else:
                wav, sr = engine.tts(
                    text, np.asarray(prompt), seconds=req.get("seconds"),
                    seed=int(req.get("seed", 0)),
                )
        except (KeyError, ValueError) as e:
            return self._json(400, {"error": str(e)})
        except audioio.DecoderUnavailable as e:  # a non-WAV prompt on a host without the decoder
            return self._json(415, {"error": str(e)})
        body = _wav_bytes(wav, sr)
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _demo_engine(device: Optional[str] = None) -> TTSEngine:
    """Tiny randomly-initialised conditional pipeline at the JAX demo's
    widths (serving plumbing demo — load trained weights for real speech)."""
    import naturalspeech2_tpu_torch as ns
    from naturalspeech2_tpu_torch.utils.tokenizer import Tokenizer

    torch.manual_seed(0)
    codec = ns.SoundStream(
        codebook_dim=16, channels=4, num_quantizers=2, codebook_size=16,
        use_pallas_rvq=False,
    )
    model = ns.Model(
        dim=16, depth=1, heads=2, dim_head=8, wavenet_layers=1,
        wavenet_stacks=1, condition_on_prompt=True, dim_prompt=24,
        num_latents_m=4, resampler_depth=1, use_flash_attn=False,
    )
    ns2 = ns.NaturalSpeech2(
        model=model, codec=codec, timesteps=4, tokenizer=Tokenizer(),
        duration_pitch_dim=24, aligner_dim_in=8, aligner_dim_hidden=24,
        aligner_attn_channels=8, pitch_emb_dim=32, pitch_emb_pp_hidden_dim=24,
        phoneme_enc_kwargs=dict(dim=24, dim_hidden=24, kernel_size=3, depth=1,
                                dim_head=8, heads=2, use_flash=False),
        prompt_enc_kwargs=dict(dims=(24, 24), depth=1, heads=2, dim_head=8,
                               kernel_size=3, use_flash_attn=False),
        duration_pitch_kwargs=dict(dim_encoded_prompts=24, depth=1,
                                   kernel_size=3, heads=2, dim_head=8,
                                   dim_hidden=24, use_flash_attn=False,
                                   num_convolutions_per_block=1,
                                   num_convs_per_resnet_block=1),
    )
    return TTSEngine(
        ns2, text_buckets=(16, 32), frame_buckets=(8, 16), prompt_samples=640,
        timesteps=2, cond_scale=1.0, device=device,
    )


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--demo", action="store_true",
                    help="serve a tiny random model (plumbing demo)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if not args.demo:
        raise SystemExit(
            "construct TTSServer(TTSEngine(ns2)) around a trained model, or pass "
            "--demo for the plumbing demo"
        )
    eng = _demo_engine(args.device)
    print("warming serving buckets...", flush=True)
    print("warm:", eng.warmup())
    eng.start_batcher()
    srv = TTSServer(eng, (args.host, args.port))
    print(f"serving on http://{args.host}:{srv.port}  (POST /tts, GET /healthz)")
    srv.serve_forever()
