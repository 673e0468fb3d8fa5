"""The port's CLI (`python -m naturalspeech2_tpu_torch`, `ns2-torch`) on
the CPU with tiny configs: `train` → checkpoint → `sample`, conditional
`sample` from text and a WAV prompt, `build_engine` from a checkpoint,
`serve --demo` over HTTP, `info` against the JAX package's `info`,
`codec-train` with a resume, `import-torch --encodec`, `train` → `sample`
with the Encodec codec, `--steps-per-dispatch` in `train` and
`codec-train`, and the named refusals of what is not ported or cannot
run."""

import base64
import json
import os
import queue
import re
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from naturalspeech2_tpu import cli as jcli
from naturalspeech2_tpu_torch import cli
from naturalspeech2_tpu_torch.data import load_audio, write_wav
from naturalspeech2_tpu_torch.serve import _wav_bytes
from naturalspeech2_tpu_torch.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SERVE_START_S = 300  # the demo's bucket warm-up takes seconds on the CPU

TINY = {
    "codec": {"type": "soundstream", "codebook_dim": 16, "channels": 4, "num_quantizers": 2,
              "codebook_size": 16, "use_pallas_rvq": False},
    "model": {"dim": 16, "depth": 1, "heads": 2, "dim_head": 8, "wavenet_layers": 2,
              "wavenet_stacks": 2, "use_flash_attn": False},
    "ns2": {"timesteps": 4},
    "trainer": {"sample_length": 4},
}
# tests/test_cli.py's conditional config
CONDITIONAL = {
    "codec": TINY["codec"],
    "model": {**TINY["model"], "wavenet_layers": 1, "wavenet_stacks": 1,
              "condition_on_prompt": True, "dim_prompt": 24, "num_latents_m": 4,
              "resampler_depth": 1},
    "ns2": {
        "timesteps": 4, "duration_pitch_dim": 24, "aligner_dim_in": 8, "aligner_dim_hidden": 24,
        "aligner_attn_channels": 8, "pitch_emb_dim": 32, "pitch_emb_pp_hidden_dim": 24,
        "phoneme_enc_kwargs": dict(dim=24, dim_hidden=24, kernel_size=3, depth=1, dim_head=8,
                                   heads=2, use_flash=False),
        "prompt_enc_kwargs": dict(dims=(24, 24), depth=1, heads=2, dim_head=8, kernel_size=3,
                                  use_flash_attn=False),
        "duration_pitch_kwargs": dict(dim_encoded_prompts=24, depth=1, kernel_size=3, heads=2,
                                      dim_head=8, dim_hidden=24, use_flash_attn=False,
                                      num_convolutions_per_block=1,
                                      num_convs_per_resnet_block=1),
    },
    "trainer": {"sample_length": 4},
}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Configs, a folder of WAVs and a conditional checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    folder = root / "wavs"
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        write_wav(folder / f"a{i}.wav", rng.uniform(-1, 1, 4000), 24000)
    (root / "tiny.json").write_text(json.dumps(TINY))
    (root / "cond.json").write_text(json.dumps(CONDITIONAL))
    ns2 = cli.build_ns2(cli.load_config(str(root / "cond.json")))
    trainer = Trainer(ns2, batches=iter(()), train_batch_size=1, save_and_sample_every=10**9,
                      results_folder=str(root / "cond_results"))
    with torch.no_grad():  # EMA apart from the raw weights
        for e in trainer.ema.values():
            e.add_(0.01)
    return {"root": root, "folder": folder, "tiny": str(root / "tiny.json"),
            "cond": str(root / "cond.json"), "cond_ckpt": trainer.save(0)}


def test_train_amp_runs_two_steps(work, tmp_path):
    """`train --amp` trains in bf16 (`Trainer(amp=True)`): two steps on the
    CPU, finite losses, an f32 checkpoint."""
    results = tmp_path / "results"
    rc = cli.main(["train", "--amp", "--folder", str(work["folder"]), "--config", work["tiny"],
                   "--steps", "2", "--batch-size", "2", "--save-every", "2",
                   "--results", str(results), "--data-seconds", "0.04", "--log-every", "1", *CPU])
    assert rc == 0
    lines = [json.loads(line) for line in (results / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2] and all(np.isfinite(m["loss"]) for m in lines)
    payload = torch.load(results / "model-1.ckpt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in payload["params"].values()
               if v.is_floating_point())


def test_train_then_sample(work, tmp_path):
    results = tmp_path / "results"
    rc = cli.main(["train", "--folder", str(work["folder"]), "--config", work["tiny"],
                   "--steps", "2", "--batch-size", "2", "--save-every", "2",
                   "--results", str(results), "--data-seconds", "0.04", "--log-every", "1", *CPU])
    assert rc == 0
    ckpt = results / "model-1.ckpt"
    assert ckpt.exists() and (results / "sample-1.wav").exists()
    assert [json.loads(line)["step"] for line in
            (results / "metrics.jsonl").read_text().splitlines()] == [1, 2]

    out = tmp_path / "out"
    rc = cli.main(["sample", "--checkpoint", str(ckpt), "--config", work["tiny"],
                   "--out", str(out), "--length", "4", "--batch", "2", "--timesteps", "2", *CPU])
    assert rc == 0
    wavs = sorted(out.glob("sample-*.wav"))
    assert len(wavs) == 2
    audio, sr = load_audio(wavs[0])
    assert sr == 24000 and audio.shape == (4 * 320,)


def test_conditional_sample_from_text_and_prompt(work, tmp_path):
    """`sample --text --prompt` on a conditional checkpoint, from the EMA
    weights unless ``--no-ema``."""
    outs = {}
    for flag in ([], ["--no-ema"]):
        out = tmp_path / f"out{len(flag)}"
        rc = cli.main(["sample", "--checkpoint", work["cond_ckpt"], "--config", work["cond"],
                       "--out", str(out), "--length", "4", "--timesteps", "2",
                       "--cfg-interval", "0.1", "0.8", "--text", "hello world",
                       "--text", "good morning", "--prompt",
                       str(sorted(work["folder"].glob("*.wav"))[0]), *flag, *CPU])
        assert rc == 0
        wavs = sorted(out.glob("sample-*.wav"))
        assert len(wavs) == 2
        outs[len(flag)] = [load_audio(w)[0] for w in wavs]
        assert all(a.shape == (4 * 320,) and np.isfinite(a).all() for a in outs[len(flag)])
    assert np.abs(outs[0][0] - outs[1][0]).max() > 1e-3  # the EMA copy is not the raw weights


def test_sample_bf16_flag(work, tmp_path):
    """`sample --bf16` runs the denoiser in bf16 (a bf16 copy of its
    parameters for the call) and writes a finite waveform close to the f32
    one (correlation ≥ 0.98, JAX's bf16 bound)."""
    args = ["sample", "--checkpoint", work["cond_ckpt"], "--config", work["cond"], "--length",
            "4", "--timesteps", "2", "--text", "hello world", "--prompt",
            str(sorted(work["folder"].glob("*.wav"))[0]), *CPU]
    waves = {}
    for flag in ([], ["--bf16"]):
        out = tmp_path / f"out{len(flag)}"
        assert cli.main([*args, "--out", str(out), *flag]) == 0
        waves[len(flag)] = load_audio(out / "sample-0.wav")[0]
    assert waves[1].shape == (4 * 320,) and np.isfinite(waves[1]).all()
    assert not np.array_equal(waves[0], waves[1])  # the bf16 path ran
    assert np.corrcoef(waves[0], waves[1])[0, 1] >= 0.98


def test_serve_bf16_flag(work, monkeypatch):
    """`serve --bf16` builds its engine with ``dtype="bfloat16"``: the
    denoiser's parameters bf16, the rest f32 (the server itself stubbed)."""
    from naturalspeech2_tpu_torch import serve as serve_mod

    served = []

    class Server:
        port = 0

        def __init__(self, engine, address):
            served.append(engine)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(serve_mod, "TTSServer", Server)
    assert cli.main(["serve", "--config", work["cond"], "--checkpoint", work["cond_ckpt"],
                     "--bf16", "--no-warmup", "--timesteps", "2", *CPU]) == 0
    ns2 = served[0].ns2
    assert {p.dtype for p in ns2.model.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in ns2.prompt_enc.parameters()} == {torch.float32}


def test_build_engine_from_checkpoint(work):
    engine = cli.build_engine(work["cond"], work["cond_ckpt"], timesteps=2, cond_scale=1.0,
                              device="cpu", text_buckets=(16,), frame_buckets=(8,),
                              prompt_samples=640)
    assert engine.device.type == "cpu" and engine.timesteps == 2
    payload = torch.load(work["cond_ckpt"], weights_only=True)
    for name, p in engine.ns2.named_parameters():  # the EMA weights were loaded
        torch.testing.assert_close(p, payload["ema_params"][name], rtol=0, atol=0)
    wav, sr = engine.tts("hi", np.zeros(640, np.float32), seconds=8 * 320 / 24000)
    assert sr == 24000 and wav.shape == (8 * 320,) and np.isfinite(wav).all()


def test_serve_demo_over_http():
    """`python -m naturalspeech2_tpu_torch serve --demo --device cpu`: warm
    the demo's buckets, serve, answer /healthz and /tts; the server must
    say it serves within SERVE_START_S, else it is killed and the test
    fails."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "naturalspeech2_tpu_torch", "serve", "--demo", "--port", "0",
         *CPU], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        pending: queue.Queue = queue.Queue()

        def read():
            for out_line in proc.stdout:
                pending.put(out_line)
            pending.put("")  # the server exited

        threading.Thread(target=read, daemon=True).start()
        deadline, lines = time.monotonic() + SERVE_START_S, []
        while not (lines and lines[-1].startswith("serving on")):
            try:
                line = pending.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                pytest.fail(f"no 'serving on' in {SERVE_START_S} s:\n{''.join(lines)}")
            if not line:
                break
            lines.append(line)
        match = re.search(r"http://127\.0\.0\.1:(\d+)", lines[-1]) if lines else None
        assert match, "".join(lines)
        base = f"http://127.0.0.1:{match.group(1)}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["batching"] is True
        assert health["compiled_buckets"] == [[16, 8], [16, 16], [32, 8], [32, 16]]
        body = json.dumps({"text": "hello world", "seconds": 8 * 320 / 24000,
                           "prompt_wav_base64": base64.b64encode(
                               _wav_bytes(np.zeros(640, np.float32), 24000)).decode()})
        req = urllib.request.Request(f"{base}/tts", data=body.encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.read()[:4] == b"RIFF"
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()


def _info_lines(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith(("model:", "codec:", "  "))]


def test_info_matches_jax(work, capsys):
    """Unconditional: the JAX `info` output line for line."""
    assert jcli.main(["info", "--config", work["tiny"]]) == 0
    expected = _info_lines(capsys.readouterr().out)
    assert cli.main(["info", "--config", work["tiny"]]) == 0
    assert _info_lines(capsys.readouterr().out) == expected


def test_info_conditional_counts_match_jax(work, capsys):
    """Conditional: each module's parameter count against the JAX tree of
    the same config (initialised under jit, as `info` initialises it)."""
    cfg = jcli.load_config(work["cond"])
    jns2 = jcli.build_ns2(cfg)
    batch = {k: np.asarray(v) for k, v in next(jcli._dummy_batches(jns2, 640)).items()}
    audio = batch.pop("audio")
    key = jax.random.PRNGKey(0)
    rngs = {n: key for n in ("params", "times", "noise", "cfg", "dropout")}
    params = dict(jax.jit(lambda a, e: jns2.init(rngs, a, **e))(audio, batch)["params"])
    params["codec"] = jax.jit(jns2.codec.init)(key, audio)["params"]
    expected = {name: sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(tree))
                for name, tree in params.items()}
    assert cli.main(["info", "--config", work["cond"]]) == 0
    got = {}
    for line in _info_lines(capsys.readouterr().out):
        parts = line.split()
        if line.startswith("  ") and parts[0] != "TOTAL":
            got[parts[0]] = int(parts[1].replace(",", ""))
    assert got == expected


REFUSALS = {
    "orbax": (["train", "--checkpoint-backend", "orbax"], NotImplementedError, "item 22"),
    # a batch the data axis does not divide, refused before any rank starts
    "param_sharding": (["train", "--param-sharding", "fsdp", "--mesh-data", "3",
                        "--batch-size", "2"], ValueError,
                       "train_batch_size (2) must be divisible by the mesh's data axis (3"),
    # under a launcher whose process count is not --mesh-data
    "mesh_data": (["train", "--mesh-data", "2"], ValueError, "does not match WORLD_SIZE=3"),
    "serve_tp": (["serve", "--tp", "2", "--device", "cuda"], RuntimeError,
                 "--tp 2 asks for 2 cards; this host has 0"),
    # more cards than the host has (the tests run without a card)
    "codec_train_mesh": (["codec-train", "--mesh-data", "2", "--device", "cuda"], RuntimeError,
                         "--mesh-data 2 asks for 2 cards; this host has 0"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_named_refusals(work, case, monkeypatch):
    """Each refusal names what it refuses: orbax (#22), and the parallel
    commands' bad requests (tensor-parallel serving on more cards than the
    host has among them); the parallel runs themselves are in
    tests/test_torch_parallel.py and tests/test_torch_tp.py."""
    argv, error, match = REFUSALS[case]
    command, extra = argv[0], argv[1:]
    cfg = work["cond"] if command == "serve" else work["tiny"]
    args = [command, "--config", cfg, *CPU, *extra]
    if command in ("train", "codec-train"):
        args += ["--folder", str(work["folder"])]
    if command in ("sample", "serve"):
        args += ["--checkpoint", work["cond_ckpt"] if command == "serve" else
                 str(_tiny_checkpoint(work))]
    if case == "mesh_data":
        monkeypatch.setenv("WORLD_SIZE", "3")
        monkeypatch.setenv("RANK", "0")
    with pytest.raises(error, match=re.escape(match)):
        cli.main(args)


@pytest.mark.parametrize("command", ["train", "codec-train"])
def test_steps_per_dispatch_runs(work, tmp_path, command, capsys):
    """`train --steps-per-dispatch 2` and `codec-train --steps-per-dispatch 2`
    run two steps in one dispatch: the trainer logs
    one line at step 2 with the dispatch's means; the codec trainer ends
    at step 2 and logs it."""
    results = tmp_path / "results"
    common = ["--folder", str(work["folder"]), "--config", work["tiny"], "--steps", "2",
              "--batch-size", "2", "--save-every", "2", "--results", str(results),
              "--data-seconds", "0.04", "--log-every", "1", "--steps-per-dispatch", "2", *CPU]
    assert cli.main([command, *common]) == 0
    out = capsys.readouterr().out
    if command == "train":
        lines = [json.loads(line) for line in (results / "metrics.jsonl").read_text().splitlines()]
        assert [m["step"] for m in lines] == [2] and np.isfinite(lines[0]["loss"])
        assert (results / "model-1.ckpt").exists()
    else:
        assert "codec step 2:" in out and "codec step 1:" not in out
        assert torch.load(results / "codec-2.ckpt", weights_only=True)["step"] == 2


@pytest.mark.parametrize("sampler", ["dpmpp", "ddpm"])
def test_sample_with_sampler(work, tmp_path, sampler):
    """`sample --sampler dpmpp|ddpm` (once a named refusal) runs on the CPU
    and writes finite WAVs that differ from DDIM's from the same seed."""
    base = ["sample", "--checkpoint", str(_tiny_checkpoint(work)), "--config", work["tiny"],
            "--length", "4", "--batch", "1", "--timesteps", "3", *CPU]
    waves = {}
    for name in ("ddim", sampler):
        out = tmp_path / name
        assert cli.main([*base, "--out", str(out), "--sampler", name]) == 0
        audio, sr = load_audio(out / "sample-0.wav")
        assert sr == 24000 and audio.shape == (4 * 320,) and np.isfinite(audio).all()
        waves[name] = audio
    assert not np.array_equal(waves["ddim"], waves[sampler])


def test_engine_serves_with_the_configured_sampler(work):
    """A served config with ``ns2.sampler`` builds an engine that samples
    with it."""
    cfg = json.loads(Path(work["cond"]).read_text())
    cfg["ns2"]["sampler"] = "dpmpp"
    path = work["root"] / "cond_dpmpp.json"
    path.write_text(json.dumps(cfg))
    engine = cli.build_engine(str(path), work["cond_ckpt"], timesteps=3, cond_scale=2.0,
                              device="cpu", text_buckets=(16,), frame_buckets=(8,),
                              prompt_samples=640)
    assert engine.ns2.sampler_name == "dpmpp"
    wav, sr = engine.tts("hi", np.zeros(640, np.float32), seconds=8 * 320 / 24000)
    assert sr == 24000 and wav.shape == (8 * 320,) and np.isfinite(wav).all()


def _tiny_checkpoint(work) -> Path:
    path = work["root"] / "tiny.ckpt"
    if not path.exists():
        ns2 = cli.build_ns2(cli.load_config(work["tiny"]))
        torch.save({"params": ns2.state_dict()}, path)
    return path


@pytest.mark.parametrize("command", ["build_engine", "sample", "serve", "train"])
def test_no_card_no_fallback(work, command):
    """Without ``--device cpu`` every subcommand that runs on a device wants
    the card and raises on a host without one, rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the commands would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if command == "build_engine":
            cli.build_engine(work["cond"], work["cond_ckpt"])
        else:
            args = {"sample": ["sample", "--checkpoint", work["cond_ckpt"]],
                    "serve": ["serve", "--demo"],
                    "train": ["train", "--folder", str(work["folder"])]}
            cli.main([*args[command], "--config", work["cond"]])


def test_info_needs_no_device(work, capsys):
    """`info` only counts parameters: it takes no ``--device`` and runs
    without a card."""
    assert cli.main(["info", "--config", work["cond"]]) == 0
    assert "TOTAL" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["info", "--config", work["cond"], *CPU])


def test_config_and_flagship(tmp_path):
    cfg = cli.load_config(None)
    assert cfg == jcli.load_config(None)
    assert cfg["model"]["dim"] == 128 and cfg["ns2"]["timesteps"] == 1000
    ns2 = cli.build_ns2(cfg)
    assert ns2.tokenizer is not None and ns2.tokenizer.vocab_size == 125
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"modell": {"dim": 8}}))
    with pytest.raises(AssertionError, match="unknown config section"):
        cli.main(["info", "--config", str(bad)])


# the Encodec codec at the widths of tests/test_torch_encodec.py (hop 8)
ENCODEC = {"type": "encodec", "codebook_dim": 16, "num_filters": 4, "upsampling_ratios": [4, 2],
           "num_quantizers": 2, "codebook_size": 32, "num_lstm_layers": 1,
           "use_pallas_rvq": False}


def test_codec_train_and_resume(work, tmp_path):
    """`codec-train` of the Encodec (adversarial from step 1) writes a
    checkpoint every ``--save-every`` steps and at the end; ``--resume``
    continues from the checkpoint's step to ``--steps`` (either codec's
    steps against JAX: tests/test_torch_codec_trainer.py)."""
    cfg = tmp_path / "codec.json"
    cfg.write_text(json.dumps({"codec": ENCODEC}))
    results = tmp_path / "results"
    base = ["codec-train", "--folder", str(work["folder"]), "--config", str(cfg),
            "--batch-size", "2", "--data-seconds", "0.04", "--adversarial-weight", "1",
            "--warmup", "1", "--save-every", "2", "--results", str(results), "--log-every", "1",
            *CPU]
    assert cli.main([*base, "--steps", "3"]) == 0
    assert sorted(p.name for p in results.glob("codec-*.ckpt")) == ["codec-2.ckpt", "codec-3.ckpt"]
    payload = torch.load(results / "codec-3.ckpt", weights_only=True)
    assert payload["step"] == 3 and "disc_params" in payload
    assert cli.main([*base, "--steps", "4", "--resume", str(results / "codec-3.ckpt")]) == 0
    payload = torch.load(results / "codec-4.ckpt", weights_only=True)
    assert payload["step"] == 4 and payload["disc_updates"] == 3


def test_import_torch_encodec(tmp_path):
    """`import-torch --encodec` on a HuggingFace-layout state dict (the
    port's own Encodec's, renamed: ``layers.{i}``, ``block.{j}``, one
    ``codebook.embed`` per quantizer) gives back the same tensors, loadable
    with ``strict=True``."""
    from naturalspeech2_tpu_torch.models.encodec import Encodec

    torch.manual_seed(0)
    codec = Encodec(codebook_dim=16, num_filters=4, codebook_size=32, num_lstm_layers=1)
    hf = {}
    for k, v in codec.state_dict().items():
        if k == "codebooks":
            hf.update({f"quantizer.layers.{q}.codebook.embed": v[q] for q in range(8)})
        else:
            hf[re.sub(r"block_(\d)", r"block.\1", re.sub(r"layer_(\d+)", r"layers.\1", k))] = v
    path, out = tmp_path / "hf.pt", tmp_path / "encodec.ckpt"
    torch.save(hf, path)
    assert cli.main(["import-torch", "--encodec", "--input", str(path), "--output", str(out)]) == 0
    fresh = Encodec(codebook_dim=16, num_filters=4, codebook_size=32, num_lstm_layers=1)
    fresh.load_state_dict(torch.load(out, weights_only=True)["params"], strict=True)
    for k, v in codec.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_train_sample_and_info_with_encodec(work, tmp_path, capsys):
    """``{"codec": {"type": "encodec"}}``: `train` → checkpoint → `sample`
    on the CPU (waveforms of length × hop), and `info` (Encodec's hop and
    rate) against the JAX package's `info`."""
    cfg = tmp_path / "encodec.json"
    cfg.write_text(json.dumps({**TINY, "codec": ENCODEC}))
    results = tmp_path / "results"
    assert cli.main(["train", "--folder", str(work["folder"]), "--config", str(cfg),
                     "--steps", "2", "--batch-size", "2", "--save-every", "2",
                     "--results", str(results), "--data-seconds", "0.04", "--log-every", "1",
                     *CPU]) == 0
    out = tmp_path / "out"
    assert cli.main(["sample", "--checkpoint", str(results / "model-1.ckpt"), "--config", str(cfg),
                     "--out", str(out), "--length", "6", "--timesteps", "2", *CPU]) == 0
    audio, sr = load_audio(out / "sample-0.wav")
    assert sr == 24000 and audio.shape == (6 * 8,) and np.isfinite(audio).all()
    capsys.readouterr()
    assert jcli.main(["info", "--config", str(cfg)]) == 0
    expected = _info_lines(capsys.readouterr().out)
    assert cli.main(["info", "--config", str(cfg)]) == 0
    got = _info_lines(capsys.readouterr().out)
    assert got == expected and "codec: hop=8 sample_hz=24000" in got[1]


def test_engine_serves_with_encodec(work, tmp_path):
    """A conditional config on the Encodec codec: `cli.build_engine` from a
    checkpoint and `TTSEngine.tts` on the CPU (the prompt encoded with
    curtail_from_left, the sample decoded by Encodec)."""
    cfg = {**CONDITIONAL, "codec": ENCODEC}
    path, ckpt = tmp_path / "cond_encodec.json", tmp_path / "cond_encodec.ckpt"
    path.write_text(json.dumps(cfg))
    torch.save({"params": cli.build_ns2(cli.load_config(str(path))).state_dict()}, ckpt)
    engine = cli.build_engine(str(path), str(ckpt), timesteps=2, cond_scale=2.0, device="cpu",
                              text_buckets=(16,), frame_buckets=(8,), prompt_samples=640)
    wav, sr = engine.tts("hi", np.zeros(643, np.float32), seconds=8 * 8 / 24000)
    assert sr == 24000 and wav.shape == (8 * 8,) and np.isfinite(wav).all()
