"""`train --mesh-data 2` and `codec-train --mesh-data 2` of the port's CLI
on the CPU, end to end at tests/test_torch_cli.py's tiny config: the
command starts two gloo ranks, trains two steps, and rank 0 alone logs
and writes the checkpoint (and the trainer's EMA sample).

Both commands run in one child process, started once for the module in
a session of its own, with a time limit: past it the whole session (the
command and the ranks it started) is killed and the tests fail."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from naturalspeech2_tpu_torch import cli
from naturalspeech2_tpu_torch.data import load_audio, write_wav

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 240
TINY = {
    "codec": {"type": "soundstream", "codebook_dim": 16, "channels": 4, "num_quantizers": 2,
              "codebook_size": 16, "use_pallas_rvq": False},
    "model": {"dim": 16, "depth": 1, "heads": 2, "dim_head": 8, "wavenet_layers": 2,
              "wavenet_stacks": 2, "use_flash_attn": False},
    "ns2": {"timesteps": 4},
    "trainer": {"sample_length": 4},
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    folder = root / "wavs"
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        write_wav(folder / f"a{i}.wav", rng.uniform(-1, 1, 4000), 24000)
    config = root / "tiny.json"
    config.write_text(json.dumps(TINY))
    common = ["--device", "cpu", "--mesh-data", "2", "--folder", str(folder), "--config",
              str(config), "--steps", "2", "--batch-size", "2", "--save-every", "2",
              "--data-seconds", "0.04", "--log-every", "1"]
    commands = [["train", "--param-sharding", "fsdp", "--results", str(root / "train"), *common],
                ["codec-train", "--steps-per-dispatch", "1", "--results", str(root / "codec"),
                 *common]]
    code = ("import sys\nfrom naturalspeech2_tpu_torch import cli\n"
            f"sys.exit(max(cli.main(argv) for argv in {commands!r}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=LIMIT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the data-parallel commands exceeded their {LIMIT_S}-s limit; killed")
    assert proc.returncode == 0, out[-6000:]
    return root, out


def test_train_mesh_data_2(run):
    """Two steps, one line a step in metrics.jsonl, one checkpoint holding
    the whole model and one EMA sample, all from rank 0."""
    root, out = run
    results = root / "train"
    lines = [json.loads(line) for line in (results / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2] and all(np.isfinite(m["loss"]) for m in lines)
    assert out.count("training complete") == 1
    assert sorted(p.name for p in results.glob("model-*.ckpt")) == ["model-1.ckpt"]
    payload = torch.load(results / "model-1.ckpt", weights_only=True)
    assert payload["step"] == 2
    ns2 = cli.build_ns2(cli.load_config(str(root / "tiny.json")))
    ns2.load_state_dict(payload["params"], strict=True)
    ns2.load_state_dict({**payload["params"], **payload["ema_params"]}, strict=True)
    audio, sr = load_audio(results / "sample-1.wav")
    assert sr == 24000 and audio.shape == (4 * 320,) and np.isfinite(audio).all()


def test_codec_train_mesh_data_2(run):
    """Two codec steps, logged once each, and one checkpoint at step 2."""
    root, out = run
    assert out.count("codec step 1:") == 1 and out.count("codec step 2:") == 1
    assert sorted(p.name for p in (root / "codec").glob("codec-*.ckpt")) == ["codec-2.ckpt"]
    payload = torch.load(root / "codec" / "codec-2.ckpt", weights_only=True)
    assert payload["step"] == 2
    codec = cli.build_codec(cli.load_config(str(root / "tiny.json"))["codec"])
    codec.load_state_dict(payload["params"], strict=True)
