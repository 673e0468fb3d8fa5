"""The port stands alone: importing it loads no JAX, flax or JAX package,
and `chip_smoke.py` refuses to run without a CUDA device, both from the
repository and from a directory holding nothing but the script."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(args, cwd, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout,
    )


def test_import_loads_no_jax():
    code = (
        "import json, sys\n"
        "import naturalspeech2_tpu_torch\n"
        "import naturalspeech2_tpu_torch.ops, naturalspeech2_tpu_torch.params\n"
        "import naturalspeech2_tpu_torch.trainer, naturalspeech2_tpu_torch.data\n"
        "import naturalspeech2_tpu_torch.ops.flash_attention, naturalspeech2_tpu_torch.ops.rvq\n"
        "import naturalspeech2_tpu_torch.ops.attention, naturalspeech2_tpu_torch.ops.pitch\n"
        "import naturalspeech2_tpu_torch.models.encoders, naturalspeech2_tpu_torch.models.aligner\n"
        "import naturalspeech2_tpu_torch.ops.wavenet_kernel, naturalspeech2_tpu_torch.ops.ff_block_kernel\n"
        "import naturalspeech2_tpu_torch.ops.mel, naturalspeech2_tpu_torch.ops.mas\n"
        "import naturalspeech2_tpu_torch.ops.ctc, naturalspeech2_tpu_torch.utils.helpers\n"
        "import naturalspeech2_tpu_torch.serve, naturalspeech2_tpu_torch.cli\n"
        "import naturalspeech2_tpu_torch.distill\n"
        "import naturalspeech2_tpu_torch.models.encodec, naturalspeech2_tpu_torch.codec_trainer\n"
        "import naturalspeech2_tpu_torch.models.discriminator, naturalspeech2_tpu_torch.ops.stft_loss\n"
        "import naturalspeech2_tpu_torch.utils.torch_import\n"
        "import naturalspeech2_tpu_torch.examples.wavenet_d512_probe\n"
        "import naturalspeech2_tpu_torch.native.audioio, naturalspeech2_tpu_torch.models.wavenet\n"
        "import naturalspeech2_tpu_torch.utils, naturalspeech2_tpu_torch.ops.schedules\n"
        "import naturalspeech2_tpu_torch.parallel, naturalspeech2_tpu_torch.parallel.comm\n"
        "import naturalspeech2_tpu_torch.parallel.fsdp, naturalspeech2_tpu_torch.parallel.mesh\n"
        "import naturalspeech2_tpu_torch.parallel.tp, naturalspeech2_tpu_torch.parallel.sp\n"
        "import naturalspeech2_tpu_torch.ops.dropout\n"
        "naturalspeech2_tpu_torch.native.audioio.library()  # builds the decoder\n"
        "import naturalspeech2_tpu_torch.utils.tokenizer, naturalspeech2_tpu_torch.utils.cleaner\n"
        "import naturalspeech2_tpu_torch.utils.phonemizers.fallback_multi\n"
        "import naturalspeech2_tpu_torch.utils.phonemizers.espeak_wrapper\n"
        "naturalspeech2_tpu_torch.utils.tokenizer.Tokenizer().texts_to_tensor_ids(['hi, 9:30 am'])\n"
        "naturalspeech2_tpu_torch.cli.build_parser()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'naturalspeech2_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _no_cuda() -> bool:
    import torch

    return not torch.cuda.is_available()


@pytest.mark.parametrize("where", ["repo", "script_alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if not _no_cuda():
        pytest.skip("this host has a CUDA device; chip_smoke.py would run for real")
    cwd = ROOT
    if where == "script_alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run(["chip_smoke.py"], cwd=cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
