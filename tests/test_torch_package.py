"""Packaging of the PyTorch port: it imports no JAX, and chip_smoke.py
refuses to run (non-zero exit, no result line) without a CUDA card or
without the repository beside it."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _run(code_or_script, cwd, script=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT) if not script else "")
    args = [sys.executable, code_or_script] if script \
        else [sys.executable, "-c", code_or_script]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax():
    res = _run(
        "import sys\n"
        "import hyperreel_tpu_torch, hyperreel_tpu_torch.convert\n"
        "import hyperreel_tpu_torch.models.model\n"
        "import hyperreel_tpu_torch.models.fused_eval\n"
        "import hyperreel_tpu_torch.ops.kernels.build\n"
        "from hyperreel_tpu.configs.presets import technicolor_z_plane\n"
        "from hyperreel_tpu_torch.models.model import build_model\n"
        "build_model(technicolor_z_plane(), {'num_keyframes': 4,"
        " 'num_frames': 50})\n"
        "bad = [m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'jaxlib', 'triton'))]\n"
        "assert not bad, bad\n"
        "print('clean')\n", cwd=ROOT)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    results = []
    if not torch.cuda.is_available():
        results.append(_run(str(ROOT / "chip_smoke.py"), ROOT, script=True))
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    results.append(_run(str(alone), tmp_path, script=True))
    for res in results:
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
