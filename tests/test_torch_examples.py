"""The examples' PyTorch twins (``examples/*_torch.py``) run end to end on
the CPU (``--device cpu``) at tiny size, each printing what its JAX
original prints at its end: the quickstart's bit-identical restore, the
serving demo's state sizes, the elastic trainer's two resizes, the
multi-app cluster's growth, the end-to-end driver's transparent restart.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CASES = {
    "quickstart_torch.py": ([], "forward pass is bit-identical"),
    "serve_demo_torch.py": ([], "(O(1) state)"),
    "elastic_train_torch.py": ([], "across 2 resizes"),
    "multi_app_torch.py": ([], "controller grew via the RM"),
    "train_e2e_torch.py": (["--small", "--steps", "20"],
                           "restart was transparent"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_twin_runs_on_the_cpu(name):
    extra, want = CASES[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *extra], capture_output=True, text=True, timeout=300, env=env,
        cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert want in proc.stdout, proc.stdout[-2000:]
