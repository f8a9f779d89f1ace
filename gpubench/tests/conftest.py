"""Helpers of the benchmark's own tests: run one cell as the driver does,
from the root of the checkout, and read its result line."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def run_cell(*args, root: Path = ROOT, timeout: float = 600):
    """(returncode, result dict or None, stderr) of `python gpubench/run.py args`."""
    proc = subprocess.run([sys.executable, "gpubench/run.py", *args], cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr


@pytest.fixture
def card():
    """Skips where there is no CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
