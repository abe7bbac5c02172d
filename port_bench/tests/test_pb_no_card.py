"""The full command refuses to run without a card, and prints no result."""

import os
import subprocess
import sys

import pytest
import torch

from port_bench.harness import manifest


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "webcam_fp32_overlay", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=manifest.ROOT), timeout=300)
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr
