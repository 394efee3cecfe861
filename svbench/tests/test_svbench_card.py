"""On the card: one short measured run of the default cell is correct and
prints the contract's result line. Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_measured_run_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "svbench.run", "--workload", "oncopanel_t.sv_dense",
                          "--seed", "2147483777", "--seconds", "5", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"regions_per_s", "peak_rss_gb", "setup_s"}
    assert list(line)[-1] == "checks"
