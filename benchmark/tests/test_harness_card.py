"""Each cell once on the card, for a few seconds: the result line's keys.

Run on the card's machine from the checkout's root:
``python -m pytest benchmark/tests/test_harness_card.py -q``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def cards():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run on the card only")
    return torch.cuda.device_count()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs(cards, cell):
    chips = json.loads((ROOT / "benchmark" / "workloads"
                        / f"{cell}.json").read_text())["chips"]
    if cards < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        line)
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], line["checks"]
    assert "setup_s" in line["metrics"]
    assert list(line)[-1] == "checks"
