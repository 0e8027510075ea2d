"""On the card (marker ``cuda``; skipped elsewhere): one short traced run
of every cell prints a correct result line from the card."""

import json
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import REPO

BENCH = spec.load_json(REPO / "BENCHMARK.json")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures one")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_the_card(card, workload):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", "3141592653", "--seconds", "2", "--trace", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, proc.stderr[-2000:]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
