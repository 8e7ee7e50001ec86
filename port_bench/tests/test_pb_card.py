"""One run of each cell on the card, through the command the benchmark gives.
Run on the GPU machine: ``python -m pytest -m cuda port_bench/tests``."""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 11), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert list(line)[-1] == "checks"
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
    assert line["device"]["platform"] == "gpu" and line["metrics"]
