"""On the card: each cell's command prints a correct result line, and each
cell's control comes out not correct at the cell's own size.  Run there
with ``python3 -m pytest benchmark/tests -m card`` (several minutes)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json")
                                       .read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(card, workload):
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 17), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_not_correct(card, workload):
    res = subprocess.run(
        [sys.executable, "benchmark/controls.py", "--workload", workload,
         "--seeds", str(2**31 + 18)], cwd=ROOT, capture_output=True,
        text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert row["control_correct"] is False, row
