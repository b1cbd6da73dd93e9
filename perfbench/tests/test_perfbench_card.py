"""Each cell end to end on the card, as a benchmark run makes it (a short
window): the run exits 0, and its last line is correct and reports the
cell's end-to-end metrics from the GPU. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_card(cell, card):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**33 + 1),
                           "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {m["name"] for m in harness.load_spec(cell)["end_to_end"]}
