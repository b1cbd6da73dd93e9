"""Whole runs of each cell at a size a test run holds, on the CPU: the run
is correct; the control (the program's f32 path) and a broken timed path
are not; and a new cell made of added files alone is found and runs."""
import copy
import json

import pytest
import torch

from perfbench import entry, harness
from perfbench.tests.helpers import SMALL, run_small, small_spec

CELLS = sorted(SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_is_correct(cell):
    spec = small_spec(cell)
    res = run_small(spec)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(spec["mix"]["limits"]) == {"backward_err", "residual"}
    assert res["checks"]["backward_err"]["value"] < 1e-13 and res["checks"]["residual"]["value"] < 1e-7
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]} - {"peak_mem_gb"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_counters(cell):
    spec = small_spec(cell)
    res = run_small(spec, trace=True)
    counters = {m["name"] for m in spec["per_layer"] if m["name"].startswith("pcg.")}
    assert res["correct"] and len(counters) == 2 and counters <= set(res["metrics"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    if cell == "unstruct416q.amg":
        assert res["metrics"]["amg.setup.rap_s"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec = small_spec(cell)
    spec["mix"]["entry"] = entry.spec_of(spec["mix"], control=True)
    res = run_small(spec)
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert res["checks"]["backward_err"]["value"] > res["checks"]["backward_err"]["limit"]


def stale(fn):
    """A solve that returns its state unchanged: the previous answer."""
    last = {}

    def solve(self, forces, **kw):
        out = last.get(id(self))
        last[id(self)] = fn(self, forces, **kw)
        return torch.zeros_like(last[id(self)]) if out is None else out
    return solve


def half(fn):
    """A solve that leaves half of the field out."""
    def solve(self, forces, **kw):
        u = fn(self, forces, **kw).clone()
        u[u.shape[0] // 2:] = 0
        return u
    return solve


def altered(fn):
    """A solve whose answer is altered where it is produced: the largest
    displacement off by 1e-6 of itself."""
    def solve(self, forces, **kw):
        u = fn(self, forces, **kw).clone()
        i = torch.unravel_index(torch.argmax(u.abs()), u.shape)
        u[i] *= 1 + 1e-6
        return u
    return solve


def scaled(fn):
    """A solve whose answer is off by a factor: twice the field."""
    def solve(self, forces, **kw):
        return 2 * fn(self, forces, **kw)
    return solve


@pytest.mark.parametrize("fault", [stale, half, altered, scaled], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    spec = small_spec(cell)
    espec = spec["mix"]["entry"]
    path, _, name = espec["class"].rpartition(".")
    cls = getattr(__import__(path, fromlist=[name]), name)
    monkeypatch.setattr(cls, espec["solve"], fault(getattr(cls, espec["solve"])))
    res = run_small(spec)
    assert not res["correct"] and res["failed"] >= 1


def test_new_cell_from_added_files_only(checkout):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as new files and new entries; no file already there changes."""
    before = {p: p.read_bytes() for p in (checkout / "perfbench").rglob("*") if p.is_file()}
    cfg = json.loads((checkout / "perfbench/configs/testG-plate-1024-tri.json").read_text())
    cfg.update(name="testG-plate-32-quad")
    cfg["mesh"].update(elem="q", nx=32, ny=32)
    (checkout / "perfbench/configs/testG-plate-32-quad.json").write_text(json.dumps(cfg))
    mix = json.loads((checkout / "perfbench/traffic/loadcases.mg64.json").read_text())
    mix["loads"]["cases"] = 3
    mix["entry"]["solve_args"]["rtol"] = 1e-8
    (checkout / "perfbench/traffic/loadcases.mg64-loose.json").write_text(json.dumps(mix))
    (checkout / "perfbench/metrics/pcg.max_iters.py").write_text(
        '"""pcg.max_iters: the most CG iterations of one solve in the window."""\n\n\n'
        "def read(ctx):\n    return max(ctx.iters)\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "testG-plate-32-quad", "source": "a test", "file":
                             "perfbench/configs/testG-plate-32-quad.json", "reduced": ["mesh"], "why": "a test"})
    bench["workloads"].append({"name": "plate32q.mg64", "config": "testG-plate-32-quad",
                               "traffic": "loadcases.mg64-loose", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "solve_s")["workloads"].append("plate32q.mg64")
    bench["per_layer"].append({"name": "pcg.max_iters", "unit": "iters", "better": "lower",
                               "source": "program_counter", "layer": "Krylov (solver.pcg)", "moves": "solve_s",
                               "workloads": ["plate32q.mg64"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = harness.load_spec("plate32q.mg64", root=checkout)
    assert spec["config"]["mesh"]["nx"] == 32 and spec["mix"]["loads"]["cases"] == 3
    res = run_small(copy.deepcopy(spec), trace=True)
    assert res["correct"] and res["metrics"]["pcg.max_iters"]["value"] >= 1
    assert set(res["metrics"]) == {"pcg.max_iters"}  # the other metrics list their cells
    res = run_small(spec)
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "solve_s"}
    assert all(p.read_bytes() == b for p, b in before.items())
