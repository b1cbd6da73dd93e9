"""BENCHMARK.json against the benchmark format's rules of names, units and keys,
and every part of every cell found by name."""
import json
import re

import pytest

from perfbench import harness
from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads", "layer", "moves"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    for w in BENCH["workloads"]:
        names += [w["config"], w["traffic"]]
        assert one_line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        names += c["reduced"]
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and set(m) <= METRIC_KEYS
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_end_to_end_and_per_layer_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and one_line(m["layer"]) and "bound" not in m
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        spec = harness.load_spec(cell)
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    spec = harness.load_spec(cell)
    conf = {c["name"]: c for c in BENCH["configs"]}[spec["cell"]["config"]]
    assert conf["file"].startswith("perfbench/configs/")
    assert spec["config"]["name"] == conf["name"] and spec["config"]["reduced"] == conf["reduced"]
    assert {"entry", "control", "loads", "limits"} <= set(spec["mix"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_every_config_and_file_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files) and all((ROOT / f).is_file() for f in files)
