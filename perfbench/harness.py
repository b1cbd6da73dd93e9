"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (its ``file``), its traffic mix (``traffic/<mix>.json``) and
each metric's reader (``metrics/<metric>.py``, a function ``read(ctx)``
that returns a number, or None where it finds nothing to read). A new
cell, configuration, mix or metric is new files and entries, not an edit.

A run: build the plate from the configuration's recipe, build the mix's
entry (the program's solver) on it, make the seed's load cases on the
device, run the entry's warm-up solves; that is set-up. Then the closed
loop: one engineer sweeping load cases (the cases after the warm-up's,
cycling), each solve synchronised before the next starts, until ``seconds`` have passed; the window ends with the
last solve. A sample of the window's displacements, drawn from the seed
(reservoir sampling, ``sample`` of the mix's answers), is kept on the
device in a buffer made in set-up, so the memory peak does not depend on
how many solves the window holds. With ``trace`` the window's first
``tracing.TRACE_SECONDS`` run under the profiler and the cell's per-layer
metrics are read; without, its end-to-end metrics. Then the program is freed and every kept displacement
is judged by the plain reference (``reference/check.py``): each of its
numbers against the mix's limit for it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import entry, meshes, tracing
from perfbench.loadcases import LoadCases
from perfbench.reference.check import Operator

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fem_shell_tpu")


def load_spec(workload: str, root: Path = ROOT) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {
        "root": root,
        "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "mix": json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


def reader(name: str, root: Path = ROOT):
    """``read`` of ``metrics/<name>.py``."""
    return load_reader(root / "perfbench" / "metrics" / f"{name}.py")


def load_reader(path: Path):
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a metric's reader may read."""

    spec: dict
    device: torch.device
    system: object  # the program's solver, until the reference runs
    plate: meshes.Plate
    setup_s: float
    window_s: float
    iters: list  # CG iterations of each solve of the window
    peak_bytes: int
    trace: Optional[dict]  # tracing.summary of the traced window, in trace runs
    traced_s: float = 0.0  # the traced window: its seconds (the window's first)
    traced_solves: int = 0  # and the solves it holds (the first ones)

    @property
    def solves(self) -> int:
        return len(self.iters)

    @property
    def card_name(self) -> str:
        """The device's name, as the table of peaks knows it."""
        return torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else self.device.type


class Reservoir:
    """A uniform sample of ``size`` of a stream of displacement fields,
    drawn from the seed, held in a device buffer made once; ``index`` holds
    each slot's load case."""

    def __init__(self, size: int, like: torch.Tensor, seed: int):
        self.buf = like.new_empty((size,) + tuple(like.shape))
        self.index = []
        self.seen = 0
        self.rng = np.random.default_rng([int(seed), 1])

    def offer(self, case: int, u: torch.Tensor):
        j, self.seen = self.seen, self.seen + 1
        slot = j if j < len(self.buf) else int(self.rng.integers(0, j + 1))
        if slot < len(self.buf):
            self.buf[slot].copy_(u)
            if slot == len(self.index):
                self.index.append(case)
            else:
                self.index[slot] = case

    def items(self):
        return [(k, self.buf[i]) for i, k in enumerate(self.index)]


class Phases:
    """Seconds of each step of set-up, from the process's start."""

    def __init__(self, t_start: float):
        self.last, self.secs = t_start, {}

    def mark(self, name: str):
        now = time.perf_counter()
        self.secs[name], self.last = now - self.last, now

    def __str__(self):
        return ", ".join(f"{k} {v:.3f}" for k, v in self.secs.items())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """The result of one run (the printed line's keys, ``checks`` last)."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mix = spec["config"], spec["mix"]
    phases = Phases(t_start)
    phases.mark("imports")
    torch.empty(1, device=device)
    _sync(device)
    phases.mark("device_init")
    plate = meshes.plate(cfg["mesh"])
    phases.mark("mesh")
    espec = entry.spec_of(mix)
    system = entry.build(espec, plate, cfg["material"], device)
    _sync(device)
    phases.mark("build")
    loads = LoadCases(mix["loads"], cfg["load"]["q"], plate, seed, device)
    _sync(device)
    phases.mark("loads")
    warm = int(espec.get("warmup", 1))
    for k in range(warm):
        u, _ = entry.solve(system, espec, loads.forces(k))
        _sync(device)
        phases.mark(f"warmup{k + 1}")
    kept = Reservoir(int(mix["sample"]), u, seed)
    setup_s = time.perf_counter() - t_start
    print(f"perfbench: set-up {setup_s:.3f} s: {phases}", file=sys.stderr)

    iters, times, paused = [], [], 0.0
    win = tracing.Window(trace)
    t0 = time.perf_counter()
    while True:
        t_solve = time.perf_counter()
        u, it = entry.solve(system, espec, loads.forces(warm + len(iters)))
        _sync(device)
        times.append(time.perf_counter() - t_solve)
        kept.offer(warm + len(iters), u)
        iters.append(it)
        now = time.perf_counter() - t0 - paused
        if win.running and (now >= tracing.TRACE_SECONDS or now >= seconds):
            t_stop = time.perf_counter()
            win.stop(now, len(iters))
            paused += time.perf_counter() - t_stop  # the profiler's stop is not window time
        if now >= seconds:
            break
    window_s = time.perf_counter() - t0 - paused
    q = np.quantile(times, [0, 0.25, 0.5, 0.75, 1])
    print(f"perfbench: window {window_s:.3f} s, {len(times)} solves; seconds per solve min {q[0]:.4f} "
          f"q1 {q[1]:.4f} median {q[2]:.4f} q3 {q[3]:.4f} max {q[4]:.4f}; first {times[0]:.4f}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ctx = Context(spec, device, system, plate, setup_s, window_s, iters, peak,
                  tracing.summary(win.prof, win.seconds) if trace else None, win.seconds, win.solves)
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = reader(m["name"], spec["root"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ctx.system = system = win = u = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = Operator(plate, cfg["material"], device)
    limits = {name: float(v) for name, v in mix["limits"].items()}
    worst, failed = dict.fromkeys(limits, 0.0), 0
    for k, u in kept.items():
        read = ref.compare(u, loads.forces(k))
        for name in limits:
            worst[name] = max(worst[name], read[name])
        failed += not all(read[name] <= limit for name, limit in limits.items())
    result = {"correct": failed == 0 and len(kept.index) > 0, "attempted": len(iters), "failed": failed,
              "metrics": metrics, "device": device_record(device, peak, ctx.trace)}
    if ctx.trace is not None:
        result["breakdown"] = {k: ctx.trace[k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {name: {"value": worst[name], "limit": limit} for name, limit in limits.items()}
    return result


def card_record() -> dict:
    """Power limit and clocks of GPU 0 from nvidia-smi (None where it
    cannot say)."""
    keys = ("power.limit", "clocks.sm", "clocks.max.sm")
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(keys)}", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30).stdout
        vals = [float(v) for v in out.strip().split(",")]
    except (OSError, ValueError, subprocess.SubprocessError):
        vals = [None] * len(keys)
    return dict(zip(("power_limit_w", "clock_sm_mhz", "clock_max_sm_mhz"), vals))


def device_record(device, peak: int, trace: Optional[dict]) -> dict:
    if device.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": int(peak)}
        rec.update(card_record())
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        rec.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return rec


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    spec = load_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"perfbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
