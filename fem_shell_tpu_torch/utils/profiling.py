"""Profiling utilities — the libMesh PerfLog analog (fem-shell.h:21;
methodology doc/validation.tex:500-518: named scopes for assembly / solver
/ overall, repeated runs, min/avg/max) plus torch.profiler trace capture.

Port of ``fem_shell_tpu/utils/profiling.py``: ``PerfLog`` is a copy;
``trace`` captures a ``torch.profiler`` trace (CPU, and CUDA in a CUDA
build) and writes it into ``log_dir`` as a Chrome trace, where the JAX
package writes an XProf trace; ``block_until_ready``
synchronizes the devices of the CUDA tensors it is given.

Usage::

    perf = PerfLog()
    with perf.scope("assembly"):
        a = system.assemble()
    with perf.scope("solve"):
        u = system.solve(f)
    print(perf.report())

    with trace("/tmp/torch_trace"):     # chrome://tracing or Perfetto
        system.solve(f)
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List


class PerfLog:
    def __init__(self):
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def stats(self, name: str):
        ts = self._times[name]
        return {
            "n": len(ts),
            "min": min(ts),
            "avg": sum(ts) / len(ts),
            "max": max(ts),
            "total": sum(ts),
        }

    def report(self) -> str:
        lines = [f"{'scope':<24}{'n':>5}{'min':>12}{'avg':>12}{'max':>12}{'total':>12}"]
        for name in self._times:
            s = self.stats(name)
            lines.append(
                f"{name:<24}{s['n']:>5}{s['min']:>12.4f}{s['avg']:>12.4f}"
                f"{s['max']:>12.4f}{s['total']:>12.4f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block: every activity this
    PyTorch build can trace (CPU, and CUDA in a CUDA build). Waits for the
    device's queued work before the trace ends and writes
    ``log_dir/trace.json`` (a Chrome trace)."""
    import torch
    from torch.profiler import profile, supported_activities

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=sorted(supported_activities(), key=lambda a: a.value)) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def block_until_ready(tree):
    """Wait for the devices of every CUDA tensor in a (nested list, tuple
    or dict) ``tree``; returns ``tree`` (accurate timing)."""
    import torch

    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
