"""Reading the device: the profiler over a traced window, and device time
per call of a probe.

``Window(on)`` runs ``torch.profiler`` (CPU and CUDA activity) over the
first ``TRACE_SECONDS`` of the measured window of a ``--trace 1`` run (to
the end of the solve that crosses them; the rest of the window runs
untraced, so the trace's size, and the time to read it, do not grow with
the window); ``summary`` reduces its raw kineto events to:

- ``busy_s``: the union of the intervals in which any device operation
  (kernel, copy, set) ran;
- ``kernels``: {name: [seconds, launches]} of every device operation;
- ``device_ops``: the ten that took the most time, [name, seconds];
- ``idle_gaps``: the device's idle time between operations, summed by
  what the host was doing at the middle of each gap (the innermost host
  event that spans it: a PyTorch operator or a CUDA runtime call, or
  ``host (no event)`` where none does), the ten largest, [name, seconds].
- ``launches``: a ``Launches``, which reads the grid and block of each
  kernel launch from the trace when a metric asks for them.

``event_ms(fn, reps)`` is the device time of one call of ``fn``: CUDA
events recorded on the stream around ``reps`` back-to-back calls, after a
warm-up call, over ``reps``.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

TRACE_SECONDS = 10.0
TOP = 10
NAME_CHARS = 160
SCAN = 64  # host events looked back at per gap for one that spans it


class Window:
    def __init__(self, on: bool):
        self.prof = None
        self.seconds = 0.0  # the traced window's length
        self.solves = 0  # the solves it holds
        if on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    @property
    def running(self) -> bool:
        return self.prof is not None and not self.seconds

    def stop(self, seconds: float, solves: int):
        self.prof.__exit__(None, None, None)
        self.seconds, self.solves = seconds, solves


def _events(prof):
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if dur <= 0:
            continue
        (dev if e.device_type() == DeviceType.CUDA else host).append((e.start_ns(), dur, e.name()))
    return dev, host


class Launches:
    """The grid and block of each traced kernel launch, which the
    profiler's Python events do not carry: read from its Chrome trace,
    written once to a temporary file (under ``TMPDIR``) on the first call
    and deleted once read."""

    def __init__(self, prof):
        self.prof, self.kernels = prof, None

    def __call__(self, pattern: str) -> list:
        """[(name, grid, block, seconds)] of each launch whose name holds
        ``pattern``; grid and block as [x, y, z], None where the trace
        has none."""
        if self.kernels is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as fh:
                    events = json.load(fh).get("traceEvents", [])
            finally:
                os.unlink(path)
            self.kernels = [(e["name"], e.get("args", {}).get("grid"), e.get("args", {}).get("block"),
                             float(e.get("dur", 0.0)) * 1e-6)
                            for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
        return [k for k in self.kernels if pattern in k[0]]


def summary(prof, window_s: float) -> dict:
    dev, host = _events(prof)
    kernels = {}
    for _, dur, name in dev:
        rec = kernels.setdefault(name, [0.0, 0])
        rec[0] += dur * 1e-9
        rec[1] += 1
    busy_ns, gaps = 0, []
    if dev:
        iv = np.array([(s, s + d) for s, d, _ in dev], dtype=np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        end = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), dtype=bool)
        new[1:] = iv[1:, 0] > end[:-1]  # an interval that starts after all before it ended
        starts = iv[new, 0]
        ends = np.append(end[np.nonzero(new)[0][1:] - 1], end[-1])
        busy_ns = int((ends - starts).sum())
        gaps = np.stack([ends[:-1], starts[1:]], axis=1)
    idle = {}
    if len(gaps) and host:
        h = np.array([(s, s + d) for s, d, _ in host], dtype=np.int64)
        names = np.array([n for _, _, n in host], dtype=object)
        order = np.argsort(h[:, 0], kind="stable")
        h, names = h[order], names[order]
        mid = (gaps[:, 0] + gaps[:, 1]) // 2
        last = np.searchsorted(h[:, 0], mid, side="right") - 1
        who = np.full(len(mid), -1, dtype=np.int64)
        for back in range(SCAN):
            j = last - back
            hit = (who < 0) & (j >= 0) & (h[np.clip(j, 0, None), 1] >= mid)
            who[hit] = j[hit]
        length = (gaps[:, 1] - gaps[:, 0]) * 1e-9
        for j, sec in zip(who, length):
            key = names[j] if j >= 0 else "host (no event)"
            idle[key] = idle.get(key, 0.0) + float(sec)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": window_s,
        "kernels": kernels,
        "device_ops": [[n[:NAME_CHARS], s] for n, (s, _) in top],
        "idle_gaps": [[n[:NAME_CHARS], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
        "launches": Launches(prof),
    }


def event_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the device (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
