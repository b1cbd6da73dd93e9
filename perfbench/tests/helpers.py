"""Small cells on the CPU: the benchmark's real cells with their plate cut
to a size a test run holds."""
import time

from perfbench import harness

SMALL = {"plate1024t.fused": 32, "plate1024t.mg64": 32, "unstruct416q.amg": 16}
SEED = 2**40 + 3  # larger than 32 signed bits hold


def small_spec(workload, root=harness.ROOT, n=None):
    spec = harness.load_spec(workload, root)
    n = n or SMALL[workload]
    spec["config"]["mesh"].update(nx=n, ny=n)
    return spec


def run_small(spec, seconds=0.3, trace=False, seed=SEED):
    return harness.run_cell(spec, seed, seconds, trace, "cpu", time.perf_counter())
