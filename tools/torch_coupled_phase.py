#!/usr/bin/env python3
"""chip_smoke.py's phase 11 alone: the coupled solver and stress recovery.
Builds the kernels, runs the fused Test-G solves whose converged fields
phase 11(d) recovers (64x64 and n x n, tri and quad), then phases
11(a)-(e) through chip_smoke.py's own functions, with their gates. Prints
each sub-phase's seconds and writes the records to
chiprun_out/coupled_phase.json.

    python3 tools/torch_coupled_phase.py [--device cuda] [--split 16] [--n 1024]

One GPU, about three minutes; ``--device cpu --split 2 --n 16`` rehearses
it on the host (about a minute).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--split", type=int, default=cs.TOWER_SPLIT)
    ap.add_argument("--n", type=int, default=1024)
    args = ap.parse_args()
    cuda = args.device == "cuda"
    if cuda:
        from fem_shell_tpu_torch.ops import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    gates = cs.Gates()
    fields = {}
    for et, n in (("q", 64), ("t", 64), ("t", args.n), ("q", args.n)):
        if f"{et}{n}" not in fields:
            cs.solve_phase(gates, et, n, device=args.device, keep=fields,
                           golden=cs.GOLDEN[et] if n == 64 else cs.KIRCHHOFF, gate_rel=1e-4 if n == 64 else 1e-3)
    out, laps = {}, {}
    t0 = time.perf_counter()
    out["tower_demo"], run = cs.tower_demo_phase(gates, device=args.device)
    laps["a"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["coupled_cli"] = cs.coupled_cli_phase(gates, run, device=args.device)
    laps["b"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["tower_scale"] = cs.tower_scale_phase(gates, device=args.device, split=args.split)
    laps["c"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["recovery"] = cs.recovery_phase(gates, fields, n=args.n, device=args.device)
    laps["d"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["stress_cli"] = cs.stress_cli_phase(gates, device=args.device)
    laps["e"] = time.perf_counter() - t0
    out["phase11_s"] = laps
    print(f"phase11_s={sum(laps.values()):.1f} {laps}", flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "coupled_phase.json").write_text(json.dumps(out, indent=1, default=str))
    if gates.failed:
        print(f"{len(gates.failed)} gate(s) failed: {gates.failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
