#!/usr/bin/env python3
"""chip_smoke.py's phase 13 alone: the sharded solvers. Builds the kernels,
starts the CPU ranks' dry run in the background, then runs phases
13(a)-(e) (or the ``--parts`` named; (e) runs inside (b), and (d) needs
(e)'s plate) through chip_smoke.py's own functions, with their gates.
Prints each part's seconds and writes the records to
chiprun_out/parallel_phase.json.

    python3 tools/torch_parallel_phase.py [--device cuda] [--n 1024] [--steps 10] [--parts abdc]

One GPU, about two and a half minutes; ``--device cpu --n 32 --steps 3``
rehearses it on the host (gloo ranks only, about four minutes). ``--parts a`` on a
box with two to four GPUs runs the dry run over NCCL with one GPU per
rank (two ranks and min(count, 4)) and over gloo at the same counts, and
holds them bit for bit.
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
    ap.add_argument("--n", type=int, default=cs.SHARD_N)
    ap.add_argument("--steps", type=int, default=cs.SHARD_TOWER_STEPS)
    ap.add_argument("--parts", default="abdc", help="which of 13(a), (b) with (e), (d), (c) to run")
    args = ap.parse_args()
    count = 0
    if args.device == "cuda":
        from fem_shell_tpu_torch.ops import _build

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
        count, listed = cs.gpu_counts()
        print(f"gpus: torch.cuda.device_count()={count} nvidia-smi -L={listed}", flush=True)
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    gates = cs.Gates()
    cpu = cs.start_cpu_dryrun() if "a" in args.parts else None
    try:
        out = cs.phase13(gates, count, cpu, device=args.device, n=args.n, steps=args.steps, parts=args.parts)
    finally:
        cs.stop_background()
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "parallel_phase.json").write_text(json.dumps(out, indent=1, default=str))
    if gates.failed:
        print(f"{len(gates.failed)} gate(s) failed: {gates.failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
