#!/usr/bin/env python3
"""chip_smoke.py's phase 12 alone: the differentiable solve and the f32
systems. Builds the kernels, runs the stencil_spmv_f32v check of phase 2
at 64^2 and 1024^2 tri, then phases 12(a)-(c) through chip_smoke.py's own
functions, with their gates, and writes the records to
chiprun_out/f32_autodiff_phase.json.

    python3 tools/torch_f32_autodiff_phase.py [--device cuda] [--split 16] [--n 64]

One GPU. ``--device cpu --split 2 --n 16`` rehearses it on the host (the
kernel check and the launch gates need the card and are skipped there).
``--device cpu --cpu-reference`` prints each f32 route's centre and
iterations at --n on the CPU, the source of chip_smoke.F32_CPU.
``--scaling`` runs only chip_smoke.f32_scaling_check with its CGs (the
f32 solve_df's scaling on the card against the CPU's, and the CG over
each device's f32 rsqrt scaling on either device) and writes
chiprun_out/f32_scaling.json.
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
    ap.add_argument("--n", type=int, default=cs.F32_N)
    ap.add_argument("--cpu-reference", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    args = ap.parse_args()
    if args.cpu_reference:
        for key, (centre, iters) in cs.f32_cpu_reference(args.n, device=args.device).items():
            print(f"    {key!r}: ({centre!r}, {iters}),", flush=True)
        return 0
    gates = cs.Gates()
    out = {}
    if args.scaling:
        out["f32_scaling"] = [cs.f32_scaling_check(gates, et, args.n, device=args.device, cg=True)
                              for et in ("q", "t")]
        return finish(gates, out, "f32_scaling.json")
    if args.device == "cuda":
        from fem_shell_tpu_torch.ops import _build

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(smi, flush=True)
        t0 = time.perf_counter()
        _build.build_all()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        bandwidth, peaks = cs.card_rates(torch_name())
        out["card"] = smi
        out["f32v_kernel"] = cs.f32v_kernel_phase(gates, [("q", 64), ("t", 64), ("t", 1024)], {64: 200, 1024: 20},
                                                  bandwidth, peaks)
    elif args.n not in (cs.F32_N,):
        cs.F32_CPU.update(cs.f32_cpu_reference(args.n, device="cpu"))  # a rehearsal's own size
    out.update(cs.phase12(gates, device=args.device, split=args.split, n=args.n))
    return finish(gates, out, "f32_autodiff_phase.json")


def finish(gates, out, name) -> int:
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / name).write_text(json.dumps(out, indent=1, default=str))
    if gates.failed:
        print(f"{len(gates.failed)} gate(s) failed: {gates.failed}", file=sys.stderr)
        return 1
    return 0


def torch_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


if __name__ == "__main__":
    sys.exit(main())
