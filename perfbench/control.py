#!/usr/bin/env python3
"""Readings of the comparison that decides ``correct``, for setting its
limits: the program (the mix's ``entry``), the control (the mix's
``control``: the program's own f32 path, the precision below the f64 the
configurations state) and faults of the timed path, on the same load
cases, each judged by the plain reference.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --cases 4 \\
        --sides program,control,stale,double,loose [--fault-seeds 1,2,3]

runs in one process on the cell's full size: the plate and the reference
once, then each side's solver once, and for each seed the seed's load
cases 0 .. cases-1 (the first cases a run's window solves). The faults
read the program's own fields: ``stale`` judges each case's field against
the next case's load (a solve that hands back its previous answer),
``double`` twice the field (a scaled answer), ``loose`` a solve by the
program's solver stopped at rtol 1e-2 (a loosened stopping rule). The
control and the faults run on ``--fault-seeds`` (the first three seeds
by default). Prints one JSON object: per side and seed the worst of each
number compared, the CG iterations and the seconds of each solve. The
benchmark's runs do not run this; a limit lies above the program's
readings and below the control's and the faults'.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOOSE_RTOL = 1e-2


def readings(spec: dict, seeds, cases: int, sides, device, fault_seeds=None) -> dict:
    import torch

    from perfbench import entry, meshes
    from perfbench.loadcases import LoadCases
    from perfbench.reference.check import Operator

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, mix = spec["config"], spec["mix"]
    fault_seeds = list(fault_seeds or seeds[:3])
    plate = meshes.plate(cfg["mesh"])
    ref = Operator(plate, cfg["material"], device)
    out = {side: {"seeds": {}} for side in sides}

    def record(side, seed, reads, iters=(), secs=()):
        worst = {name: max(r[name] for r in reads) for name in reads[0]}
        out[side]["seeds"][str(seed)] = {**worst, "reads": reads, "iters": list(iters), "secs": list(secs)}
        print(f"{spec['cell']['name']} {side} seed {seed}: "
              + " ".join(f"{n} {v!r}" for n, v in worst.items()) + f" iters {list(iters)}",
              file=sys.stderr, flush=True)

    def sweep(system, espec, seed):
        loads = LoadCases(mix["loads"], cfg["load"]["q"], plate, seed, device)
        fields, iters, secs = [], [], []
        for k in range(cases):
            t0 = time.perf_counter()
            u, it = entry.solve(system, espec, loads.forces(k))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            secs.append(time.perf_counter() - t0)
            iters.append(it)
            fields.append(u.to(torch.float64).clone())
        return loads, fields, iters, secs

    program = None
    faults = {"stale", "double", "loose"} & set(sides)
    for side in [s for s in ("program", "control") if s in sides or (s == "program" and faults)]:
        espec = entry.spec_of(mix, control=side == "control")
        t0 = time.perf_counter()
        system = entry.build(espec, plate, cfg["material"], device)
        build_s = time.perf_counter() - t0
        for seed in (seeds if side == "program" else fault_seeds):
            loads, fields, iters, secs = sweep(system, espec, seed)
            if side in sides:
                record(side, seed, [ref.compare(u, loads.forces(k)) for k, u in enumerate(fields)], iters, secs)
            if side == "program" and seed in fault_seeds:
                if "stale" in sides:
                    record("stale", seed, [ref.compare(fields[k], loads.forces((k + 1) % cases))
                                           for k in range(cases)])
                if "double" in sides:
                    record("double", seed, [ref.compare(2 * u, loads.forces(k)) for k, u in enumerate(fields)])
            del fields
        if side in sides:
            out[side]["build_s"] = build_s
        if side == "program":
            program = (system, espec)
        else:
            del system
    if "loose" in sides:
        system, espec = program
        espec = dict(espec, solve_args={**espec.get("solve_args", {}), "rtol": LOOSE_RTOL})
        for seed in fault_seeds:
            loads, fields, iters, secs = sweep(system, espec, seed)
            record("loose", seed, [ref.compare(u, loads.forces(k)) for k, u in enumerate(fields)], iters, secs)
    for rec in out.values():
        per_seed = list(rec["seeds"].values())
        for name in per_seed[0]:
            if name not in ("reads", "iters", "secs"):
                rec[name] = [min(r[name] for r in per_seed), max(r[name] for r in per_seed)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault-seeds", default=None, help="comma-separated; the first three seeds by default")
    ap.add_argument("--cases", type=int, default=4)
    ap.add_argument("--sides", default="program,control,stale,double,loose")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",")] if args.fault_seeds else None
    res = readings(spec, seeds, args.cases, args.sides.split(","), torch.device("cuda", 0), fault_seeds)
    res["device"] = {"kind": torch.cuda.get_device_name(0), **harness.card_record()}
    res["limits"] = spec["mix"]["limits"]
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
