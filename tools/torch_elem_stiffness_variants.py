#!/usr/bin/env python3
"""Probe: variants of the port's Quad-4 element-stiffness kernel on one GPU.

    python3 tools/torch_elem_stiffness_variants.py [--min-blocks 2,3] [--diagnose]
        [--baseline FILE.cu]

fem_shell_tpu_torch/csrc/elem_stiffness.cu takes the register cap of its
Quad-4 kernel from kQuadMinBlocks (resident blocks of 256 threads per SM
in the launch bounds). This probe builds the source once per value (one
nvcc per variant, all started together, into
fem_shell_tpu_torch/_build/probe/) and, with --baseline, another
elem_stiffness.cu with the same C interface as it stands (an older
version, to compare against). With --diagnose it also builds edited
copies of the first variant (EDITS): two cuts that only time, "no stores"
(every store of ke behind a condition that never holds, so all the
arithmetic stays) and "phase 1" (every block returns after its last
barrier), and two alternatives held to the gates, "streaming stores"
(__stcs, evict-first) and "reciprocal" (one division per side, then five
products, where the reference divides five times). On the strips of the
1024x1024 quad fine level (as LargeShellSystem.assemble_df cuts them),
the first strip warped out of plane, and the 64x64 quad plate it holds
every variant against the plain version at chip_smoke.ELEM_GATE, checks
that two launches are equal bit for bit, records whether ke equals its
transpose and how far the variant moves from the baseline, and times it:
``ms`` by CUDA events over the level's launches, ``device_ms`` per launch
from torch.profiler, beside chip_smoke's bound. Turns run v0, v1, ...,
v0 (the source's own first and last). It prints each variant's ptxas
lines and SASS counts and one JSON line per (variant, shape); details go
to chiprun_out/elem_variants.json. The package is not changed.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from fem_shell_tpu_torch.ops import _build  # noqa: E402
from fem_shell_tpu_torch.ops import elem_stiffness as esm  # noqa: E402

_MIN_BLOCKS = re.compile(r"constexpr int kQuadMinBlocks = \d+;")
# (name, timing only, [(regex, replacement, places)]) applied to the first variant
EDITS = (
    ("no stores", True, [(r"ke\[quad_index\(", "if (ne < 0) ke[quad_index(", 3)]),
    ("phase 1", True, [(r"if \(e >= ne\) return;\n  double rot", "if (e >= ne || ne > 0) return;\n  double rot", 1)]),
    ("streaming stores", False, [(r"ke\[quad_index\(([^]]*)\)\] = ([^;]*);", r"__stcs(ke + quad_index(\1), \2);", 3)]),
    ("reciprocal", False, [
        (r"(const double ss = dx \* dx \+ dy \* dy;[^\n]*)", r"\1\n  const double rss = 1.0 / ss;", 1),
        (r"(row\(table, kRowH \+[^;]*) / ss;", r"\1 * rss;", 5),
    ]),
)


def edited(src: str, edits) -> str:
    for pattern, repl, places in edits:
        src, n = re.subn(pattern, repl, src)
        if n != places:
            raise RuntimeError(f"csrc/elem_stiffness.cu: {n} places for {pattern!r}, not {places}")
    return src


def build(min_blocks, baseline, diagnose=False):
    """One shared library per variant; returns [(name, timing only, path,
    ptxas lines)]."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.SRC_DIR / "elem_stiffness.cu").read_text()
    sources = []
    for mb in min_blocks:
        body, n = _MIN_BLOCKS.subn(f"constexpr int kQuadMinBlocks = {mb};", src)
        if n != 1:
            raise RuntimeError("csrc/elem_stiffness.cu: kQuadMinBlocks was not found")
        sources.append((f"min_blocks={mb}", False, body))
    if diagnose:
        first = sources[0]
        sources += [(f"{first[0]} {name}", timing, edited(first[2], edits)) for name, timing, edits in EDITS]
    if baseline:
        sources.append(("baseline", False, Path(baseline).read_text()))
    procs = []
    for i, (name, timing, body) in enumerate(sources):
        cu = out_dir / f"elem_stiffness_v{i}.cu"
        cu.write_text(body)
        so = out_dir / f"elem_stiffness_v{i}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs.append((name, timing, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
    built = []
    for name, timing, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built.append((name, timing, str(so), cs.ptxas_by_kernel(log)))
    return built


def use(lib_path: str):
    """Point the wrapper at one variant's library."""
    _build._loaded["elem_stiffness"] = ctypes.CDLL(lib_path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--min-blocks", default="2,3")
    ap.add_argument("--baseline", default=None, help="another elem_stiffness.cu to build and compare")
    ap.add_argument("--diagnose", action="store_true", help="also build and time the EDITS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_elem_stiffness_variants: needs a GPU", file=sys.stderr)
        return 2
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.mg import detect_structured_grid
    from fem_shell_tpu_torch.ops.assemble_grid import (
        family_coords, family_corners, grid_coords, strip_bounds)

    name = torch.cuda.get_device_name(0)
    bandwidth, peaks = cs.card_rates(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = build([int(v) for v in args.min_blocks.split(",")], args.baseline, args.diagnose)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    sass = {}
    for i, (vname, _, path, ptx) in enumerate(built):
        for k, v in ptx.items():
            print(f"  v{i} {vname} {k[-50:]}: {v}", flush=True)
        sass[vname] = cs.sass_counts(path)
        for k, v in (sass[vname] or {}).items():
            print(f"  v{i} {vname} sass {k[-50:]}: {v}", flush=True)

    mat = Material(0.3, 1e7, 0.5)
    t = mat.thickness
    dm, dp = (torch.from_numpy(a).cuda() for a in mat.matrices())
    cases = []
    for n in (1024, 64):
        mesh, _, _ = cs.plate("q", n)
        grid = detect_structured_grid(mesh)
        strip_rows = max(1, 65536 // grid.nxp)
        corners = family_corners("q", grid.ul_lr)[0]
        cg = grid_coords(grid, mesh.coords, "cuda")
        strips = [family_coords(cg, corners, r0, rows) for r0, rows in strip_bounds(grid.nyp - 1, strip_rows)]
        cases.append((f"q{n}", strips, 5 if n > 64 else 50))
        if n == 1024:
            c = np.asarray(mesh.coords, np.float64).copy()
            c[:, 2] = 0.3 * np.sin(c[:, 0]) * np.cos(0.7 * c[:, 1])
            cw = grid_coords(grid, c, "cuda")
            cases.append(("q1024 warped strip", [family_coords(cw, corners, 0, strip_rows)], 20))
    refs = {tag: [esm.elem_stiffness_plain(x, dm, dp, t) for x in xs] for tag, xs, _ in cases}
    base_ke = {}
    if args.baseline:
        use(built[-1][2])
        base_ke = {tag: [esm.elem_stiffness(x, dm, dp, t) for x in xs] for tag, xs, _ in cases}

    failed, rows = [], []
    order = list(range(len(built))) + [0]
    for turn, i in enumerate(order):
        vname, timing_only, path, _ = built[i]
        use(path)
        for tag, xs, reps in cases:
            err = move = 0.0
            repeat = symmetric = True
            for k, x in enumerate([] if timing_only else xs):
                ke = esm.elem_stiffness(x, dm, dp, t)
                again = esm.elem_stiffness(x, dm, dp, t)
                err = max(err, cs.elem_err(ke, refs[tag][k])[0])
                repeat = repeat and torch.equal(ke, again)
                symmetric = symmetric and torch.equal(ke, ke.transpose(0, 1))
                if base_ke:
                    move = max(move, cs.elem_err(ke, base_ke[tag][k])[0])
                del ke, again
            if not (err <= cs.ELEM_GATE and repeat):
                failed.append(f"v{i} {vname} {tag}: rel_err {err:.3e} repeat {repeat}")

            def level():
                for x in xs:
                    esm.elem_stiffness(x, dm, dp, t)

            ms = cs.cuda_ms(level, reps, warmup=1)
            dev = cs.kernel_device_ms(level, max(1, reps // 5), "stiffness_kernel")
            ne = sum(x.shape[2] for x in xs)
            nbytes, ops = cs.elem_work(4, ne)
            bound_ms = max(nbytes / bandwidth, ops / peaks[torch.float64]) * 1e3
            rec = {"variant": i, "name": vname, "turn": turn, "shape": tag, "launches": len(xs),
                   "elements": ne, "ms": ms, "device_ms_per_launch": dev, "bound_ms": bound_ms,
                   "pct_of_bound": 100 * bound_ms / ms, "rel_err": err, "bitwise_repeat": repeat,
                   "symmetric": symmetric, "move_from_baseline": move if base_ke else None,
                   "timing_only": timing_only}
            print(json.dumps(rec), flush=True)
            rows.append(rec)
    _build._loaded.pop("elem_stiffness", None)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "elem_variants.json").write_text(json.dumps(
        {"card": smi, "ptxas": {v: p for v, _, _, p in built}, "sass": sass, "rows": rows}, indent=1))
    if failed:
        print("gates failed: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
