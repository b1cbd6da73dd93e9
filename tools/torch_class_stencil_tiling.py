#!/usr/bin/env python3
"""Probe: tiling variants of the port's class-stencil kernel on one GPU.

    python3 tools/torch_class_stencil_tiling.py [--shapes t1024,q64]

fem_shell_tpu_torch/csrc/class_stencil.cu takes its tile from kTX (node
columns per tile) and Tiling<float>, Tiling<double> (thread rows per
block, nodes per thread along y, resident blocks per SM for the launch
bounds). This probe builds the source once per variant of those constants (one nvcc per
variant, all started together, into fem_shell_tpu_torch/_build/probe/),
holds every form of every variant against the plain version at the gates
of chip_smoke.py phase 2b, and times it with CUDA events beside the bound
of chip_smoke.class_work: ``ms`` by CUDA events over back-to-back calls
(which the host's per-call cost bounds from below), ``device_ms`` the
kernel's own time from torch.profiler over the same calls. It prints each
variant's ptxas lines and one JSON line per (variant, shape, form); the
package is not changed.
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
from fem_shell_tpu_torch.ops import class_stencil as csm  # noqa: E402

# (node columns per tile, float: (kTY, kNY, kMinBlocks), double: (...));
# the first is the source's own
VARIANTS = (
    (32, (8, 2, 4), (8, 2, 4)),
    (32, (8, 2, 5), (8, 2, 5)),
    (64, (4, 4, 4), (4, 2, 4)),
    (64, (4, 2, 4), (4, 2, 4)),
    (32, (8, 2, 6), (16, 1, 4)),
)
_TILING = re.compile(r"(struct Tiling<(float|double)> \{\s*static constexpr int) kTY = \d+, kNY = \d+, "
                     r"kMinBlocks = \d+;")
_WIDTH = re.compile(r"constexpr int kTX = \d+;")


def variant_source(src: str, width, f32, f64) -> str:
    def sub(m):
        ty, ny, mb = f32 if m.group(2) == "float" else f64
        return f"{m.group(1)} kTY = {ty}, kNY = {ny}, kMinBlocks = {mb};"

    out, n = _TILING.subn(sub, src)
    out, m = _WIDTH.subn(f"constexpr int kTX = {width};", out)
    if n != 2 or m != 1:
        raise RuntimeError("csrc/class_stencil.cu: the tiling constants were not found")
    return out


def build(variants):
    """One shared library per variant; returns [(path, ptxas lines)]."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.SRC_DIR / "class_stencil.cu").read_text()
    procs = []
    for i, (width, f32, f64) in enumerate(variants):
        cu = out_dir / f"class_stencil_v{i}.cu"
        cu.write_text(variant_source(src, width, f32, f64))
        so = out_dir / f"class_stencil_v{i}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs.append((so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    built = []
    for so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        built.append((so, cs.ptxas_by_kernel(log)))
    return built


def use(lib_path: str):
    """Point the wrapper at one variant's library."""
    lib = ctypes.CDLL(lib_path)
    for dt, sym in csm._SYMBOLS.items():
        fn = getattr(lib, sym)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        csm._FNS[dt] = fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default="t1024,q64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_class_stencil_tiling: needs a GPU", file=sys.stderr)
        return 2
    from fem_shell_tpu_torch import Material
    from fem_shell_tpu_torch.large import LargeShellSystem
    from fem_shell_tpu_torch.ops.class_matvec import build_class_parts
    from fem_shell_tpu_torch.ops.exact_stencil import build_exact_stencil

    name = torch.cuda.get_device_name(0)
    bandwidth, peaks = cs.card_rates(name)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = build(VARIANTS)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for i, (_, ptx) in enumerate(built):
        for k, v in ptx.items():
            print(f"  v{i} {k[-60:]}: {v}", flush=True)
    mat = Material(0.3, 1e7, 0.5)
    failed = []
    for shape in args.shapes.split(","):
        et, n = shape[0], int(shape[1:])
        mesh, _, _ = cs.plate(et, n)
        sys_ = LargeShellSystem(mesh, mat, device="cpu")
        st = build_exact_stencil(mesh, mat, sys_.offsets)
        cp, _ = build_class_parts(st, sys_.pattern.n_pad, device="cuda")
        nn, npad = cp.nyp * cp.nxp, cp.npad
        rng = np.random.default_rng(n)
        x64 = torch.zeros((6, npad), dtype=torch.float64)
        x64[:, :nn] = torch.from_numpy(rng.normal(size=(6, nn)))
        x64 = x64.cuda()
        w32 = torch.from_numpy(rng.random((6, npad)).astype(np.float32)).cuda()
        b32 = torch.from_numpy(rng.normal(size=(6, npad)).astype(np.float32)).cuda()
        forms = (("f64", cp.a64, x64, None, None), ("f32", cp.hi, x64.float(), None, None),
                 ("fused", cp.hi, x64.float(), w32, b32))
        reps = 200 if n <= 64 else 50
        for form, tab, x, w, b in forms:
            ref = csm.class_stencil_plain(tab, x, w=w, b=b)
            nbytes, ops = cs.class_work(cp, x.dtype, w is not None)
            bound_ms = max(nbytes / bandwidth, ops / peaks[x.dtype]) * 1e3
            # turns: v0, v1, ..., v0 again (the source's own tiling first and last)
            order = list(range(len(built))) + [0]
            for turn, i in enumerate(order):
                use(str(built[i][0]))
                y = csm.class_stencil(tab, x, w=w, b=b)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max()) / float(ref.abs().max())
                if not (err <= cs.ERR_GATE[x.dtype] and bool(torch.isfinite(y).all())):
                    failed.append(f"v{i} {shape} {form}: {err:.3e}")
                ms = cs.cuda_ms(lambda: csm.class_stencil(tab, x, w=w, b=b), reps)
                dev = cs.kernel_device_ms(lambda: csm.class_stencil(tab, x, w=w, b=b), reps,
                                          "class_stencil_kernel")
                print(json.dumps({"variant": i, "turn": turn, "width": VARIANTS[i][0],
                                  "f32": VARIANTS[i][1], "f64": VARIANTS[i][2], "shape": shape,
                                  "form": form, "ms": ms,
                                  "device_ms": dev,
                                  "bound_ms": bound_ms, "pct_of_bound": 100 * bound_ms / ms,
                                  "rel_err": err}), flush=True)
        del cp, x64, w32, b32
        torch.cuda.empty_cache()
    csm._FNS.clear()
    if failed:
        print("gates failed: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
