"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``. A build
is keyed by a hash of the sources and flags and kept in
``fem_shell_tpu_torch/_build/`` (listed in .gitignore), so the first use
in a checkout builds and later uses load. Nothing builds at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256()
    for dep in sorted(SRC_DIR.glob("*.cuh")) + [src]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every csrc/*.cu that has no current build, one nvcc process
    per source, all started together. Returns {stem: {"path", "seconds",
    "log"}}; for a build that was current "seconds" is 0.0 and "log" the
    one kept beside it.
    Raises RuntimeError with nvcc's output if any source fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    running = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        so = _target(src)
        if so.exists():
            log = so.with_suffix(".log")
            out[src.stem] = {"path": str(so), "seconds": 0.0,
                             "log": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, so, tmp, proc, time.perf_counter()))
    failed = []
    for src, so, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        so.with_suffix(".log").write_text(log)
        out[src.stem] = {"path": str(so), "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu, built first if needed."""
    lib = _loaded.get(stem)
    if lib is None:
        src = SRC_DIR / f"{stem}.cu"
        so = _target(src)
        if not so.exists():
            build_all()
        lib = ctypes.CDLL(str(so))
        _loaded[stem] = lib
    return lib
