#!/usr/bin/env python3
"""One run of one benchmark cell of fem_shell_tpu_torch on the GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``breakdown`` too with ``--trace 1``) and, last, ``checks``:
each number the comparison used, with its limit. Exits non-zero, printing
no result, without as many CUDA devices as the cell asks for, or if the
process loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"  # fixed, inside the checkout, listed in .gitignore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder
    from perfbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
