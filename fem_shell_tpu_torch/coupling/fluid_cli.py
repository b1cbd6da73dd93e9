"""Dummy fluid solver CLI — the ``FluidSolver`` executable analog
(fluid_solver.cpp:33-38): ``fluid-solver <config.xml> [N]``.

A copy of ``fem_shell_tpu/coupling/fluid_cli.py``:
``python -m fem_shell_tpu_torch.coupling.fluid_cli <config.xml> [N [steps]]``.
"""
from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("Usage: fluid-solver configurationFileName [N]")
        print("configurationFileName: coupling XML-configuration file")
        print("N: number of coupling interface nodes (default 43, tower demo)")
        return -1
    config = args[0]
    # N is accepted for CLI parity; the grid is the hard-coded tower outline
    # (fluid_solver.cpp:43-51 overrides N the same way)
    print("Starting Fluid Solver Dummy...")

    from fem_shell_tpu_torch.coupling.fluid_dummy import run_fluid

    steps = None
    if len(args) > 2 and args[2].isdigit():
        steps = int(args[2])
    history = run_fluid(config, max_timesteps=steps)
    print(f"Exiting FluidSolver ({len(history)} timesteps)")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
