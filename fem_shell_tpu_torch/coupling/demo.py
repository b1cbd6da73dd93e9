"""Self-contained bending-tower FSI demo — the Test-H analog
(doc/validation.tex:717-786; run_example.sh:50-53).

Generates the tower mesh (2x20 cells over [3.0, 3.25] x [0, 2], Tri-3,
clamping bc 0 at the bottom, coupling interface bc 2 on left/right/top —
43 interface nodes matching the dummy fluid's hard-coded grid), then runs
STRUCTURE (shell solver) and FLUID (dummy) as two coupled participants.

The two participants run as threads over an in-process transport; the
same protocol over TCP (the reference's m2n), one process each, is
``python -m fem_shell_tpu_torch.coupling.structure_cli`` with
``python -m fem_shell_tpu_torch.coupling.fluid_cli``.

Port of ``fem_shell_tpu/coupling/demo.py``: the structure solves on
``device`` (CUDA unless the caller names another) on the caller's
thread; the fluid thread runs host numpy only.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from fem_shell_tpu_torch.coupling.adapter import run_structure
from fem_shell_tpu_torch.coupling.fluid_dummy import run_fluid
from fem_shell_tpu_torch.coupling.m2n import InProcessTransport
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.meshgen import MeshGenParams, generate

CONFIG = os.path.join(os.path.dirname(__file__), "configs", "fsi_tower.xml")


def tower_mesh():
    """Structure mesh whose interface nodes coincide with the dummy fluid's
    43-node tower outline (fluid_solver.cpp:95-121)."""
    p = MeshGenParams(
        "t", 2, 20, 3.0, 0.0, 3.25, 2.0, (2, 0, 2, 2), 0.0, 0, False, "y"
    )
    mesh, _, _ = generate(p)
    return mesh


def run_demo(
    max_timesteps: Optional[int] = None,
    nu: float = 0.3,
    em: float = 1e6,
    thickness: float = 0.1,
    rtol: float = 1e-10,
    verbose: bool = True,
    config=None,
    device=None,
    devices: int = 1,
    backend=None,
):
    """Run the coupled demo in-process; returns (structure_result, fluid_history).
    ``config`` overrides the default tower XML (path or CouplingConfig —
    tests use it to vary scheme knobs like extrapolation-order);
    ``device`` is the structure solve's (default CUDA); ``devices > 1``
    shards it over that many ranks joined over ``backend``."""
    if config is None:
        config = CONFIG
    mesh = tower_mesh()
    t_struct, t_fluid = InProcessTransport.pair()

    fluid_out = {}

    def fluid_thread():
        fluid_out["history"] = run_fluid(
            config, transport=t_fluid, max_timesteps=max_timesteps
        )

    th = threading.Thread(target=fluid_thread, daemon=True)
    th.start()

    def report(t, sols):
        if verbose and (t % 50 == 0):
            tip = np.abs(sols[:, 0]).max()
            print(f"  timestep {t}: max |u_x| = {tip:.6g}")

    result = run_structure(
        mesh,
        Material(nu=nu, em=em, thickness=thickness),
        config,
        dt=0.01,
        dead_axis="y",
        transport=t_struct,
        on_timestep=report,
        rtol=rtol,
        max_timesteps=max_timesteps,
        device=device,
        devices=devices,
        backend=backend,
    )
    th.join(timeout=60)
    return result, fluid_out.get("history")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="fem-shell-fsi-demo")
    ap.add_argument("--steps", type=int, default=None, help="cap timesteps (default: run to max-time = 400 steps)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the structure solve (default cuda)")
    args = ap.parse_args(argv)
    res, hist = run_demo(max_timesteps=args.steps, device=args.device)
    print(
        f"Coupled demo finished: {res.timesteps} timesteps, "
        f"mean CG iters/solve {np.mean(res.iterations):.1f}, "
        f"coupling solves total {len(res.iterations)}"
    )
    tip = res.solutions[:, :, 0]
    print(f"max |u_x| over run: {np.abs(tip).max():.6g}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
