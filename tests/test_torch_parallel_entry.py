"""The public entry points of the sharded solvers on the CPU over gloo:

- the solver CLI's ``--devices 2 --device cpu`` writes the .vtu of the
  library solve on 2 ranks, bit for bit: ``ShardedShellSystem`` on the
  8x8 plate, and with ``--precond mg`` ``ShardedMGShellSystem`` (f64) on
  the 32x32 plate. The CLI asks ``make_device_mesh`` for 2 gloo ranks on
  the CPU and is lent the module's mesh, which it must not close (a mesh
  costs ~3.5 s to start; tests/test_torch_cli.py's ``--devices 2`` test
  starts the CLI's own ranks);
- ``run_structure(devices=2, device="cpu")`` on the tower demo (3 steps)
  takes the coupling iterations of ``devices=1`` in every step, its
  solutions within 1e-10 of max|u| of that run's (4.2e-13 measured over
  30 steps: Jacobi PCG on the ranks against block-Jacobi on one device,
  both to rtol 1e-10)."""
import numpy as np
import pytest
import torch

from fem_shell_tpu_torch.coupling.demo import run_demo
from fem_shell_tpu_torch.io.vtk import write_vtu
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import load_mesh_and_forces
from fem_shell_tpu_torch.meshgen import main as meshgen
from fem_shell_tpu_torch.parallel.mg_shard import ShardedMGShellSystem
from fem_shell_tpu_torch.parallel.sharded import ShardedShellSystem
from fem_shell_tpu_torch.utils.cli import main as cli
from torch_parallel_meshes import StartingMeshes

MATERIAL = ["-nu", "0.3", "-e", "1e7", "-t", "0.5"]
ROUTES = {"default": ("q 8 8 0 0 10 10 0,0,0,0 300 2 1 z", []),
          "mg": ("q 32 32 0 0 10 10 0,0,0,0 300 2 1 z", ["--precond", "mg"])}
TOWER_GATE = 1e-10  # of max|u|; chip_smoke.py phase 13(c) holds the card to the same bound


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(2)
    yield started
    started.close()


@pytest.mark.parametrize("route", list(ROUTES))
def test_cli_devices_writes_the_library_solve(tmp_path, capsys, monkeypatch, meshes, route):
    import contextlib

    from fem_shell_tpu_torch.parallel import sharded

    def lend(n, device=None, backend=None):
        assert (n, device, backend) == (2, "cpu", "gloo")
        return contextlib.nullcontext(meshes[2])

    monkeypatch.setattr(sharded, "make_device_mesh", lend)
    plate, flags = ROUTES[route]
    base = str(tmp_path / "plate")
    assert meshgen(plate.split() + [base]) == 0
    rc = cli(MATERIAL + ["-mesh", base + ".xda", "-out", base + "_cli", "--device", "cpu", "--devices", "2",
                         "--backend", "gloo"] + flags)
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[-1] == "All done :)"
    assert any(line.startswith("Linear solve:") for line in out)
    mesh, forces = load_mesh_and_forces(base + ".xda")
    if route == "mg":
        system = ShardedMGShellSystem(mesh, Material(0.3, 1e7, 0.5), meshes[2], dtype=torch.float64)
    else:
        system = ShardedShellSystem(mesh, Material(0.3, 1e7, 0.5), meshes[2])
    u = system.solve(forces, rtol=1e-10, maxiter=20000)
    assert f"Linear solve: {system.last_iters} CG iterations" in "\n".join(out) and not meshes[2].closed
    write_vtu(mesh, base + "_lib.vtu", displacement=u, displace=True)
    assert open(base + "_lib.vtu").read() == open(base + "_cli.vtu").read()


def test_run_structure_devices_matches_one_device():
    one, _ = run_demo(max_timesteps=3, verbose=False, device="cpu")
    two, _ = run_demo(max_timesteps=3, verbose=False, device="cpu", devices=2)
    assert two.timesteps == one.timesteps == 3
    assert two.step_iterations == one.step_iterations
    assert two.solutions.dtype == np.float64
    scale = np.abs(one.solutions).max()
    assert np.abs(two.solutions - one.solutions).max() <= TOWER_GATE * scale
