"""The port's package rules: fem_shell_tpu_torch (and chip_smoke.py)
import nothing of JAX or of the JAX package, importing the package builds
no kernel, and asking for CUDA where there is none raises instead of
falling back to the CPU (the constructors, stress recovery, the coupled
structure solve, and the solver CLI's default device)."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fem_shell_tpu_torch import Material, MeshGenParams, MultigridShellSystem, ShellSystem, generate
from fem_shell_tpu_torch.coupling.adapter import run_structure
from fem_shell_tpu_torch.coupling.demo import CONFIG, tower_mesh
from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.ops.recovery import recover_stresses, recover_stresses_nodal
from fem_shell_tpu_torch.large import LargeShellSystem

ROOT = Path(__file__).resolve().parent.parent
_FOREIGN = re.compile(r"^jax(\.|$)|\bfem_shell_tpu\b(?!_torch)")

_CHILD = r"""
import sys
import numpy as np
import fem_shell_tpu_torch
from fem_shell_tpu_torch import Material, MeshGenParams, MultigridShellSystem, generate
from fem_shell_tpu_torch.ops import _build
p = MeshGenParams("q", 8, 8, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z")
mesh, rows, fac = generate(p)
mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), assemble=False, device="cpu")
u = mg.solve_fused(rows * fac)
assert mg.last_residual < 1e-9
mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), device="cpu")
mg.solve(rows * fac)
assert mg.last_cg.residual < 1e-10 and mg.levels[-1].dense_inv is not None
import os, tempfile
import torch
from fem_shell_tpu_torch import ShellSystem
from fem_shell_tpu_torch.io.vtk import write_legacy_vtk, write_vtu
from fem_shell_tpu_torch.meshgen import main as meshgen_main
from fem_shell_tpu_torch.utils.cli import main as cli_main
s = ShellSystem(mesh, Material(0.3, 1e7, 0.5), device="cpu")
u = s.solve(rows * fac)
assert s.last_cg.residual < 1e-12
d = tempfile.mkdtemp()
write_vtu(mesh, os.path.join(d, "u.vtu"), displacement=u.numpy(), displace=True)
write_legacy_vtk(mesh, os.path.join(d, "u.vtk"), displacement=u.numpy())
base = os.path.join(d, "plate")
assert meshgen_main("q 8 8 0 0 10 10 0,0,0,0 300 2 1 z".split() + [base]) == 0
assert cli_main(["-nu", "0.3", "-e", "1e7", "-t", "0.5", "-mesh", base + ".xda", "-out", base,
                 "--device", "cpu"]) == 0 and os.path.exists(base + ".vtu")
assert cli_main(["-nu", "0.3", "-e", "1e7", "-t", "0.5", "-mesh", base + ".xda", "--precond", "mg",
                 "--device", "cpu"]) == 0
p = MeshGenParams("t", 12, 12, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, False, "z")
mesh, rows, fac = generate(p)
mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), dtype=torch.float32, df_operator=True,
                          smoother="chebyshev", coarse_max=4, device="cpu")
mg.solve_df_refined(rows * fac)
assert mg.levels[0].cparts is not None and mg.refine_history[-1] < 1e-9
mg = MultigridShellSystem(mesh, Material(0.3, 1e7, 0.5), dtype=torch.float32, df_operator=True,
                          smoother="chebyshev", coarse_max=4, class_operator=False,
                          sym_spmv=True, device="cpu")
mg.solve_df_refined(rows * fac)
assert mg._fine_sym is not None and mg._class_pair_done and mg.refine_history[-1] < 1e-9
s = mg._systems[0]
v, d = s.assemble_df(method="grid", with_diag=True)
ref = s.assemble()
assert float((v - ref).abs().max()) <= 1e-13 * float(ref.abs().max()) and d.shape == (6, v.shape[2])
from fem_shell_tpu_torch.amg import AMGShellSystem
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.mesh import permute_nodes
p = MeshGenParams("q", 8, 8, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z")
mesh, rows, fac = generate(p)
perm = np.random.default_rng(0).permutation(mesh.n_nodes)
pm, pf = permute_nodes(mesh, perm), (rows * fac)[perm]
big = LargeShellSystem(pm, Material(0.3, 1e7, 0.5), reorder="rcm", device="cpu")
big.solve_df_refined(pf)
assert big.refine_history[-1] < 1e-9
amg = AMGShellSystem(pm, Material(0.3, 1e7, 0.5), dtype=torch.float32, df=True, device="cpu")
amg.solve_df_refined(pf)
assert amg.refine_history[-1] < 1e-9
from fem_shell_tpu_torch.coupling.demo import run_demo
from fem_shell_tpu_torch.mesh import read_mesh, write_xdr
res, _ = run_demo(max_timesteps=2, verbose=False, device="cpu")
assert res.timesteps == 2 and res.step_iterations == [3, 3]
write_xdr(mesh, base + ".xdr")
assert read_mesh(base + ".xdr").n_nodes == mesh.n_nodes
assert cli_main(["-nu", "0.3", "-e", "1e7", "-t", "0.5", "-mesh", base + ".xda", "-out", base + "_s",
                 "--stress", "--device", "cpu"]) == 0 and os.path.exists(base + "_s.vtu")
bad =sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "fem_shell_tpu" or m.startswith("fem_shell_tpu."))
print("FOREIGN", bad)
print("LOADED", sorted(_build._loaded))
"""


def test_package_and_solve_import_no_jax():
    # a fresh interpreter (this test process has imported JAX already)
    # runs the fused solve, the f64 multigrid solve, ShellSystem, the
    # writers, the meshgen and solver CLIs, the refined solves of the class
    # operator and of the materialized pair, a 12^2 grid assembly, a
    # renumbered plate's refined LargeShellSystem and AMG solves, two steps
    # of the coupled tower demo, an XDR round trip and the CLI's --stress
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOREIGN []" in out.stdout, out.stdout
    assert "LOADED []" in out.stdout, out.stdout  # no kernel built or loaded


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


PARALLEL = ("comm", "partition", "sharded", "stencil_shard", "mg_shard", "df_shard", "unstructured_shard", "dryrun")


def test_sources_import_no_jax():
    files = sorted((ROOT / "fem_shell_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    parallel = ROOT / "fem_shell_tpu_torch" / "parallel"
    assert all(parallel / f"{m}.py" in files for m in PARALLEL)  # the sharded solvers are scanned too
    for f in files:
        for mod in _imports(f):
            assert not _FOREIGN.search(mod), f"{f.relative_to(ROOT)} imports {mod}"
        src = f.read_text()
        assert "import_module(" not in src and "__import__(" not in src, f


CUDA_SOURCES = ("stencil_spmv.cu", "class_stencil.cu", "stencil_resid.cu", "stencil_spmv_sym.cu",
                "elem_stiffness.cu")


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_cuda_sources_plain_c_and_noted(name):
    """Each hand-written kernel source builds with plain nvcc (no PyTorch
    headers), exports its entry points with a C interface for ctypes, and
    its note names the TPU kernel it replaces and its bound."""
    csrc = ROOT / "fem_shell_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(CUDA_SOURCES)
    src = (csrc / name).read_text()
    assert "torch/" not in src and "ATen" not in src
    assert 'extern "C"' in src
    assert "fem_shell_tpu/ops/pallas_" in src and "Bound:" in src


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = MeshGenParams("q", 8, 8, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z")
    mesh, _, _ = generate(p)
    mat = Material(0.3, 1e7, 0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultigridShellSystem(mesh, mat)
    with pytest.raises(RuntimeError, match="CUDA"):
        LargeShellSystem(mesh, mat, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShellSystem(mesh, mat)
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_stresses(mesh, mat, np.zeros((mesh.n_nodes, 6)))
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_stresses_nodal(mesh, mat, np.zeros((mesh.n_nodes, 6)))
    with pytest.raises(RuntimeError, match="CUDA"):  # before any transport opens
        run_structure(tower_mesh(), mat, CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):  # before any rank starts
        run_structure(tower_mesh(), mat, CONFIG, devices=2)
    from fem_shell_tpu_torch.parallel.sharded import make_device_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_device_mesh(2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where CUDA
    is missing, and in a directory that holds nothing else of the repo."""
    env = dict(os.environ, PYTHONPATH="", CUDA_VISIBLE_DEVICES="")  # no card, even where there is one
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
