"""Port parity: LargeShellSystem's own solves (fem_shell_tpu_torch/large.py)
against the JAX package's, on the CPU, in stencil mode (the 16x16 Test-G
quad plate) and gather mode (the same plate renumbered at random).

- ``solve`` with Jacobi and block-Jacobi to rtol 1e-10: the displacements
  within 1e-10 of max|u| of the JAX ``LargeShellSystem.solve`` and the
  iteration counts equal to JAX's;
- ``solve_df`` (native f64 CG on the scaled operator) within 1e-10 of the
  JAX f64 ``solve`` (Jacobi), its count within one of that solve's. The
  JAX ``solve_df`` is held apart: its two-float32 CG is FMA-contracted on
  the CPU (ROADMAP.md Queue 3, "Differences") and takes 225 iterations to
  end 7.9e-7 of max|u| from its own f64 solve at this size, which this
  test pins (stencil mode);
- ``solve_df_refined`` within 1e-8 of the JAX ``ShellSystem`` f64 solve
  (tests/test_refined_ecorr.py), its true residual below its rtol 1e-11:
  the double-double iterate reaches below an f64 x's own floor;
- the f32 system (tests/test_torch_f32.py holds its solves) assembles
  the same with ``exact_geom`` on or off, and ``solve_df_refined`` on it
  raises; an unknown ``reorder`` or ``dtype`` raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import permute_nodes as jpermute
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.system import ShellSystem as JSystem
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
N = 16
_CACHE = {}


def _case(mode):
    """The JAX reference solves once per mode and process."""
    if mode not in _CACHE:
        jmesh, rows, fac = jgenerate(JParams("q", N, N, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
        forces = rows * fac
        if mode == "gather":
            perm = np.random.default_rng(3).permutation(jmesh.n_nodes)
            jmesh, forces = jpermute(jmesh, perm), forces[perm]
        js = JLarge(jmesh, JMAT, dtype=jnp.float64)
        ref = {}
        for pc in ("jacobi", "block_jacobi"):
            u = np.asarray(js.solve(forces, rtol=1e-10, precond=pc))
            ref[pc] = (u, int(js.last_cg.iters))
        c = {"jmesh": jmesh, "forces": forces, "js": js, "ref": ref,
             "system": np.asarray(JSystem(jmesh, JMAT).solve(forces, rtol=1e-13))}
        if mode == "stencil":
            c["df"] = (np.asarray(js.solve_df(forces, rtol=1e-10)), int(js.last_iters))
        _CACHE[mode] = c
    return _CACHE[mode]


def _port(c):
    return LargeShellSystem(mesh_from_jax(c["jmesh"]), material_from_jax(JMAT), device="cpu")


@pytest.mark.parametrize("mode", ["stencil", "gather"])
@pytest.mark.parametrize("precond", ["jacobi", "block_jacobi"])
def test_solve_matches_jax(mode, precond):
    c = _case(mode)
    ts = _port(c)
    assert (ts.offsets is not None) == (mode == "stencil") == (c["js"].offsets is not None)
    u = ts.solve(c["forces"], rtol=1e-10, precond=precond)
    ju, jit = c["ref"][precond]
    assert u.dtype == torch.float64 and tuple(u.shape) == ju.shape
    assert np.abs(u.numpy() - ju).max() <= 1e-10 * np.abs(ju).max()
    assert ts.last_cg.iters == jit and ts.last_cg.residual <= 1e-10


@pytest.mark.parametrize("mode", ["stencil", "gather"])
def test_solve_df_matches_jax_f64(mode):
    c = _case(mode)
    ts = _port(c)
    u = ts.solve_df(c["forces"], rtol=1e-10).numpy()
    ju, jit = c["ref"]["jacobi"]
    scale = np.abs(ju).max()
    assert np.abs(u - ju).max() <= 1e-10 * scale
    assert abs(ts.last_iters - jit) <= 1 and ts.last_residual <= 1e-10
    if mode == "stencil":
        # the JAX CPU df CG, FMA-degraded: many more iterations, far from f64
        jdf, jdf_it = c["df"]
        assert jdf_it > 2 * jit and np.abs(jdf - ju).max() > 1e-7 * scale


@pytest.mark.parametrize("mode", ["stencil", "gather"])
def test_solve_df_refined_matches_jax_system(mode):
    c = _case(mode)
    ts = _port(c)
    u = ts.solve_df_refined(c["forces"], rtol=1e-11, inner_rtol=1e-6).numpy()
    ref = c["system"]
    assert np.abs(u - ref).max() <= 1e-8 * np.abs(ref).max()
    hist = ts.refine_history
    assert 1 <= len(hist) <= 6 and hist[-1] < 1e-11 and np.all(np.isfinite(hist))
    assert ts.last_iters == sum(ts.refine_inner_iters) and len(ts.refine_inner_iters) == len(hist)


def test_f32_and_strip_routes_raise():
    c = _case("stencil")
    mesh, mat = mesh_from_jax(c["jmesh"]), material_from_jax(JMAT)
    f32 = LargeShellSystem(mesh, mat, dtype=torch.float32, device="cpu")
    off = LargeShellSystem(mesh, mat, dtype=torch.float32, exact_geom=False, device="cpu")
    assert torch.equal(f32.assemble(), off.assemble())  # exact_geom changes nothing
    with pytest.raises(ValueError, match="f64 operator"):
        f32.solve_df_refined(c["forces"])
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        LargeShellSystem(mesh, mat, dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="reorder"):
        LargeShellSystem(mesh, mat, reorder="metis", device="cpu")
