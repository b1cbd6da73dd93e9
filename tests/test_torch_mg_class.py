"""Port parity: the scale configuration of MultigridShellSystem
(dtype=float32, df_operator=True, smoother="chebyshev") of
fem_shell_tpu_torch against the JAX package, on the CPU at 32^2.

The JAX package's solves on this path take 16-138 s each here, mostly
compiling, so its numbers are pinned as constants, produced with

    JAX_PLATFORMS=cpu python -c "import jax; jax.config.update('jax_enable_x64', True);
      import jax.numpy as jnp; from fem_shell_tpu.materials import Material;
      from fem_shell_tpu.meshgen import MeshGenParams, generate;
      from fem_shell_tpu.mg import MultigridShellSystem as M
      for et in 'tq':
        m, r, f = generate(MeshGenParams(et, 32, 32, 0, 0, 10, 10, (0,0,0,0), 300.0, 2, et == 'q', 'z'))
        for co in (None, False):
          s = M(m, Material(0.3, 1e7, 0.5), dtype=jnp.float32, df_operator=True,
                smoother='chebyshev', class_operator=co)
          s.solve_df(r * f, rtol=1e-6, maxiter=300)
          print(et, co, float(s.levels[0].lam), float(s.levels[0].omega), s.last_iters)"

and, for the tri class operator, ``s.solve_df_refined(r * f, rtol=1e-9)``
(41 iterations, history 8.77e-3, 5.93e-8, 8.59e-10, centre w 0.10625490).

Iteration counts are pinned from the materialized pair
(class_operator=False): on the CPU the JAX class operator's jitted df
arithmetic is FMA-degraded (tests/test_class_matvec.py), so its counts
drift (tri 17 against the pair's 15) and on quad it stalls (2000
iterations, residual 2.5e-3); the port's class operator is f64 and must
converge as the pair does. ROADMAP.md Queue 3 records the reference's
behaviour.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu import mg as jmg
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops import class_matvec as jcm
from fem_shell_tpu.ops.exact_stencil import build_exact_stencil, exact_matvec_f64
from fem_shell_tpu_torch import mg as tmg
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.mesh import ShellMesh

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
# level-0 lambda_max(D^-1 A) and omega of the JAX class operator (quad:
# the same on the materialized pair)
JAX_LAM = {"t": 2.71298146, "q": 2.21707177}
JAX_OMEGA = {"t": 0.491464198, "q": 0.601393819}
JAX_PAIR_ITERS = {"t": 15, "q": 9}  # solve_df(rtol=1e-6), class_operator=False
JAX_REFINED_W = {"t": 0.10625490}  # solve_df_refined(rtol=1e-9), class operator


def _plate(et, n):
    p = JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    jmesh, rows, fac = jgenerate(p)
    return jmesh, mesh_from_jax(jmesh), rows * fac


def _scale(mesh, **kw):
    return tmg.MultigridShellSystem(mesh, TMAT, dtype=torch.float32, df_operator=True,
                                    smoother="chebyshev", device="cpu", **kw)


@functools.cache
def _run(et):
    """One plate: the class-operator system, its solve_df at 1e-6 and
    1e-9, its refined solve, and the port's own solve_fused field."""
    jmesh, mesh, forces = _plate(et, 32)
    mg = _scale(mesh)
    r = {"jmesh": jmesh, "mesh": mesh, "forces": forces, "mg": mg}
    mg.solve_df(forces, rtol=1e-6)
    r["iters6"], r["res6"] = mg.last_iters, mg.last_residual
    r["u9"] = mg.solve_df(forces, rtol=1e-9)
    r["res9"] = mg.last_residual
    r["u_ref"] = mg.solve_df_refined(forces, rtol=1e-9)
    r["hist"], r["inner"] = list(mg.refine_history), list(mg.refine_inner_iters)
    fused = tmg.MultigridShellSystem(mesh, TMAT, assemble=False, device="cpu")
    r["u_fused"] = fused.solve_fused(forces, rtol=1e-9)
    return r


@pytest.mark.parametrize("et", ["t", "q"])
def test_level0_is_the_class_operator(et):
    mg = _run(et)["mg"]
    assert mg.n_levels == 2 and mg._fine64 is None
    l0, l1 = mg.levels
    assert l0.values is None and l0.cparts is not None and l0.cparts is mg._cdf
    assert l0.inv_diag.dtype == torch.float32 and l0.free_t.dtype == torch.float32
    assert l1.values.dtype == torch.float32 and l1.chol is not None and l1.cparts is None


@pytest.mark.parametrize("et", ["t", "q"])
def test_level0_damping_matches_jax(et):
    l0 = _run(et)["mg"].levels[0]
    assert abs(float(l0.lam) - JAX_LAM[et]) <= 1e-5 * JAX_LAM[et]
    assert abs(float(l0.omega) - JAX_OMEGA[et]) <= 1e-5 * JAX_OMEGA[et]


@pytest.mark.parametrize("et", ["t", "q"])
def test_solve_df_iterations_match_jax_pair(et):
    r = _run(et)
    assert abs(r["iters6"] - JAX_PAIR_ITERS[et]) <= 1
    assert r["res6"] < 1e-6 and r["res9"] < 1e-9


@pytest.mark.parametrize("et", ["t", "q"])
def test_solves_agree_with_solve_fused(et):
    """solve_df at 1e-9 and solve_df_refined against the port's own f64
    solve_fused field (held against JAX in tests/test_torch_mg.py): three
    solves of one operator to relative residual 1e-9, where kappa ~ 1e7
    leaves ~1e-8 of max|u| apart, so 1e-6 holds with room."""
    r = _run(et)
    scale = float(r["u_fused"].abs().max())
    for u in (r["u9"], r["u_ref"]):
        assert tuple(u.shape) == (r["mesh"].n_nodes, 6) and u.dtype == torch.float64
        assert float((u - r["u_fused"]).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("et", ["t", "q"])
def test_refined_solve_true_residual(et):
    """The refinement reaches rtol 1e-9 on the true operator, and the
    solution's residual, recomputed with the JAX package's longdouble
    oracle, is <= 1e-8 of ||b||; the tri centre deflection matches the
    JAX refined solve's to 1e-6 relative."""
    r = _run(et)
    hist = r["hist"]
    assert hist[-1] < 1e-9 and all(np.isfinite(hist))
    assert sum(r["inner"]) == r["mg"].last_iters and len(r["inner"]) == len(hist)
    jmesh, u = r["jmesh"], r["u_ref"].numpy()
    st = build_exact_stencil(jmesh, JMAT, r["mg"].levels[0].offsets)
    b = (np.asarray(r["forces"]) * ~jmesh.dirichlet_mask()).T
    res = b - np.asarray(exact_matvec_f64(st, u.T), np.float64)
    assert np.linalg.norm(res) <= 1e-8 * np.linalg.norm(b)
    if et in JAX_REFINED_W:
        w = float(u[jmesh.n_nodes // 2, 2])
        assert abs(w - JAX_REFINED_W[et]) <= 1e-6 * JAX_REFINED_W[et]


def test_staged_io_and_reassemble():
    """stage_forces / return_device / fetch_solution give the host path's
    field bit for bit; solve_df_refined takes the staged handle;
    reassemble() rebuilds a matrix-free level 0 and the same solve."""
    r = _run("q")
    mg, forces = r["mg"], r["forces"]
    u_host = mg.solve_df(forces, rtol=1e-6).numpy()
    f_dev = mg.stage_forces(forces)
    assert tuple(f_dev.shape) == (6, mg._fine.npad) and f_dev.dtype == torch.float64
    x_dev = mg.solve_df(f_dev, rtol=1e-6, return_device=True)
    assert tuple(x_dev.shape) == (6, mg._fine.npad)
    u_dev = mg.fetch_solution(x_dev)
    assert isinstance(u_dev, np.ndarray)
    np.testing.assert_array_equal(u_host, u_dev)
    x_ref = mg.solve_df_refined(f_dev, rtol=1e-9, return_device=True)
    np.testing.assert_array_equal(mg.fetch_solution(x_ref), r["u_ref"].numpy())

    old = mg.levels[0].cparts
    mg.reassemble()
    l0 = mg.levels[0]
    assert l0.values is None and l0.cparts is not None and l0.cparts is not old
    assert mg._cdf is l0.cparts and mg._fine64 is None
    np.testing.assert_array_equal(mg.solve_df(forces, rtol=1e-6).numpy(), u_host)


def test_class_operator_required_on_warped_mesh_raises():
    """class_operator=True raises on a non-uniform grid; the default falls
    back to the materialized f64 operator, whose solve_df converges and
    whose refinement (it needs the class tables) raises ValueError, as in
    the JAX package."""
    jmesh, mesh, forces = _plate("q", 16)
    coords = np.asarray(mesh.coords).copy()
    coords[:, 0] += 0.05 * np.sin(coords[:, 1])  # non-affine warp
    warped = ShellMesh(coords, mesh.elem_types, mesh.elem_conn, mesh.boundary_sides)
    with pytest.raises(ValueError, match="uniform"):
        _scale(warped, class_operator=True, coarse_max=4)
    mg = _scale(warped, coarse_max=4)
    assert mg._cdf is None and mg._fine64 is not None and mg.levels[0].values is not None
    u = mg.solve_df(forces, rtol=1e-8)
    assert mg.last_residual < 1e-8 and bool(torch.isfinite(u).all())
    with pytest.raises(ValueError, match="uniform"):
        mg.solve_df_refined(forces)


def test_pair_and_class_operators_agree():
    """On a uniform grid class_operator=False (materialized f64 operator)
    and the class operator are one operator: same iterations within one,
    the same field to 1e-8 of max|u|."""
    _, mesh, forces = _plate("t", 16)
    mg_c = _scale(mesh, coarse_max=4)
    mg_p = _scale(mesh, coarse_max=4, class_operator=False)
    assert mg_c._cdf is not None and mg_p._cdf is None
    u_c = mg_c.solve_df(forces, rtol=1e-10)
    u_p = mg_p.solve_df(forces, rtol=1e-10)
    assert abs(mg_c.last_iters - mg_p.last_iters) <= 1
    assert float((u_c - u_p).abs().max()) <= 1e-8 * float(u_p.abs().max())


def test_class_vcycle_matches_jax():
    """One V-cycle with the class operator on level 0 (Chebyshev smoother)
    over the same f32 levels (the port's, handed to the JAX package): the
    JAX package's flat _vcycle (eager; wrap-ring class matvec) against the
    port's (fused kernel form; zero ring), to 1e-5 of max, as the stencil
    V-cycle of tests/test_torch_mg.py."""
    jmesh, mesh, _ = _plate("q", 12)
    tsys = _scale(mesh, coarse_max=4)
    t0, t1 = tsys.levels
    jsys = jmg.MultigridShellSystem(jmesh, JMAT, dtype=jnp.float64, assemble=False,
                                    coarse_max=4, smoother="chebyshev")
    cpj, _ = jcm.build_class_parts(tsys._exact_st, t0.npad)

    def j(t):
        return jnp.asarray(t.numpy())

    jl = [
        dataclasses.replace(jsys.levels[0], values=None, cparts=cpj, free_t=j(t0.free_t),
                            inv_diag=j(t0.inv_diag), omega=j(t0.omega), lam=j(t0.lam)),
        dataclasses.replace(jsys.levels[1], values=j(t1.values), free_t=j(t1.free_t),
                            inv_diag=j(t1.inv_diag), chol=j(t1.chol), chol_scale=j(t1.chol_scale)),
    ]
    rng = np.random.default_rng(6)
    b = (rng.normal(size=(6, t0.npad)) * t0.free_t.numpy()).astype(np.float32)
    ref = np.asarray(jsys._vcycle(jl, 0, jnp.asarray(b)))
    got = tsys._vcycle(tsys.levels, 0, torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
