"""Port parity: multigrid transfers, damping estimate, one V-cycle, and the
fused Test-G-class solve of fem_shell_tpu_torch against the JAX package's
mg.py, on the CPU with seeded inputs.

The V-cycle runs in f32 on both sides, over the same f32 levels carried
across with fem_shell_tpu_torch.convert; the two frameworks sum in other
orders, so the damping estimate and the cycle output are held to 1e-5
relative. The fused solve is the JAX package's arith="f64" program:
iteration counts may differ by one (the f32 preconditioner rounds
differently), displacements agree to 1e-8 of max|u|.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu import mg as jmg
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops.soa import soa_diagonal as jdiag
from fem_shell_tpu_torch import mg as tmg
from fem_shell_tpu_torch.convert import levels_from_jax, material_from_jax, mesh_from_jax

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)


def _mesh(et, n):
    p = JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    return jgenerate(p)


def test_prolong_restrict_exact():
    rng = np.random.default_rng(5)
    gc = rng.normal(size=(6, 5, 7))
    gf = rng.normal(size=(6, 9, 13))
    np.testing.assert_array_equal(
        tmg._prolong(torch.from_numpy(gc)).numpy(), np.asarray(jmg._prolong(jnp.asarray(gc)))
    )
    np.testing.assert_array_equal(
        tmg._restrict(torch.from_numpy(gf)).numpy(), np.asarray(jmg._restrict(jnp.asarray(gf)))
    )


def _jax_levels32(jsys):
    """The f32 level stack exactly as the JAX package's _fused_impl builds
    it (f64 assembly, f32 cast, power-iteration damping, scaled coarse
    Cholesky)."""
    out = []
    for l, s in enumerate(jsys._systems):
        base = jsys.levels[l]
        v64 = s.assemble()
        diag = jdiag(v64, offsets=base.offsets)
        lvl = dataclasses.replace(
            base,
            values=v64.astype(jnp.float32),
            free_t=base.free_t.astype(jnp.float32),
            inv_diag=jnp.where(diag != 0, 1.0 / diag, 1.0).astype(jnp.float32),
        )
        if l == jsys.n_levels - 1:
            dense = jmg._densify(dataclasses.replace(lvl, values=v64))
            d = jnp.diagonal(dense)
            sc = jnp.where(d > 0, 1.0 / jnp.sqrt(d), 1.0)
            scaled = (dense * sc[None, :] * sc[:, None]).astype(jnp.float32)
            lvl = dataclasses.replace(
                lvl, chol=jnp.linalg.cholesky(scaled), chol_scale=sc.astype(jnp.float32)
            )
        else:
            lam = jsys._power_lambda(lvl)
            lvl = dataclasses.replace(lvl, omega=jnp.clip(4.0 / (3.0 * lam), 0.2, 1.0), lam=lam)
        out.append(lvl)
    return out


@pytest.mark.parametrize("et", ["q", "t"])
def test_power_lambda_and_vcycle_on_carried_levels(et):
    jmesh, _, _ = _mesh(et, 16)
    jsys = jmg.MultigridShellSystem(jmesh, JMAT, dtype=jnp.float64, assemble=False, coarse_max=4)
    assert jsys.n_levels == 2
    jl = _jax_levels32(jsys)
    tsys = tmg.MultigridShellSystem(
        mesh_from_jax(jmesh), material_from_jax(JMAT), coarse_max=4, assemble=False, device="cpu"
    )
    tl = levels_from_jax(jl, device="cpu")
    assert tl[0].values.dtype == torch.float32 and tl[-1].chol is not None

    lam_t = float(tsys._power_lambda(tl[0]))
    assert abs(lam_t - float(jl[0].lam)) <= 1e-5 * float(jl[0].lam)

    rng = np.random.default_rng(6)
    b = (rng.normal(size=(6, jl[0].npad)) * np.asarray(jl[0].free_t)).astype(np.float32)
    ref = np.asarray(jsys._vcycle(jl, 0, jnp.asarray(b)))
    got = tsys._vcycle(tl, 0, torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()

    # the Chebyshev smoother (smoother="chebyshev") on the same level
    ref = np.asarray(jsys._smooth_cheby(jl[0], jnp.zeros_like(b), jnp.asarray(b), 3))
    got = tsys._smooth_cheby(tl[0], torch.zeros(b.shape), torch.from_numpy(b), 3).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_densify_matches_jax():
    jmesh, _, _ = _mesh("t", 4)
    jsys = jmg.MultigridShellSystem(jmesh, JMAT, dtype=jnp.float64, assemble=False)
    base = jsys.levels[0]
    lvl = dataclasses.replace(base, values=jsys._systems[0].assemble())
    ref = np.asarray(jmg._densify(lvl))
    got = tmg._densify(levels_from_jax([lvl], device="cpu")[0]).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("et", ["q", "t"])
def test_solve_fused_matches_jax_f64(et, n):
    jmesh, rows, fac = _mesh(et, n)
    forces = rows * fac
    jsys = jmg.MultigridShellSystem(jmesh, JMAT, dtype=jnp.float64, assemble=False)
    ref = jsys.solve_fused(forces, rtol=1e-9, maxiter=400, arith="f64")
    tsys = tmg.MultigridShellSystem(mesh_from_jax(jmesh), material_from_jax(JMAT), assemble=False,
                                    device="cpu")
    got = tsys.solve_fused(forces, rtol=1e-9, maxiter=400).numpy()
    assert tsys.n_levels == jsys.n_levels
    assert abs(tsys.last_iters - jsys.last_iters) <= 1
    assert tsys.last_residual < 1e-9
    assert got.shape == ref.shape == (jmesh.n_nodes, 6)
    assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()
    if (et, n) == ("q", 32):
        # Test-D window of tests/test_exact_stencil.py::test_fused_solve_f64_golden
        assert abs(float(got[jmesh.n_nodes // 2, 2]) - 0.106460) < 5e-5


@pytest.mark.parametrize("et", ["q", "t"])
def test_solve_fused_never_scatters(monkeypatch, et):
    """solve_fused assembles every level through the grid pipeline, never
    through the index_add_ scatter (assemble_soa made to raise), one
    assemble_grid call per level and solve; the result holds the JAX f64
    fused solve's tolerances (+-1 iteration, 1e-8 of max|u|), and a
    second solve repeats the first bit for bit."""
    from fem_shell_tpu_torch import large as tlarge

    def refuse(*args, **kw):
        raise AssertionError("solve_fused reached assemble_soa")

    calls = []
    real = tlarge.assemble_grid
    monkeypatch.setattr(tlarge, "assemble_soa", refuse)
    monkeypatch.setattr(tlarge, "assemble_grid", lambda *a, **kw: calls.append(a[0].nxp) or real(*a, **kw))
    jmesh, rows, fac = _mesh(et, 16)
    forces = rows * fac
    jsys = jmg.MultigridShellSystem(jmesh, JMAT, dtype=jnp.float64, assemble=False)
    ref = jsys.solve_fused(forces, rtol=1e-9, maxiter=400, arith="f64")
    tsys = tmg.MultigridShellSystem(mesh_from_jax(jmesh), material_from_jax(JMAT), assemble=False,
                                    device="cpu")
    got = tsys.solve_fused(forces, rtol=1e-9, maxiter=400)
    assert calls == [16 // 2**lvl + 1 for lvl in range(tsys.n_levels)]
    assert abs(tsys.last_iters - jsys.last_iters) <= 1 and tsys.last_residual < 1e-9
    assert np.abs(got.numpy() - ref).max() <= 1e-8 * np.abs(ref).max()
    assert torch.equal(tsys.solve_fused(forces, rtol=1e-9, maxiter=400), got)


def test_unported_paths_raise():
    jmesh, rows, fac = _mesh("q", 8)
    mesh, mat = mesh_from_jax(jmesh), material_from_jax(JMAT)
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        tmg.MultigridShellSystem(mesh, mat, dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        tmg.MultigridShellSystem(mesh, mat, df_operator=True, device="cpu")
    tsys = tmg.MultigridShellSystem(mesh, mat, assemble=False, device="cpu")
    with pytest.raises(ValueError, match="native f64"):
        tsys.solve_fused(rows * fac, arith="df")
