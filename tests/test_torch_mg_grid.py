"""The grid-assembly slice as a whole, on the CPU at 32^2: a scale system
(dtype=float32, df_operator=True, smoother="chebyshev") assembles every
level through ``ops/assemble_grid.assemble_grid``, over a fine mesh of at
least ``large.GRID_MIN_ELEMENTS`` elements (the JAX package's rule,
fem_shell_tpu/mg.py:658-662) and below it (where the JAX package
scatters). The threshold is lowered with monkeypatch so that a 32^2 plate
counts as big; the same system with every level forced through the
index_add_ assembly (``assemble_df(method="strip")``) is the reference.

The pair path (class_operator=False) then refines to the port's pinned
numbers (ROADMAP.md Queue 3: tri 25 inner iterations, centre
0.1062548953; quad 15, 0.1064630751). The JAX package's own pair path
stalls on the CPU (tests/test_torch_mg_pair.py), so those are the port's.
"""
import functools

import numpy as np
import pytest
import torch

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu_torch import large as tlarge
from fem_shell_tpu_torch import mg as tmg
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax

TMAT = material_from_jax(JMaterial(nu=0.3, em=1e7, thickness=0.5))
# the port's pair-path solve_df_refined(rtol=1e-9) at 32^2 (index_add_ build)
PINNED = {"t": {"inner": [13, 12], "w": 0.1062548953}, "q": {"inner": [8, 7], "w": 0.1064630751}}


def _system(mesh, **kw):
    return tmg.MultigridShellSystem(mesh, TMAT, dtype=torch.float32, df_operator=True,
                                    smoother="chebyshev", device="cpu", **kw)


def _snapshot(mg, forces):
    out = {"fine64": mg._fine64, "levels": [lvl.values for lvl in mg.levels],
           "inv_diag": [lvl.inv_diag for lvl in mg.levels], "big": mg._big, "sym": mg.sym_spmv}
    u = mg.solve_df_refined(forces, rtol=1e-9)
    out.update(inner=list(mg.refine_inner_iters), hist=list(mg.refine_history),
               w=float(u[len(u) // 2, 2]))
    return out


def _index_add_system(mesh, **kw):
    """The system with every level assembled by index_add_: assemble_df
    forced to method="strip" while the constructor runs."""
    real = tlarge.LargeShellSystem.assemble_df
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlarge.LargeShellSystem, "assemble_df",
                   lambda self, *a, **k: real(self, *a, **{**k, "method": "strip"}))
        return _system(mesh, **kw)


@functools.cache
def _run(et):
    """One plate: the pair path built with index_add_ ("ref"), below the
    threshold ("small", assemble_grid calls counted in the constructor)
    and through the grid pipeline over a lowered threshold ("grid",
    assemble_grid calls counted in the constructor and in reassemble());
    the class path through the grid pipeline."""
    jmesh, rows, fac = jgenerate(JParams(et, 32, 32, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2,
                                         et == "q", "z"))
    mesh, forces = mesh_from_jax(jmesh), rows * fac
    r = {"ref": _snapshot(_index_add_system(mesh, class_operator=False, sym_spmv=True), forces)}
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        real = tlarge.assemble_grid

        def counted(*args, **kw):
            calls.append(args[0].nxp)
            return real(*args, **kw)

        mp.setattr(tlarge, "assemble_grid", counted)
        small = _system(mesh, class_operator=False)
        r["small_calls"] = list(calls)
        r["small"] = _snapshot(small, forces)
        del calls[:]
        mp.setattr(tlarge, "GRID_MIN_ELEMENTS", 1024)
        mg = _system(mesh, class_operator=False)
        r["ctor_calls"] = list(calls)
        r["grid"] = _snapshot(mg, forces)
        del calls[:]
        mg.reassemble()
        r["reassemble_calls"] = list(calls)
        r["n_levels"] = mg.n_levels
        del calls[:]
        cls = _system(mesh)
        r["class_calls"] = list(calls)
        r["class_w"] = float(cls.solve_df_refined(forces, rtol=1e-9)[len(jmesh.coords) // 2, 2])
    r["class_ref_w"] = float(_system(mesh).solve_df_refined(forces, rtol=1e-9)[len(jmesh.coords) // 2, 2])
    return r


@pytest.mark.parametrize("et", ["t", "q"])
def test_every_level_through_the_grid_pipeline(et):
    """From the threshold on, every level is assembled by assemble_grid, in
    the constructor and in reassemble(); the class path's coarse levels
    too (its fine level is the class operator). Symmetric storage follows
    the same threshold."""
    r = _run(et)
    nl = r["n_levels"]
    widths = [32 // 2**lvl + 1 for lvl in range(nl)]
    assert r["grid"]["big"] and r["grid"]["sym"] and not r["ref"]["big"]
    assert r["ctor_calls"] == widths and r["reassemble_calls"] == widths
    assert r["class_calls"] == widths[1:]
    assert r["class_w"] == pytest.approx(r["class_ref_w"], rel=1e-12)


@pytest.mark.parametrize("et", ["t", "q"])
def test_grid_levels_match_index_add_levels(et):
    """The f64 fine operator to 1e-13 of max|A|; every f32 level entry
    within one f32 ulp of the index_add_ build's, except cancellation
    residues (both builds under 1e-13 of max|A|, where the f64 gate
    governs); the Jacobi diagonals likewise within one ulp."""
    ref, got = _run(et)["ref"], _run(et)["grid"]
    scale = float(ref["fine64"].abs().max())
    assert float((got["fine64"] - ref["fine64"]).abs().max()) <= 1e-13 * scale
    inf = torch.tensor(float("inf"))
    for a, b in zip(ref["levels"] + ref["inv_diag"], got["levels"] + got["inv_diag"]):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        ulp = torch.nextafter(a.abs(), inf) - a.abs()
        residue = torch.maximum(a.abs(), b.abs()) <= 1e-13 * float(a.abs().max())
        assert bool(((a - b).abs() <= ulp).logical_or(residue).all())


@pytest.mark.parametrize("et", ["t", "q"])
def test_grid_built_pair_solve_keeps_pinned_numbers(et):
    """solve_df_refined(rtol=1e-9) on the grid-built pair path takes the
    index_add_ build's inner iterations (the pinned counts) and its centre
    deflection."""
    ref, got = _run(et)["ref"], _run(et)["grid"]
    assert got["inner"] == ref["inner"] == PINNED[et]["inner"]
    assert got["w"] == pytest.approx(ref["w"], rel=1e-12)
    assert got["w"] == pytest.approx(PINNED[et]["w"], rel=1e-9)
    assert got["hist"][-1] < 1e-9 and np.all(np.isfinite(got["hist"]))


@pytest.mark.parametrize("et", ["t", "q"])
def test_small_system_assembles_every_level_through_the_grid_pipeline(et):
    """Below the threshold (the 32^2 plate, 1024 / 2048 elements) every
    level still comes from assemble_grid, so the assembly is bitwise
    repeatable; full storage as the JAX package's default there; the
    pinned pair iterations (25 tri / 15 quad) and centre deflection."""
    r = _run(et)
    small = r["small"]
    assert r["small_calls"] == [32 // 2**lvl + 1 for lvl in range(r["n_levels"])]
    assert not small["big"] and not small["sym"]
    assert small["inner"] == PINNED[et]["inner"]
    assert small["w"] == pytest.approx(PINNED[et]["w"], rel=1e-9)
    assert torch.equal(small["fine64"], r["grid"]["fine64"])
    assert small["hist"][-1] < 1e-9 and np.all(np.isfinite(small["hist"]))
