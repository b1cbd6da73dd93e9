"""Port parity: the pair path of MultigridShellSystem's scale configuration
(dtype=float32, df_operator=True, smoother="chebyshev",
class_operator=False) in fem_shell_tpu_torch, on the CPU at 32^2: the
refined solve on the class-consistent materialized operator, with its CG
matvec from symmetric storage (sym_spmv=True) or full storage.

The JAX package's own pair-path refined solves take 40-70 s each here,
mostly compiling, so their numbers are pinned as constants, produced with

    JAX_PLATFORMS=cpu python -c "import jax; jax.config.update('jax_enable_x64', True);
      import jax.numpy as jnp; from fem_shell_tpu.materials import Material;
      from fem_shell_tpu.meshgen import MeshGenParams, generate;
      from fem_shell_tpu.mg import MultigridShellSystem as M
      for et in 'tq':
        m, r, f = generate(MeshGenParams(et, 32, 32, 0, 0, 10, 10, (0,0,0,0), 300.0, 2, et == 'q', 'z'))
        s = M(m, Material(0.3, 1e7, 0.5), dtype=jnp.float32, df_operator=True,
              smoother='chebyshev', class_operator=False)
        u = s.solve_df_refined(r * f, rtol=1e-9)
        print(et, s.last_iters, s.refine_history, float(u[m.n_nodes // 2, 2]))"

Both stall far above rtol (tri 1.37e-2 then 1.51e-2, quad 4.28e-3 then
4.80e-3): on the CPU the JAX package's pair path evaluates its residual
with the jitted df EFTs of ``exact_residual_df``, which the CPU compiler
FMA-contracts (tests/test_exact_stencil.py:186-193). So the port is held to
its own class path on the same mesh, which is the same operator, and the
JAX numbers stand as reference behaviour (ROADMAP.md Queue 3).
"""
import functools
import gc
import weakref

import numpy as np
import pytest
import torch

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops.exact_stencil import build_exact_stencil, exact_matvec_f64
from fem_shell_tpu_torch import large as tlarge
from fem_shell_tpu_torch import mg as tmg
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops import exact_stencil as tes
from fem_shell_tpu_torch.ops.stencil_spmv_sym import prepare_sym_values

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
# JAX solve_df_refined(rtol=1e-9), class_operator=False, 32^2 (see above)
JAX_PAIR = {
    "t": {"iters": 26, "hist": (1.3727781014062662e-02, 1.5078052142159487e-02), "w": 0.1063158640},
    "q": {"iters": 16, "hist": (4.284298883905426e-03, 4.795786647984249e-03), "w": 0.1064343627},
}


def _plate(et, n):
    p = JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    jmesh, rows, fac = jgenerate(p)
    return jmesh, mesh_from_jax(jmesh), rows * fac


def _scale(mesh, **kw):
    return tmg.MultigridShellSystem(mesh, TMAT, dtype=torch.float32, df_operator=True,
                                    smoother="chebyshev", device="cpu", **kw)


def _refined(mg, forces):
    u = mg.solve_df_refined(forces, rtol=1e-9)
    return {"u": u, "hist": list(mg.refine_history), "inner": list(mg.refine_inner_iters),
            "iters": mg.last_iters}


@functools.cache
def _run(et):
    """One plate: the class path's refined solve; the pair path with
    symmetric storage (its state before the solve, the solve, then
    reassemble() and a second solve, then solve_df on the class pair);
    the pair path with full storage."""
    jmesh, mesh, forces = _plate(et, 32)
    r = {"jmesh": jmesh, "forces": forces}
    r["class"] = _refined(_scale(mesh), forces)
    mg = _scale(mesh, class_operator=False, sym_spmv=True)
    r["before"] = (mg._fine_sym is not None, mg._class_pair_done, mg._fine64)
    r["sym"] = _refined(mg, forces)
    r["pair_state"] = (mg._fine64, mg._fine_sym, mg.levels[0].values, mg.levels[0].inv_diag)
    mg.reassemble()
    r["reassembled"] = (mg._class_pair_done, mg._fine64, mg._fine_sym is not None)
    r["sym2"] = _refined(mg, forces)
    r["df"] = mg.solve_df(forces, rtol=1e-9)
    r["df_state"] = (mg._fine64, mg._fine_sym, mg.last_residual)
    r["mg"] = mg
    full = _scale(mesh, class_operator=False, sym_spmv=False)
    r["full"] = _refined(full, forces)
    r["full_sym"] = full._fine_sym
    return r


@pytest.mark.parametrize("et", ["t", "q"])
def test_pair_system_holds_upper_half(et):
    """sym_spmv=True keeps the assembled operator's upper half from the
    constructor on; after the refinement the operator is the class pair
    and the upper half is rebuilt from it; full storage keeps none."""
    r = _run(et)
    has_sym, done, fine64_0 = r["before"]
    assert has_sym and not done and fine64_0 is not None
    mg = r["mg"]
    assert mg.sym_spmv and r["full_sym"] is None
    a64, sym, hi, inv_diag = r["pair_state"]
    pst = mg._exact_st
    tfl0, tfl1, _, cls = tes.class_flat_tables(pst)
    want64, want32 = tes.class_pair_flat(tfl0, tfl1, cls, mg.levels[0].npad, device="cpu")
    assert torch.equal(a64, want64) and torch.equal(hi, want32)
    assert torch.equal(sym, prepare_sym_values(a64, mg.levels[0].offsets))
    d = torch.stack([hi.reshape(6, 6, -1, hi.shape[-1])[a, a, len(mg.levels[0].offsets) // 2]
                     for a in range(6)])
    assert torch.equal(inv_diag, torch.where(d != 0, 1.0 / d, torch.ones_like(d)))


def test_sym_spmv_default_follows_the_mesh_size():
    """None = symmetric storage from 65,536 elements, as the JAX package's
    threshold; the 16^2 plate (512 tri elements) keeps full storage."""
    _, mesh, _ = _plate("t", 16)
    mg = _scale(mesh, class_operator=False, coarse_max=4)
    assert not mg.sym_spmv and mg._fine_sym is None and mg._fine64 is not None
    mg = _scale(mesh, coarse_max=4, sym_spmv=True)  # class path: no materialized operator
    assert mg._cdf is not None and mg._fine_sym is None


@pytest.mark.parametrize("et", ["t", "q"])
@pytest.mark.parametrize("storage", ["sym", "full"])
def test_pair_refined_history(et, storage):
    """A finite history that stops at rtol or at the representation floor
    (a pass that gains less than 10x)."""
    s = _run(et)[storage]
    hist = s["hist"]
    assert all(np.isfinite(hist)) and len(hist) == len(s["inner"])
    assert hist[-1] < 1e-9 or (len(hist) > 1 and hist[-1] > 0.1 * hist[-2])
    assert sum(s["inner"]) == s["iters"]


@pytest.mark.parametrize("et", ["t", "q"])
def test_pair_true_residual_matches_history(et):
    """The last history entry is the returned field's true residual:
    recomputed with the JAX package's longdouble oracle, within 10 %."""
    r = _run(et)
    jmesh, u = r["jmesh"], r["sym"]["u"].numpy()
    st = build_exact_stencil(jmesh, JMAT, r["mg"].levels[0].offsets)
    b = (np.asarray(r["forces"]) * ~jmesh.dirichlet_mask()).T
    res = np.linalg.norm(b - np.asarray(exact_matvec_f64(st, u.T), np.float64)) / np.linalg.norm(b)
    assert abs(res - r["sym"]["hist"][-1]) <= 0.1 * res


@pytest.mark.parametrize("et", ["t", "q"])
def test_pair_agrees_with_class_path(et):
    """One operator, two storages: the pair path's centre deflection
    matches the class path's to 1e-8 relative, its inner iterations are
    within 3 of the class path's, and symmetric and full storage take the
    same count within 1."""
    r = _run(et)
    ctr = r["jmesh"].n_nodes // 2
    w_c = float(r["class"]["u"][ctr, 2])
    for storage in ("sym", "full"):
        w = float(r[storage]["u"][ctr, 2])
        assert abs(w - w_c) <= 1e-8 * abs(w_c), storage
        assert abs(r[storage]["iters"] - r["class"]["iters"]) <= 3, storage
    assert abs(r["sym"]["iters"] - r["full"]["iters"]) <= 1


@pytest.mark.parametrize("et", ["t", "q"])
def test_reassemble_then_solve_reproduces(et):
    """reassemble() drops the class pair for the assembled operator and
    its upper half; the next refined solve swaps the pair in again and
    reproduces the first solve to 1e-12."""
    r = _run(et)
    done, fine64, has_sym = r["reassembled"]
    assert not done and has_sym and not torch.equal(fine64, r["pair_state"][0])
    u1, u2 = r["sym"]["u"], r["sym2"]["u"]
    assert float((u1 - u2).abs().max()) <= 1e-12 * float(u1.abs().max())
    assert r["sym2"]["hist"] == pytest.approx(r["sym"]["hist"], rel=1e-6)


@pytest.mark.parametrize("et", ["t", "q"])
def test_solve_df_after_refinement_uses_class_pair(et):
    """solve_df after the refinement runs CG on the class pair's upper
    half (the sym kernel's plain version here) and meets its rtol; its
    field is the refined one to 1e-6 of max|u|."""
    r = _run(et)
    a64, sym, res = r["df_state"]
    assert torch.equal(sym, prepare_sym_values(a64, r["mg"].levels[0].offsets))
    assert res < 1e-9
    u = r["sym2"]["u"]
    assert float((r["df"] - u).abs().max()) <= 1e-6 * float(u.abs().max())


@pytest.mark.parametrize("et", ["t", "q"])
def test_jax_pair_reference(et):
    """Where the JAX pair-path run on the CPU reaches a true residual
    under 1e-8, the port's centre holds to its centre at 1e-6; where it
    stalls higher (FMA-degraded df EFTs: both plates at 32^2), the port's
    final residual is at least 1e3 times lower and its centre holds to the
    class path (test_pair_agrees_with_class_path)."""
    ref, s = JAX_PAIR[et], _run(et)["sym"]
    w = float(s["u"][_run(et)["jmesh"].n_nodes // 2, 2])
    if ref["hist"][-1] < 1e-8:
        assert abs(w - ref["w"]) <= 1e-6 * ref["w"]
    else:
        assert s["hist"][-1] <= 1e-3 * ref["hist"][-1]
        assert abs(w - ref["w"]) <= 2e-3 * ref["w"]  # both within discretisation reach


def test_pair_refinement_refused_on_warped_grid():
    """On a grid build_exact_stencil refuses, solve_df_refined raises
    ValueError before it touches the system: solve_df still runs on the
    assembled operator afterwards."""
    _, mesh, forces = _plate("q", 16)
    coords = np.asarray(mesh.coords).copy()
    coords[:, 0] += 0.05 * np.sin(coords[:, 1])  # non-affine warp
    warped = ShellMesh(coords, mesh.elem_types, mesh.elem_conn, mesh.boundary_sides)
    mg = _scale(warped, coarse_max=4, sym_spmv=True)
    fine64 = mg._fine64
    with pytest.raises(ValueError, match="uniform"):
        mg.solve_df_refined(forces)
    assert mg._fine64 is fine64 and mg._fine_sym is not None and not mg._class_pair_done
    mg.solve_df(forces, rtol=1e-8)
    assert mg.last_residual < 1e-8


def _check_release_order(monkeypatch, assembler: str):
    """Spy on the fine system's ``assembler`` during reassemble() and on
    class_pair_flat during the refined solve; both must find the previous
    fine operators unreferenced."""
    _, mesh, forces = _plate("t", 16)
    mg = _scale(mesh, coarse_max=4, class_operator=False, sym_spmv=True)
    seen = []

    def spy(fn):
        def wrapped(*args, **kw):
            gc.collect()
            seen.append([r() is None for r in refs])
            return fn(*args, **kw)
        return wrapped

    refs = [weakref.ref(t) for t in (mg.levels[0].values, mg._fine64, mg._fine_sym)]
    monkeypatch.setattr(tmg, "class_pair_flat", spy(tmg.class_pair_flat))
    mg.solve_df_refined(forces)
    refs = [weakref.ref(t) for t in (mg.levels[0].values, mg._fine64, mg._fine_sym)]
    monkeypatch.setattr(mg._systems[0], assembler, spy(getattr(mg._systems[0], assembler)))
    mg.reassemble()
    assert seen == [[True, True, True], [True, True, True]]


def test_old_fine_operator_released_before_the_new_one(monkeypatch):
    """Two fine operators never coexist: the assembled operator, its f32
    level-0 values and its upper half are unreferenced when the class
    pair is generated, and the class pair's are unreferenced when
    reassemble() assembles the fine level again (assemble_df, the grid
    pipeline at every size); the index_add_ assembly is never called."""
    monkeypatch.setattr(tlarge.LargeShellSystem, "assemble",
                        lambda self: pytest.fail("the index_add_ assembly was called"))
    _check_release_order(monkeypatch, "assemble_df")


def test_old_fine_operator_released_before_the_new_one_on_the_grid_path(monkeypatch):
    """The same rule where every level comes from the grid pipeline (the
    threshold lowered, so the 16^2 plate counts as big): the spy sits on
    assemble_df, which runs assemble_grid."""
    monkeypatch.setattr(tlarge, "GRID_MIN_ELEMENTS", 512)
    grid_calls = []
    real = tlarge.assemble_grid
    monkeypatch.setattr(tlarge, "assemble_grid",
                        lambda *a, **kw: grid_calls.append(a[0].nxp) or real(*a, **kw))
    _check_release_order(monkeypatch, "assemble_df")
    assert grid_calls.count(17) == 2  # the fine level, in the constructor and in reassemble()
