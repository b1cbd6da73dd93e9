"""Port parity: the scatter-free structured-grid assembly of
fem_shell_tpu_torch (``ops/assemble_grid.py``, ``LargeShellSystem.assemble_df``)
against the JAX package's ``assemble_grid_df`` and against the port's own
``index_add_`` assembly, at 8^2.

The JAX grid pipeline runs eagerly here (``eager=True``; its jitted form
FMA-contracts the two-float32 arithmetic on the CPU) and takes ~15 s per
call, so it runs for two cases only, each in its own test: quad with
3-row strips on a warped shell, and tri with the other diagonal
(``ul_lr=False``) and 2-row strips, warped. Its (hi, lo) pair becomes the
port's f64 operator through ``convert.df_pair_from_jax``. Tolerance
1e-13 of max|A|, the JAX package's own grid-against-f64 contract
(tests/test_assemble_grid.py). The four cases of that file are held
against the port's ``assemble()`` at the same tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.mesh import ShellMesh as JMesh
from fem_shell_tpu.mg import detect_structured_grid as jdetect
from fem_shell_tpu.ops.assemble_grid import assemble_grid_df, grid_families as jgrid_families
from fem_shell_tpu_torch import large as tlarge
from fem_shell_tpu_torch.convert import df_pair_from_jax, material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.mg import detect_structured_grid
from fem_shell_tpu_torch.ops import assemble_grid as tag
from fem_shell_tpu_torch.ops.soa import _offsets_of, soa_diagonal

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
TMAT = material_from_jax(JMAT)
GATE = 1e-13
CASES = [  # (elem type, ul_lr, strip_rows, warp), as tests/test_assemble_grid.py
    ("q", True, None, False),
    ("q", True, 3, True),
    ("t", True, None, False),
    ("t", False, 2, True),
]
JAX_CASES = [CASES[1], CASES[3]]


def _jmesh(et, n, ul, warp):
    jmesh, _, _ = jgenerate(JParams(et, n, n, 0, 0, 10, 10, (0, 1, 0, 1), 300.0, 2, ul, "z"))
    if warp:  # curved structured shell: same connectivity, z = bump(x, y)
        c = np.asarray(jmesh.coords, np.float64).copy()
        c[:, 2] = 0.3 * np.sin(c[:, 0]) * np.cos(0.7 * c[:, 1])
        jmesh = JMesh(c, jmesh.elem_types, jmesh.elem_conn, jmesh.boundary_sides)
    return jmesh


def _port_grid(sys_, strip_rows, with_diag=False):
    grid = detect_structured_grid(sys_.mesh)
    return tag.assemble_grid(grid, sys_.mesh.coords, sys_.free_t, sys_.offsets, sys_.pattern.n_pad,
                             sys_.dm, sys_.dp, sys_.thickness, strip_rows=strip_rows,
                             with_diag=with_diag)


def _jax_op(case):
    """The JAX grid pipeline's operator (f64 from its df pair) and the
    port's, for one JAX case."""
    et, ul, strip_rows, warp = case
    jmesh = _jmesh(et, 8, ul, warp)
    js = JLarge(jmesh, JMAT, dtype=jnp.float64, chunk=64)
    pair = assemble_grid_df(jdetect(jmesh), np.asarray(jmesh.coords, np.float64),
                            js.free_t.astype(jnp.float32), js.offsets, js.pattern.n_pad,
                            js._grid_kernel_fn(3 if et == "t" else 4),
                            strip_rows=strip_rows, eager=True)
    ts = LargeShellSystem(mesh_from_jax(jmesh), TMAT, device="cpu")
    assert tuple(ts.offsets) == tuple(int(o) for o in js.offsets)
    return df_pair_from_jax(pair, device="cpu"), _port_grid(ts, strip_rows)


@pytest.mark.parametrize("case", JAX_CASES, ids=["q-strip3-warp", "t-lr-strip2-warp"])
def test_grid_matches_jax_grid_df(case):
    ref, got = _jax_op(case)
    assert got.shape == ref.shape and got.dtype == torch.float64
    assert float((got - ref).abs().max()) <= GATE * float(ref.abs().max())


@pytest.mark.parametrize("case", CASES, ids=["q", "q-strip3-warp", "t", "t-lr-strip2-warp"])
def test_grid_matches_index_add_assembly(case):
    """Against the chunked index_add_ assembly with apply_bc_soa; the
    constrained DOFs carry the same exact unit diagonal."""
    et, ul, strip_rows, warp = case
    ts = LargeShellSystem(mesh_from_jax(_jmesh(et, 8, ul, warp)), TMAT, device="cpu")
    ref = ts.assemble()
    got = _port_grid(ts, strip_rows)
    assert float((got - ref).abs().max()) <= GATE * float(ref.abs().max())
    d_ref, d_got = soa_diagonal(ref, ts.offsets), soa_diagonal(got, ts.offsets)
    constrained = ts.free_t == 0
    assert torch.equal(d_got[constrained], torch.ones_like(d_got[constrained]))
    assert torch.equal(d_ref[constrained], d_got[constrained])


def test_grid_is_deterministic_and_diag_matches():
    """Two assemblies agree bit for bit; with_diag returns soa_diagonal of
    the same operator."""
    et, ul, strip_rows, warp = CASES[3]
    ts = LargeShellSystem(mesh_from_jax(_jmesh(et, 8, ul, warp)), TMAT, device="cpu")
    v1 = _port_grid(ts, strip_rows)
    v2, diag = _port_grid(ts, strip_rows, with_diag=True)
    assert torch.equal(v1, v2)
    assert torch.equal(diag, soa_diagonal(v2, ts.offsets))


@pytest.mark.parametrize("et,ul", [("q", True), ("t", True), ("t", False)])
def test_grid_families_match_jax(et, ul):
    jmesh, _, _ = jgenerate(JParams(et, 6, 6, 0, 0, 1, 1, (0, 0, 0, 0), 1.0, 0, ul, "z"))
    offsets = _offsets_of(mesh_from_jax(jmesh))
    want = jgrid_families(et, ul, 7, offsets)
    got = tag.grid_families(et, ul, 7, offsets)
    assert [(f.corners, f.slots) for f in got] == [(f.corners, f.slots) for f in want]


def _spied(monkeypatch, sys_):
    calls = []
    monkeypatch.setattr(tlarge, "assemble_grid", lambda *a, **kw: calls.append("grid") or "grid")
    monkeypatch.setattr(sys_, "assemble", lambda *a, **kw: calls.append("strip") or "strip")
    return calls


@pytest.mark.parametrize("n,want", [(255, "strip"), (256, "grid")])
def test_auto_picks_grid_from_65536_elements(monkeypatch, n, want):
    """'auto' takes the grid pipeline on a structured grid of at least
    65,536 elements (256 x 256 quads), and the index_add_ assembly below
    (255 x 256); 'grid' and 'strip' force either."""
    jmesh, _, _ = jgenerate(JParams("q", n, 256, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
    ts = LargeShellSystem(mesh_from_jax(jmesh), TMAT, device="cpu")
    calls = _spied(monkeypatch, ts)
    assert ts.assemble_df() == want
    assert ts.assemble_df(method="grid") == "grid" and ts.assemble_df(method="strip") == "strip"
    assert calls == [want, "grid", "strip"]
    assert ts.grid is ts.grid and ts.grid.nxp == n + 1


def test_grid_refused_off_a_structured_grid(monkeypatch):
    """A mesh that grid detection refuses (the elements of a 6 x 6 grid
    listed in reverse order) stays on the index_add_ assembly under 'auto'
    even above the threshold, and 'grid' raises ValueError."""
    jmesh, _, _ = jgenerate(JParams("q", 6, 6, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
    mesh = mesh_from_jax(jmesh)
    ne = len(mesh.elem_types)
    sides = mesh.boundary_sides.copy()
    sides[:, 0] = ne - 1 - sides[:, 0]
    reversed_ = type(mesh)(mesh.coords, mesh.elem_types[::-1], mesh.elem_conn[::-1], sides)
    ts = LargeShellSystem(reversed_, TMAT, device="cpu")
    monkeypatch.setattr(tlarge, "GRID_MIN_ELEMENTS", 1)
    assert ts.grid is None
    with pytest.raises(ValueError, match="structured grid"):
        ts.assemble_df(method="grid")
    with pytest.raises(ValueError, match="unknown method"):
        ts.assemble_df(method="tiled")
    v, d = ts.assemble_df(with_diag=True)
    assert torch.equal(v, ts.assemble()) and torch.equal(d, soa_diagonal(v, ts.offsets))
