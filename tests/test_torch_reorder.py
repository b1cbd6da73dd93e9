"""Port parity: node reordering and refinement (fem_shell_tpu_torch/mesh.py
``rcm_order``, ``permute_nodes``, ``refine_uniform``, ``bandwidth``) and
LargeShellSystem's RCM route against the JAX package, on the CPU.

- the helpers equal the JAX package's element for element on a randomly
  renumbered 12x12 plate and on the Test-E I-beam (twice refined: 80 ->
  1,280 elements), and so does the pure-numpy RCM that runs without scipy;
- the I-beam through ``LargeShellSystem(reorder="rcm").solve(precond=
  "block_jacobi", rtol=1e-12)`` within 1e-12 of max|u| of the JAX
  package's same solve (tests/test_reorder.py), in the original numbering;
- block-Jacobi takes fewer than 0.8 x the Jacobi iterations there
  (tests/test_reorder.py:57-72).
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu import mesh as jmesh_mod
from fem_shell_tpu.data import test_e as JE
from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu_torch import mesh as tmesh_mod
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem

from helpers import mesh_from_tris

IBEAM_MAT = JMaterial(nu=0.25, em=10000, thickness=0.25)


def _jax_mesh(case):
    if case == "ibeam":
        return mesh_from_tris(JE.COORDS, JE.TRIS, JE.BOUNDARY_SIDES)
    jm, _, _ = jgenerate(JParams("q", 12, 12, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
    return jmesh_mod.permute_nodes(jm, np.random.default_rng(0).permutation(jm.n_nodes))


def _same_mesh(t, j):
    np.testing.assert_array_equal(t.coords, j.coords)
    np.testing.assert_array_equal(t.elem_types, j.elem_types)
    np.testing.assert_array_equal(t.elem_conn, j.elem_conn)
    np.testing.assert_array_equal(t.boundary_sides, j.boundary_sides)
    np.testing.assert_array_equal(t.boundary_nodes, np.asarray(j.boundary_nodes).reshape(-1, 2))
    np.testing.assert_array_equal(t.dirichlet_mask(), j.dirichlet_mask())


@pytest.mark.parametrize("case", ["plate", "ibeam"])
def test_rcm_permute_bandwidth_match_jax(case):
    jm = _jax_mesh(case)
    tm = mesh_from_jax(jm)
    jo, to = jmesh_mod.rcm_order(jm), tmesh_mod.rcm_order(tm)
    np.testing.assert_array_equal(to, jo)
    assert tmesh_mod.bandwidth(tm) == jmesh_mod.bandwidth(jm)
    jp, tp = jmesh_mod.permute_nodes(jm, jo), tmesh_mod.permute_nodes(tm, to)
    _same_mesh(tp, jp)
    assert tmesh_mod.bandwidth(tp) == jmesh_mod.bandwidth(jp) < tmesh_mod.bandwidth(tm)


@pytest.mark.parametrize("case", ["plate", "ibeam"])
def test_rcm_without_scipy_matches_jax(monkeypatch, case):
    """Both packages' pure-numpy fallback (scipy's csgraph made
    unimportable) give the same order."""
    monkeypatch.setitem(sys.modules, "scipy.sparse.csgraph", None)
    jm = _jax_mesh(case)
    to = tmesh_mod.rcm_order(mesh_from_jax(jm))
    np.testing.assert_array_equal(to, jmesh_mod.rcm_order(jm))
    assert sorted(to.tolist()) == list(range(jm.n_nodes))


def test_refine_uniform_matches_jax():
    jm = _jax_mesh("ibeam")
    jr = jmesh_mod.refine_uniform(jm, 2)
    tr = tmesh_mod.refine_uniform(mesh_from_jax(jm), 2)
    assert tr.n_elems == 16 * jm.n_elems == 1280
    _same_mesh(tr, jr)
    # nodal boundary records propagate too (a plate with a node record)
    jq, _, _ = jgenerate(JParams("q", 3, 2, 0, 0, 1, 1, (0, 0, 0, 0), 1.0, 1, True, "z"))
    jq = jmesh_mod.ShellMesh(jq.coords, jq.elem_types, jq.elem_conn, jq.boundary_sides,
                             np.array([[0, 1], [1, 1], [4, 1]], np.int32))
    _same_mesh(tmesh_mod.refine_uniform(mesh_from_jax(jq), 1), jmesh_mod.refine_uniform(jq, 1))


_IBEAM = {}


def _ibeam_systems():
    if not _IBEAM:
        jm = _jax_mesh("ibeam")
        js = JLarge(jm, IBEAM_MAT, dtype=jnp.float64, reorder="rcm")
        u = np.asarray(js.solve(JE.FORCES, rtol=1e-12, precond="block_jacobi"))
        ts = LargeShellSystem(mesh_from_jax(jm), material_from_jax(IBEAM_MAT), reorder="rcm", device="cpu")
        _IBEAM.update(js=js, ts=ts, u=u, iters=int(js.last_cg.iters))
    return _IBEAM


def test_ibeam_rcm_block_jacobi_matches_jax():
    d = _ibeam_systems()
    ts = d["ts"]
    np.testing.assert_array_equal(ts._order, d["js"]._order)
    assert (ts.offsets is None) == (d["js"].offsets is None)
    u = ts.solve(JE.FORCES, rtol=1e-12, precond="block_jacobi")
    assert isinstance(u, torch.Tensor) and u.dtype == torch.float64 and tuple(u.shape) == (54, 6)
    assert np.abs(u.numpy() - d["u"]).max() <= 1e-12 * np.abs(d["u"]).max()
    assert abs(ts.last_cg.iters - d["iters"]) <= 2, (ts.last_cg.iters, d["iters"])


def test_block_jacobi_cuts_iterations_vs_jacobi():
    ts = _ibeam_systems()["ts"]
    ts.solve(JE.FORCES, rtol=1e-10, precond="jacobi")
    it_j = ts.last_cg.iters
    ts.solve(JE.FORCES, rtol=1e-10, precond="block_jacobi")
    it_bj = ts.last_cg.iters
    assert it_bj < 0.8 * it_j, (it_bj, it_j)
    with pytest.raises(ValueError, match="precond"):
        ts.solve(JE.FORCES, precond="ilu")
