"""Port parity: mesh generation and the .xda / force-file input of
fem_shell_tpu_torch against the JAX package's meshgen.py and mesh.py."""
import numpy as np
import pytest

from fem_shell_tpu import mesh as jmesh_mod
from fem_shell_tpu import meshgen as jgen
from fem_shell_tpu_torch import mesh as tmesh_mod
from fem_shell_tpu_torch import meshgen as tgen


@pytest.mark.parametrize("et,ul_lr,bc", [("q", True, (0, 0, 0, 0)), ("t", True, (1, 0, -1, 0)),
                                         ("t", False, (0, 1, 0, -1))])
def test_generate_matches_jax(et, ul_lr, bc):
    args = (et, 6, 4, 0.0, 0.0, 10.0, 5.0, bc, 300.0, 2, ul_lr, "z")
    jm, jrows, jfac = jgen.generate(jgen.MeshGenParams(*args))
    tm, trows, tfac = tgen.generate(tgen.MeshGenParams(*args))
    for name in ("coords", "elem_types", "elem_conn", "boundary_sides", "tri", "quad"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    np.testing.assert_array_equal(tm.dirichlet_mask(), jm.dirichlet_mask())
    np.testing.assert_array_equal(trows, jrows)  # includes the n_nodes-1 row quirk
    assert trows[-1].sum() == 0.0 and tfac == jfac


def test_xda_flow_matches_jax(tmp_path):
    p = jgen.MeshGenParams("t", 5, 3, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z")
    base = str(tmp_path / "plate")
    jgen.write_files(p, base)
    jm, jf = jmesh_mod.load_mesh_and_forces(base + ".xda")
    tm, tf = tmesh_mod.load_mesh_and_forces(base + ".xda")
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.elem_conn, jm.elem_conn)
    np.testing.assert_array_equal(tm.dirichlet_mask(), jm.dirichlet_mask())
    np.testing.assert_array_equal(tf, jf)
    # the same mesh as Gmsh 2.x (triangles, boundary points with bc 0)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(tm.n_nodes)]
    lines += [f"{i + 1} {float(x)!r} {float(y)!r} {float(z)!r}" for i, (x, y, z) in enumerate(tm.coords)]
    bc = tm.boundary_node_ids([0])
    lines += ["$EndNodes", "$Elements", str(len(tm.tri) + len(bc))]
    lines += [f"{e + 1} 2 2 0 0 " + " ".join(str(v + 1) for v in t) for e, t in enumerate(tm.tri)]
    lines += [f"{len(tm.tri) + k + 1} 15 2 0 0 {n + 1}" for k, n in enumerate(bc)]
    with open(base + ".msh", "w") as fh:
        fh.write("\n".join(lines + ["$EndElements"]) + "\n")
    jm, jf = jmesh_mod.load_mesh_and_forces(base + ".msh")
    tm, tf = tmesh_mod.load_mesh_and_forces(base + ".msh")
    for name in ("coords", "elem_types", "elem_conn", "boundary_nodes", "tri"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    np.testing.assert_array_equal(tm.dirichlet_mask(), jm.dirichlet_mask())
    np.testing.assert_array_equal(tf, jf)
