"""Port parity: XDR and Gmsh mesh input (fem_shell_tpu_torch/mesh.py,
io/gmsh.py), the coupled run's checkpoint (checkpoint.py) and the
profiling helpers (utils/profiling.py) against the JAX package's, on the
CPU.

- ``read_msh`` on the thesis example and with line BCs, array for array;
- a ``.msh`` plate solved end to end by the port within 1e-10 of the
  JAX package's solve of the same file;
- the XDR round trip bit for bit, the JAX writer's bytes, ASCII parity,
  and garbage refused;
- ``CoupledState`` files readable by either package, ``latest_checkpoint``;
- ``PerfLog`` scopes, ``trace`` writing a Chrome trace, and
  ``block_until_ready``.
"""
import filecmp
import json

import numpy as np
import pytest
import torch

from fem_shell_tpu import checkpoint as jcheckpoint
from fem_shell_tpu import mesh as jmesh
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.system import ShellSystem as JShellSystem
from fem_shell_tpu_torch import Material, MeshGenParams, ShellSystem, generate
from fem_shell_tpu_torch import checkpoint
from fem_shell_tpu_torch import mesh as tmesh
from fem_shell_tpu_torch.io.gmsh import read_msh
from fem_shell_tpu_torch.utils.profiling import PerfLog, block_until_ready, trace

MSH_THESIS = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 -1.0 -1.0  0.0
2  1.0 -1.0  0.0
3 -1.0  1.0  0.0
4  1.0  1.0  0.0
$EndNodes
$Elements
6
1 2 2 0 0 1 2 3
2 2 2 0 0 2 4 3
3 15 2 0 0 1
4 15 2 0 0 2
5 15 2 1 0 3
6 15 2 1 0 4
$EndElements
"""

MSH_LINE_BCS = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
2
1 3 2 0 0 1 2 3 4
2 1 2 20 0 1 2
$EndElements
"""

ARRAYS = ("coords", "elem_types", "elem_conn", "boundary_sides", "boundary_nodes", "tri", "quad")


def _same_mesh(got, want):
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(got.dirichlet_mask(), want.dirichlet_mask())
    np.testing.assert_array_equal(got.coupling_node_ids(), want.coupling_node_ids())


@pytest.mark.parametrize("text", [MSH_THESIS, MSH_LINE_BCS], ids=["thesis", "line_bcs"])
def test_read_msh_matches_jax(tmp_path, text):
    p = tmp_path / "m.msh"
    p.write_text(text)
    mesh = tmesh.read_mesh(str(p))
    _same_mesh(mesh, jmesh.read_mesh(str(p)))
    _same_mesh(read_msh(str(p)), mesh)
    if text is MSH_THESIS:  # nodes 1, 2: simply supported; 3, 4: clamped
        np.testing.assert_array_equal(mesh.tri, [[0, 1, 2], [1, 3, 2]])
        mask = mesh.dirichlet_mask()
        assert mask[0, :3].all() and not mask[0, 3:].any() and mask[2].all() and mask[3].all()
    else:
        assert set(mesh.coupling_node_ids().tolist()) == {0, 1}  # bc id 20


def test_msh_solve_end_to_end(tmp_path):
    """A plate written as .msh (quads + boundary point BCs) and its _f
    file, loaded and solved by both packages."""
    mesh, rows, fac = generate(MeshGenParams("q", 4, 4, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(mesh.n_nodes)]
    lines += [f"{i + 1} {float(c[0])!r} {float(c[1])!r} {float(c[2])!r}" for i, c in enumerate(mesh.coords)]
    bc_nodes = mesh.boundary_node_ids([0])
    lines += ["$EndNodes", "$Elements", str(mesh.n_elems + len(bc_nodes))]
    lines += [f"{e + 1} 3 2 0 0 " + " ".join(str(v + 1) for v in q) for e, q in enumerate(mesh.quad)]
    lines += [f"{mesh.n_elems + k + 1} 15 2 0 0 {n + 1}" for k, n in enumerate(bc_nodes)]
    lines.append("$EndElements")
    path = tmp_path / "plate.msh"
    path.write_text("\n".join(lines) + "\n")
    tmesh.write_forces(str(tmp_path / "plate_f"), mesh.n_nodes, fac, rows)
    tm, tf = tmesh.load_mesh_and_forces(str(path))
    jm, jf = jmesh.load_mesh_and_forces(str(path))
    np.testing.assert_array_equal(tf, jf)
    u = ShellSystem(tm, Material(0.3, 1e7, 0.5), device="cpu").solve(tf).numpy()
    want = np.asarray(JShellSystem(jm, JMaterial(0.3, 1e7, 0.5)).solve(jf))
    assert np.abs(u - want).max() <= 1e-10 * np.abs(want).max()
    u_xda = ShellSystem(mesh, Material(0.3, 1e7, 0.5), device="cpu").solve(rows * fac).numpy()
    assert np.abs(u - u_xda).max() <= 1e-10 * np.abs(u_xda).max()


def test_xdr_roundtrip_and_ascii_parity(tmp_path):
    p = MeshGenParams("t", 7, 5, 0, 0, 3.3, 2.1, (0, 1, -1, 2), 1.0, 0, False, "y")
    mesh, _, _ = generate(p)
    tmesh.write_xdr(mesh, str(tmp_path / "m.xdr"))
    jmesh.write_xdr(jmesh.read_xdr(str(tmp_path / "m.xdr")), str(tmp_path / "j.xdr"))
    assert filecmp.cmp(tmp_path / "m.xdr", tmp_path / "j.xdr", shallow=False)
    m2 = tmesh.read_mesh(str(tmp_path / "m.xdr"))  # binary round trip: bit for bit
    for name in ("coords", "elem_types", "elem_conn", "boundary_sides"):
        np.testing.assert_array_equal(getattr(m2, name), getattr(mesh, name))
    _same_mesh(m2, jmesh.read_mesh(str(tmp_path / "m.xdr")))
    tmesh.write_xda(mesh, str(tmp_path / "m.xda"))  # ASCII keeps 6 digits
    m3 = tmesh.read_mesh(str(tmp_path / "m.xda"))
    np.testing.assert_array_equal(m2.elem_conn, m3.elem_conn)
    np.testing.assert_array_equal(m2.boundary_sides, m3.boundary_sides)
    np.testing.assert_allclose(m2.coords, m3.coords, rtol=1e-5)


def test_xdr_rejects_garbage(tmp_path):
    (tmp_path / "bad.xdr").write_bytes(b"\x00\x00\x00\x04nope")
    with pytest.raises(ValueError, match="not a libMesh XDR"):
        tmesh.read_xdr(str(tmp_path / "bad.xdr"))
    mesh, _, _ = generate(MeshGenParams("q", 2, 2, 0, 0, 1, 1, (0, 0, 0, 0), 1.0, 0, True, "z"))
    tmesh.write_xdr(mesh, str(tmp_path / "m.xdr"))
    data = bytearray((tmp_path / "m.xdr").read_bytes())
    first_type = 4 + 16 + 8 + 4 * (4 + 4) + 4  # header, counts, four spec strings, n_elem0
    assert data[first_type : first_type + 4] == b"\x00\x00\x00\x05"
    data[first_type + 3] = 9
    (tmp_path / "bad_type.xdr").write_bytes(bytes(data))
    for reader in (tmesh.read_xdr, jmesh.read_xdr):
        with pytest.raises(ValueError, match="unsupported XDR element type 9"):
            reader(str(tmp_path / "bad_type.xdr"))


def test_checkpoint_and_profiling(tmp_path):
    perf = PerfLog()
    for _ in range(2):
        with perf.scope("x"):
            pass
    assert perf.stats("x")["n"] == 2 and "x" in perf.report()

    st = checkpoint.CoupledState(3, 0.03, np.arange(30.0).reshape(5, 6), np.ones((2, 2)))
    path = str(tmp_path / "ck" / "ckpt_3.npz")
    st.save(path)
    checkpoint.CoupledState(12, 0.12, st.pre_sols, st.iface_forces).save(str(tmp_path / "ck" / "ckpt_12.npz"))
    for load in (checkpoint.CoupledState.load, jcheckpoint.CoupledState.load):
        back = load(path)
        assert back.timestep == 3 and back.time == 0.03
        np.testing.assert_array_equal(back.pre_sols, st.pre_sols)
        np.testing.assert_array_equal(back.iface_forces, st.iface_forces)
    latest = str(tmp_path / "ck" / "ckpt_12.npz")
    assert checkpoint.latest_checkpoint(str(tmp_path / "ck")) == jcheckpoint.latest_checkpoint(
        str(tmp_path / "ck")) == latest
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None

    x = torch.arange(6.0)
    with trace(str(tmp_path / "tr")):
        y = block_until_ready({"a": [x * 2.0], "b": (x + 1.0,)})
    assert torch.equal(y["a"][0], x * 2.0)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mul" in str(e.get("name", "")) for e in events)
