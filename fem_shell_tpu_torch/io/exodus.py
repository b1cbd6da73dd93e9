"""ExodusII (.e) result writer — the libMesh ``ExodusII_IO`` analog
(fem-shell.cpp:1240-1251; per-timestep variant fem-shell_precice.cpp:1526).
A copy of ``fem_shell_tpu/io/exodus.py``.

ExodusII is a convention layer over netCDF-3 classic; this writer emits
the minimal large-model structure ParaView's Exodus reader consumes:
coordinates (coordx/y/z), one element block per family (TRI3 / QUAD4),
time steps, and named nodal variables (displacement + rotation
components). Built on scipy.io.netcdf_file (pure-python netCDF-3); gated
with a clear error when scipy is unavailable.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from fem_shell_tpu_torch.mesh import ShellMesh

_LEN_STRING = 33

NODAL_VAR_NAMES = ("disp_x", "disp_y", "disp_z", "rot_x", "rot_y", "rot_z")


def write_exodus(
    mesh: ShellMesh,
    path: str,
    displacements: Optional[np.ndarray] = None,
    times: Optional[Sequence[float]] = None,
    title: str = "fem_shell_tpu output",
) -> None:
    """Write mesh + nodal solution to an ExodusII file.

    ``displacements``: [N,6] for a single step or [T,N,6] for a series;
    ``times`` defaults to 0..T-1.
    """
    try:
        from scipy.io import netcdf_file
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "ExodusII export requires scipy (netCDF-3 writer); "
            "use the VTU/VTK writers in fem_shell_tpu_torch.io.vtk instead"
        ) from e

    if displacements is not None:
        displacements = np.asarray(displacements, np.float64)
        if displacements.ndim == 2:
            displacements = displacements[None]
        n_steps = displacements.shape[0]
    else:
        n_steps = 0
    if times is None:
        times = np.arange(max(n_steps, 1), dtype=np.float64)

    blocks = []
    if len(mesh.tri):
        blocks.append(("TRI3", mesh.tri))
    if len(mesh.quad):
        blocks.append(("QUAD4", mesh.quad))

    f = netcdf_file(path, "w", version=1)
    try:
        f.title = title.encode()
        f.api_version = np.float32(5.22)
        f.version = np.float32(5.22)
        f.floating_point_word_size = np.int32(8)
        f.file_size = np.int32(1)

        f.createDimension("time_step", None)  # scipy: record dim must be first
        f.createDimension("len_string", _LEN_STRING)
        f.createDimension("len_line", 81)
        f.createDimension("four", 4)
        f.createDimension("num_dim", 3)
        f.createDimension("num_nodes", mesh.n_nodes)
        f.createDimension("num_elem", mesh.n_elems)
        f.createDimension("num_el_blk", max(len(blocks), 1))

        for axis, name in enumerate("xyz"):
            v = f.createVariable(f"coord{name}", "d", ("num_nodes",))
            v[:] = mesh.coords[:, axis]

        eb_status = f.createVariable("eb_status", "i", ("num_el_blk",))
        eb_status[:] = np.ones(max(len(blocks), 1), np.int32)
        eb_prop = f.createVariable("eb_prop1", "i", ("num_el_blk",))
        eb_prop[:] = np.arange(1, max(len(blocks), 1) + 1, dtype=np.int32)
        eb_prop.name = b"ID"

        for bi, (etype, conn) in enumerate(blocks, start=1):
            f.createDimension(f"num_el_in_blk{bi}", conn.shape[0])
            f.createDimension(f"num_nod_per_el{bi}", conn.shape[1])
            cv = f.createVariable(
                f"connect{bi}", "i", (f"num_el_in_blk{bi}", f"num_nod_per_el{bi}")
            )
            cv[:] = conn.astype(np.int32) + 1  # exodus is 1-based
            cv.elem_type = etype.encode()

        tv = f.createVariable("time_whole", "d", ("time_step",))
        if n_steps:
            f.createDimension("num_nod_var", 6)
            names = f.createVariable(
                "name_nod_var", "c", ("num_nod_var", "len_string")
            )
            arr = np.zeros((6, _LEN_STRING), dtype="S1")
            for k, nm in enumerate(NODAL_VAR_NAMES):
                for j, ch in enumerate(nm[: _LEN_STRING - 1]):
                    arr[k, j] = ch.encode()
            names[:] = arr
            vals = [
                f.createVariable(f"vals_nod_var{k+1}", "d", ("time_step", "num_nodes"))
                for k in range(6)
            ]
            for t in range(n_steps):
                tv[t] = float(times[t])
                for k in range(6):
                    vals[k][t] = displacements[t, :, k]
        else:
            tv[0] = 0.0
    finally:
        f.close()


def read_exodus_summary(path: str) -> Dict:
    """Light-weight read-back (for tests/tools): dims, coords, blocks,
    nodal variable names and values."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    try:
        out = {
            "num_nodes": f.dimensions["num_nodes"],
            "num_elem": f.dimensions["num_elem"],
            "coords": np.stack(
                [f.variables[f"coord{a}"][:].copy() for a in "xyz"], axis=1
            ),
            "blocks": [],
            "times": f.variables["time_whole"][:].copy(),
            "nodal_vars": {},
        }
        bi = 1
        while f"connect{bi}" in f.variables:
            cv = f.variables[f"connect{bi}"]
            out["blocks"].append(
                (cv.elem_type.decode(), cv[:].copy() - 1)
            )
            bi += 1
        if "name_nod_var" in f.variables:
            raw = f.variables["name_nod_var"][:]
            names = ["".join(c.decode() for c in row if c != b"").rstrip("\x00") for row in raw]
            for k, nm in enumerate(names):
                out["nodal_vars"][nm] = f.variables[f"vals_nod_var{k+1}"][:].copy()
        return out
    finally:
        f.close()
