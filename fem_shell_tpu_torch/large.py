"""LargeShellSystem — the SoA stencil operator of one mesh: pattern,
device tables and f64 assembly. Port of ``fem_shell_tpu/large.py``
(``__init__``, ``_tables``, ``_assemble_impl``, ``assemble``,
``assemble_df``).

Two f64 assemblies are ported: the general one (element kernels on
plain coordinates, a chunked ``index_add_`` scatter and Dirichlet
elimination; ``assemble``), and on a structured grid the scatter-free
grid pipeline (``ops/assemble_grid.py``, the element kernel
``csrc/elem_stiffness.cu`` on the card), which ``assemble_df`` picks from
``GRID_MIN_ELEMENTS`` elements. Native f64 takes the place of the JAX
package's two-float32 pair, so ``assemble_df`` returns one f64 operator.
Another dtype raises NotImplementedError. The JAX package's f32
exact-geometry path, its strip-df pipeline, RCM reordering and its own
Jacobi/block-Jacobi ``solve`` are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.assemble_grid import assemble_grid
from fem_shell_tpu_torch.ops.soa import apply_bc_soa, assemble_soa, build_soa_pattern, soa_diagonal

# from this many elements a structured grid is assembled by the grid
# pipeline (assemble_df "auto"), and a multigrid hierarchy over such a
# fine mesh assembles every level that way (mg.py)
GRID_MIN_ELEMENTS = 65536


class LargeShellSystem:
    def __init__(
        self,
        mesh: ShellMesh,
        material: Material,
        dtype=torch.float64,
        chunk: int = 16384,
        dirichlet_mask: Optional[np.ndarray] = None,
        device=None,
    ):
        """``dirichlet_mask`` overrides the mesh's own BC mask (multigrid
        coarse levels pass subsampled fine masks). ``device`` defaults to
        CUDA; pass ``"cpu"`` to run on the host."""
        if dtype != torch.float64:
            raise NotImplementedError(
                "only the f64 assembly is ported; the f32 exact-geometry path is "
                "listed in ROADMAP.md"
            )
        self.device = resolve_device(device)
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        self.chunk = int(chunk)
        dm, dp = material.matrices()
        self.dm = torch.as_tensor(dm, dtype=dtype, device=self.device)
        self.dp = torch.as_tensor(dp, dtype=dtype, device=self.device)
        self.thickness = material.thickness

        self.pattern = build_soa_pattern(mesh)
        p = self.pattern
        self.offsets = p.offsets  # host-side ints

        free = np.ones((p.n_pad, 6), dtype=np.float64)
        mask = mesh.dirichlet_mask() if dirichlet_mask is None else np.asarray(dirichlet_mask, bool)
        free[: p.n_nodes] = ~mask
        free[p.n_nodes :] = 0.0
        self.free_t = torch.as_tensor(free.T.copy(), dtype=dtype, device=self.device)  # [6, Npad]
        self._tables_cache = None
        self._coords_cache = None

    @property
    def coords(self):
        if self._coords_cache is None:
            self._coords_cache = torch.as_tensor(self.mesh.coords, dtype=self.dtype, device=self.device)
        return self._coords_cache

    @property
    def _tables(self):
        if self._tables_cache is None:
            p = self.pattern

            def idx(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

            self._tables_cache = {
                "tri_conn": idx(self.mesh.tri),
                "quad_conn": idx(self.mesh.quad),
                "tri_slot": idx(p.tri_slot),
                "quad_slot": idx(p.quad_slot),
                "free_t": self.free_t,
            }
        return self._tables_cache

    def _assemble_impl(self, coords, tables):
        values = assemble_soa(
            self.pattern,
            coords,
            tables["tri_conn"],
            tables["quad_conn"],
            tables["tri_slot"],
            tables["quad_slot"],
            self.dm,
            self.dp,
            self.thickness,
            chunk=self.chunk,
        )
        return apply_bc_soa(values, tables["free_t"], offsets=self.offsets)

    def assemble(self):
        """BC-eliminated operator values [36, K, Npad] in f64."""
        return self._assemble_impl(self.coords, self._tables)

    @functools.cached_property
    def grid(self):
        """The mesh's structured grid (mg.GridInfo) or None, detected once."""
        from fem_shell_tpu_torch.mg import detect_structured_grid  # mg imports this module

        return detect_structured_grid(self.mesh)

    def assemble_df(self, strip_nodes: int = 65536, method: str = "auto", with_diag: bool = False):
        """BC-eliminated operator values [36, K, Npad] in f64 (and with
        ``with_diag`` the [6, Npad] diagonal), the port's counterpart of the
        JAX package's df pair.

        - ``grid``: the scatter-free structured-grid pipeline
          (``ops/assemble_grid.py``), ``max(1, strip_nodes // nxp)`` element
          rows per strip; ValueError off a structured grid.
        - ``strip``: ``assemble()`` (chunked ``index_add_``).
        - ``auto``: ``grid`` on a structured grid of at least
          ``GRID_MIN_ELEMENTS`` elements, else ``strip``. The JAX package
          also keeps the CPU on ``strip``, because its CPU compiler
          contracts the two-float32 arithmetic; native f64 has no such
          hazard, so the port does not."""
        if method == "auto":
            n_elem = len(self.mesh.tri) + len(self.mesh.quad)
            method = "grid" if n_elem >= GRID_MIN_ELEMENTS and self.grid is not None else "strip"
        if method == "grid":
            grid = self.grid
            if grid is None:
                raise ValueError("method='grid' requires a detected structured grid "
                                 "(detect_structured_grid returned None for this mesh)")
            return assemble_grid(grid, self.coords, self.free_t, self.offsets,
                                 self.pattern.n_pad, self.dm, self.dp, self.thickness,
                                 strip_rows=max(1, strip_nodes // grid.nxp), with_diag=with_diag)
        if method != "strip":
            raise ValueError(f"unknown method {method!r}: 'auto', 'grid' or 'strip'")
        values = self.assemble()
        if with_diag:
            return values, soa_diagonal(values, offsets=self.offsets)
        return values
