"""LargeShellSystem — the SoA stencil operator of one mesh: pattern,
device tables and f64 assembly. Port of ``fem_shell_tpu/large.py``
(``__init__``, ``_tables``, ``_assemble_impl``, ``assemble``).

Only the plain f64 path is ported: element kernels on plain coordinates,
a chunked ``index_add_`` scatter and Dirichlet elimination; another dtype
raises NotImplementedError. The JAX package's f32 exact-geometry path,
strip-df and grid-df assemblies, RCM reordering and its own
Jacobi/block-Jacobi ``solve`` are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fem_shell_tpu_torch.device import resolve_device
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.soa import apply_bc_soa, assemble_soa, build_soa_pattern


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
