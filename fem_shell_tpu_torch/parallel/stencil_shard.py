"""Halo-exchange SPMD solver: the strip-partitioned stencil operator —
port of ``fem_shell_tpu/parallel/stencil_shard.py``.

- nodes are strip-partitioned over the ranks: rank s owns lanes
  [s*L, (s+1)*L);
- the stencil half-width W = max|offset| bounds every cross-rank
  dependency, so a matvec needs one ring exchange of [6, Wp] halo columns
  per direction (Wp = W rounded up to 128), O(W) bytes instead of the
  O(N) all-gather of ``parallel/sharded.py``;
- assembly is element-parallel with elements assigned to the strip of
  their first node. Every element then writes only into the window
  [s*L - Wp, (s+1)*L + Wp); the window is filled pass by pass through the
  slot tables (``sharded.scatter_elements``, the kernel
  ``csrc/elem_stiffness.cu`` on the card), and one halo reduction (the
  reverse exchange, then core + left + right) finishes the operator;
- the halos wrap around at the ends of the rank ring. That is harmless
  because out-of-domain columns only multiply blocks that are
  identically zero (the padded lanes past the last node are constrained
  and their couplings masked), as in the single-device stencil mode.

The per-rank SpMV is the ``stencil_spmv`` kernel (``csrc/stencil_spmv.cu``,
``<float>`` or ``<double>`` by dtype) on the values zero-padded once to
[36, K, Wp+L+Wp] and the haloed x, of which the core [:, Wp:Wp+L] is
kept: how the JAX package feeds its Pallas kernel (``df_matvec_pallas``).
On the CPU the wrapper takes its plain version. ``matvec_plain`` is the
JAX ``matvec_spmd``'s slice-and-einsum loop, the plain version the card's
check holds the kernel's per-rank product against.

The operator is assembled in f64 and rounded once to ``dtype`` (the JAX
package assembles an f32 system in f32); the system assembles when it is
built and keeps the operator on the ranks.
"""
from __future__ import annotations

import copy
import types
from typing import Optional

import numpy as np
import torch

from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.soa import _ceil_to, _offsets_of
from fem_shell_tpu_torch.ops.stencil_spmv import MAX_STENCIL, stencil_spmv
from fem_shell_tpu_torch.parallel.comm import DeviceMesh
from fem_shell_tpu_torch.parallel.sharded import (
    ShardedSystemBase,
    material_tensors,
    pcg_spmd,
    scatter_elements,
)


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------


def halo_exchange(comm, st, x_l):
    """x_l [C, L] -> x_ext [C, Wp + L + Wp]: the left halo is the left
    neighbour's last Wp lanes, the right halo the right neighbour's first
    Wp lanes (wrapping around the ring)."""
    wp = st.wp
    from_left, from_right = comm.ppermute_ring(x_l[:, -wp:], x_l[:, :wp])
    return torch.cat([from_left, x_l, from_right], dim=1)


def halo_reduce(comm, st, vals_w):
    """Window contributions [C, Wp + L + Wp] -> the core [C, L] with the
    neighbours' edge contributions added: core, then left, then right."""
    wp, l = st.wp, st.l
    from_left, from_right = comm.ppermute_ring(vals_w[:, -wp:], vals_w[:, :wp])
    core = vals_w[:, wp:wp + l].clone()
    core[:, :wp] += from_left
    core[:, -wp:] += from_right
    return core


def assemble_vals_spmd(comm, p):
    """One rank's share of a strip system: the BC-constrained operator
    zero-padded to [36, K, Wp+L+Wp] in p["dtype"], the Jacobi inverse
    diagonal and the free mask [6, L]. Reused by the sharded multigrid
    levels."""
    dev, f64 = comm.device, torch.float64
    wp, l, offsets = p["wp"], p["l"], p["offsets"]
    k, width = len(offsets), l + 2 * p["wp"]
    st = types.SimpleNamespace(wp=wp, l=l, offsets=offsets, k0=offsets.index(0))
    row0 = comm.axis_index() * l
    coords = torch.as_tensor(p["coords"], dtype=f64, device=dev)
    dm, dp, t = material_tensors(p["mats"], p["thickness"], dev)
    off_arr = np.asarray(offsets, np.int64)
    win = torch.zeros((36, k * width), dtype=f64, device=dev)
    for conn in p["families"]:
        # block (a, b): row node conn[a], slot of offset conn[b] - conn[a],
        # window column conn[a] - row0 + Wp
        c = np.asarray(conn, np.int64)
        kslot = np.searchsorted(off_arr, c[:, None, :] - c[:, :, None])
        col = np.broadcast_to((c - row0 + wp)[:, :, None], kslot.shape)
        scatter_elements(win, coords, c, kslot * width + col, dm, dp, t, chunk=p["chunk"])
    vals = halo_reduce(comm, st, win.reshape(36 * k, width)).reshape(6, 6, k, l)
    del win  # the window is as large as the operator: free it before the masking

    # BC masking: rows by the local mask, columns by the haloed mask
    free_l = torch.as_tensor(p["free"], dtype=f64, device=dev)  # [6, L]
    free_ext = halo_exchange(comm, st, free_l)
    vals.mul_(free_l[:, None, None, :])
    for si, off in enumerate(offsets):
        vals[:, :, si, :] *= free_ext[None, :, off + wp:off + wp + l]
    eye = torch.eye(6, dtype=f64, device=dev)
    vals[:, :, st.k0, :] += eye[:, :, None] * (1.0 - free_l)[None, :, :]

    return _set_operator(st, vals, free_l, p["dtype"])


def _set_operator(st, vals, free_l, dtype):
    """Round the masked f64 operator [6, 6, K, L] once to ``dtype`` into
    ``st``: the values zero-padded to [36, K, Wp+L+Wp] (rounded as they are
    copied in, with no rounded copy beside them), the Jacobi inverse
    diagonal and the free mask [6, L]."""
    k, l, wp = len(st.offsets), st.l, st.wp
    padded = torch.zeros((36, k, l + 2 * wp), dtype=dtype, device=vals.device)
    padded[:, :, wp:wp + l].copy_(vals.reshape(36, k, l))
    return _set_padded(st, padded, free_l)


def _set_padded(st, padded, free_l):
    """Take the operator already zero-padded to [36, K, Wp+L+Wp] (in its
    dtype) into ``st``, with the Jacobi inverse diagonal of its core and the
    free mask [6, L] in that dtype."""
    k, l, wp = len(st.offsets), st.l, st.wp
    core = padded[:, :, wp:wp + l].reshape(6, 6, k, l)
    diag = torch.diagonal(core[:, :, st.k0, :]).T  # [6, L]
    st.inv_diag = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)).contiguous()
    st.vals = padded
    st.free = free_l.to(padded.dtype)
    return st


def matvec_spmd(comm, st, x_l):
    """y = A x on this rank's lanes, [6, L] -> [6, L]: one halo exchange,
    then ``stencil_spmv`` on the padded window, of which the core is
    kept."""
    x_ext = halo_exchange(comm, st, x_l)
    return stencil_spmv(st.vals, x_ext, st.offsets)[:, st.wp:st.wp + st.l]


def matvec_plain(st, x_ext):
    """The JAX ``matvec_spmd``'s slice-and-einsum loop on the haloed x
    [6, Wp+L+Wp]: the plain version of the per-rank product."""
    wp, l = st.wp, st.l
    k = len(st.offsets)
    v = st.vals.reshape(6, 6, k, -1)[:, :, :, wp:wp + l]
    y = torch.zeros((6, l), dtype=x_ext.dtype, device=x_ext.device)
    for si, off in enumerate(st.offsets):
        y = y + torch.einsum("abn,bn->an", v[:, :, si], x_ext[:, off + wp:off + wp + l])
    return y


def compare_products(comm, kernel, plain, reps: int, meta: dict) -> dict:
    """A per-rank product against its plain version: their largest
    absolute difference, the largest |y|, and on the card their
    milliseconds per call over ``reps`` calls (CUDA events), with ``meta``."""
    y, y_plain = kernel(), plain()
    out = dict(meta, max_abs_err=float((y - y_plain).abs().max()), max_abs_y=float(y_plain.abs().max()))
    if comm.device.type == "cuda":
        for name, fn in (("ms", kernel), ("plain_ms", plain)):
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(comm.device)
            out[name] = start.elapsed_time(end) / reps
    return out


def check_spmv_rank(comm, arg):
    """A rank command for the card's check: on the state ``key``, the
    per-rank product (``stencil_spmv`` on the padded window, its core) and
    ``matvec_plain`` on one seeded haloed x; returns their largest absolute
    difference, the largest |y|, and their milliseconds per call over
    ``reps`` calls (CUDA events; None on the CPU)."""
    key, seed, reps = arg
    st = comm.state[key]
    g = torch.Generator().manual_seed(seed + comm.rank)
    x_ext = torch.randn((6, st.l + 2 * st.wp), generator=g, dtype=torch.float64)
    x_ext = x_ext.to(device=comm.device, dtype=st.vals.dtype)
    return compare_products(comm, lambda: stencil_spmv(st.vals, x_ext, st.offsets)[:, st.wp:st.wp + st.l],
                            lambda: matvec_plain(st, x_ext), reps,
                            {"shape": [36, len(st.offsets), st.l + 2 * st.wp], "dtype": str(st.vals.dtype)})


def _build_rank(comm, arg):
    key, p = arg
    comm.state[key] = assemble_vals_spmd(comm, p)


def _round_rank(comm, arg):
    key, src_key, dtype = arg
    src = comm.state[src_key]
    st = types.SimpleNamespace(wp=src.wp, l=src.l, offsets=src.offsets, k0=src.k0)
    core = src.vals[:, :, src.wp:src.wp + src.l].reshape(6, 6, len(src.offsets), src.l)
    comm.state[key] = _set_operator(st, core, src.free, dtype)


def _solve_rank(comm, arg):
    key, b, rtol, maxiter = arg
    st = comm.state[key]
    b = torch.as_tensor(b, dtype=st.vals.dtype, device=comm.device) * st.free
    x, it, res = pcg_spmd(comm, lambda v: matvec_spmd(comm, st, v), b, lambda r: st.inv_diag * r,
                          rtol, maxiter)
    return x.cpu().numpy(), it, res


# ----------------------------------------------------------------------
# controller side
# ----------------------------------------------------------------------


class ShardedStencilSystem(ShardedSystemBase):
    """Domain-decomposed shell solver with the halo-exchange stencil SpMV.

    ``l_force`` overrides the 128-aligned strip length (the sharded
    multigrid partitions by grid rows, so its strips are multiples of the
    grid width); ``dirichlet_mask`` overrides the mesh's BC mask
    (subsampled masks on multigrid coarse levels). With ``assemble=False``
    the system assembles nothing: its caller puts each rank's operator
    under ``key`` (``_set_operator``), as ``grid_asm_shard`` does."""

    def __init__(
        self,
        mesh: ShellMesh,
        material: Material,
        device_mesh: DeviceMesh,
        dtype=torch.float32,
        chunk: int = 8192,
        l_force: Optional[int] = None,
        dirichlet_mask=None,
        assemble: bool = True,
    ):
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"{type(self).__name__}(dtype={dtype}): torch.float64 or torch.float32")
        self._bind(device_mesh)
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        s = self.n_shards
        offsets = _offsets_of(mesh)
        if len(offsets) > MAX_STENCIL:
            raise ValueError("mesh is not stencil-addressable; use parallel.sharded instead")
        self.offsets = [int(o) for o in offsets]
        self.k = len(self.offsets)
        self.w = max(abs(self.offsets[0]), abs(self.offsets[-1]))
        self.w_pad = _ceil_to(max(self.w, 1), 128)

        # strip length L: lanes per rank, 128-aligned, covering the nodes
        n = mesh.n_nodes
        if l_force is not None:
            if l_force * s < n:
                raise ValueError(f"l_force={l_force} too small for {n} nodes on {s} shards")
            self.l = int(l_force)
        else:
            self.l = _ceil_to(_ceil_to(n, 128), 128 * s) // s
        self.n_tot = self.l * s
        if self.l < 2 * self.w_pad:
            raise ValueError(f"strips too narrow for halo exchange: L={self.l} < 2*W={2 * self.w_pad}")
        self.chunk = int(chunk)
        free = np.ones((self.n_tot, 6))
        mask = mesh.dirichlet_mask() if dirichlet_mask is None else np.asarray(dirichlet_mask, bool)
        free[:n] = ~mask
        free[n:] = 0.0
        self.free = free.T.reshape(6, s, self.l).transpose(1, 0, 2)  # [S, 6, L]
        if not assemble:
            return

        # per-rank element partition by the strip of the first node; the
        # tables pad each rank to the largest count as the JAX package's do
        def part_elems(conn, m):
            if len(conn) == 0:
                return np.zeros((s, 0, m), np.int32), np.zeros((s, 0), np.float64)
            anchor = conn[:, 0] // self.l
            order = np.argsort(anchor, kind="stable")
            counts = np.bincount(anchor, minlength=s)
            e_l = int(counts.max())
            out = np.zeros((s, e_l, m), np.int32)
            wgt = np.zeros((s, e_l), np.float64)
            sorted_conn = conn[order]
            pos = 0
            for si in range(s):
                c = counts[si]
                out[si, :c] = sorted_conn[pos:pos + c]
                wgt[si, :c] = 1.0
                out[si, c:] = out[si, 0] if c > 0 else conn[0]
                pos += c
            return out, wgt

        self.tri_conn, self.tri_w = part_elems(mesh.tri, 3)
        self.quad_conn, self.quad_w = part_elems(mesh.quad, 4)
        self.device_mesh.run(_build_rank, [(self.key, self._payload(si)) for si in range(s)])

    def rounded(self, dtype) -> "ShardedStencilSystem":
        """This system with its f64 operator rounded once to ``dtype`` on the
        ranks: what ``dtype`` would build from the same strips, without a
        second assembly."""
        if self.dtype != torch.float64:
            raise ValueError(f"rounded() starts from the f64 operator, not {self.dtype}")
        other = copy.copy(self)
        other._bind(self.device_mesh)
        other.dtype = dtype
        self.device_mesh.run(_round_rank, [(other.key, self.key, dtype)] * self.n_shards)
        return other

    def _payload(self, si: int) -> dict:
        return {"wp": self.w_pad, "l": self.l, "offsets": self.offsets, "coords": self.mesh.coords,
                "mats": self.material.matrices(), "thickness": self.material.thickness,
                "chunk": self.chunk, "dtype": self.dtype, "free": self.free[si],
                "families": [self.tri_conn[si][self.tri_w[si] > 0], self.quad_conn[si][self.quad_w[si] > 0]]}

    def split_forces(self, forces, dtype=np.float64):
        """[N, 6] -> per-rank [6, L] blocks of the padded lanes."""
        f = np.zeros((self.n_tot, 6))
        f[: self.mesh.n_nodes] = np.asarray(forces)
        return [np.ascontiguousarray(b, dtype=dtype)
                for b in f.T.reshape(6, self.n_shards, self.l).transpose(1, 0, 2)]

    def join_solution(self, parts) -> np.ndarray:
        """Per-rank [6, L] blocks -> [N, 6]."""
        return np.concatenate(parts, axis=1).T[: self.mesh.n_nodes].copy()

    def solve(self, forces, rtol: float = 1e-10, maxiter: int = 20000) -> np.ndarray:
        """Jacobi-PCG; forces [N, 6] -> displacements [N, 6] (numpy, in
        ``dtype``); sets ``last_iters`` and ``last_residual``."""
        parts = self._run_solve(_solve_rank, [(self.key, b, rtol, maxiter)
                                              for b in self.split_forces(forces)])
        return self.join_solution(parts)
