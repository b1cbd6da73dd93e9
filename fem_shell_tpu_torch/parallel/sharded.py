"""Row-block sharded assembly and distributed PCG — port of
``fem_shell_tpu/parallel/sharded.py``.

The analog of the reference's MPI domain decomposition (libMesh
partitioning, PETSc MatMPIAIJ and VecScatter):

- **Assembly** is element-parallel: each rank computes the element
  stiffnesses of its element block with ``ops/elem_stiffness`` (the
  kernel ``csrc/elem_stiffness.cu`` on the card) and adds their 6x6
  blocks into a full-height block-ELL buffer pass by pass through the
  slot tables (``ops/soa.scatter_passes``; never ``index_add_``, whose
  order on CUDA is not fixed). A reduce-scatter then sums the ranks'
  buffers in rank order and leaves each rank its own row block.
- **CG** is point-Jacobi PCG on the row blocks: vector operations are
  local, dot products are rank-ordered sums (``comm.Comm.psum_scalars``),
  and the matvec all-gathers x and runs ``ops/assemble.ell_matvec`` on the
  row block.

``make_device_mesh`` starts the ranks (``comm.DeviceMesh``). The system
assembles once, when it is built, and keeps the operator on the ranks;
``solve`` runs only the PCG (the JAX package traces assembly and solve as
one program per call).
"""
from __future__ import annotations

import math
import types
import weakref
from typing import Optional

import numpy as np
import torch

from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.ops.assemble import _first_self, build_ell_pattern, ell_matvec
from fem_shell_tpu_torch.ops.soa import _scatter_family, scatter_passes
from fem_shell_tpu_torch.parallel.comm import DeviceMesh, check_mesh
from fem_shell_tpu_torch.parallel.partition import Partition, build_partition

# elements per element-kernel call in a rank's assembly
CHUNK = 8192


def make_device_mesh(n_devices: Optional[int] = None, device=None, backend: Optional[str] = None) -> DeviceMesh:
    """``n_devices`` persistent ranks (default: one per visible GPU on CUDA,
    one on the CPU) on ``device`` (CUDA unless the caller names the CPU),
    joined over ``backend`` ("nccl" on CUDA, "gloo" on the CPU by
    default; "gloo" on CUDA lets ranks share a card)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if (device is None or str(device).startswith("cuda")) else 1
    return DeviceMesh(n_devices, device=device, backend=backend)


def scatter_elements(flat, coords, conn, slot, dm, dp, thickness, chunk: int = CHUNK):
    """Add the element blocks of ``conn`` [E, m] (node ids into ``coords``
    [N, 3] f64, on the rank's device) into ``flat`` [36, X] f64 at the flat
    columns ``slot`` [E, m, m] (host numpy): one ``elem_stiffness`` call per
    chunk of elements, then the chunk's passes of distinct columns, so
    every sum has the element order."""
    if len(conn) == 0:
        return flat
    dev = flat.device
    passes = [(torch.as_tensor(src, device=dev), torch.as_tensor(dest, device=dev), bounds)
              for src, dest, bounds in scatter_passes(np.asarray(slot, np.int64), chunk)]
    conn_t = torch.as_tensor(np.asarray(conn, np.int64), device=dev)
    return _scatter_family(flat, coords, conn_t, passes, chunk, dm, dp, thickness)


def material_tensors(material_mats, thickness, device):
    dm, dp = material_mats
    return (torch.as_tensor(dm, dtype=torch.float64, device=device),
            torch.as_tensor(dp, dtype=torch.float64, device=device), float(thickness))


def pcg_spmd(comm, matvec, b, prec, rtol: float, maxiter: int):
    """PCG on this rank's rows of a distributed system, the JAX loop: stop
    when ||r|| <= rtol ||b|| or at ``maxiter``. Each dot product is one
    rank-ordered sum, so every rank holds the same scalars and leaves the
    loop at the same iteration. Returns (x, iterations, ||r|| / ||b||)."""
    r = b
    z = prec(r)
    bb, rz = comm.psum_scalars(torch.sum(b * b), torch.sum(r * z))
    b_norm = math.sqrt(bb)
    stop = rtol * b_norm
    x = torch.zeros_like(b)
    p = z
    rr, it = bb, 0
    while math.sqrt(rr) > stop and it < maxiter:
        ap = matvec(p)
        (pap,) = comm.psum_scalars(torch.sum(p * ap))
        alpha = rz / pap
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new, rr = comm.psum_scalars(torch.sum(r * z), torch.sum(r * r))
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    rn = math.sqrt(rr)
    return x, it, (rn / b_norm if b_norm > 0 else rn)


class ShardedSystemBase:
    """What the sharded systems share on the controller: the mesh of ranks,
    a key for the system's state on them (dropped when the system is
    collected), and the gathering of per-rank solve results."""

    def _bind(self, device_mesh: DeviceMesh):
        self.device_mesh = check_mesh(device_mesh)
        self.n_shards = device_mesh.size
        self.key = device_mesh.new_key()
        weakref.finalize(self, device_mesh.drop, self.key)

    def _run_solve(self, fn, per_rank):
        out = self.device_mesh.run(fn, per_rank)
        # every rank leaves the CG at the same iteration with the same residual
        self.last_iters = max(int(o[1]) for o in out)
        self.last_residual = max(float(o[2]) for o in out)
        return [o[0] for o in out]


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------


def _build_rank(comm, arg):
    key, p = arg
    dev, f64 = comm.device, torch.float64
    rps, n_pad, k = p["rps"], p["n_pad"], p["k"]
    coords = torch.as_tensor(p["coords"], dtype=f64, device=dev)
    dm, dp, t = material_tensors(p["mats"], p["thickness"], dev)
    flat = torch.zeros((36, n_pad * k), dtype=f64, device=dev)
    for conn, w, slot in p["families"]:
        real = w > 0  # padding elements carry weight 0 and add nothing
        scatter_elements(flat, coords, conn[real], slot[real], dm, dp, t)
    # reduce-scatter: my rows [rps*K] of every entry, summed in rank order
    local = comm.psum_scatter(flat, dim=1)
    blocks = local.reshape(6, 6, rps, k).permute(2, 3, 0, 1)  # [rps, K, 6, 6]

    # Dirichlet masking on my rows; columns through the global free mask
    adj = torch.as_tensor(p["adj"], dtype=torch.int64, device=dev)  # [rps, K] global ids
    free_full = torch.as_tensor(p["free_full"], dtype=f64, device=dev)  # [n_pad, 6]
    row0 = comm.axis_index() * rps
    free_l = free_full[row0:row0 + rps]
    blocks = blocks * free_l[:, None, :, None] * free_full[adj][:, :, None, :]
    is_self = adj == (row0 + torch.arange(rps, device=dev))[:, None]
    first_self = _first_self(adj - row0).to(f64)
    eye = torch.eye(6, dtype=f64, device=dev)
    blocks = blocks + first_self[:, :, None, None] * (eye[None, None] * (1.0 - free_l)[:, None, :, None])

    dtype = p["dtype"]
    blocks = blocks.to(dtype).contiguous()
    diag_blocks = torch.diagonal(blocks, dim1=-2, dim2=-1)  # [rps, K, 6]
    diag = torch.where(is_self[..., None], diag_blocks, 0.0).sum(dim=1)
    inv_diag = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))
    comm.state[key] = types.SimpleNamespace(blocks=blocks, adj=adj, inv_diag=inv_diag,
                                            free_l=free_l.to(dtype))


def _matvec(comm, st, x_l):
    return ell_matvec(st.blocks, st.adj, comm.all_gather(x_l, tiled=True))


def _solve_rank(comm, arg):
    key, b, rtol, maxiter = arg
    st = comm.state[key]
    b = torch.as_tensor(b, dtype=st.blocks.dtype, device=comm.device) * st.free_l
    x, it, res = pcg_spmd(comm, lambda v: _matvec(comm, st, v), b, lambda r: st.inv_diag * r, rtol, maxiter)
    return x.cpu().numpy(), it, res


# ----------------------------------------------------------------------
# controller side
# ----------------------------------------------------------------------


class ShardedShellSystem(ShardedSystemBase):
    """Domain-decomposed shell solver over a mesh of ranks. The assembled
    operator is a fixed-order sum and every reduction is rank-ordered, so
    repeated solves are bitwise equal and the solution agrees with the
    single-device ``ShellSystem`` to the CG's tolerance at any rank count
    (the reference's Test G invariance)."""

    def __init__(self, mesh: ShellMesh, material: Material, device_mesh: DeviceMesh, dtype=torch.float64):
        if dtype not in (torch.float64, torch.float32):
            raise ValueError(f"ShardedShellSystem(dtype={dtype}): torch.float64 or torch.float32")
        self._bind(device_mesh)
        self.mesh = mesh
        self.material = material
        self.dtype = dtype
        pattern = build_ell_pattern(mesh)
        self.part: Partition = build_partition(mesh, pattern, self.n_shards)
        p = self.part
        rps, k = p.rows_per_shard, p.adj.shape[1]
        free = np.zeros((p.n_pad, 6))
        free[: p.n_nodes] = ~mesh.dirichlet_mask()  # padded rows are fully constrained
        common = {"rps": rps, "n_pad": p.n_pad, "k": k, "coords": mesh.coords, "mats": material.matrices(),
                  "thickness": material.thickness, "free_full": free, "dtype": dtype}
        args = []
        for s in range(self.n_shards):
            fams = [(p.tri_shard[s], p.tri_weight[s], p.tri_slot[s]),
                    (p.quad_shard[s], p.quad_weight[s], p.quad_slot[s])]
            args.append((self.key, dict(common, families=fams, adj=p.adj[s * rps:(s + 1) * rps])))
        self.device_mesh.run(_build_rank, args)

    def solve(self, forces, rtol: float = 1e-12, maxiter: int = 20000) -> np.ndarray:
        """forces [N, 6] -> displacements [N, 6] (numpy, in ``dtype``); sets
        ``last_iters`` and ``last_residual``."""
        p = self.part
        rps = p.rows_per_shard
        f = np.zeros((p.n_pad, 6))
        f[: p.n_nodes] = np.asarray(forces)
        parts = self._run_solve(_solve_rank, [(self.key, f[s * rps:(s + 1) * rps], rtol, maxiter)
                                              for s in range(self.n_shards)])
        return np.concatenate(parts)[: p.n_nodes]
