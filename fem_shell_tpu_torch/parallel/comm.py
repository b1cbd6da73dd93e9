"""The sharded solvers' runtime: persistent rank processes behind one
controller, and the collectives the designs call by their JAX names.

The JAX designs are single-controller: one process calls
``system.solve(forces)`` and a ``shard_map`` runs the SPMD program inside,
with ``jax.lax.psum``, ``psum_scatter``, ``all_gather``, ``ppermute`` and
``axis_index``. Here the SPMD program runs in ``n`` rank processes that
live as long as their ``DeviceMesh``:

- ``DeviceMesh(n, device, backend)`` starts the ranks once, with the
  ``spawn`` start method; they meet at a ``torch.distributed`` TCP
  rendezvous on 127.0.0.1, on a port the controller found free. A design
  sends each rank a module-level function and that rank's argument
  (``DeviceMesh.run``); the rank calls ``fn(comm, arg)`` with its
  ``Comm`` and returns the result. What a design builds on a rank (its
  assembled operator) stays in ``comm.state`` under the design's key
  until the design is dropped.
- Backends: ``nccl`` puts rank r on ``cuda:r`` and needs a card per rank;
  ``gloo`` on ``device="cuda"`` puts rank r on ``cuda:(r % count)``, so
  ranks may share a card, and carries every message through a host copy
  (gloo moves CUDA tensors only for ``broadcast`` and ``all_reduce``);
  ``gloo`` on the CPU keeps everything on the host. The caller chooses
  the transport: nothing switches on a failure.
- Every reduction sums in rank order: the parts are gathered, then added
  rank 0, 1, ... in f64. So every rank holds bitwise the same dot
  products and takes the same branch of a CG's stopping test, and a
  repeated solve is bitwise equal. The two transports carry the same
  bytes into the same sums, so gloo and NCCL agree bit for bit: held on
  every dry-run path at two and four ranks on four H100 GPUs
  (``tools/torch_parallel_phase.py --parts a``; ``chip_smoke.py`` 13(a)
  checks it wherever there are two or more GPUs).
- A rank's exception ends the mesh: the controller stops every rank and
  raises with the rank's traceback. It polls the ranks while it waits, so
  a rank that dies is reported too, and the process group's timeout ends
  a collective that waits for a peer that never comes.
- Kernel launches are counted in the process that launches: each rank
  reports the launches of its command with the result, and the
  controller adds them to ``DeviceMesh.launches`` (per rank) and to
  ``RANK_LAUNCHES`` (summed over ranks and meshes).
"""
from __future__ import annotations

import atexit
import datetime
import multiprocessing
import os
import queue
import socket
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from fem_shell_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
# the launch counters a rank reports (the wrappers of this slice's kernels)
LAUNCH_KEYS = ("spmv_f32", "spmv_f64", "elem3", "elem4")
# kernel launches made by rank processes since the last reset, summed over
# every rank of every mesh of this controller
RANK_LAUNCHES: Dict[str, int] = {k: 0 for k in LAUNCH_KEYS}
# a collective that waits longer than this for a peer raises on its rank
COLLECTIVE_TIMEOUT_S = 600
# a rank that has not joined the rendezvous by then fails the mesh
START_TIMEOUT_S = 600
# how often an idle rank checks that its controller is still there
CONTROLLER_POLL_S = 0.5

_OPEN: "weakref.WeakSet[DeviceMesh]" = weakref.WeakSet()


def reset_rank_launches() -> None:
    for k in RANK_LAUNCHES:
        RANK_LAUNCHES[k] = 0


def _launch_counts() -> Dict[str, int]:
    from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness
    from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv

    return {"spmv_f32": stencil_spmv.launches[torch.float32],
            "spmv_f64": stencil_spmv.launches[torch.float64],
            "elem3": elem_stiffness.launches[3], "elem4": elem_stiffness.launches[4]}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------------
# rank side
# ----------------------------------------------------------------------


class Comm:
    """One rank's view of the mesh inside the SPMD program: its index, the
    mesh size, its device, the collectives, and ``state`` (what the
    designs built on this rank, by key)."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.state: Dict[int, Any] = {}
        # gloo carries CUDA tensors only through host copies
        self._staged = backend == "gloo" and device.type == "cuda"

    def axis_index(self) -> int:
        return self.rank

    def _wire(self, tensors):
        """The tensors as sent: contiguous, and for gloo on CUDA copied to
        the host in one copy (one synchronisation, not one per tensor)."""
        if not self._staged:
            return [t.contiguous() for t in tensors]
        if not tensors:
            return []
        if len({t.dtype for t in tensors}) != 1:
            raise TypeError(f"one staged exchange carries one dtype, got {sorted({str(t.dtype) for t in tensors})}")
        host = torch.cat([t.reshape(-1) for t in tensors]).cpu()
        return [p.view(t.shape) for p, t in zip(host.split([t.numel() for t in tensors]), tensors)]

    def _unwire(self, tensors):
        """Received host buffers back on the rank's device, in one copy."""
        if not self._staged or not tensors:
            return tensors
        dev = torch.cat([t.reshape(-1) for t in tensors]).to(self.device)
        return [p.view(t.shape) for p, t in zip(dev.split([t.numel() for t in tensors]), tensors)]

    def _exchange(self, sends, recvs, to_host: bool = False):
        """Point-to-point messages: ``sends`` [(peer, tag, tensor)] and
        ``recvs`` [(peer, tag, shape, dtype)]; returns the received tensors
        in ``recvs``' order, on the rank's device (gloo with ``to_host``:
        left on the host). Every rank lists its sends, then its receives,
        in one order (NCCL pairs the messages between two ranks by that
        order, gloo by tag), and all are posted before any is waited on."""
        import torch.distributed as dist

        if not sends and not recvs:
            return []
        out = [torch.empty(shape, dtype=dt, device="cpu" if self._staged else self.device)
               for _, _, shape, dt in recvs]
        wired = self._wire([t for _, _, t in sends])
        if self.backend == "nccl":
            ops = [dist.P2POp(dist.isend, t, peer) for (peer, _, _), t in zip(sends, wired)]
            ops += [dist.P2POp(dist.irecv, buf, peer) for (peer, _, _, _), buf in zip(recvs, out)]
            reqs = dist.batch_isend_irecv(ops)
        else:
            reqs = [dist.isend(t, peer, tag=tag) for (peer, tag, _), t in zip(sends, wired)]
            reqs += [dist.irecv(buf, peer, tag=tag) for (peer, tag, _, _), buf in zip(recvs, out)]
        for req in reqs:
            req.wait()
        return out if to_host else self._unwire(out)

    def all_gather(self, x, tiled: bool = False):
        """Every rank's x stacked in rank order, [S, ...] (``tiled``:
        concatenated along dim 0)."""
        if self.size == 1:
            return x.clone() if tiled else x[None].clone()
        if self.backend == "nccl":
            import torch.distributed as dist

            out = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x.contiguous())
        else:
            # gloo: one message to and from every peer, posted together (on
            # the host a third of the latency of gloo's all_gather)
            peers = [j for j in range(self.size) if j != self.rank]
            got = dict(zip(peers, self._exchange([(j, 3, x) for j in peers],
                                                 [(j, 3, tuple(x.shape), x.dtype) for j in peers])))
            got[self.rank] = x
            out = torch.stack([got[j] for j in range(self.size)])
        return out.reshape((self.size * x.shape[0],) + tuple(x.shape[1:])) if tiled else out

    def psum(self, x):
        """The sum of every rank's x, added in rank order in f64 and
        rounded once to x's dtype; equal on every rank."""
        if self.size == 1:
            return x.clone()
        parts = self.all_gather(x)
        acc = parts[0].to(torch.float64)
        for r in range(1, self.size):
            acc = acc + parts[r]
        return acc.to(x.dtype)

    def psum_scalars(self, *vals) -> List[float]:
        """The sums over ranks of 0-d tensors, as host floats: one gather,
        then rank-ordered f64 adds (the CG's dot products)."""
        local = torch.stack([v.reshape(()).to(torch.float64) for v in vals])
        if self.backend == "nccl" or self.size == 1:
            rows = self.all_gather(local).cpu().tolist()
        else:  # gloo: one copy to the host, the sums taken there
            host = local.cpu()
            peers = [j for j in range(self.size) if j != self.rank]
            got = dict(zip(peers, self._exchange([(j, 4, host) for j in peers],
                                                 [(j, 4, tuple(host.shape), host.dtype) for j in peers],
                                                 to_host=True)))
            got[self.rank] = host
            rows = [got[j].tolist() for j in range(self.size)]
        out = []
        for j in range(len(vals)):
            acc = rows[0][j]
            for r in range(1, self.size):
                acc = acc + rows[r][j]
            out.append(acc)
        return out

    def psum_scatter(self, x, dim: int = 0):
        """The tiled reduce-scatter: x split into S equal chunks along
        ``dim``; rank r gets chunk r summed over the ranks, in rank order in
        f64, rounded once to x's dtype."""
        chunks = list(torch.chunk(x, self.size, dim=dim))
        if len({c.shape[dim] for c in chunks}) != 1 or len(chunks) != self.size:
            raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does not split into "
                             f"{self.size} equal chunks")
        if self.size == 1:
            return x.clone()
        r = self.rank
        peers = [j for j in range(self.size) if j != r]
        mine = chunks[r].contiguous()
        got = self._exchange([(j, 2, chunks[j]) for j in peers],
                             [(j, 2, tuple(mine.shape), x.dtype) for j in peers])
        parts = dict(zip(peers, got))
        parts[r] = mine
        acc = parts[0].to(torch.float64)
        for j in range(1, self.size):
            acc = acc + parts[j]
        return acc.to(x.dtype)

    def send_next(self, to_next, shape, dtype):
        """The open chain's one-way shift: rank r sends ``to_next`` to r+1
        (the last rank sends nothing; pass None there) and returns what
        r-1 sent, of ``shape`` and ``dtype`` (None on rank 0)."""
        r, last = self.rank, self.size - 1
        sends = [(r + 1, 5, to_next)] if r < last else []
        recvs = [(r - 1, 5, tuple(shape), dtype)] if r > 0 else []
        got = self._exchange(sends, recvs)
        return got[0] if got else None

    def ppermute_shift(self, to_plus, to_minus, grid=None, axis: int = 1):
        """The two shifts of a halo exchange along one axis of a process
        grid, in one exchange. ``grid`` = (py, px), rank = iy * px + ix
        (default (1, size): the ring); ``axis`` 1 shifts within a row (x), 0
        within a column (y), wrapping around. Rank r sends ``to_plus`` to
        its +1 neighbour and ``to_minus`` to its -1 neighbour and returns
        ``(from_minus, from_plus)``, what the -1 neighbour sent toward +1 and
        the +1 neighbour toward -1. On an axis of size 1 a rank gets its
        own back, as ``jax.lax.ppermute`` on one device does; on an axis of
        size 2 both messages go to one peer, told apart by tag (gloo) and
        by order (NCCL)."""
        py, px = grid if grid is not None else (1, self.size)
        if py * px != self.size or axis not in (0, 1):
            raise ValueError(f"grid {py}x{px}, axis {axis} on {self.size} ranks")
        iy, ix = divmod(self.rank, px)
        if axis == 1:
            n, plus, minus = px, iy * px + (ix + 1) % px, iy * px + (ix - 1) % px
        else:
            n, plus, minus = py, ((iy + 1) % py) * px + ix, ((iy - 1) % py) * px + ix
        if n == 1:
            return to_plus.clone(), to_minus.clone()
        from_minus, from_plus = self._exchange(
            [(plus, 0, to_plus), (minus, 1, to_minus)],
            [(minus, 0, tuple(to_plus.shape), to_plus.dtype),
             (plus, 1, tuple(to_minus.shape), to_minus.dtype)])
        return from_minus, from_plus

    def ppermute_ring(self, to_right, to_left):
        """The two ring shifts of a halo exchange in one exchange: rank r
        sends ``to_right`` to r+1 and ``to_left`` to r-1 (both wrapping
        around) and returns ``(from_left, from_right)``: the 1-D case of
        ``ppermute_shift``."""
        return self.ppermute_shift(to_right, to_left)


def peak_memory(comm, reset: bool):
    """A rank command: this rank's peak allocated device bytes since the
    last reset (None on the CPU); ``reset`` starts a new window."""
    if comm.device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(comm.device)
    if reset:
        torch.cuda.reset_peak_memory_stats(comm.device)
    return peak


def rank_main(rank: int, size: int, port: int, device_type: str, backend: str, cmds, results) -> None:
    """A rank process: join the process group, then run the controller's
    commands until it sends None or is gone (it ended without closing the
    mesh: killed, or left through ``os._exit``). Every failure goes back as
    a traceback."""
    controller = multiprocessing.parent_process()
    try:
        import torch.distributed as dist

        if device_type == "cuda":
            index = rank if backend == "nccl" else rank % torch.cuda.device_count()
            device = torch.device("cuda", index)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)
        # the rendezvous is on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=size, rank=rank,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        comm = Comm(rank, size, device, backend)
        results.put(("ready", rank, None, None))
    except Exception:  # noqa: BLE001 - reported to the controller, which raises
        results.put(("error", rank, traceback.format_exc(), None))
        return
    seen = _launch_counts()
    while True:
        try:
            msg = cmds.get(timeout=CONTROLLER_POLL_S)
        except queue.Empty:
            if controller.is_alive():
                continue
            break
        if msg is None:
            break
        fn, arg, drops = msg
        try:
            for key in drops:
                comm.state.pop(key, None)
            out = fn(comm, arg)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = _launch_counts()
            delta = {k: now[k] - seen[k] for k in LAUNCH_KEYS}
            seen = now
            results.put(("ok", rank, out, delta))
        except Exception:  # noqa: BLE001 - reported to the controller, which raises
            results.put(("error", rank, traceback.format_exc(), None))
            break
    try:
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001 - a peer already gone; the process ends here
        pass


# ----------------------------------------------------------------------
# controller side
# ----------------------------------------------------------------------


class DeviceMesh:
    """``n`` persistent rank processes on ``device`` (CUDA unless the caller
    names the CPU) joined over ``backend`` (``nccl`` on CUDA, ``gloo`` on the
    CPU by default). Close it with ``close()`` or a ``with`` block; the
    interpreter's exit closes what is left open."""

    def __init__(self, n: int, device=None, backend: Optional[str] = None):
        n = int(n)
        if n < 1:
            raise ValueError(f"a device mesh needs at least one rank, got {n}")
        dev = resolve_device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"ranks run on cuda or cpu, not {dev}")
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("the nccl backend runs on CUDA; use backend='gloo' on the CPU")
            count = torch.cuda.device_count()
            if n > count:
                raise ValueError(f"nccl needs one GPU per rank: {n} ranks, {count} GPU(s) "
                                 "(backend='gloo' lets ranks share a card)")
        self.size = n
        self.device = dev
        self.backend = backend
        # (py, px) where a 2-D process grid is laid over the ranks
        # (grid2d_shard.make_device_mesh2d), else None
        self.grid2d: Optional[Tuple[int, int]] = None
        self.launches: List[Dict[str, int]] = [{k: 0 for k in LAUNCH_KEYS} for _ in range(n)]
        self._next_key = 0
        self._drops: List[int] = []
        self._procs = []
        self._closed = False
        if dev.type == "cuda":
            # one nvcc per source here, not one per source in every rank
            from fem_shell_tpu_torch.ops import _build

            _build.build_all()

        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self._results = ctx.Queue()
        self._cmds = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=rank_main, args=(r, n, port, dev.type, backend, self._cmds[r],
                                                           self._results), daemon=True)
                       for r in range(n)]
        _OPEN.add(self)
        for p in self._procs:
            p.start()
        self._collect("ready", START_TIMEOUT_S)

    # ------------------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def new_key(self) -> int:
        """A fresh key for a design's state on the ranks."""
        self._next_key += 1
        return self._next_key

    def drop(self, key: int) -> None:
        """Forget ``key``'s state on every rank (sent with the next command)."""
        if not self._closed:
            self._drops.append(key)

    def reset_launches(self) -> None:
        for counts in self.launches:
            for k in counts:
                counts[k] = 0

    def run(self, fn: Callable, args: Sequence[Any]) -> List[Any]:
        """Run ``fn(comm, args[r])`` on every rank r; the results in rank
        order. Raises if any rank raises or dies."""
        if self._closed:
            raise RuntimeError("the device mesh is closed")
        if len(args) != self.size:
            raise ValueError(f"{len(args)} arguments for {self.size} ranks")
        drops, self._drops = self._drops, []
        for q, a in zip(self._cmds, args):
            q.put((fn, a, drops))
        return self._collect("ok", None)

    def _collect(self, kind: str, timeout: Optional[float]) -> List[Any]:
        out: List[Any] = [None] * self.size
        pending = set(range(self.size))
        waited = 0.0
        while pending:
            try:
                tag, rank, payload, delta = self._results.get(timeout=0.2)
            except queue.Empty:
                waited += 0.2
                dead = [r for r in sorted(pending) if not self._procs[r].is_alive()]
                if dead:
                    self._fail(f"rank {dead[0]} exited with code {self._procs[dead[0]].exitcode}")
                if timeout is not None and waited > timeout:
                    self._fail(f"ranks {sorted(pending)} did not start within {timeout} s")
                continue
            if tag == "error":
                self._fail(f"rank {rank} raised:\n{payload}")
            out[rank] = payload
            pending.discard(rank)
            if delta:
                for k, v in delta.items():
                    self.launches[rank][k] += v
                    RANK_LAUNCHES[k] += v
        return out

    def _fail(self, why: str):
        self._stop(graceful=False)
        raise RuntimeError(f"sharded run failed ({self.size} {self.backend} ranks on {self.device.type}): {why}")

    def _stop(self, graceful: bool) -> None:
        if self._closed:
            return
        self._closed = True
        started = [p for p in self._procs if p.pid is not None]
        if graceful:
            for q in self._cmds:
                q.put(None)
            for p in started:
                p.join(timeout=30)
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for q in self._cmds + [self._results]:
            q.cancel_join_thread()
            q.close()
        _OPEN.discard(self)

    def close(self) -> None:
        """Stop the ranks (idempotent)."""
        self._stop(graceful=True)

    def __repr__(self):
        state = "closed" if self._closed else "open"
        return f"DeviceMesh({self.size}, device={self.device.type!r}, backend={self.backend!r}, {state})"


@atexit.register
def _close_open_meshes() -> None:
    for mesh in list(_OPEN):
        mesh.close()


def check_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh (parallel.sharded.make_device_mesh), got {type(mesh).__name__}")
    if mesh.closed:
        raise RuntimeError("the device mesh is closed")
    return mesh
