"""The sharded solvers' runtime (fem_shell_tpu_torch/parallel/comm.py) on
the CPU, over gloo: the collectives against numpy on 2 and 3 ranks (rank
r holds a seeded array of its own), directly and through the host-copy
path gloo takes for ranks on a card, bitwise repeats, a rank's exception
raised in the controller within seconds, ranks that exit on their own when
their controller is gone, and the nccl backend refused before any rank
starts where there is no GPU for each rank.

Each mesh is spawned once per module, in the background. The ranks start from the package's
``comm.rank_main`` and run the commands below, which they import from this
module by name."""
import multiprocessing
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fem_shell_tpu_torch.parallel import comm as pcomm
from fem_shell_tpu_torch.parallel.sharded import make_device_mesh
from torch_parallel_meshes import StartingMeshes


def _data(rank, shape=(6, 10)):
    return np.random.default_rng(100 + rank).normal(size=shape)


def collectives(comm, staged):
    """Every collective once on this rank's seeded data (the ranks import
    this module by name through the controller's sys.path). ``staged``
    takes gloo's host-copy path for ranks on a card, here between host
    tensors."""
    comm._staged = staged
    x = torch.as_tensor(_data(comm.rank))
    wide = torch.as_tensor(_data(comm.rank, (4, 6 * comm.size)))
    from_left, from_right = comm.ppermute_ring(x[:, -2:], x[:, :2])
    return {"rank": comm.axis_index(), "psum": comm.psum(x).numpy(),
            "psum32": comm.psum(x.to(torch.float32)).numpy(),
            "scalars": comm.psum_scalars(x.sum(), (x * x).sum()),
            "gather": comm.all_gather(x).numpy(), "tiled": comm.all_gather(x, tiled=True).numpy(),
            "scatter": comm.psum_scatter(wide, dim=1).numpy(),
            "from_left": from_left.numpy(), "from_right": from_right.numpy()}


def fail_on_rank_1(comm, _):
    if comm.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    comm.psum_scalars(torch.zeros(()))  # rank 0 waits in a collective for rank 1
    return None


@pytest.fixture(scope="module")
def meshes():
    started = StartingMeshes(2, 3, doomed=2)
    yield started
    started.close()


@pytest.mark.parametrize("staged", [False, True], ids=["direct", "staged"])
@pytest.mark.parametrize("n", [2, 3], ids=["2ranks", "3ranks"])
def test_collectives_match_numpy(meshes, n, staged):
    mesh = meshes[n]
    s = mesh.size
    out = mesh.run(collectives, [staged] * s)
    xs = [_data(r) for r in range(s)]
    wides = [_data(r, (4, 6 * s)) for r in range(s)]
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x  # rank order
    for r, o in enumerate(out):
        assert o["rank"] == r
        np.testing.assert_array_equal(o["psum"], total)
        np.testing.assert_array_equal(o["psum32"], sum(x.astype(np.float64) for x in
                                                       [x.astype(np.float32) for x in xs]).astype(np.float32))
        np.testing.assert_allclose(o["scalars"], [sum(x.sum() for x in xs), sum((x * x).sum() for x in xs)],
                                   rtol=1e-14)
        np.testing.assert_array_equal(o["gather"], np.stack(xs))
        np.testing.assert_array_equal(o["tiled"], np.concatenate(xs))
        np.testing.assert_array_equal(o["scatter"], sum(wides)[:, 6 * r:6 * (r + 1)])
        np.testing.assert_array_equal(o["from_left"], xs[(r - 1) % s][:, -2:])
        np.testing.assert_array_equal(o["from_right"], xs[(r + 1) % s][:, :2])
    # every rank holds bitwise the same reductions, and a repeat is bitwise equal
    again = mesh.run(collectives, [staged] * s)
    for o, a in zip(out, again):
        assert o["scalars"] == out[0]["scalars"] == a["scalars"]
        np.testing.assert_array_equal(o["psum"], a["psum"])
        np.testing.assert_array_equal(o["scatter"], a["scatter"])


def test_rank_error_raises_without_hang(meshes):
    meshes.wait()  # every rank of the module's meshes is running
    m = meshes["doomed"]
    before = len(multiprocessing.active_children())
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="(?s)rank 1 raised:.*rank 1 fails on purpose"):
        m.run(fail_on_rank_1, [None, None])
    assert time.perf_counter() - t0 < 30
    assert m.closed
    with pytest.raises(RuntimeError, match="closed"):
        m.run(fail_on_rank_1, [None, None])
    assert len(multiprocessing.active_children()) == before - 2


def test_nccl_without_gpus_raises_before_spawn(monkeypatch):
    before = len(multiprocessing.active_children())
    with pytest.raises(ValueError, match="nccl backend runs on CUDA"):
        make_device_mesh(2, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_device_mesh(2, backend="nccl")  # no CUDA here: refused, nothing falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks, 1 GPU"):
        make_device_mesh(2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        pcomm.DeviceMesh(2, device="cpu", backend="mpi")
    assert len(multiprocessing.active_children()) == before


def _running(pid):
    """Whether ``pid`` is a live process (a zombie has exited)."""
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_ranks_exit_when_the_controller_is_gone(tmp_path):
    """A controller that ends without closing its mesh (``os._exit`` skips
    the clean-up that stops the ranks, as does a kill) leaves no rank
    behind: each idle rank sees its controller gone and exits."""
    pids = tmp_path / "pids"
    code = ("import os, sys\n"
            "from fem_shell_tpu_torch.parallel import comm\n"
            "mesh = comm.DeviceMesh(2, device='cpu')\n"
            "open(sys.argv[1], 'w').write(' '.join(str(p.pid) for p in mesh._procs))\n"
            "os._exit(1)\n")
    with open(tmp_path / "stderr", "w") as err:
        done = subprocess.run([sys.executable, "-c", code, str(pids)], cwd=pathlib.Path(__file__).parents[1],
                              stdout=subprocess.DEVNULL, stderr=err, timeout=120)
    assert done.returncode == 1, (tmp_path / "stderr").read_text()
    ranks = [int(p) for p in pids.read_text().split()]
    assert len(ranks) == 2
    deadline = time.monotonic() + 10
    while any(map(_running, ranks)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(map(_running, ranks))
