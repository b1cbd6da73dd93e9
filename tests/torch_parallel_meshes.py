"""Rank meshes for the sharded solvers' CPU tests, started in the
background: a module fixture starts one mesh per rank count, and a
test's first use of a mesh waits for it, so the ranks start while the
test computes its JAX references."""
from concurrent.futures import ThreadPoolExecutor

from fem_shell_tpu_torch.parallel.sharded import make_device_mesh


class StartingMeshes:
    """``meshes[n]``: the n-rank gloo mesh on the CPU, once it has started;
    ``meshes[name]`` for a mesh started as ``name=n``."""

    def __init__(self, *counts, **named):
        meshes = dict({n: n for n in counts}, **named)
        self._pool = ThreadPoolExecutor(len(meshes))
        self._futures = {k: self._pool.submit(make_device_mesh, n, device="cpu") for k, n in meshes.items()}

    def __getitem__(self, n):
        return self._futures[n].result()

    def wait(self):
        """Wait until every mesh has started."""
        for f in self._futures.values():
            f.result()

    def close(self):
        try:
            for f in self._futures.values():
                f.result().close()
        finally:
            self._pool.shutdown()
