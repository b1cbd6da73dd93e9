"""The port's multi-rank dry run (parallel/dryrun.py: the JAX
``_dryrun_body`` paths 1-7 with their asserts) on 2 gloo ranks on
the CPU. Marked slow: path 7's Jacobi PCG takes ~5,800 iterations of
~7 ms of gloo latency each on the host (~60 s in all); chip_smoke.py
runs the dry run on the card and on the CPU ranks of the card's host."""
import numpy as np
import pytest

from fem_shell_tpu_torch.parallel.dryrun import dryrun


@pytest.mark.slow
def test_dryrun_two_cpu_ranks():
    out = dryrun(2, device="cpu", verbose=False)
    paths = ["1", "2", "2t", "3", "4", "5", "5b", "6", "7"]
    assert sorted(k for k in out if k != "launches") == paths
    assert all(np.isfinite(out[p]["u"]).all() for p in paths)
    assert out["3"]["n_sharded"] == 2 and out["3"]["n_levels"] == 3
    assert out["5"]["grid"] == [1, 2] and out["5"]["tile"] == [22, 11]
