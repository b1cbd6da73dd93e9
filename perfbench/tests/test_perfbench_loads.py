"""The seeded load-case generator: one seed, one set of cases; every seed
the same sizes in another order; any whole seed, also beyond 32 bits."""
import numpy as np
import pytest
import torch

from perfbench import loadcases, meshes

LOADS = {"cases": 16, "scale": [0.5, 1.5], "patch_area": [0.01, 0.1], "patch_factor": [0.5, 3.0],
         "patch_aspect": [0.5, 2.0]}
PLATE = {"elem": "t", "nx": 16, "ny": 16, "lx": 10.0, "ly": 10.0, "support": "simply_supported",
         "renumber_seed": None}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_cases(seed):
    plate = meshes.plate(PLATE)
    a = loadcases.LoadCases(LOADS, 300.0, plate, seed, "cpu")
    b = loadcases.LoadCases(LOADS, 300.0, plate, seed, "cpu")
    assert a.params == b.params and torch.equal(a.fz, b.fz)
    assert a.fz.shape == (16, plate.n_nodes) and bool((a.fz > 0).all())


def test_seeds_differ_in_order_not_in_sizes():
    a, b = loadcases.draw(LOADS, 1, 10.0, 10.0), loadcases.draw(LOADS, 2, 10.0, 10.0)
    assert a != b
    for key in ("scale", "factor"):
        assert sorted(c[key] for c in a) == pytest.approx(sorted(c[key] for c in b))
    area = [sorted((c["x1"] - c["x0"]) * (c["y1"] - c["y0"]) for c in d) for d in (a, b)]
    assert area[0] == pytest.approx(area[1])


def test_patches_inside_the_plate_and_in_range():
    for c in loadcases.draw(LOADS, 2**40 + 3, 10.0, 10.0):
        assert 0.0 <= c["x0"] < c["x1"] <= 10.0 and 0.0 <= c["y0"] < c["y1"] <= 10.0
        assert 0.01 <= (c["x1"] - c["x0"]) * (c["y1"] - c["y0"]) / 100.0 <= 0.1 + 1e-12
        assert 0.5 <= c["scale"] <= 1.5 and 0.5 <= c["factor"] <= 3.0


def test_forces_lump_the_pressure():
    plate = meshes.plate(PLATE)
    lc = loadcases.LoadCases(LOADS, 300.0, plate, 3, "cpu")
    c = lc.params[0]
    f = lc.forces(16)  # case 0 again: the cases cycle
    assert f.shape == (plate.n_nodes, 6) and bool((f[:, [0, 1, 3, 4, 5]] == 0).all())
    lump = 300.0 * plate.dx * plate.dy
    x, y = plate.coords[:, 0], plate.coords[:, 1]
    inside = (x >= c["x0"]) & (x <= c["x1"]) & (y >= c["y0"]) & (y <= c["y1"])
    want = lump * (c["scale"] + c["factor"] * inside)
    assert np.allclose(f[:, 2].numpy(), want, rtol=1e-15, atol=0)
