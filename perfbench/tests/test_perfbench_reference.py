"""The plain reference against a dense solve at 8^2, and the plates it is
handed."""
import numpy as np
import pytest
import torch

from perfbench import meshes
from perfbench.reference.check import Operator

MAT = {"em": 1e7, "nu": 0.3, "thickness": 0.5}


def recipe(elem, n, renumber=None):
    return {"elem": elem, "nx": n, "ny": n, "lx": 10.0, "ly": 10.0, "support": "simply_supported",
            "renumber_seed": renumber}


def dense(op):
    eye = torch.eye(op.n, dtype=torch.float64)
    return torch.stack([op.apply(eye[j]) for j in range(op.n)], dim=1)


def dense_solution(elem, renumber=None):
    """(operator, plate, dense K, Test G's load f, the dense solve's u) at 8^2."""
    plate = meshes.plate(recipe(elem, 8, renumber))
    op = Operator(plate, MAT, "cpu", chunk=37)  # chunks that do not divide the element count
    k = dense(op)
    assert torch.allclose(k, k.T, rtol=0, atol=1e-9 * float(k.abs().max()))
    free = op.free
    f = torch.zeros(op.n, dtype=torch.float64)
    f[2::6] = 300.0 * plate.dx * plate.dy
    u = torch.zeros_like(f)
    kf = k[free][:, free]
    u[free] = torch.linalg.solve(kf, f[free])
    assert bool((torch.linalg.eigvalsh(kf) > 0).all())
    return op, plate, k, f, u


@pytest.mark.parametrize("elem, renumber", [("t", None), ("q", None), ("q", 1)])
def test_reference_against_a_dense_solve(elem, renumber):
    op, plate, k, f, u = dense_solution(elem, renumber)
    free = op.free
    # the dense solution is exact to f64 rounding, by both numbers
    read = op.compare(u.reshape(-1, 6), f.reshape(-1, 6))
    assert read["backward_err"] < 1e-14 and read["residual"] < 1e-11
    # centre deflection of Test G near Kirchhoff's 0.1064 already at 8^2
    centre = int(np.argmin(np.linalg.norm(plate.coords[:, :2] - 5.0, axis=1)))
    assert 0.09 < float(u.reshape(-1, 6)[centre, 2]) < 0.12
    # a displacement off by 1e-9 of its size on one dof, or left on a
    # constrained dof, is seen
    bad = u.clone()
    i = int(torch.argmax(bad.abs()))
    bad[i] *= 1 + 1e-9
    assert op.compare(bad.reshape(-1, 6), f.reshape(-1, 6))["backward_err"] > 1e-12
    bad = u.clone()
    bad[int(torch.nonzero(~free)[0])] = 1e-9 * float(u.abs().max())
    assert op.compare(bad.reshape(-1, 6), f.reshape(-1, 6))["backward_err"] > 1e-12
    # the same solution in f32 is not
    assert op.compare(u.float().double().reshape(-1, 6), f.reshape(-1, 6))["backward_err"] > 1e-9


@pytest.mark.parametrize("elem", ["t", "q"])
def test_residual_sees_smooth_errors(elem):
    """Fields wrong all over the plate leave a residual of the load's size:
    a scaled field, the field of another load, a solve stopped early."""
    op, plate, k, f, u = dense_solution(elem)
    free = op.free
    other = f.clone()
    other[2::6] *= torch.linspace(0.5, 1.5, plate.n_nodes, dtype=torch.float64)
    u_other = torch.zeros_like(u)
    u_other[free] = torch.linalg.solve(k[free][:, free], other[free])
    steps = torch.zeros_like(u)  # five steps of steepest descent from 0
    kf, r = k[free][:, free], f[free].clone()
    for _ in range(5):
        a = float(r @ r / (r @ (kf @ r)))
        steps[free] += a * r
        r = f[free] - kf @ steps[free]
    for wrong, least in ((2 * u, 0.99), (0.01 * u, 0.98), (u_other, 0.05), (steps, 0.05)):
        assert op.compare(wrong.reshape(-1, 6), f.reshape(-1, 6))["residual"] > least
    assert op.compare(u.reshape(-1, 6), f.reshape(-1, 6))["residual"] < 1e-11


def test_plates():
    t, q = meshes.plate(recipe("t", 8)), meshes.plate(recipe("q", 8))
    assert (t.n_nodes, t.n_elems, q.n_elems) == (81, 128, 64)
    assert int(t.fixed[:, 2].sum()) == 32 and not t.fixed[:, 3:].any()
    r = meshes.plate(recipe("q", 8, 1))
    order = np.random.default_rng(1).permutation(81)
    assert np.array_equal(r.coords, q.coords[order]) and np.array_equal(r.fixed, q.fixed[order])
    assert np.array_equal(order[r.conn], q.conn)
