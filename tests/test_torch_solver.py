"""Port parity: fem_shell_tpu_torch.solver.pcg against the JAX package's
solver.pcg — the stopping rule, the flexible beta and the divergence
guard (stop after 8 consecutive growth steps above blowup_factor x the
start; a transient first-iteration spike must not trip it). Fixtures as
in tests/test_solver_divergence.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.solver import pcg as jpcg
from fem_shell_tpu_torch.solver import pcg


def _spd(n=60, seed=0):
    """kappa 1e2: CG converges in about n iterations and both packages
    count the same (at kappa 1e4 and n=120 both need ~470 iterations,
    past n, and their rounding moves the count by ~10)."""
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = q @ np.diag(np.logspace(0, 2, n)) @ q.T
    return a, rng.standard_normal(n)


@pytest.mark.parametrize("flexible", [False, True])
def test_pcg_matches_jax(flexible):
    """f64, Jacobi: same iteration count and solution as the JAX package."""
    a, b = _spd()
    d = np.diagonal(a).copy()
    ref = jpcg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), diag=jnp.asarray(d),
               rtol=1e-10, maxiter=1000, flexible=flexible)
    got = pcg(lambda v: torch.from_numpy(a) @ v, torch.from_numpy(b), diag=torch.from_numpy(d),
              rtol=1e-10, maxiter=1000, flexible=flexible)
    assert abs(got.iters - int(ref.iters)) <= 1  # reductions sum in another order
    assert got.residual < 1e-10
    x = np.asarray(ref.x)
    assert np.abs(got.x.numpy() - x).max() <= 1e-8 * np.abs(x).max()


def test_pcg_exits_early_on_divergence():
    """An indefinite preconditioner on an f32 ill-conditioned system: the
    guard fires long before maxiter, and the result reports no convergence."""
    n, neg = 200, 10
    rng = np.random.default_rng(0)
    q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    a = (q @ np.diag(np.logspace(0, 6, n)) @ q.T).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    v = np.linalg.qr(rng.standard_normal((n, neg)))[0]
    m = (np.eye(n) - 1e4 * v @ v.T).astype(np.float32)
    at, mt = torch.from_numpy(a), torch.from_numpy(m)
    res = pcg(lambda x: at @ x, torch.from_numpy(b), maxiter=5000, rtol=1e-6,
              apply_prec=lambda r: mt @ r, blowup_factor=2.0)
    assert res.iters < 5000
    assert res.residual > 1.0


def test_pcg_survives_first_iteration_spike():
    """SPD system and preconditioner whose first application spikes the
    residual ~1.5e4x ||b||, then converges: the guard stays off."""
    n = 200
    lam = np.logspace(0, 10, n)
    b = np.zeros(n)
    b[:100] = 1.0
    b[-1] = 3e-3
    m = np.diag(1.0 / lam)
    m[-1, -1] += 1e-2
    at, mt = torch.from_numpy(np.diag(lam)), torch.from_numpy(m)
    res = pcg(lambda x: at @ x, torch.from_numpy(b), rtol=1e-10, maxiter=100,
              apply_prec=lambda r: mt @ r)
    assert res.residual < 1e-9
    assert res.iters < 20


def test_pcg_history_records_every_iteration():
    """``history`` holds ||r|| / ||b|| after each iteration: one entry per
    iteration, the last the returned residual, and the run unchanged."""
    a, b = _spd()
    d = torch.from_numpy(np.diagonal(a).copy())
    mv = lambda v: torch.from_numpy(a) @ v  # noqa: E731
    hist = []
    got = pcg(mv, torch.from_numpy(b), diag=d, rtol=1e-10, maxiter=1000, history=hist)
    plain = pcg(mv, torch.from_numpy(b), diag=d, rtol=1e-10, maxiter=1000)
    assert len(hist) == got.iters == plain.iters and hist[-1] == got.residual
    assert torch.equal(got.x, plain.x)
    assert all(h > 1e-10 for h in hist[:-1])
