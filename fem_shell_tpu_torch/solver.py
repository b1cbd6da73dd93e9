"""Preconditioned conjugate gradients — port of ``fem_shell_tpu/solver.py``.

The JAX package runs the loop as a ``lax.while_loop``; here it is a Python
loop that reads the residual norm on the host every iteration, so the
stopping decision and the iteration count follow the reference's rule
exactly: stop when ||r|| <= max(rtol ||b||, atol), at ``maxiter``, or when
the residual has grown for 8 consecutive iterations and sits above
``blowup_factor`` times its start (the divergence guard; a healthy MG-CG
may spike its residual ~1e4x on iteration 1, so a single spike never
stops it). ``refine`` is the iterative-refinement loop of the refined
solves (``large.py``, ``amg.py``). ``dense_solve`` is the direct solve on a
densified operator (small systems, the oracle path).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import math

import torch

from fem_shell_tpu_torch.ops.stencil_resid import dd_add


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int  # iterations taken
    residual: float  # final ||r||/||b||


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    diag: Optional[torch.Tensor] = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 10000,
    x0: Optional[torch.Tensor] = None,
    apply_prec: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    blowup_factor: float = 1e4,
    flexible: bool = False,
    history: Optional[list] = None,
) -> CGResult:
    """Preconditioned CG. Pass either ``diag`` (Jacobi) or ``apply_prec``
    (any SPD preconditioner application). ``flexible=True`` switches beta
    to the Polak-Ribiere form ``z_{k+1}.(r_{k+1} - r_k) / z_k.r_k``, for a
    preconditioner that varies between applications. A ``history`` list
    receives ||r|| / ||b|| after every iteration (the norm the loop reads
    anyway)."""
    if apply_prec is None:
        inv_diag = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))
        apply_prec = lambda v: inv_diag * v  # noqa: E731
    b_norm = float(torch.sqrt(torch.sum(b * b)))
    stop = max(rtol * b_norm, atol)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    z = apply_prec(r)
    p = z
    rz = torch.sum(r * z)

    r0n = float(torch.sqrt(torch.sum(r * r)))
    tiny = torch.finfo(b.dtype).tiny
    blowup = blowup_factor * max(r0n, b_norm, tiny)
    rn, rn_prev, grow, it = r0n, r0n, 0, 0
    while rn > stop and it < maxiter and not (grow >= 8 and rn > blowup):
        ap = matvec(p)
        alpha = rz / torch.sum(p * ap)
        x = x + alpha * p
        r_old = r
        r = r - alpha * ap
        z = apply_prec(r)
        rz_new = torch.sum(r * z)
        if flexible:
            beta = (rz_new - torch.sum(r_old * z)) / rz
        else:
            beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        rn = float(torch.sqrt(torch.sum(r * r)))
        if history is not None:
            history.append(rn / b_norm if b_norm > 0 else rn)
        grow = grow + 1 if rn > rn_prev else 0
        rn_prev = rn
        it += 1
    rel = rn / b_norm if b_norm > 0 else rn
    return CGResult(x, it, rel)


class RefineResult(NamedTuple):
    x: torch.Tensor  # x_hi + x_lo
    history: list  # true ||r|| / ||b|| per pass
    inner_iters: list  # inner iterations per solve, the first included


def refine(
    inner: Callable[[torch.Tensor, float, int], CGResult],
    resid: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    rtol: float,
    n_refine: int,
    inner_rtol: float,
    inner_maxiter: int,
    verbose: bool = False,
) -> RefineResult:
    """Iterative refinement: ``inner(rhs, inner_rtol, inner_maxiter)`` solves
    A x = b, then each pass computes the true residual ``resid(x_hi, x_lo)``
    of the iterate, kept as a double-double x_hi + x_lo, and adds the inner
    solve of it. The loop stops at ``rtol``, on a non-finite residual, or
    when a pass improves the residual by less than 10x (the floor: a
    healthy pass with inner_rtol=1e-5 gains orders of magnitude)."""
    b_norm = float(torch.sqrt(torch.sum(b * b)))
    res = inner(b, inner_rtol, inner_maxiter)
    x_hi, x_lo = res.x, torch.zeros_like(res.x)
    iters, hist = [int(res.iters)], []
    for _ in range(n_refine):
        r = resid(x_hi, x_lo)
        rn = float(torch.sqrt(torch.sum(r * r))) / b_norm
        hist.append(rn)
        if verbose:
            print(f"  refine: true residual {rn:.3e} ({sum(iters)} inner iters)", flush=True)
        if rn < rtol or not math.isfinite(rn):
            break
        if len(hist) > 1 and rn > 0.1 * hist[-2]:
            break
        d = inner(r, inner_rtol, inner_maxiter)
        x_hi, x_lo = dd_add(x_hi, x_lo, d.x)
        iters.append(int(d.iters))
    return RefineResult(x_hi + x_lo, hist, iters)


def dense_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct dense solve (small systems / oracle path)."""
    return torch.linalg.solve(a, b)
