"""Batched 6x6 block-Jacobi preconditioner — port of
``fem_shell_tpu/ops/blockprec.py``.

The JAX package unrolls the 6x6 Cholesky into plain elementwise ops
because the TPU lacks batched LAPACK; on a GPU that unrolled form is ~70
tiny launches per CG iteration. Here the factor is one batched
``torch.linalg.cholesky_ex`` over the [N, 6, 6] blocks and its
application one batched ``torch.cholesky_solve`` (the pair of triangular
solves). Both are library calls outside any kernel of the port, as the
JAX package computes them outside Pallas.

The node-diagonal blocks of the constrained shell operator are SPD
(element matrices are PSD, drilling stabilization adds positive diagonal,
constrained dofs carry identity), so Cholesky without pivoting is stable;
a block that is not raises instead of giving NaN.
"""
from __future__ import annotations

import torch


def cholesky6(a: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factors of [N, 6, 6] SPD blocks. Raises
    ValueError naming the first block whose factorization fails."""
    l, info = torch.linalg.cholesky_ex(a)
    bad = torch.nonzero(info)
    if bad.numel():
        n = int(bad[0, 0])
        raise ValueError(f"cholesky6: block {n} is not positive definite "
                         f"(leading minor {int(info[n])} fails); {bad.shape[0]} blocks fail")
    return l


def cholesky6_solve(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) z = r for batched [N, 6, 6] factors and [N, 6] rhs."""
    return torch.cholesky_solve(r.unsqueeze(-1), l).squeeze(-1)
