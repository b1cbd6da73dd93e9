"""Coupling acceleration (post-processing): constant under-relaxation and
IQN-ILS (interface quasi-Newton with inverse least-squares, Degroote et al.),
matching the configuration surface of the reference
(precice_config.xml:67-76: initial-relaxation, max-used-iterations,
timesteps-reused, QR1 filter, singularity-limit).

Operates on the *second* participant's written data in a serial-implicit
scheme. Host-side numpy: interface vectors are small (O(100) dofs for the
tower demo) and the QR is O(m^2 n) with m <= max_used_iterations.

A copy of ``fem_shell_tpu/coupling/accel.py``: the same sequence of
solver outputs gives the same accelerated iterates.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class ConstantRelaxation:
    def __init__(self, omega: float = 0.5):
        self.omega = omega
        self._prev_in: Optional[np.ndarray] = None

    def next_timestep(self):
        self._prev_in = None

    def accelerate(self, x_out: np.ndarray) -> np.ndarray:
        if self._prev_in is None:
            new = x_out.copy()
        else:
            new = self._prev_in + self.omega * (x_out - self._prev_in)
        self._prev_in = new
        return new


class IQNILS:
    """Interface quasi-Newton inverse least-squares.

    Notation: the fixed-point iteration maps the accelerated input x to
    the solver output x̃ = H(x); residual r = x̃ - x. The update solves
    min ||r_k + V a|| over the difference history V = [Δr], W = [Δx̃] and
    sets x_{k+1} = x̃_k + W a.
    """

    def __init__(
        self,
        initial_relaxation: float = 0.001,
        max_used_iterations: int = 20,
        timesteps_reused: int = 5,
        singularity_limit: float = 1e-9,
    ):
        self.omega0 = initial_relaxation
        self.max_used = max_used_iterations
        self.reused = timesteps_reused
        self.eps_qr = singularity_limit
        self._v_cols: List[np.ndarray] = []  # current-timestep columns
        self._w_cols: List[np.ndarray] = []
        self._old_v: List[List[np.ndarray]] = []  # per past timestep
        self._old_w: List[List[np.ndarray]] = []
        self._prev_r: Optional[np.ndarray] = None
        self._prev_xt: Optional[np.ndarray] = None
        self._prev_in: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def next_timestep(self):
        if self._v_cols:
            self._old_v.insert(0, self._v_cols)
            self._old_w.insert(0, self._w_cols)
            self._old_v = self._old_v[: self.reused]
            self._old_w = self._old_w[: self.reused]
        self._v_cols, self._w_cols = [], []
        self._prev_r = None
        self._prev_xt = None
        # keep _prev_in: the converged value seeds the next timestep

    # ------------------------------------------------------------------
    def _stacked(self):
        cols_v = list(self._v_cols)
        cols_w = list(self._w_cols)
        for tv, tw in zip(self._old_v, self._old_w):
            cols_v.extend(tv)
            cols_w.extend(tw)
        cols_v = cols_v[: self.max_used]
        cols_w = cols_w[: self.max_used]
        if not cols_v:
            return None, None
        return np.stack(cols_v, axis=1), np.stack(cols_w, axis=1)

    def accelerate(self, x_out: np.ndarray) -> np.ndarray:
        x_out = np.asarray(x_out, dtype=np.float64).reshape(-1)
        if self._prev_in is None:
            # very first iterate ever: pass through
            self._prev_in = x_out.copy()
            self._prev_r = None
            self._prev_xt = x_out.copy()
            return x_out.copy()
        r = x_out - self._prev_in
        if self._prev_r is not None:
            self._v_cols.insert(0, r - self._prev_r)
            self._w_cols.insert(0, x_out - self._prev_xt)
            self._v_cols = self._v_cols[: self.max_used]
            self._w_cols = self._w_cols[: self.max_used]
        v, w = self._stacked()
        if v is None:
            new = self._prev_in + self.omega0 * r  # first iteration: relax
        else:
            q, rr = np.linalg.qr(v)
            # QR1 filter: drop columns with small diagonal (re-QR after
            # drop). With more columns than rows, R's diagonal covers only
            # the first `rows` columns — the excess columns are dropped
            # outright (they are necessarily linearly dependent).
            diag = np.abs(np.diag(rr))
            scale = diag.max() if diag.size else 0.0
            keep = np.zeros(v.shape[1], dtype=bool)
            keep[: diag.size] = diag > self.eps_qr * max(scale, 1e-300)
            if not keep.all():
                v, w = v[:, keep], w[:, keep]
                if v.shape[1] == 0:
                    new = self._prev_in + self.omega0 * r
                    self._finish(r, x_out, new)
                    return new
                q, rr = np.linalg.qr(v)
            rhs = -(q.T @ r)
            try:
                a = np.linalg.solve(rr, rhs)
            except np.linalg.LinAlgError:
                a = np.linalg.lstsq(rr, rhs, rcond=None)[0]
            new = x_out + w @ a
        self._finish(r, x_out, new)
        return new

    def _finish(self, r, x_out, new):
        self._prev_r = r
        self._prev_xt = x_out.copy()
        self._prev_in = new.copy()
