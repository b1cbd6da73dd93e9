"""The seeded load-case generator that every ``loadcases.*`` traffic mix
reads.

A load case is the configuration's uniform transverse pressure ``q``
scaled by a factor, plus one rectangular pressure patch, lumped onto the
nodes as the reference's meshGen lumps a uniform load: each node takes
pressure x dx x dy (main_all.cpp:341-387). The mix's ``loads`` block
gives the ranges:

- ``cases``: how many distinct load cases a run cycles through;
- ``scale``: [lo, hi] of the factor on ``q``;
- ``patch_area``: [lo, hi] of the patch's share of the plate's area;
- ``patch_factor``: [lo, hi] of the patch pressure, in units of ``q``;
- ``patch_aspect``: [lo, hi] of the patch's width over its height.

Scale, area and patch factor are stratified: case k of every seed takes
the midpoints of ``cases`` equal bins, shuffled by the seed, so every seed
offers the same sizes in another order. The aspect and the position are
drawn from the seed; the patch lies inside the plate. The parameters are
drawn on the host (a few numbers per case) and the nodal fields are made
on the device.
"""
from __future__ import annotations

import numpy as np
import torch


def draw(loads: dict, seed: int, lx: float, ly: float) -> list:
    """The parameters of each load case: dicts with ``scale``, ``factor``
    and the patch rectangle ``x0, x1, y0, y1``."""
    rng = np.random.default_rng(int(seed))
    n = int(loads["cases"])
    mids = (np.arange(n) + 0.5) / n

    def strata(key):
        lo, hi = loads[key]
        return lo + (hi - lo) * rng.permutation(mids)

    scale, area, factor = strata("scale"), strata("patch_area"), strata("patch_factor")
    a_lo, a_hi = loads["patch_aspect"]
    aspect = np.exp(rng.uniform(np.log(a_lo), np.log(a_hi), n))
    out = []
    for k in range(n):
        w = min(np.sqrt(area[k] * lx * ly * aspect[k]), lx)
        h = min(area[k] * lx * ly / w, ly)
        x0, y0 = rng.uniform(0.0, lx - w), rng.uniform(0.0, ly - h)
        out.append({"scale": float(scale[k]), "factor": float(factor[k]),
                    "x0": float(x0), "x1": float(x0 + w), "y0": float(y0), "y1": float(y0 + h)})
    return out


class LoadCases:
    """The transverse nodal forces of every case, [cases, N] f64 on the
    device; ``forces(k)`` gives case k as the [N, 6] field the entries
    take."""

    def __init__(self, loads: dict, q: float, plate, seed: int, device):
        self.params = draw(loads, seed, plate.lx, plate.ly)
        xy = torch.as_tensor(plate.coords[:, :2], dtype=torch.float64, device=device)
        x, y = xy[:, 0], xy[:, 1]
        lump = q * plate.dx * plate.dy
        rows = []
        for c in self.params:
            inside = (x >= c["x0"]) & (x <= c["x1"]) & (y >= c["y0"]) & (y <= c["y1"])
            rows.append(lump * (c["scale"] + c["factor"] * inside.to(torch.float64)))
        self.fz = torch.stack(rows)
        self.n = len(rows)

    def forces(self, k: int) -> torch.Tensor:
        f = self.fz.new_zeros((self.fz.shape[1], 6))
        f[:, 2] = self.fz[k % self.n]
        return f
