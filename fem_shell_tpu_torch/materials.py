"""Material model: isotropic plane-stress matrices for membrane and plate.

Port of ``fem_shell_tpu/materials.py`` (reference behaviour:
fem-shell.cpp:273-294, initMaterialMatrices).
  D  = [[1, nu, 0], [nu, 1, 0], [0, 0, (1-nu)/2]]
  Dm = E/(1-nu^2) * D                (membrane / plane part)
  Dp = E*t^3/(12*(1-nu^2)) * D       (plate bending part)
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Material:
    """Isotropic linear-elastic shell material (CLI flags -nu, -e, -t)."""

    nu: float  # Poisson's ratio
    em: float  # Young's modulus E
    thickness: float  # shell thickness t

    def matrices(self, dtype=np.float64):
        return material_matrices(self.nu, self.em, self.thickness, dtype=dtype)


def material_matrices(nu: float, em: float, thickness: float, dtype=np.float64):
    """Return (Dm, Dp) as numpy arrays of shape (3, 3)."""
    base = np.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]], dtype=np.float64
    )
    dm = base * (em / (1.0 - nu * nu))
    dp = base * (em * thickness**3 / (12.0 * (1.0 - nu * nu)))
    return dm.astype(dtype), dp.astype(dtype)
