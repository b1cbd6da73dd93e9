"""Data mapping between non-matching coupling meshes.

Reference counterpart: preCICE nearest-neighbor consistent mapping
(precice_config.xml:44-45). Host-side numpy; interface meshes are small.

A copy of ``fem_shell_tpu/coupling/mapping.py``.
"""
from __future__ import annotations

import numpy as np


def nearest_neighbor_indices(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """For each dst vertex, the index of the nearest src vertex.
    src [Ns,d], dst [Nd,d] -> [Nd] int."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    d2 = ((dst[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1).astype(np.int64)


class NearestNeighborMapping:
    """Consistent NN mapping: dst value = value at nearest src vertex."""

    def __init__(self, src_pos: np.ndarray, dst_pos: np.ndarray):
        self.idx = nearest_neighbor_indices(src_pos, dst_pos)

    def apply(self, src_values: np.ndarray) -> np.ndarray:
        """src_values [Ns, d] -> [Nd, d]."""
        return np.asarray(src_values)[self.idx]
