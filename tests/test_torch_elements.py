"""Port parity: element stiffness matrices of fem_shell_tpu_torch against
the JAX package's ops/elements.py, on the same seeded element geometries.

Elements are random, rotated and tilted out of the xy-plane, so the local
frames, the Specht plate (with its Y[2,1] quirk) and the DKQ plate are all
exercised away from the axis-aligned cases. Tolerance: 1e-12 of max|Ke|
(both sides are f64; the two frameworks round the products in other
orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.ops import elements as jel
from fem_shell_tpu_torch.ops import elements as tel

MAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q


def _elements(m: int, n: int, seed: int) -> np.ndarray:
    """[n, m, 3] convex planar elements in random 3-D orientations."""
    rng = np.random.default_rng(seed)
    if m == 3:
        base = np.array([[0.0, 0.0], [1.0, 0.0], [0.3, 0.9]])
    else:
        base = np.array([[0.0, 0.0], [1.0, 0.0], [1.1, 0.9], [-0.1, 1.0]])
    out = np.empty((n, m, 3))
    for e in range(n):
        xy = (base + 0.1 * rng.normal(size=base.shape)) * rng.uniform(0.2, 3.0)
        pts = np.hstack([xy, np.zeros((m, 1))]) @ _rotation(rng).T
        out[e] = pts + rng.normal(size=3) * 10.0
    return out


@pytest.mark.parametrize("m", [3, 4], ids=["tri", "quad"])
def test_element_stiffness_matches_jax(m):
    xyz = _elements(m, 24, seed=100 + m)
    dm, dp = MAT.matrices()
    t = MAT.thickness
    jfn = jel.tri_shell_stiffness if m == 3 else jel.quad_shell_stiffness
    ref = np.asarray(
        jax.jit(jax.vmap(lambda p: jfn(p, jnp.asarray(dm), jnp.asarray(dp), t)))(jnp.asarray(xyz))
    )
    tfn = tel.tri_shell_stiffness if m == 3 else tel.quad_shell_stiffness
    got = tfn(
        torch.from_numpy(xyz),
        torch.from_numpy(dm),
        torch.from_numpy(dp),
        t,
    ).numpy()
    assert got.shape == ref.shape == (24, 6 * m, 6 * m)
    for e in range(len(xyz)):
        scale = np.abs(ref[e]).max()
        assert np.abs(got[e] - ref[e]).max() <= 1e-12 * scale, f"element {e}"


def test_batched_kernels_gather_coords():
    """batched_*_stiffness gather node coordinates through the connectivity."""
    xyz = _elements(3, 4, seed=7).reshape(-1, 3)
    conn = np.arange(12).reshape(4, 3)
    dm, dp = (torch.from_numpy(a) for a in MAT.matrices())
    a = tel.batched_tri_stiffness(torch.from_numpy(xyz), torch.from_numpy(conn), dm, dp, 0.5)
    b = tel.tri_shell_stiffness(torch.from_numpy(xyz[conn]), dm, dp, 0.5)
    assert torch.equal(a, b)
