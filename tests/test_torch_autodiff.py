"""Port parity: the differentiable solve (fem_shell_tpu_torch/system.py
``_solve_pcg_impl(..., differentiable=True)``, ``ops/assemble.py``
``coords_gradient``, ``ops/elem_stiffness.py`` ``elem_stiffness_vjp``)
and ``models/shell.py`` against the JAX package, on the CPU.

- load and coordinate gradients of L = <x, w> (w a seeded weight field)
  on tests/test_autodiff.py's 4x4 quad plate against ``jax.grad`` of the
  JAX ``_solve_pcg_impl(..., differentiable=True)``, within 1e-8 of each
  gradient's max (both solve to rtol 1e-12; measured ~1e-14);
- the same gradients of the compliance against central differences of
  the port's own solve at three entries each, rtol 1e-5 (loads) and 1e-4
  (coordinates), as tests/test_autodiff.py;
- ``elem_stiffness_vjp`` against ``jax.vjp`` of the vmapped JAX element
  functions on seeded Tri-3 and Quad-4 elements, among them a square and
  a right isosceles triangle in the xy-plane whose drilling maxima tie,
  within 1e-10 of each family's max|grad|;
- ``coords_gradient``'s nodal sum equal bit for bit to ``np.add.at`` of
  its element rows, on the mixed I-beam (both families);
- ``models/shell.forward_step_fn`` against the JAX one: within 1e-8 in
  f64, and in f32 (the default) within 2e-3 of max|u| (the two f32
  operators round differently: the port's is the cast of the f64 one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.models import shell as jshell
from fem_shell_tpu.ops import elements as jel
from fem_shell_tpu.system import ShellSystem as JSystem
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.data import mixed_ibeam_mesh
from fem_shell_tpu_torch.models import shell as tshell
from fem_shell_tpu_torch.ops.assemble import coords_gradient, corner_table, element_cotangents, sum_by_table
from fem_shell_tpu_torch.ops.elem_stiffness import elem_stiffness_vjp
from fem_shell_tpu_torch.system import ShellSystem

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)


def _plate(n=4):
    jmesh, rows, fac = jgenerate(JParams("q", n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
    return jmesh, rows * fac


def _port(jmesh):
    return ShellSystem(mesh_from_jax(jmesh), material_from_jax(JMAT), device="cpu")


def test_gradients_match_jax_grad():
    jmesh, forces = _plate()
    w = np.random.default_rng(4).normal(size=forces.shape)
    js = JSystem(jmesh, JMAT)

    def loss(coords, f):
        x, _ = js._solve_pcg_impl(coords, f, 1e-12, 5000, "block_jacobi", differentiable=True)
        return jnp.sum(x * w)

    jgc, jgf = (np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1)))(js.coords, jnp.asarray(forces)))
    ts = _port(jmesh)
    coords = ts.coords.clone().requires_grad_(True)
    f = torch.as_tensor(forces).clone().requires_grad_(True)
    x, res = ts._solve_pcg_impl(coords, f, 1e-12, 5000, "block_jacobi", differentiable=True)
    assert res.iters == -1 and res.residual < 1e-11
    (x * torch.as_tensor(w)).sum().backward()
    assert np.abs(coords.grad.numpy() - jgc).max() <= 1e-8 * np.abs(jgc).max()
    assert np.abs(f.grad.numpy() - jgf).max() <= 1e-8 * np.abs(jgf).max()
    assert ts.last_adjoint_cg.residual < 1e-12


def test_gradients_match_central_differences():
    jmesh, forces = _plate()
    ts = _port(jmesh)
    f0 = torch.as_tensor(forces)

    def compliance(coords, f):
        x, _ = ts._solve_pcg_impl(coords, f, 1e-12, 5000)
        return float(torch.sum(x * f0))

    coords = ts.coords.clone().requires_grad_(True)
    f = f0.clone().requires_grad_(True)
    x, _ = ts._solve_pcg_impl(coords, f, 1e-12, 5000, differentiable=True)
    torch.sum(x * f0).backward()
    centre = jmesh.n_nodes // 2
    for probe in ((7, 2), (centre, 2), (centre + 6, 3)):
        eps = 1e-3
        fp, fm = f0.clone(), f0.clone()
        fp[probe] += eps
        fm[probe] -= eps
        fd = (compliance(ts.coords, fp) - compliance(ts.coords, fm)) / (2 * eps)
        np.testing.assert_allclose(float(f.grad[probe]), fd, rtol=1e-5)
    for probe in ((centre + 1, 0), (centre + 5, 1), (centre + 6, 0)):
        eps = 1e-4
        cp, cm = ts.coords.clone(), ts.coords.clone()
        cp[probe] += eps
        cm[probe] -= eps
        fd = (compliance(cp, f0) - compliance(cm, f0)) / (2 * eps)
        np.testing.assert_allclose(float(coords.grad[probe]), fd, rtol=1e-4)


def test_differentiable_flag_and_repeat():
    """solve(differentiable=True) gives _solve_pcg_impl's gradient; two
    backward passes are equal bit for bit; without the flag an input that
    requires grad raises."""
    jmesh, forces = _plate()
    ts = _port(jmesh)
    grads = []
    for _ in range(2):
        coords = ts.coords.clone().requires_grad_(True)
        f = torch.as_tensor(forces).clone().requires_grad_(True)
        x, _ = ts._solve_pcg_impl(coords, f, 1e-12, 5000, differentiable=True)
        torch.sum(x * x).backward()
        grads.append((coords.grad, f.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    f = torch.as_tensor(forces).clone().requires_grad_(True)
    u = ts.solve(f, differentiable=True)
    torch.sum(u * u).backward()
    assert torch.equal(f.grad, grads[0][1]) and ts.last_cg.iters == -1
    with pytest.raises(ValueError, match="differentiable=True"):
        ts._solve_pcg_impl(ts.coords, f, 1e-12, 5000)


def _elements(m, rng):
    """Seeded elements of family m: 5 random ones turned and placed in 3-D,
    and one in the xy-plane whose drilling maxima tie (a unit square, a
    right isosceles triangle). [E, m, 3]."""
    square = [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]
    base = np.array(square if m == 4 else [square[0], square[1], square[3]], float)
    out = [base]
    for _ in range(5):
        el = base + 0.2 * rng.uniform(-1, 1, size=base.shape) * np.array([1, 1, 0.1])
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out.append(el @ q.T * rng.uniform(0.5, 2) + rng.normal(size=3))
    return np.stack(out)


@pytest.mark.parametrize("m", [3, 4], ids=["tri", "quad"])
def test_elem_stiffness_vjp_matches_jax_vjp(m):
    rng = np.random.default_rng(m)
    xyz = _elements(m, rng)
    g = rng.normal(size=(len(xyz), 6 * m, 6 * m))
    dm, dp = JMAT.matrices()
    fn = jel.tri_shell_stiffness if m == 3 else jel.quad_shell_stiffness
    batch = jax.vmap(lambda e: fn(e, jnp.asarray(dm), jnp.asarray(dp), 0.5))
    want = jax.jit(lambda x, ct: jax.vjp(batch, x)[1](ct)[0])(jnp.asarray(xyz), jnp.asarray(g))
    got = elem_stiffness_vjp(torch.as_tensor(xyz).permute(1, 2, 0).contiguous(), torch.as_tensor(dm),
                             torch.as_tensor(dp), 0.5, torch.as_tensor(g).permute(1, 2, 0).contiguous())
    want = np.asarray(want).transpose(1, 2, 0)
    assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()


def test_coords_gradient_sums_in_add_at_order():
    mesh = mixed_ibeam_mesh()
    ts = ShellSystem(mesh, material_from_jax(JMAT), device="cpu")
    rng = np.random.default_rng(5)
    lam, x = (torch.as_tensor(rng.normal(size=(mesh.n_nodes, 6))) for _ in range(2))
    flat = np.concatenate([mesh.tri.ravel(), mesh.quad.ravel()])
    table = torch.as_tensor(corner_table(flat, mesh.n_nodes))
    got = coords_gradient(ts.coords, ts.tri_conn, ts.quad_conn, ts.dm, ts.dp, ts.thickness, lam, x, table,
                          chunk=7)
    rows = []
    for conn in (ts.tri_conn, ts.quad_conn):
        xyz = ts.coords[conn].permute(1, 2, 0).contiguous()
        rows.append(elem_stiffness_vjp(xyz, ts.dm, ts.dp, ts.thickness, element_cotangents(lam, x, conn))
                    .permute(2, 0, 1).reshape(-1, 3).numpy())
    want = np.zeros((mesh.n_nodes, 3))
    np.add.at(want, flat, np.concatenate(rows))
    assert len(mesh.tri) and len(mesh.quad)
    assert np.array_equal(got.numpy(), want)
    vals = torch.as_tensor(rng.normal(size=(len(flat) + 1, 2)))
    vals[-1] = 0.0
    ref = np.zeros((mesh.n_nodes, 2))
    np.add.at(ref, flat, vals[:-1].numpy())
    assert np.array_equal(sum_by_table(vals, table).numpy(), ref)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_forward_step_fn_matches_jax(dtype):
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    rtol = 1e-12 if dtype == "f64" else 1e-6
    jsys, forces = jshell.make_plate_system(8, dtype=jdt)
    want = np.asarray(jax.jit(jshell.forward_step_fn(jsys, rtol=rtol, maxiter=5000))(jsys.coords,
                                                                                    jnp.asarray(forces, jdt)))
    tsys, tforces = tshell.make_plate_system(8, dtype=tdt, device="cpu")
    assert np.array_equal(tforces, forces) and tsys.dtype == tdt
    got = tshell.forward_step_fn(tsys, rtol=rtol, maxiter=5000)(tsys.coords, torch.as_tensor(tforces))
    assert got.dtype == tdt
    gate = 1e-8 if dtype == "f64" else 2e-3
    assert np.abs(got.numpy() - want).max() <= gate * np.abs(want).max()
