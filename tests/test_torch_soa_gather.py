"""Port parity: the gather mode of the SoA operator (fem_shell_tpu_torch
ops/soa.py and LargeShellSystem's assembly) against the JAX package's
ops/soa.py and large.py, on the CPU: randomly renumbered 10x10 and 16x16
quad plates (more than 32 offsets) and the Test-E I-beam forced into
gather mode with ``k_max=1``.

- the pattern (``adj_t``, the slot-major slots, K, Npad) equal element for
  element;
- the assembled, BC-eliminated values (chunk 64: several chunks per family)
  within 1e-13 of max|A|, and a second assembly equal bit for bit (the
  pass-by-pass scatter sums every slot in one order);
- ``apply_bc_soa`` on seeded values and masks, ``soa_diagonal``,
  ``soa_self_blocks`` and ``soa_matvec`` on the same operator within
  1e-13; ``gather_resid_dd`` within 2 ulp of the correctly rounded
  residual (math.fsum of the exact product halves).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.data import test_e as JE
from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.mesh import permute_nodes as jpermute
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops import soa as jsoa
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.ops import soa as tsoa

from helpers import mesh_from_tris

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
CASES = ["plate10", "plate16", "ibeam"]


def _jax_mesh(case):
    if case == "ibeam":
        return mesh_from_tris(JE.COORDS, JE.TRIS, JE.BOUNDARY_SIDES), JMaterial(0.25, 10000, 0.25), 1
    n = int(case[5:])
    jmesh, _, _ = jgenerate(JParams("q", n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, True, "z"))
    perm = np.random.default_rng(n).permutation(jmesh.n_nodes)
    return jpermute(jmesh, perm), JMAT, None


_CACHE = {}


def _systems(case):
    """(JAX system, port system, JAX values) once per case and process."""
    if case not in _CACHE:
        jmesh, jmat, k_max = _jax_mesh(case)
        js = JLarge(jmesh, jmat, dtype=jnp.float64, chunk=64, k_max=k_max)
        ts = LargeShellSystem(mesh_from_jax(jmesh), material_from_jax(jmat), chunk=64, k_max=k_max,
                              device="cpu")
        _CACHE[case] = (js, ts, np.asarray(js.assemble()))
    return _CACHE[case]


@pytest.mark.parametrize("case", CASES)
def test_gather_pattern_matches_jax(case):
    js, ts, _ = _systems(case)
    jp, tp = js.pattern, ts.pattern
    assert jp.offsets is None and tp.offsets is None
    assert (jp.n_nodes, jp.n_pad, jp.k) == (tp.n_nodes, tp.n_pad, tp.k)
    np.testing.assert_array_equal(tp.adj_t, jp.adj_t)
    np.testing.assert_array_equal(tp.tri_slot, jp.tri_slot)
    np.testing.assert_array_equal(tp.quad_slot, jp.quad_slot)
    assert torch.equal(ts.adj_t, torch.from_numpy(np.asarray(jp.adj_t, np.int64)))


@pytest.mark.parametrize("case", CASES)
def test_gather_assembly_matches_jax_and_repeats(case):
    js, ts, jv = _systems(case)
    tv = ts.assemble()
    assert tv.dtype == torch.float64 and tuple(tv.shape) == jv.shape
    assert np.abs(tv.numpy() - jv).max() <= 1e-13 * np.abs(jv).max()
    assert torch.equal(ts.assemble(), tv)
    n_chunks = -(-max(len(ts.mesh.tri), len(ts.mesh.quad)) // 64)
    assert len(ts._passes[0]) + len(ts._passes[1]) >= n_chunks > 1


@pytest.mark.parametrize("case", CASES)
def test_gather_bc_diagonal_blocks_matvec_match_jax(case):
    js, ts, jv = _systems(case)
    rng = np.random.default_rng(11)
    k, npad = jv.shape[1], jv.shape[2]
    raw = rng.normal(size=(36, k, npad))
    free = (rng.random((6, npad)) > 0.2).astype(np.float64)
    jadj = js.adj_t
    want = np.asarray(jsoa.apply_bc_soa(jnp.asarray(raw), jnp.asarray(free), adj_t=jadj))
    got = tsoa.apply_bc_soa(torch.from_numpy(raw), torch.from_numpy(free), adj_t=ts.adj_t).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()

    tval = torch.from_numpy(jv.copy())
    jd = np.asarray(jsoa.soa_diagonal(jnp.asarray(jv), adj_t=jadj))
    td = tsoa.soa_diagonal(tval, adj_t=ts.adj_t).numpy()
    assert np.abs(td - jd).max() <= 1e-13 * np.abs(jd).max()
    jb = np.asarray(jsoa.soa_self_blocks(jnp.asarray(jv), adj_t=jadj))
    tb = tsoa.soa_self_blocks(tval, adj_t=ts.adj_t).numpy()
    assert tb.shape == (npad, 6, 6) and np.abs(tb - jb).max() <= 1e-13 * np.abs(jb).max()
    # the flat [36K, Npad] layout reads the same blocks
    assert np.array_equal(tsoa.soa_self_blocks(tval.reshape(36 * k, npad), adj_t=ts.adj_t).numpy(), tb)

    x = rng.normal(size=(6, npad))
    jy = np.asarray(jsoa.soa_matvec(jnp.asarray(jv), jnp.asarray(x), adj_t=jadj))
    ty = tsoa.soa_matvec(tval, torch.from_numpy(x), ts.adj_t).numpy()
    assert np.abs(ty - jy).max() <= 1e-13 * np.abs(jy).max()


def test_gather_resid_dd_is_compensated():
    """b - A x in double-double against the correctly rounded residual
    (every product split exactly by TwoProd, the terms summed by
    math.fsum), with b = A x + a small perturbation (massive
    cancellation): the compensated residual is within 2 ulp of each
    entry, the plain f64 one errs ~eps |A||x|."""
    import math

    from fem_shell_tpu_torch.ops.stencil_resid import _two_prod

    _, ts, jv = _systems("plate10")
    rng = np.random.default_rng(5)
    npad, n = jv.shape[2], ts.pattern.n_nodes
    v = torch.from_numpy(jv.copy())
    x = torch.from_numpy(rng.normal(size=(6, npad)))
    b = tsoa.soa_matvec(v, x, ts.adj_t) + torch.from_numpy(rng.normal(size=(6, npad))) * 1e-6
    got = tsoa.gather_resid_dd(v, x, b, ts.adj_t).numpy()[:, :n]
    plain = (b - tsoa.soa_matvec(v, x, ts.adj_t)).numpy()[:, :n]
    k = jv.shape[1]
    xg = x[:, ts.adj_t]  # [6, K, Npad]
    p, e = _two_prod(v.reshape(6, 6, k, npad), xg[None])  # exact: p + e = a x
    p, e, bn = p.numpy(), e.numpy(), b.numpy()
    ref = np.array([[math.fsum([bn[a, i]] + [-t for t in p[a, :, :, i].ravel()]
                               + [-t for t in e[a, :, :, i].ravel()]) for i in range(n)] for a in range(6)])
    ulp = np.spacing(np.abs(ref))
    assert (np.abs(got - ref) <= 2 * ulp).all()
    assert np.abs(plain - ref).max() > 1e3 * np.abs(got - ref).max()


@pytest.mark.parametrize("case", ["plate16", "ibeam"])
def test_assembly_calls_the_element_kernel_per_chunk_and_no_index_add(monkeypatch, case):
    """LargeShellSystem.assemble() computes every element stiffness through
    the element kernel's wrapper ``elem_stiffness`` (the CUDA kernel on a
    card, its plain version here), one call per family present per chunk,
    and never sums through ``index_add_`` (unordered on CUDA)."""
    _, ts, jv = _systems(case)
    calls = []
    real = tsoa.elem_stiffness

    def counted(xyz, *a):
        calls.append((xyz.shape[0], xyz.shape[2]))
        return real(xyz, *a)

    def refuse(*a, **kw):
        raise AssertionError("index_add_ called")

    monkeypatch.setattr(tsoa, "elem_stiffness", counted)
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    tv = ts.assemble()
    want = [(m, min(64, len(conn) - start)) for m, conn in ((3, ts.mesh.tri), (4, ts.mesh.quad))
            for start in range(0, len(conn), 64)]
    assert calls == want and len(calls) > 1
    assert np.abs(tv.numpy() - jv).max() <= 1e-13 * np.abs(jv).max()
