"""Port parity: SoA stencil pattern, f64 assembly, Dirichlet elimination,
diagonal and the stencil block-SpMV of fem_shell_tpu_torch against the JAX
package (ops/soa.py, large.py, and the Pallas SpMV kernels in interpret
mode), on 8x8 meshes (Npad 4096) with seeded inputs.

Tolerances: assembled values and diagonal 1e-12 of max (f64, scatter-adds
in another order); f64 matvec 1e-13 of max|y|; f32 matvec 1e-6 of max|y|
(as tests/test_pallas_spmv.py); the df Pallas kernel's hi+lo against the
port's f64 product 1e-12 of max|y| (a df pair carries ~2^-48 of each
entry).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops import soa as jsoa
from fem_shell_tpu_torch.convert import material_from_jax, mesh_from_jax
from fem_shell_tpu_torch.large import LargeShellSystem
from fem_shell_tpu_torch.ops import soa as tsoa
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv, stencil_spmv_plain

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
N = 8


def _systems(et):
    p = JParams(et, N, N, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    jmesh, _, _ = jgenerate(p)
    js = JLarge(jmesh, JMAT, dtype=jnp.float64, chunk=64)
    ts = LargeShellSystem(mesh_from_jax(jmesh), material_from_jax(JMAT), chunk=64, device="cpu")
    return js, ts


def _operators(et):
    js, ts = _systems(et)
    return js, ts, np.asarray(js.assemble()), ts.assemble()


def _rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(size=shape) * scale


@pytest.mark.parametrize("et", ["q", "t"])
def test_pattern_matches_jax(et):
    js, ts = _systems(et)
    jp, tp = js.pattern, ts.pattern
    assert (jp.n_nodes, jp.n_pad, jp.k) == (tp.n_nodes, tp.n_pad, tp.k)
    assert tp.n_pad % 4096 == 0
    np.testing.assert_array_equal(jp.offsets, tp.offsets)
    np.testing.assert_array_equal(jp.tri_slot, tp.tri_slot)
    np.testing.assert_array_equal(jp.quad_slot, tp.quad_slot)
    np.testing.assert_array_equal(np.asarray(js.free_t), ts.free_t.numpy())


@pytest.mark.parametrize("et", ["q", "t"])
def test_assembly_and_diagonal_match_jax(et):
    js, ts, jv, tv = _operators(et)
    assert tv.dtype == torch.float64 and tuple(tv.shape) == jv.shape
    scale = np.abs(jv).max()
    assert np.abs(tv.numpy() - jv).max() <= 1e-12 * scale
    jd = np.asarray(jsoa.soa_diagonal(jnp.asarray(jv), offsets=js.offsets))
    td = tsoa.soa_diagonal(tv, ts.offsets).numpy()
    assert np.abs(td - jd).max() <= 1e-12 * np.abs(jd).max()


@pytest.mark.parametrize("et", ["q", "t"])
def test_plain_spmv_f64_matches_soa_matvec(et):
    js, ts, jv, tv = _operators(et)
    x = _rand((6, ts.pattern.n_pad), seed=21)
    ref = np.asarray(jsoa.soa_matvec(jnp.asarray(jv), jnp.asarray(x), offsets=js.offsets))
    offs = tuple(int(o) for o in ts.offsets)
    # the same values on both sides, so only the matvec is compared
    got = stencil_spmv_plain(torch.from_numpy(jv), torch.from_numpy(x), offs).numpy()
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()


@pytest.mark.parametrize("et", ["q", "t"])
def test_plain_spmv_f32_matches_pallas_kernels(et):
    from fem_shell_tpu.ops.pallas_spmv import (
        prepare_tiled_values,
        stencil_spmv_pallas,
        stencil_spmv_pallas_tiled,
    )

    js, ts, jv, _ = _operators(et)
    v32 = jv.astype(np.float32)
    x = _rand((6, ts.pattern.n_pad), seed=22).astype(np.float32)
    offs = tuple(int(o) for o in ts.offsets)
    got = stencil_spmv_plain(torch.from_numpy(v32), torch.from_numpy(x), offs).numpy()
    ref = np.asarray(stencil_spmv_pallas(jnp.asarray(v32), jnp.asarray(x), offs, interpret=True))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-6 * scale
    vt, _ = prepare_tiled_values(jnp.asarray(v32))
    ref_t = np.asarray(stencil_spmv_pallas_tiled(vt, jnp.asarray(x), offs, interpret=True))
    assert np.abs(got - ref_t).max() <= 1e-6 * scale


def test_plain_spmv_f64_matches_pallas_df_kernel():
    """The native-f64 product against the TPU's two-float32 kernel
    (pallas_spmv_df.py _kernel through its flat-layout entry, eager and in
    interpret mode: CPU jit FMA-contracts its error-free transforms, and
    the tile-major entry interprets far slower at the same size)."""
    from fem_shell_tpu.ops.df import df_from_f64
    from fem_shell_tpu.ops.pallas_spmv_df import stencil_spmv_pallas_df_flat

    js, ts, jv, tv = _operators("q")
    k, npad = jv.shape[1], jv.shape[2]
    x = _rand((6, npad), seed=23)
    pair = df_from_f64(jnp.asarray(jv.reshape(36 * k, npad)))
    y = stencil_spmv_pallas_df_flat(pair, df_from_f64(jnp.asarray(x)), js.offsets,
                                    r_tile=32, interpret=True)
    ref = np.asarray(y.hi, np.float64) + np.asarray(y.lo, np.float64)
    got = stencil_spmv_plain(tv, torch.from_numpy(x), tuple(int(o) for o in ts.offsets)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stencil_spmv_takes_plain_version_on_cpu(dtype):
    _, ts, _, tv = _operators("t")
    offs = tuple(int(o) for o in ts.offsets)
    v = tv.to(dtype)
    x = torch.from_numpy(_rand((6, ts.pattern.n_pad), seed=24)).to(dtype)
    before = dict(stencil_spmv.launches)
    y = stencil_spmv(v, x, offs)
    assert torch.equal(y, stencil_spmv_plain(v, x, offs))
    assert stencil_spmv.launches == before  # no kernel launch on the CPU


def test_stencil_spmv_rejects_bad_inputs():
    _, ts, _, tv = _operators("q")
    offs = tuple(int(o) for o in ts.offsets)
    x = torch.zeros((6, ts.pattern.n_pad), dtype=torch.float64)
    with pytest.raises(TypeError):
        stencil_spmv(tv, x.float(), offs)
    with pytest.raises(ValueError):
        stencil_spmv(tv, x[:, :-1], offs)
    with pytest.raises(ValueError):
        stencil_spmv(tv, x, offs[:-1])
    with pytest.raises(ValueError):
        stencil_spmv(tv.transpose(1, 2).contiguous().transpose(1, 2), x, offs)


def test_gather_mode_not_ported():
    """A mesh with more stencil offsets than the stencil mode takes, which
    the port once refused, now takes the gather mode: the pattern equals
    the JAX package's (tests/test_torch_soa_gather.py holds the rest)."""
    from fem_shell_tpu.mesh import ShellMesh as JShellMesh
    from fem_shell_tpu_torch.mesh import ShellMesh, XDA_TRI3

    # a fan of triangles around node 0 couples it to 40 distinct offsets
    n = 41
    coords = np.zeros((n, 3))
    ang = np.linspace(0, 2 * np.pi, n - 1, endpoint=False)
    coords[1:, 0], coords[1:, 1] = np.cos(ang), np.sin(ang)
    conn = np.array([[0, i, i % (n - 1) + 1, -1] for i in range(1, n)])
    mesh = ShellMesh(coords, np.full(n - 1, XDA_TRI3), conn, np.zeros((0, 3)))
    tp = tsoa.build_soa_pattern(mesh)
    jp = jsoa.build_soa_pattern(JShellMesh(coords, np.full(n - 1, XDA_TRI3), conn, np.zeros((0, 3))))
    assert tp.offsets is None and jp.offsets is None and tp.k == jp.k == n
    np.testing.assert_array_equal(tp.adj_t, jp.adj_t)
    np.testing.assert_array_equal(tp.tri_slot, jp.tri_slot)
