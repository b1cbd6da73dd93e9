"""Port parity: the pair path's refinement residual of fem_shell_tpu_torch
(ops/exact_stencil.class_pair_flat, ops/class_matvec.build_pair_ecorr,
ops/stencil_resid.stencil_resid_dd) against the JAX package, on the CPU
at 16^2, quad and tri.

Both packages get the same ExactStencil (carried across with
convert.exact_stencil_from_jax). Gates:

- the class-consistent operator: bitwise (the same f32 tables, gathered;
  fl64(t0 + t1) is one rounding in both);
- the E term (one class-stencil pass in f32 on x rounded to f32) against
  a longdouble evaluation of (A_true - A64) x: 1e-5 of max|E x|. It stores
  E of the interior class (2, 2) for every node off the bands. At 16^2
  (a dyadic grid spacing) the redundant interior class 3 equals class 2
  bit for bit; at 12^2 it differs from it by longdouble noise, 1.3e-19 of
  the largest entry, which this gate would see in E x (2.7e-4 of max|E x|)
  and the residual does not (below its oracle's own rounding);
- against the JAX package's E term, ``class_stencil_matvec_f32`` on its
  t2 table: E equals t2 wherever fl64(t0 + t1) is exact, which on these
  grids is every quad entry and all but 48 of 9072 tri entries (where t2
  misses E by up to 2 % of max|t2|); measured 9.6e-8 (quad) and 5.0e-2
  (tri) of max|E x| apart, the tri figure all from those entries (the
  test holds the difference to the longdouble (t2 - E) x at 1e-5);
- the whole pair residual against the JAX package's eager EFT residual
  ``exact_residual_df``: 1e-13 of the term scale (max over rows of
  sum |a x|);
- compensation: for a smooth x and b = fl64(A_true x), the dd residual's
  error against the longdouble oracle is at most 1e-2 of the plain-f64
  residual's error. Measured: dd 2.3e-20 / 2.9e-20 of the term scale
  (quad / tri, about the oracle's own rounding), plain f64 7.4e-17 /
  6.6e-17, ratios 3.1e-4 / 4.3e-4 (the test prints them).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops import exact_stencil as jes
from fem_shell_tpu.ops.df import DF, df_from_f64
from fem_shell_tpu_torch.convert import df_pair_from_jax, exact_stencil_from_jax
from fem_shell_tpu_torch.ops import class_matvec as tcm
from fem_shell_tpu_torch.ops import exact_stencil as tes
from fem_shell_tpu_torch.ops.stencil_resid import (
    stencil_resid_dd,
    stencil_resid_dd_plain,
)
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv_plain

LD = np.longdouble
JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
N = 16


@functools.cache
def _build(et):
    """For one element type: (jmesh, JAX ExactStencil, port ExactStencil,
    offsets, npad, port a64, port hi, port E term)."""
    p = JParams(et, N, N, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    jmesh, _, _ = jgenerate(p)
    jsys = JLarge(jmesh, JMAT)
    npad = jsys.pattern.n_pad
    st = jes.build_exact_stencil(jmesh, JMAT, jsys.offsets)
    pst = exact_stencil_from_jax(st)
    tfl0, tfl1, _, cls = tes.class_flat_tables(pst)
    a64, hi = tes.class_pair_flat(tfl0, tfl1, cls, npad, device="cpu")
    ec = tcm.build_pair_ecorr(pst, device="cpu")
    return jmesh, st, pst, tuple(int(o) for o in jsys.offsets), npad, a64, hi, ec


def _vec(npad, n, rows):
    v = np.zeros((6, npad))
    v[:, :n] = rows
    return torch.from_numpy(v)


def _ld_matvec(pst, table_ld, x64):
    """y = T x in longdouble for a [K, 6, 6, P, P] longdouble class table
    T (split into the f32 triple the oracle takes), x64 [6, n]."""
    t0 = table_ld.astype(np.float32)
    r = table_ld - t0.astype(LD)
    t1 = r.astype(np.float32)
    t2 = (r - t1.astype(LD)).astype(np.float32)
    return tes.exact_matvec_ld(dataclasses.replace(pst, t0=t0, t1=t1, t2=t2), x64)


@pytest.mark.parametrize("et", ["t", "q"])
def test_class_pair_matches_jax_bitwise(et):
    _, st, pst, offsets, npad, a64, hi, _ = _build(et)
    jtabs = jes.class_flat_tables(st)
    for got, ref in zip(tes.class_flat_tables(pst), jtabs):
        np.testing.assert_array_equal(got, ref)
    tfl0, tfl1, _, cls = jtabs
    jhi, jlo = jes.class_pair_flat(jnp.asarray(tfl0), jnp.asarray(tfl1), jnp.asarray(cls), npad)
    k = len(offsets)
    assert a64.dtype == torch.float64 and tuple(a64.shape) == (36, k, npad)
    assert hi.dtype == torch.float32 and tuple(hi.shape) == (36, k, npad)
    want = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
    np.testing.assert_array_equal(a64.numpy(), want.reshape(36, k, npad))
    np.testing.assert_array_equal(df_pair_from_jax(DF(jhi, jlo), device="cpu").numpy(), a64.numpy())
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).reshape(36, k, npad))


def test_df_pair_from_jax_refuses_tile_major():
    z = np.zeros((2, 36 * 7, 8, 128), np.float32)
    with pytest.raises(ValueError, match="tile-major"):
        df_pair_from_jax(DF(z, z), device="cpu")


@pytest.mark.parametrize("et", ["t", "q"])
def test_pair_ecorr_vs_oracle_and_jax(et):
    _, st, pst, _, npad, _, _, ec = _build(et)
    n = pst.nyp * pst.nxp
    rng = np.random.default_rng(5)
    x32 = _vec(npad, n, rng.normal(size=(6, n))).to(torch.float32)
    y = tcm.pair_ecorr(ec, x32).numpy()[:, :n].astype(np.float64)
    a64 = (pst.t0.astype(np.float64) + pst.t1.astype(np.float64)).astype(LD)
    e_ld = pst.t0.astype(LD) + pst.t1.astype(LD) + pst.t2.astype(LD) - a64
    xs = x32.numpy()[:, :n].astype(np.float64)
    ref = _ld_matvec(pst, e_ld, xs).astype(np.float64)
    scale = float(np.abs(ref).max())
    assert float(np.abs(y - ref).max()) <= 1e-5 * scale
    tfl2, cls = jes.class_flat_tables(st)[2:]
    xg = jnp.asarray(x32.numpy()[:, :n].reshape(6, pst.nyp, pst.nxp))
    yj = np.asarray(jes.class_stencil_matvec_f32(jnp.asarray(tfl2), jnp.asarray(cls), st.offs2d,
                                                 xg, pst.nyp, pst.nxp)).reshape(6, n)
    # the JAX t2 term is E itself where fl64(t0 + t1) is exact: the two
    # differ by (t2 - E) x, which is zero off those entries
    d_ld = _ld_matvec(pst, pst.t2.astype(LD) - e_ld, xs).astype(np.float64)
    print(f"{et}: {int((e_ld != pst.t2).sum())} entries E != t2; JAX t2 term - port E term: "
          f"{float(np.abs(yj - y).max()) / scale:.2e} of max|E x|")
    assert float(np.abs((yj - y) - d_ld).max()) <= 1e-5 * scale


@pytest.mark.parametrize("et", ["t", "q"])
def test_pair_residual_matches_jax_exact_residual(et):
    _, st, pst, offsets, npad, a64, _, ec = _build(et)
    n = pst.nyp * pst.nxp
    rng = np.random.default_rng(3)
    xdf = df_from_f64(jnp.asarray(_vec(npad, n, rng.normal(size=(6, n)) * 1e-3).numpy()))
    bdf = df_from_f64(jnp.asarray(_vec(npad, n, rng.normal(size=(6, n))).numpy()))
    r = jes.exact_residual_df(jnp.asarray(st.t0), jnp.asarray(st.t1), jnp.asarray(st.t2),
                              jnp.asarray(st.cy_idx), jnp.asarray(st.cx_idx), xdf, bdf,
                              st.offs2d, st.nyp, st.nxp)
    ref = np.asarray(r.hi, np.float64) + np.asarray(r.lo, np.float64)
    # the exact values of the df inputs
    x = torch.from_numpy(np.asarray(xdf.hi, np.float64) + np.asarray(xdf.lo, np.float64))
    b = torch.from_numpy(np.asarray(bdf.hi, np.float64) + np.asarray(bdf.lo, np.float64))
    got = stencil_resid_dd(a64, x, b, offsets) - tcm.pair_ecorr(ec, x.float()).double()
    term = float(stencil_spmv_plain(a64.abs(), x.abs(), offsets).max())
    assert float((got - torch.from_numpy(ref)).abs().max()) <= 1e-13 * term


@pytest.mark.parametrize("et", ["t", "q"])
def test_compensated_residual_beats_f64(et):
    """A smooth field x (the shape of a plate's deflection, zero on the
    constrained DOFs) and b = fl64(A_true x): the true residual is only
    b's rounding, so every error of the evaluation shows."""
    jmesh, _, pst, offsets, npad, a64, _, ec = _build(et)
    n = pst.nyp * pst.nxp
    iy, ix = np.meshgrid(np.arange(pst.nyp), np.arange(pst.nxp), indexing="ij")
    free = ~np.asarray(jmesh.dirichlet_mask())
    rows = np.stack([(c + 1) * (np.sin(np.pi * ix / (pst.nxp - 1) + 0.3 * c)
                                * np.sin(np.pi * iy / (pst.nyp - 1))).reshape(-1) * free[:, c]
                     for c in range(6)])
    x = _vec(npad, n, rows)
    y_ld = tes.exact_matvec_ld(pst, rows)
    b = _vec(npad, n, y_ld.astype(np.float64))
    r_ld = b.numpy()[:, :n].astype(LD) - y_ld
    ex = tcm.pair_ecorr(ec, x.float()).double()
    r_dd = (stencil_resid_dd(a64, x, b, offsets) - ex).numpy()[:, :n]
    r_64 = (b - stencil_spmv_plain(a64, x, offsets) - ex).numpy()[:, :n]
    err_dd = float(np.abs(r_dd.astype(LD) - r_ld).max())
    err_64 = float(np.abs(r_64.astype(LD) - r_ld).max())
    term = float(stencil_spmv_plain(a64.abs(), x.abs(), offsets).max())
    print(f"{et}: err dd {err_dd / term:.2e}, f64 {err_64 / term:.2e} of the term scale, "
          f"ratio {err_dd / err_64:.2e}")
    assert err_64 > 0 and err_dd <= 1e-2 * err_64


def test_plain_dd_sum_is_exact_on_cancelling_terms():
    """Terms that cancel to far below f64's reach of their size: plain f64
    loses the remainder, the dd residual keeps it."""
    v = torch.zeros((36, 3, 4), dtype=torch.float64)
    v[0, :, :] = torch.tensor([1.0, 1e-20, -1.0], dtype=torch.float64)[:, None]
    x = torch.ones((6, 4), dtype=torch.float64)
    b = torch.zeros((6, 4), dtype=torch.float64)
    r = stencil_resid_dd_plain(v, x, b, (-1, 0, 1))
    assert float(r[0, 1]) == -1e-20
    assert float((b - stencil_spmv_plain(v, x, (-1, 0, 1)))[0, 1]) == 0.0


def test_resid_wrapper_refusals():
    v = torch.zeros((36, 3, 8), dtype=torch.float64)
    x = torch.zeros((6, 8), dtype=torch.float64)
    offs = (-1, 0, 1)
    with pytest.raises(TypeError):
        stencil_resid_dd(v.float(), x.float(), x.float(), offs)
    with pytest.raises(TypeError):
        stencil_resid_dd(v, x, x.float(), offs)
    with pytest.raises(ValueError, match="values must be"):
        stencil_resid_dd(v[:, :2], x, x, offs)
    with pytest.raises(ValueError, match="must be \\[6"):
        stencil_resid_dd(v, x[:, :7], x, offs)
    with pytest.raises(ValueError, match="contiguous"):
        stencil_resid_dd(v, torch.zeros((8, 6), dtype=torch.float64).T, x, offs)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stencil_resid_dd(v.to("meta"), x.to("meta"), x.to("meta"), offs)
    with pytest.raises(ValueError, match=" on "):
        stencil_resid_dd(v, x.to("meta"), x, offs)
    assert stencil_resid_dd.launches == 0  # CPU calls take the plain version
