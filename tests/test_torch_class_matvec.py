"""Port parity: the matrix-free class-table operator (ops/class_matvec.py,
ops/class_stencil.py) of fem_shell_tpu_torch against the JAX package's
ops/class_matvec.py and ops/pallas_class.py, on the CPU with seeded
inputs.

Both packages get the same ExactStencil (carried across with
convert.exact_stencil_from_jax), so the parity of the class operator
stands apart from the longdouble table build. Tolerances:

- the ClassParts tables: bitwise (same longdouble arithmetic);
- the f64 matvec plus the E term against the longdouble oracle: 1e-12 of
  max|y| (f64 accumulation over ~K*6 terms of a stiffness row, which
  cancel by ~1e3);
- the f64 matvec against the JAX df matvec, eager and Pallas-interpret:
  1e-13 of max|y| (df is ~eps49; jitted df on the CPU is FMA-degraded, so
  the JAX side runs eagerly);
- f32 against the JAX f32 matvec and its padded-layout smoother in
  interpret mode: the bounds of tests/test_class_matvec.py:176-230 (3e-6
  of max|y| for the matvec, the class decomposition's cancellation noise
  per free DOF for the smoother).

The JAX reference calls (eager df, interpret-mode Pallas) cost seconds
each here, so each runs once, on a 12^2 plate.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops import class_matvec as jcm
from fem_shell_tpu.ops import pallas_class as jpc
from fem_shell_tpu.ops.df import DF
from fem_shell_tpu.ops.exact_stencil import build_exact_stencil, exact_matvec_f64
from fem_shell_tpu_torch.convert import (
    class_parts_from_jax,
    exact_stencil_from_jax,
)
from fem_shell_tpu_torch.ops import class_matvec as tcm
from fem_shell_tpu_torch.ops.class_stencil import (
    ALL_TERMS,
    FLAT_PATTERN,
    ClassTable,
    class_stencil,
    class_stencil_plain,
    pack_launch,
)

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
CASES = [("t", 12), ("q", 12), ("t", 17)]


@functools.cache
def _build(case):
    """(jmesh, ExactStencil, JAX ClassParts, JAX diag, port ClassParts,
    port diag, npad) for one (element type, n) case."""
    et, n = case
    p = JParams(et, n, n, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    jmesh, _, _ = jgenerate(p)
    jsys = JLarge(jmesh, JMAT)
    npad = jsys.pattern.n_pad
    st = build_exact_stencil(jmesh, JMAT, jsys.offsets)
    cpj, dj = jcm.build_class_parts(st, npad)
    cpt, dt = tcm.build_class_parts(exact_stencil_from_jax(st), npad, device="cpu")
    return jmesh, st, cpj, np.asarray(dj), cpt, dt, npad


def _x(st, npad, seed):
    """Seeded x as an f64 vector [6, npad] with zero padding, and its df
    split (x = hi + lo exactly)."""
    rng = np.random.default_rng(seed)
    n = st.nyp * st.nxp
    x64 = np.zeros((6, npad))
    x64[:, :n] = rng.standard_normal((6, n))
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return x64, DF(jnp.asarray(hi), jnp.asarray(lo))


@pytest.mark.parametrize("case", CASES)
def test_class_parts_match_jax(case):
    _, _, cpj, dj, cpt, dt, npad = _build(case)
    np.testing.assert_array_equal(dt.numpy(), dj)
    assert dt.dtype == torch.float32 and tuple(dt.shape) == (6, npad)
    # the JAX package's nzmask: (a, b, s) with a nonzero interior scalar
    nz = (cpt.hi.interior != 0) | (cpt.a64.interior != 0) | (cpt.e.interior != 0)
    assert tuple(sorted((int(a), int(b), int(s)) for s, a, b in zip(*np.nonzero(nz.numpy())))) \
        == tuple(cpj.nzmask)
    assert cpt.offs2d == tuple(cpj.offs2d) and (cpt.nyp, cpt.nxp, cpt.npad) == (cpj.nyp, cpj.nxp, cpj.npad)
    nyp, nxp = cpt.nyp, cpt.nxp
    lo = (0, nxp, 2 * nxp, 2 * nxp + nyp, 2 * (nxp + nyp))  # top, bottom, left, right
    jbands = (("bt_h", "bt_l", "bt_e"), ("bb_h", "bb_l", "bb_e"),
              ("bl_h", "bl_l", "bl_e"), ("br_h", "br_l", "br_e"))
    np.testing.assert_array_equal(cpt.hi.interior.numpy(), np.asarray(cpj.ih))
    np.testing.assert_array_equal(cpt.e.interior.numpy(), np.asarray(cpj.i2))
    np.testing.assert_array_equal(
        cpt.a64.interior.numpy(), np.asarray(cpj.ih, np.float64) + np.asarray(cpj.il, np.float64))
    for i, (h, l, e) in enumerate(jbands):
        jh, jl, je = (np.asarray(getattr(cpj, f)) for f in (h, l, e))
        band = {name: getattr(cpt, name).bands.numpy()[..., lo[i] : lo[i + 1]]
                for name in ("hi", "e", "a64")}
        np.testing.assert_array_equal(band["hi"], jh)
        np.testing.assert_array_equal(band["e"], je)
        np.testing.assert_array_equal(band["a64"], jh.astype(np.float64) + jl.astype(np.float64))
    # the kernel's skip masks cover every nonzero the plain version sums
    k = len(cpt.offs2d)
    bits = np.array([[[(int(cpt.masks[s]) >> (a * 6 + b)) & 1 for b in range(6)]
                      for a in range(6)] for s in range(k)], bool)
    for tab in (cpt.hi, cpt.a64, cpt.e):
        assert not np.any((tab.interior.numpy() != 0) & ~bits)
        assert not np.any((tab.bands.numpy() != 0).any(axis=(3, 4)) & ~bits)
    # flat shells decouple membrane / plate / drilling: the mask skips most terms
    assert bits.sum() < 0.5 * bits.size


@pytest.mark.parametrize("case", CASES)
def test_f64_matvec_and_ecorr_vs_ld_oracle(case):
    _, st, _, _, cpt, _, npad = _build(case)
    n = st.nyp * st.nxp
    x64, _ = _x(st, npad, seed=1)
    xt = torch.from_numpy(x64)
    y = tcm.class_matvec_f64(cpt, xt)
    e = tcm.class_ecorr(cpt, xt.to(torch.float32))
    assert y.dtype == torch.float64 and e.dtype == torch.float32
    tot = (y + e.to(torch.float64)).numpy()[:, :n]
    ref = np.asarray(exact_matvec_f64(st, x64[:, :n]), np.float64)
    assert np.abs(tot - ref).max() <= 1e-12 * np.abs(ref).max()
    # the padding stays exactly zero (CG dot products include it)
    assert not y[:, n:].any() and not e[:, n:].any()


@pytest.mark.parametrize("kw", [{"use_pallas": False}, {"use_pallas": True, "interpret": True}],
                         ids=["eager", "interpret"])
def test_f64_matvec_vs_jax_df(kw):
    """A_df = fl64(t0 + t1) in f64 against the JAX df class matvec, eager
    XLA and the Pallas interior kernel in interpret mode (tri 12^2: each
    interpret-mode call costs seconds here)."""
    _, st, cpj, _, cpt, _, npad = _build(("t", 12))
    _, xdf = _x(st, npad, seed=2)
    got = tcm.class_matvec_f64(cpt, torch.from_numpy(np.asarray(xdf.hi, np.float64)
                                                      + np.asarray(xdf.lo, np.float64))).numpy()
    y = jcm.class_matvec_df(cpj, xdf, **kw)
    ref = np.asarray(y.hi, np.float64) + np.asarray(y.lo, np.float64)
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    # the JAX package's parts carried across give the same operator, bit for bit
    carried = class_parts_from_jax(cpj, device="cpu")
    x = torch.from_numpy(np.asarray(xdf.hi, np.float64) + np.asarray(xdf.lo, np.float64))
    np.testing.assert_array_equal(tcm.class_matvec_f64(carried, x).numpy(), got)


def test_f32_matvec_and_fused_smoother_vs_jax():
    """The f32 operator against the JAX package's eager class_matvec_f32,
    and the fused w * (b - A x) form against one damped-Jacobi sweep of
    its padded-layout smoother class_smooth_f32_pad (which runs the
    class_matvec_f32_pad kernel) in interpret mode, on the quad 12^2
    plate."""
    jmesh, st, cpj, dj, cpt, _, npad = _build(("q", 12))
    n = st.nyp * st.nxp
    x64, _ = _x(st, npad, seed=3)
    xf = x64.astype(np.float32)
    ref = np.asarray(jcm.class_matvec_f32(cpj, jnp.asarray(xf), use_pallas=False))
    got = tcm.class_matvec_f32(cpt, torch.from_numpy(xf)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=3e-6 * np.abs(ref).max())
    assert not got[:, n:].any()

    # one sweep x + w * (b - A x), omega 0.7, from a seeded x
    pg = jpc._PadGridSpec(st.nyp, st.nxp)
    inv_diag = np.where(dj != 0, 1.0 / np.where(dj != 0, dj, 1), 1.0).astype(np.float32)
    wd = (np.float32(0.7) * inv_diag).astype(np.float32)
    bf = _x(st, npad, seed=7)[0].astype(np.float32)
    b2 = jpc.to_pad_grid(pg, jnp.asarray(bf))
    wd_c = jpc.pad_core(pg, jpc.to_pad_grid(pg, jnp.asarray(inv_diag))) * np.float32(0.7)
    x2s = jpc.class_smooth_f32_pad(cpj, pg, jpc.to_pad_grid(pg, jnp.asarray(xf)),
                                   jpc.pad_core(pg, b2), wd_c, 1, interpret=True)
    ref = np.asarray(jpc.from_pad_grid(pg, x2s, npad))
    xt = torch.from_numpy(xf)
    got = (xt + tcm.class_matvec_f32(cpt, xt, w=torch.from_numpy(wd), b=torch.from_numpy(bf))).numpy()
    # free DOFs, per component, against the decomposition's cancellation
    # noise (~eps32 |c_int| |x| before the w scaling; constrained DOFs are
    # a decoupled identity subsystem)
    free = (~jmesh.dirichlet_mask()).T
    noise = 128.0 * np.finfo(np.float32).eps * float(np.abs(np.asarray(cpj.ih)).max()) \
        * float(np.abs(ref).max())
    for c in range(6):
        wd_free = float((wd[c, :n] * free[c]).max())
        dc = np.abs(got[c, :n] - ref[c, :n]) * free[c]
        assert dc.max() <= max(noise * wd_free, 1e-12), (c, dc.max(), noise * wd_free)


@pytest.mark.parametrize("case", [("t", 12), ("q", 12)])
def test_fused_form_and_ecorr_vs_jax(case):
    """w * (b - A x) equals its unfused form on the plain path, the padding
    of the fused form is w * b, and the E term (interior t2 plus the band
    e-deltas: E alone is not the t2 table, only A_df + E is the true
    operator) matches the JAX package's eager class_ecorr_f32 to f32
    accumulation noise, 1e-6 of max."""
    _, st, cpj, _, cpt, _, npad = _build(case)
    n = st.nyp * st.nxp
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_x(st, npad, seed=5)[0].astype(np.float32))
    w = torch.from_numpy(rng.random((6, npad)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((6, npad)).astype(np.float32))
    fused = tcm.class_matvec_f32(cpt, x, w=w, b=b)
    torch.testing.assert_close(fused, w * (b - tcm.class_matvec_f32(cpt, x)), rtol=0, atol=0)
    torch.testing.assert_close(fused[:, n:], w[:, n:] * b[:, n:], rtol=0, atol=0)

    ref = np.asarray(jcm.class_ecorr_f32(cpj, jnp.asarray(x.numpy()), use_pallas=False), np.float64)
    got = tcm.class_ecorr(cpt, x).numpy().astype(np.float64)
    assert np.abs(got - ref).max() <= 1e-6 * max(np.abs(ref).max(), 1e-30)


def test_wrapper_checks_and_cpu_route():
    _, st, _, _, cpt, _, npad = _build(("q", 12))
    x = torch.zeros((6, npad), dtype=torch.float64)
    y = class_stencil(cpt.a64, x)
    torch.testing.assert_close(y, class_stencil_plain(cpt.a64, x))
    with pytest.raises(TypeError):
        class_stencil(cpt.hi, x)  # f32 table, f64 x
    with pytest.raises(ValueError, match="both"):
        class_stencil(cpt.a64, x, w=x)
    with pytest.raises(ValueError, match="Npad"):
        class_stencil(cpt.a64, x[:, : cpt.nyp * cpt.nxp - 1].contiguous())


@pytest.mark.parametrize("case", CASES)
def test_packed_launch_arguments(case):
    """Each table's launch arguments, packed once: the interior
    coefficients by stencil slot (dy + 1) * 3 + (dx + 1) in the table's
    type (f64 for the CG operator, f32 for t0 and E), zeros in the slots
    the stencil lacks, the slot-to-offset map, the masks and offsets of
    the parts, and the flat-shell instance of the stencil's shape (tri
    ul_lr=False: 2; quad, all nine slots: 0), the all-36 instance on
    request. The pair path's E table likewise. The CPU route is the plain
    version, bit for bit, fused form included."""
    _, st, _, _, cpt, _, npad = _build(case)
    ec = tcm.build_pair_ecorr(st, device="cpu")
    slots = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    shape = 0 if case[0] == "q" else 2
    for tab, dt in ((cpt.hi, np.float32), (cpt.a64, np.float64), (cpt.e, np.float32),
                    (ec.table, np.float32)):
        lp = tab.launch
        assert lp.coef.dtype == dt and lp.coef.shape == (9, 36) and lp.s_of.dtype == np.int32
        assert (lp.coef_ptr, lp.s_of_ptr) == (lp.coef.ctypes.data, lp.s_of.ctypes.data)
        assert tab.offs2d == cpt.offs2d and tab.interior.dtype == torch.from_numpy(lp.coef).dtype
        for q, o in enumerate(slots):
            if o in tab.offs2d:
                s = tab.offs2d.index(o)
                assert lp.s_of[q] == s
                np.testing.assert_array_equal(lp.coef[q], tab.interior[s].numpy().reshape(36))
            else:
                assert lp.s_of[q] == -1 and not lp.coef[q].any()
        assert lp.instance == shape  # flat pattern: every mask inside it
        assert all(int(m) & ~FLAT_PATTERN == 0 for m in tab.masks)
    np.testing.assert_array_equal(cpt.hi.masks, cpt.masks)
    np.testing.assert_array_equal(ec.table.masks, ec.masks)
    assert pack_launch(cpt.hi.interior.numpy(), cpt.offs2d, cpt.masks, all_terms=True).instance \
        == ALL_TERMS
    with pytest.raises(ValueError, match="order"):
        pack_launch(cpt.hi.interior.numpy(), cpt.offs2d[::-1], cpt.masks)

    rng = np.random.default_rng(8)
    for tab in (cpt.hi, cpt.a64):
        dt = tab.interior.dtype
        x, w, b = (torch.from_numpy(rng.standard_normal((6, npad))).to(dt) for _ in range(3))
        assert torch.equal(class_stencil(tab, x), class_stencil_plain(tab, x))
        assert torch.equal(class_stencil(tab, x, w=w, b=b), class_stencil_plain(tab, x, w=w, b=b))


def test_masks_must_cover_the_table():
    """A table whose masks leave out one of its nonzeros is refused when it
    is built (the flat instance would drop it)."""
    _, st, _, _, cpt, _, _ = _build(("t", 12))
    nyp, nxp = cpt.nyp, cpt.nxp
    bands = cpt.hi.bands.numpy()
    parts = (bands[..., :nxp], bands[..., nxp : 2 * nxp], bands[..., 2 * nxp : 2 * nxp + nyp],
             bands[..., 2 * nxp + nyp :])
    interior = cpt.hi.interior.numpy().copy()
    ClassTable.from_numpy(interior, *parts, offs2d=cpt.offs2d, masks=cpt.masks, device="cpu")
    interior[0, 0, 2] = 1.0  # membrane row, plate column: outside every mask
    with pytest.raises(ValueError, match="masks"):
        ClassTable.from_numpy(interior, *parts, offs2d=cpt.offs2d, masks=cpt.masks, device="cpu")
