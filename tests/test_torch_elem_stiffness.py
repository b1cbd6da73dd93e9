"""Port parity: the batch-last element stiffness of fem_shell_tpu_torch
(``ops/elem_stiffness.py``, the plain version of ``csrc/elem_stiffness.cu``)
against the JAX package, on the same seeded elements.

The JAX package's TPU kernel (``ops/pallas_elem.py``) re-executes the
single-element stiffness in two-float32 arithmetic; on the CPU its own
tests hold it through ``df_function_bl`` evaluated eagerly (bit-equal to
the kernel body, tests/test_pallas_elem.py), and the interpret-mode
``pallas_call`` is marked slow there. So the port's plain version is held
against ``df_function_bl(kernel_fn)`` (hi + lo) and against the vmapped
f64 ``tri_shell_stiffness`` / ``quad_shell_stiffness``, on 8 elements per
family: 4 flat in the xy-plane and 4 tilted in 3-D (the quads also
warped out of their plane), with input coordinates that are exact
two-float32 pairs. The f64 comparison also takes four harder Quad-4
shapes (a 1:20 rectangle, a trapezoid, a quad turned into 3-D, a warped
quad far from the origin), four elements each: the card's gates hold the
kernel against this plain version. Tolerance: 1e-12 of each element's
max|ke| (f64 in another order of operations, and the df pair's ~2^-48
arithmetic). Each JAX call runs in the one test that compares with it
(the df interpretation takes 8.7-10.1 s eagerly); the hard shapes' f64
call runs once in a test process, on first use.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.ops import elements as jel
from fem_shell_tpu.ops.df import DF
from fem_shell_tpu.ops.dfk import df_function_bl
from fem_shell_tpu_torch.ops import _build
from fem_shell_tpu_torch.ops import elem_stiffness as tes

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)
GATE = 1e-12


def _elements(m: int, seed: int) -> np.ndarray:
    """[m, 3, 8] batch-last coordinates, exact two-float32 pairs: 4 flat
    elements in the xy-plane, 4 tilted in 3-D (quads warped)."""
    rng = np.random.default_rng(seed)
    if m == 3:
        base = np.array([[0.0, 0.0], [1.0, 0.0], [0.3, 0.9]])
    else:
        base = np.array([[0.0, 0.0], [1.0, 0.0], [1.1, 0.9], [-0.1, 1.0]])
    out = np.empty((8, m, 3))
    for e in range(8):
        xy = (base + 0.1 * rng.normal(size=base.shape)) * rng.uniform(0.2, 3.0)
        pts = np.hstack([xy, np.zeros((m, 1))])
        if e >= 4:
            if m == 4:
                pts[:, 2] = 0.05 * rng.normal(size=m)
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            pts = pts @ q.T + rng.normal(size=3) * 10.0
        out[e] = pts
    xyz = np.ascontiguousarray(out.transpose(1, 2, 0))
    hi = xyz.astype(np.float32)
    lo = (xyz - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _kernel_fn(m):
    dm, dp = (jnp.asarray(a, jnp.float64) for a in JMAT.matrices())
    base = jel.tri_shell_stiffness if m == 3 else jel.quad_shell_stiffness
    return lambda p: base(p, dm, dp, JMAT.thickness)


def _hard_quads(seed: int = 57):
    """{shape: [4, 3, 4] batch-last coordinates}: four elements each of
    Quad-4 shapes where index or frame work goes wrong first: a 1:20
    rectangle, a trapezoid, a flat quad turned into 3-D, and a warped quad
    ~150 from the origin (50-500 element sizes)."""
    rng = np.random.default_rng(seed)
    base = {
        "rect-1:20": np.array([[0.0, 0.0], [20.0, 0.0], [20.0, 1.0], [0.0, 1.0]]),
        "trapezoid": np.array([[0.0, 0.0], [2.0, 0.0], [1.5, 1.0], [0.5, 1.0]]),
        "rotated-3d": np.array([[0.0, 0.0], [1.0, 0.0], [1.1, 0.9], [-0.1, 1.0]]),
        "warped-far": np.array([[0.0, 0.0], [1.0, 0.0], [1.1, 0.9], [-0.1, 1.0]]),
    }
    out = {}
    for name, xy in base.items():
        els = np.empty((4, 4, 3))
        for e in range(4):
            a = rng.uniform(0, 2 * np.pi)
            rot2 = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
            pts = np.hstack([(xy @ rot2.T) * rng.uniform(0.3, 3.0), np.zeros((4, 1))])
            if name in ("rotated-3d", "warped-far"):
                if name == "warped-far":
                    pts[:, 2] = 0.05 * np.array([1.0, -1.0, 1.0, -1.0]) * rng.uniform(0.5, 1.5)
                q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
                pts = pts @ q.T
            if name == "warped-far":
                pts = pts + np.array([120.0, -80.0, 50.0])
            els[e] = pts
        out[name] = np.ascontiguousarray(els.transpose(1, 2, 0))
    return out


HARD_QUADS = ("rect-1:20", "trapezoid", "rotated-3d", "warped-far")


def _family(m):
    """The 8 elements of one family: their coordinates (exact two-float32
    pairs, and the f64 sum of each) and the port's plain stiffness; the
    stiffnesses [6m, 6m, 8]."""
    dm, dp = (torch.from_numpy(a) for a in JMAT.matrices())
    hi, lo = _elements(m, seed=50 + m)
    xyz = hi.astype(np.float64) + lo.astype(np.float64)  # exact
    port = tes.elem_stiffness(torch.from_numpy(xyz), dm, dp, JMAT.thickness).numpy()
    return {"hi": hi, "lo": lo, "xyz": xyz, "port": port, "dm": dm, "dp": dp}


def _jax_f64(m, xyz):
    """The JAX package's vmapped f64 stiffness of batch-last coordinates."""
    return np.moveaxis(np.asarray(jax.jit(jax.vmap(_kernel_fn(m)))(jnp.asarray(np.moveaxis(xyz, 2, 0)))), 0, 2)


@functools.cache
def _hard():
    """Per harder Quad-4 shape: its coordinates, JAX f64 and port
    stiffness; one vmapped f64 call for all of them."""
    dm, dp = (torch.from_numpy(a) for a in JMAT.matrices())
    hard = _hard_quads()
    xyz = np.concatenate([hard[k] for k in HARD_QUADS], axis=2)
    f64 = _jax_f64(4, xyz)
    port = tes.elem_stiffness(torch.from_numpy(xyz), dm, dp, JMAT.thickness).numpy()
    out = {}
    for i, k in enumerate(HARD_QUADS):
        sl = slice(4 * i, 4 * i + 4)
        out[k] = {"xyz": hard[k], "f64": f64[:, :, sl], "port": port[:, :, sl]}
    return out


def _per_element_err(got, ref):
    scale = np.abs(ref).max(axis=(0, 1))
    return (np.abs(got - ref).max(axis=(0, 1)) / scale).max()


@pytest.mark.parametrize("m", [3, 4], ids=["tri", "quad"])
def test_plain_matches_jax_df_interpretation(m):
    """The port against the JAX TPU kernel's arithmetic (df_function_bl,
    which the Pallas kernel reproduces bit for bit)."""
    c = _family(m)
    (ke_df,) = df_function_bl(_kernel_fn(m))(DF(jnp.asarray(c["hi"]), jnp.asarray(c["lo"])))
    df = np.asarray(ke_df.hi, np.float64) + np.asarray(ke_df.lo, np.float64)
    assert c["port"].shape == df.shape == (6 * m, 6 * m, 8)
    assert _per_element_err(c["port"], df) <= GATE


@pytest.mark.parametrize("m", [3, 4, *HARD_QUADS], ids=["tri", "quad", *(f"quad-{k}" for k in HARD_QUADS)])
def test_plain_matches_jax_f64_elements(m):
    if m in (3, 4):
        c = _family(m)
        f64 = _jax_f64(m, c["xyz"])
    else:
        c = _hard()[m]
        f64 = c["f64"]
    assert c["port"].shape == f64.shape
    assert _per_element_err(c["port"], f64) <= GATE


def test_kernel_source_keeps_launches_repeatable():
    """Two launches of the element kernel give the same bits: no atomic
    update in csrc/elem_stiffness.cu (each entry is summed by one thread in
    a fixed order), and no -use_fast_math among the build flags (sqrt and
    division stay IEEE)."""
    src = (_build.SRC_DIR / "elem_stiffness.cu").read_text()
    assert not re.search(r"\batomic[A-Z]\w*\s*\(", src)
    assert not any("fast_math" in f or "fast-math" in f for f in _build.NVCC_FLAGS)


@pytest.mark.parametrize("m", [3, 4], ids=["tri", "quad"])
def test_cpu_takes_the_plain_version_uncounted(m):
    """On the CPU the wrapper returns the plain version, batch-last and
    contiguous, and counts no launch."""
    c = _family(m)
    before = dict(tes.elem_stiffness.launches)
    xyz = torch.from_numpy(c["xyz"])
    ke = tes.elem_stiffness(xyz, c["dm"], c["dp"], JMAT.thickness)
    assert ke.is_contiguous() and ke.dtype == torch.float64
    assert torch.equal(ke, tes.elem_stiffness_plain(xyz, c["dm"], c["dp"], JMAT.thickness))
    assert tes.elem_stiffness.launches == before


def test_wrapper_refuses_bad_inputs():
    c = _family(3)
    xyz, dm, dp = torch.from_numpy(c["xyz"]), c["dm"], c["dp"]
    t = JMAT.thickness
    with pytest.raises(TypeError, match="float64"):
        tes.elem_stiffness(xyz.float(), dm, dp, t)
    with pytest.raises(TypeError, match="float64"):
        tes.elem_stiffness(xyz, dm.float(), dp, t)
    with pytest.raises(ValueError, match=r"\[m, 3, E\]"):
        tes.elem_stiffness(torch.zeros((5, 3, 8), dtype=torch.float64), dm, dp, t)
    with pytest.raises(ValueError, match=r"\[m, 3, E\]"):
        tes.elem_stiffness(xyz.permute(2, 1, 0).contiguous(), dm, dp, t)
    with pytest.raises(ValueError, match=r"\[m, 3, E\]"):
        tes.elem_stiffness(torch.zeros((3, 3, 0), dtype=torch.float64), dm, dp, t)
    with pytest.raises(ValueError, match=r"\[3, 3\]"):
        tes.elem_stiffness(xyz, dm[:2], dp, t)
    with pytest.raises(ValueError, match="contiguous"):
        tes.elem_stiffness(torch.from_numpy(c["xyz"][:, :, ::2]), dm, dp, t)
    with pytest.raises(ValueError, match="cpu or cuda"):
        meta = [a.to("meta") for a in (xyz, dm, dp)]
        tes.elem_stiffness(*meta, t)
