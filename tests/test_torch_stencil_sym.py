"""Port parity: the symmetric-storage stencil SpMV of fem_shell_tpu_torch
(ops/stencil_spmv_sym.py) against the JAX package, on the CPU at 16^2,
quad (K=9) and tri (K=7).

The reference is the JAX package's XLA df matvec ``df_stencil_matvec``
over an ``assemble_df`` pair, run eagerly (tests/test_pallas_spmv.py:224
holds the Pallas sym kernel to it; that kernel's interpret mode costs ~90 s
a call here, so it is not called). The pair reaches the port as f64
through ``convert.df_pair_from_jax`` and x as the exact value of a df pair
from a seed. Gate: 1e-13 of max|y| (df accumulation is ~eps49; the sym
form sums the transposed terms in another order).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_shell_tpu.large import LargeShellSystem as JLarge
from fem_shell_tpu.materials import Material as JMaterial
from fem_shell_tpu.meshgen import MeshGenParams as JParams, generate as jgenerate
from fem_shell_tpu.ops.df import DF, df_stencil_matvec
from fem_shell_tpu_torch.convert import df_pair_from_jax
from fem_shell_tpu_torch.ops.stencil_spmv import stencil_spmv_plain
from fem_shell_tpu_torch.ops.stencil_spmv_sym import (
    prepare_sym_values,
    stencil_spmv_sym,
    stencil_spmv_sym_plain,
    upper_offsets,
)

JMAT = JMaterial(nu=0.3, em=1e7, thickness=0.5)


@functools.cache
def _pair(et):
    """For one element type: (JAX df pair, offsets, npad, seeded df x)."""
    p = JParams(et, 16, 16, 0, 0, 10, 10, (0, 0, 0, 0), 300.0, 2, et == "q", "z")
    jmesh, _, _ = jgenerate(p)
    s = JLarge(jmesh, JMAT, dtype=jnp.float64, chunk=64)
    pair = s.assemble_df(strip_nodes=512, chunk=64)
    npad = s.pattern.n_pad
    rng = np.random.default_rng(11)
    x = DF(jnp.asarray(rng.normal(size=(6, npad)), jnp.float32),
           jnp.asarray(rng.normal(size=(6, npad)) * 1e-8, jnp.float32))
    return pair, tuple(int(o) for o in s.offsets), npad, x


def _x64(x):
    return torch.from_numpy(np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64))


@pytest.mark.parametrize("et,k", [("q", 9), ("t", 7)])
def test_prepare_sym_values_keeps_upper_slots(et, k):
    pair, offsets, npad, _ = _pair(et)
    v = df_pair_from_jax(pair, device="cpu")
    assert tuple(v.shape) == (36, k, npad) and len(offsets) == k
    up = prepare_sym_values(v, offsets)
    keep = [s for s, o in enumerate(offsets) if o >= 0]
    assert len(keep) == k // 2 + 1 and up.is_contiguous()
    assert upper_offsets(offsets) == tuple(offsets[s] for s in keep) and offsets[keep[0]] == 0
    np.testing.assert_array_equal(up.numpy(), v.numpy()[:, keep, :])


@pytest.mark.parametrize("et", ["q", "t"])
def test_sym_matvec_matches_jax_df(et):
    pair, offsets, _, x = _pair(et)
    ref = df_stencil_matvec(pair, x, offsets)
    r64 = np.asarray(ref.hi, np.float64) + np.asarray(ref.lo, np.float64)
    v = df_pair_from_jax(pair, device="cpu")
    y = stencil_spmv_sym(prepare_sym_values(v, offsets), _x64(x), offsets)
    assert y.dtype == torch.float64
    assert float(np.abs(y.numpy() - r64).max()) <= 1e-13 * float(np.abs(r64).max())


@pytest.mark.parametrize("et", ["q", "t"])
def test_sym_matvec_matches_full_storage(et):
    pair, offsets, _, x = _pair(et)
    v = df_pair_from_jax(pair, device="cpu")
    x64 = _x64(x)
    ref = stencil_spmv_plain(v, x64, offsets)
    y = stencil_spmv_sym_plain(prepare_sym_values(v, offsets), x64, offsets)
    assert float((y - ref).abs().max()) <= 1e-13 * float(ref.abs().max())


def test_sym_wrapper_refusals():
    offs = (-4, -1, 0, 1, 4)
    u = torch.zeros((36, 3, 16), dtype=torch.float64)
    x = torch.zeros((6, 16), dtype=torch.float64)
    assert float(stencil_spmv_sym(u, x, offs).abs().max()) == 0.0
    with pytest.raises(TypeError):
        stencil_spmv_sym(u.float(), x.float(), offs)
    with pytest.raises(ValueError, match="upper must be"):
        stencil_spmv_sym(u[:, :2], x, offs)
    with pytest.raises(ValueError, match="must be \\[6"):
        stencil_spmv_sym(u, x[:, :15], offs)
    with pytest.raises(ValueError, match="symmetric"):
        stencil_spmv_sym(u, x, (-4, -1, 0, 1, 3))
    with pytest.raises(ValueError, match="symmetric"):
        prepare_sym_values(torch.zeros((36, 5, 16), dtype=torch.float64), (0, -1, 1, -4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        stencil_spmv_sym(u, torch.zeros((16, 6), dtype=torch.float64).T, offs)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stencil_spmv_sym(u.to("meta"), x.to("meta"), offs)
    with pytest.raises(ValueError, match=" on "):
        stencil_spmv_sym(u, x.to("meta"), offs)
    assert stencil_spmv_sym.launches == 0  # CPU calls take the plain version
