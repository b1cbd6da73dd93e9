"""Compensated stencil residual r = b - A x on the SoA operator in
double-double accumulation: the CUDA kernel ``csrc/stencil_resid.cu`` and
its plain PyTorch version.

Port of the TPU kernel ``fem_shell_tpu/ops/pallas_spmv_df.py``
(``_kernel``/``_kernel_flat`` with ``tf=True``: the 4-level compensated
accumulator of the iterative-refinement residual on the materialized df
pair, ~2^-70). On a GPU the operator is native f64, so every product splits
exactly into p + e (TwoProd) and the sum runs as a double-double (TwoSum
into (s, c), seeded with (b, 0)): Ogita-Rump-Oishi's Dot2, as accurate as
the sum in twice f64 and rounded once. The JAX package's ``kahan=True``
mode is a cheaper df accumulation for the CG matvec, which native f64
(``stencil_spmv``) replaces.

``stencil_resid_dd`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from fem_shell_tpu_torch.ops import _build
from fem_shell_tpu_torch.ops.stencil_spmv import MAX_STENCIL

_SPLIT = 134217729.0  # 2^27 + 1: Dekker's split of a double into two 26-bit halves


def _two_sum(a, b):
    """Knuth's TwoSum: s + e == a + b exactly."""
    s = a + b
    z = s - a
    return s, (a - (s - z)) + (b - z)


def dd_add(hi, lo, d):
    """(hi, lo) + d as a renormalised double-double: TwoSum of the high
    parts, the low parts added to its error, then a fast TwoSum."""
    s, e = _two_sum(hi, d)
    e = e + lo
    h = s + e
    return h, e - (h - s)


def _two_prod(a, b):
    """Dekker's TwoProd: p + e == a * b exactly (torch has no fma; eager
    ops are never contracted)."""
    p = a * b
    ca = _SPLIT * a
    ah = ca - (ca - a)
    al = a - ah
    cb = _SPLIT * b
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def resid_dd(b, terms):
    """b - sum of a * x over ``terms`` (pairs of broadcastable tensors) in
    double-double: every product split exactly (TwoProd), the sum carried
    as (s, c) from (b, 0) in the terms' order, rounded once."""
    s, c = b.clone(), torch.zeros_like(b)
    for a, x in terms:
        p, e = _two_prod(a, x)
        s, err = _two_sum(s, -p)
        c = c + (err - e)
    return s + c


def stencil_resid_dd_plain(values, x, b, offsets: Sequence[int]):
    """r = b - A x in double-double, eager: the kernel's arithmetic term by
    term in its order (slot, then column). A target outside [0, Npad)
    wraps onto a block that is identically zero, whose exact zero terms
    leave the sums unchanged."""
    k, npad = values.shape[1], values.shape[2]
    v4 = values.reshape(6, 6, k, npad)
    xs = [torch.roll(x, -int(o), dims=1) for o in offsets]
    return resid_dd(b, ((v4[:, bb, j], xs[j][bb]) for j in range(k) for bb in range(6)))


def _check(values, x, b, offsets):
    if values.dtype != torch.float64 or x.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"stencil_resid_dd takes float64 values, x and b, "
                        f"got {values.dtype}, {x.dtype} and {b.dtype}")
    if not values.device == x.device == b.device:
        raise ValueError(f"values on {values.device}, x on {x.device}, b on {b.device}")
    k = len(offsets)
    if not 1 <= k <= MAX_STENCIL:
        raise ValueError(f"{k} offsets: the kernel takes 1..{MAX_STENCIL}")
    if values.dim() != 3 or values.shape[0] != 36 or values.shape[1] != k:
        raise ValueError(f"values must be [36, {k}, Npad], got {tuple(values.shape)}")
    npad = values.shape[2]
    if tuple(x.shape) != (6, npad) or tuple(b.shape) != (6, npad):
        raise ValueError(f"x and b must be [6, {npad}], got {tuple(x.shape)} and {tuple(b.shape)}")
    if not (values.is_contiguous() and x.is_contiguous() and b.is_contiguous()):
        raise ValueError("stencil_resid_dd needs contiguous values, x and b")


def stencil_resid_dd(values, x, b, offsets: Sequence[int]):
    """r = b - A x, compensated, with values [36, K, Npad] and x, b [6,
    Npad], all float64, and K integer stencil offsets. CPU tensors take
    ``stencil_resid_dd_plain``; CUDA tensors launch the kernel on the
    current stream, or raise."""
    _check(values, x, b, offsets)
    if values.device.type == "cpu":
        return stencil_resid_dd_plain(values, x, b, offsets)
    if values.device.type != "cuda":
        raise ValueError(f"stencil_resid_dd runs on cpu or cuda, not {values.device}")
    k, npad = values.shape[1], values.shape[2]
    fn = _build.load("stencil_resid").stencil_resid_dd_f64
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    r = torch.empty_like(x)
    offs = (ctypes.c_int * k)(*(int(o) for o in offsets))
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(values.data_ptr(), x.data_ptr(), b.data_ptr(), r.data_ptr(), offs, k, npad, stream)
    if rc != 0:
        raise RuntimeError(f"stencil_resid_dd launch failed with CUDA error {rc}")
    stencil_resid_dd.launches += 1
    return r


# kernel launches since the last reset (plain CPU calls do not count)
stencil_resid_dd.launches = 0
