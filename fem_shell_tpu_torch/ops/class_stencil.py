"""Class-table stencil y = A x (and the fused y = w * (b - A x)) on a
uniform grid: the CUDA kernel ``csrc/class_stencil.cu`` and its plain
PyTorch version.

Port of the TPU kernels ``fem_shell_tpu/ops/pallas_class.py`` ``_kernel``
(interior class stencil in f32: the level-0 smoother, power iteration and
E term) and ``_kernel_df2`` (the df fine CG operator, here native f64),
together with the XLA band-delta folds around them. The JAX package's
padded (8,128) lane layout is a TPU artefact and is not carried over: x
and y stay flat ``[6, Npad]`` vectors.

Edges: a neighbour outside the grid contributes nothing (the kernel
checks bounds, the plain version reads a zero ring). The JAX package's
flat path wraps instead and cancels the wrapped products through the band
deltas; the two give the same sum up to rounding.

Band nodes keep the JAX package's decomposition, interior class plus
per-node delta. Where a band row differs much from the interior row (a
constrained DOF's identity row against an interior row of ~1e8), the two
partial sums cancel and each result carries ~eps * |c_int| * |x| of its
type's rounding; constrained DOFs form a decoupled identity subsystem, so
the solves do not see it.

``class_stencil`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fem_shell_tpu_torch.ops import _build

MAX_K = 9  # 3x3 node stencil
_SYMBOLS = {torch.float32: "class_stencil_f32", torch.float64: "class_stencil_f64"}


@dataclasses.dataclass
class ClassTable:
    """One coefficient set of the class operator, on one device.

    ``interior`` [K, 6, 6] (offset s, row-var a, col-var b). ``bands``
    [K, 6, 6, 2, 2*nxp + 2*nyp] holds the per-node deltas to it on the
    four 2-node-wide bands, one after the other along the last axis:
    ``top`` (rows 0, 1) and ``bottom`` (rows nyp-2, nyp-1), nxp long,
    then ``left`` (columns 0, 1) and ``right`` (columns nxp-2, nxp-1),
    nyp long and zero on the four band rows (row bands own the
    corners). ``coef`` is the interior table as a host array, which the
    kernel takes by value."""

    interior: torch.Tensor
    bands: torch.Tensor
    nyp: int
    nxp: int
    coef: np.ndarray

    @classmethod
    def from_numpy(cls, interior, top, bottom, left, right, device):
        """From host arrays: interior [K, 6, 6], top/bottom [K, 6, 6, 2,
        nxp], left/right [K, 6, 6, 2, nyp]."""
        bands = np.ascontiguousarray(np.concatenate([top, bottom, left, right], axis=-1))
        return cls(torch.from_numpy(np.array(interior, order="C")).to(device),
                   torch.from_numpy(bands).to(device), int(left.shape[-1]), int(top.shape[-1]),
                   np.array(interior, order="C").reshape(-1))


def class_stencil_plain(table: ClassTable, x, offs2d: Sequence[Tuple[int, int]],
                        nyp: int, nxp: int, w=None, b=None):
    """A x (or w * (b - A x)) with x [6, Npad]: the interior stencil on
    the zero-ringed grid, then the band deltas summed apart and added on
    the four 2-node-wide bands. The padding of the result is A x = 0.

    Both sums run term by term in one order (s-major, then b), as the
    JAX package's and the kernel's do. Where a band delta is the exact
    negative of the interior coefficient (every coupling of a
    constrained DOF, whose class row is an identity row), the two partial
    sums are then exact negatives of each other and cancel to zero, so
    constrained DOFs stay exactly decoupled."""
    n = nyp * nxp
    npad = x.shape[1]
    xp = F.pad(x[:, :n].reshape(6, nyp, nxp), (1, 1, 1, 1))
    # neighbour values of every node, one [6, nyp, nxp] view per offset
    xs = [xp[:, 1 + dy : 1 + dy + nyp, 1 + dx : 1 + dx + nxp] for dy, dx in offs2d]
    y = x.new_zeros((6, nyp, nxp))
    for s in range(len(offs2d)):
        for bb in range(6):
            y = y + table.interior[s, :, bb][:, None, None] * xs[s][bb][None]
    # the four bands side by side: [6, 2, 2*nxp + 2*nyp]
    yb = x.new_zeros((6, 2, 2 * (nxp + nyp)))
    for s in range(len(offs2d)):
        v = xs[s]
        xb = torch.cat([v[:, :2, :], v[:, nyp - 2 :, :],
                        v[:, :, :2].transpose(1, 2), v[:, :, nxp - 2 :].transpose(1, 2)], dim=2)
        for bb in range(6):
            yb = yb + table.bands[s, :, bb] * xb[bb][None]
    y[:, :2, :] += yb[:, :, :nxp]
    y[:, nyp - 2 :, :] += yb[:, :, nxp : 2 * nxp]
    y[:, :, :2] += yb[:, :, 2 * nxp : 2 * nxp + nyp].transpose(1, 2)
    y[:, :, nxp - 2 :] += yb[:, :, 2 * nxp + nyp :].transpose(1, 2)
    y = F.pad(y.reshape(6, n), (0, npad - n))
    return y if w is None else w * (b - y)


def _check(table, x, offs2d, masks, nyp, nxp, w, b):
    dt = table.interior.dtype
    if dt not in _SYMBOLS or x.dtype != dt:
        raise TypeError(f"class_stencil takes a float32 or float64 table and x of its type, "
                        f"got {dt} and {x.dtype}")
    k = len(offs2d)
    if not 1 <= k <= MAX_K or tuple(table.interior.shape) != (k, 6, 6) or len(masks) != k:
        raise ValueError(f"{k} offsets, interior {tuple(table.interior.shape)}, {len(masks)} "
                         f"masks: the kernel takes 1..{MAX_K} offsets of a [K, 6, 6] table")
    if nyp < 4 or nxp < 4 or x.dim() != 2 or x.shape[0] != 6 or x.shape[1] < nyp * nxp:
        raise ValueError(f"x must be [6, Npad >= {nyp}*{nxp}], got {tuple(x.shape)}")
    t, shape = table.bands, (k, 6, 6, 2, 2 * (nxp + nyp))
    if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device or not t.is_contiguous():
        raise ValueError(f"band tables: want contiguous {shape} {dt} on {x.device}")
    if table.interior.device != x.device:
        raise ValueError(f"table on {table.interior.device}, x on {x.device}")
    if (w is None) != (b is None):
        raise ValueError("pass both w and b (fused w * (b - A x)) or neither")
    for v in (x,) if w is None else (x, w, b):
        if v.shape != x.shape or v.dtype != dt or v.device != x.device or not v.is_contiguous():
            raise ValueError("x, w and b must be contiguous [6, Npad] tensors of one type and device")


def class_stencil(table: ClassTable, x, offs2d: Sequence[Tuple[int, int]], masks,
                  nyp: int, nxp: int, w: Optional[torch.Tensor] = None,
                  b: Optional[torch.Tensor] = None):
    """y = A x, or y = w * (b - A x) when ``w`` and ``b`` are given, for the
    class operator ``table`` (float32 or float64, the type of x) on an
    nyp x nxp grid. ``masks`` [K] uint64 (host): bit a*6+b of masks[s] set
    where (a, b, s) is accumulated; the kernel skips the rest. CPU tensors
    take ``class_stencil_plain``; CUDA tensors launch the kernel on the
    current stream, or raise."""
    _check(table, x, offs2d, masks, nyp, nxp, w, b)
    if x.device.type == "cpu":
        return class_stencil_plain(table, x, offs2d, nyp, nxp, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"class_stencil runs on cpu or cuda, not {x.device}")
    dt = x.dtype
    fn = getattr(_build.load("class_stencil"), _SYMBOLS[dt])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    k = len(offs2d)
    coef = np.ascontiguousarray(table.coef, dtype=np.float64 if dt == torch.float64 else np.float32)
    mask = np.ascontiguousarray(masks, dtype=np.uint64)
    dydx = np.ascontiguousarray(np.asarray(offs2d, dtype=np.int32).reshape(-1))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), None if w is None else w.data_ptr(),
                None if b is None else b.data_ptr(), coef.ctypes.data, mask.ctypes.data,
                dydx.ctypes.data, k, table.bands.data_ptr(), nyp, nxp, x.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"class_stencil launch failed with CUDA error {rc}")
    class_stencil.launches[dt] += 1
    return y


# kernel launches per dtype since the last reset (plain CPU calls do not count)
class_stencil.launches = {torch.float32: 0, torch.float64: 0}
