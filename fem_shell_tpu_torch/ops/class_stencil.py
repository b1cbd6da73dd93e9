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
reads a zero halo, the plain version a zero ring). The JAX package's
flat path wraps instead and cancels the wrapped products through the band
deltas; the two give the same sum up to rounding.

Band nodes keep the JAX package's decomposition, interior class plus
per-node delta. Where a band row differs much from the interior row (a
constrained DOF's identity row against an interior row of ~1e8), the two
partial sums cancel and each result carries ~eps * |c_int| * |x| of its
type's rounding; constrained DOFs form a decoupled identity subsystem, so
the solves do not see it.

A ``ClassTable`` carries its grid, its offsets, the structural mask and
the kernel's launch arguments (``ClassLaunch``: the coefficients placed by
stencil slot in the table's type, the slot-to-offset map and the kernel
instance), packed once when the table is built, so that a launch passes
only pointers, sizes and the stream.

``class_stencil`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fem_shell_tpu_torch.ops import _build

MAX_K = 9  # 3x3 node stencil
_SYMBOLS = {torch.float32: "class_stencil_f32", torch.float64: "class_stencil_f64"}
_FNS = {}  # dtype -> the kernel's ctypes function, argtypes set

# the kernel's stencil slots, (dy + 1) * 3 + (dx + 1), and its compile-time
# shapes besides the full 3x3 (csrc/class_stencil.cu shape_slots): the two
# 7-point tri stencils, one per diagonal orientation
_SLOTS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
_TRI_SHAPES = {1: frozenset(_SLOTS) - {(-1, -1), (1, 1)},
               2: frozenset(_SLOTS) - {(-1, 1), (1, -1)}}
# the kernel's flat-shell (a, b) pattern, bit a*6 + b: membrane (u, v),
# plate (w, rx, ry) and drilling rz couple only among themselves
FLAT_BLOCKS = ((0, 1), (2, 3, 4), (5,))
FLAT_PATTERN = sum(1 << (a * 6 + b) for blk in FLAT_BLOCKS for a in blk for b in blk)
ALL_TERMS = 3  # the kernel instance for any other table


@dataclasses.dataclass(frozen=True)
class ClassLaunch:
    """A table's kernel arguments, packed once. ``coef`` [9, 36] in the
    table's type: the interior coefficients of offset (dy, dx) in row
    (dy + 1) * 3 + (dx + 1), [a*6 + b], zero in the slots the table has no
    offset for; ``s_of`` [9] int32: the table's offset index of each slot
    (-1 where absent); ``instance``: the flat-shell terms (every mask
    inside ``FLAT_PATTERN``) on the full 3x3 stencil (0) or on the 7-point
    tri stencil without (-1, -1), (1, 1) (1) or without (-1, 1), (1, -1)
    (2), else all 36 terms on the full 3x3 stencil (3; any offsets, absent
    ones with zero coefficients). ``coef_ptr`` and ``s_of_ptr`` are the
    arrays' host addresses, read once (numpy's ``.ctypes`` costs
    microseconds a call)."""

    coef: np.ndarray
    s_of: np.ndarray
    instance: int
    coef_ptr: int = dataclasses.field(init=False, repr=False)
    s_of_ptr: int = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "coef_ptr", self.coef.ctypes.data)
        object.__setattr__(self, "s_of_ptr", self.s_of.ctypes.data)


def pack_launch(interior, offs2d, masks, all_terms: bool = False) -> ClassLaunch:
    """ClassLaunch of a host [K, 6, 6] interior table (its dtype is the
    kernel's) with offsets ``offs2d``, distinct, in the 3x3 stencil and in
    (dy, dx) order (the kernel sums in that order), and [K] uint64
    ``masks``. ``all_terms`` takes the all-36 instance whatever the masks."""
    interior = np.asarray(interior)
    offs = tuple((int(dy), int(dx)) for dy, dx in offs2d)
    if (len(offs) != len(set(offs)) or list(offs) != sorted(offs)
            or any(o not in _SLOTS for o in offs)):
        raise ValueError(f"the class kernel takes distinct 3x3-stencil offsets in (dy, dx) "
                         f"order, got {offs}")
    coef = np.zeros((len(_SLOTS), 36), interior.dtype)
    s_of = np.full(len(_SLOTS), -1, np.int32)
    for s, o in enumerate(offs):
        q = _SLOTS.index(o)
        coef[q] = interior[s].reshape(36)
        s_of[q] = s
    if all_terms or any(int(m) & ~FLAT_PATTERN for m in masks):
        return ClassLaunch(coef, s_of, ALL_TERMS)
    return ClassLaunch(coef, s_of, next((k for k, sh in _TRI_SHAPES.items()
                                         if frozenset(offs) == sh), 0))


@dataclasses.dataclass
class ClassTable:
    """One coefficient set of the class operator, on one device.

    ``interior`` [K, 6, 6] (offset s, row-var a, col-var b) at the offsets
    ``offs2d`` ((dy, dx) pairs). ``bands`` [K, 6, 6, 2, 2*nxp + 2*nyp]
    holds the per-node deltas to it on the four 2-node-wide bands, one
    after the other along the last axis: ``top`` (rows 0, 1) and
    ``bottom`` (rows nyp-2, nyp-1), nxp long, then ``left`` (columns 0, 1)
    and ``right`` (columns nxp-2, nxp-1), nyp long and zero on the four
    band rows (row bands own the corners). ``masks`` [K] uint64 (host):
    bit a*6+b of masks[s] set where (a, b, s) has a nonzero interior
    scalar or band delta. ``launch`` holds the kernel's packed
    arguments."""

    interior: torch.Tensor
    bands: torch.Tensor
    nyp: int
    nxp: int
    offs2d: Tuple[Tuple[int, int], ...]
    masks: np.ndarray
    launch: ClassLaunch

    @classmethod
    def from_numpy(cls, interior, top, bottom, left, right, offs2d, masks, device):
        """From host arrays: interior [K, 6, 6], top/bottom [K, 6, 6, 2,
        nxp], left/right [K, 6, 6, 2, nyp], K offsets and masks (which
        must cover every nonzero of the tables; ValueError otherwise)."""
        interior = np.array(interior, order="C")
        bands = np.ascontiguousarray(np.concatenate([top, bottom, left, right], axis=-1))
        k = len(offs2d)
        masks = np.asarray(masks, np.uint64)
        if not 1 <= k <= MAX_K or interior.shape != (k, 6, 6) or masks.shape != (k,):
            raise ValueError(f"{k} offsets, interior {interior.shape}, {masks.shape} masks: the "
                             f"kernel takes 1..{MAX_K} offsets of a [K, 6, 6] table")
        if interior.dtype.type not in (np.float32, np.float64) or bands.dtype != interior.dtype:
            raise TypeError(f"class tables are float32 or float64 of one type, got "
                            f"{interior.dtype} and {bands.dtype}")
        nyp, nxp = int(left.shape[-1]), int(top.shape[-1])
        if nyp < 4 or nxp < 4 or bands.shape != (k, 6, 6, 2, 2 * (nxp + nyp)):
            raise ValueError(f"band tables {bands.shape} for a {nyp} x {nxp} grid")
        bits = np.array([[[(int(m) >> (a * 6 + b)) & 1 for b in range(6)] for a in range(6)]
                         for m in masks], bool)
        if np.any(((interior != 0) | (bands != 0).any(axis=(3, 4))) & ~bits):
            raise ValueError("masks leave out a nonzero coefficient of the table")
        offs = tuple((int(dy), int(dx)) for dy, dx in offs2d)
        return cls(torch.from_numpy(interior).to(device), torch.from_numpy(bands).to(device),
                   nyp, nxp, offs, masks, pack_launch(interior, offs, masks))


def class_stencil_plain(table: ClassTable, x, w=None, b=None):
    """A x (or w * (b - A x)) with x [6, Npad]: the interior stencil on
    the zero-ringed grid, then the band deltas summed apart and added on
    the four 2-node-wide bands. The padding of the result is A x = 0.

    Both sums run term by term in one order (s-major, then b), as the
    JAX package's and the kernel's do. Where a band delta is the exact
    negative of the interior coefficient (every coupling of a
    constrained DOF, whose class row is an identity row), the two partial
    sums are then exact negatives of each other and cancel to zero, so
    constrained DOFs stay exactly decoupled."""
    nyp, nxp, offs2d = table.nyp, table.nxp, table.offs2d
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


def _check(table: ClassTable, x, w, b):
    """The call's vectors against the table (checked when it was built)."""
    dt = table.interior.dtype
    if x.dtype != dt:
        raise TypeError(f"class_stencil takes x of its table's type {dt}, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] != 6 or x.shape[1] < table.nyp * table.nxp:
        raise ValueError(f"x must be [6, Npad >= {table.nyp}*{table.nxp}], got {tuple(x.shape)}")
    if x.device != table.interior.device:
        raise ValueError(f"table on {table.interior.device}, x on {x.device}")
    if (w is None) != (b is None):
        raise ValueError("pass both w and b (fused w * (b - A x)) or neither")
    for v in (x,) if w is None else (x, w, b):
        if v.shape != x.shape or v.dtype != dt or v.device != x.device or not v.is_contiguous():
            raise ValueError("x, w and b must be contiguous [6, Npad] tensors of one type and device")


def _kernel(dt):
    fn = _FNS.get(dt)
    if fn is None:
        fn = getattr(_build.load("class_stencil"), _SYMBOLS[dt])
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[dt] = fn
    return fn


def class_stencil(table: ClassTable, x, w: Optional[torch.Tensor] = None,
                  b: Optional[torch.Tensor] = None):
    """y = A x, or y = w * (b - A x) when ``w`` and ``b`` are given, for the
    class operator ``table`` (float32 or float64, the type of x) on its
    nyp x nxp grid. CPU tensors take ``class_stencil_plain``; CUDA tensors
    launch the kernel instance ``table.launch`` names on the current
    stream, or raise."""
    _check(table, x, w, b)
    dev = x.device
    if dev.type == "cpu":
        return class_stencil_plain(table, x, w, b)
    if dev.type != "cuda":
        raise ValueError(f"class_stencil runs on cpu or cuda, not {dev}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return class_stencil(table, x, w, b)
    dt = x.dtype
    fn = _kernel(dt)
    lp = table.launch
    y = torch.empty_like(x)
    rc = fn(x.data_ptr(), y.data_ptr(), None if w is None else w.data_ptr(),
            None if b is None else b.data_ptr(), lp.coef_ptr, lp.s_of_ptr,
            lp.instance, table.bands.data_ptr(), table.nyp, table.nxp, x.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"class_stencil launch failed with CUDA error {rc}")
    class_stencil.launches[dt] += 1
    return y


# kernel launches per dtype since the last reset (plain CPU calls do not count)
class_stencil.launches = {torch.float32: 0, torch.float64: 0}
