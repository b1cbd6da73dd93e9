"""Symmetric-storage stencil block-SpMV y = A x from the upper half of the
SoA operator (the off >= 0 slots): the CUDA kernel
``csrc/stencil_spmv_sym.cu`` and its plain PyTorch version.

Port of the TPU kernel ``fem_shell_tpu/ops/pallas_spmv_df.py``
``_kernel_sym`` (``stencil_spmv_pallas_df_sym``, the CG matvec of the
materialized df pair), here in native f64. A symmetric stencil operator
keeps only its off >= 0 slots; each stored block serves its direct term
and, for off > 0, the transposed term of the node it couples to, so a
matvec needs ~55 % of the full operator's bytes. The JAX package's
tile-major layout and its cross-tile carry are TPU artefacts and are not
carried over: ``prepare_sym_values`` keeps ``[36, Ku, Npad]``, and the
kernel gathers the transposed terms (thread n owns y[:, n]).

``stencil_spmv_sym`` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from fem_shell_tpu_torch.ops import _build

MAX_UPPER = 17  # the off >= 0 half of the 32-slot stencil


def is_symmetric(offsets: Sequence[int]) -> bool:
    """True when the stencil is structurally symmetric: -off is an offset
    for every offset off."""
    return sorted(-int(o) for o in offsets) == sorted(int(o) for o in offsets)


def upper_offsets(offsets: Sequence[int]):
    """The off >= 0 offsets of an ascending, structurally symmetric stencil
    (raises ValueError otherwise)."""
    offs = tuple(int(o) for o in offsets)
    if list(offs) != sorted(offs) or not is_symmetric(offs):
        raise ValueError(f"offsets {offs} are not ascending and structurally symmetric")
    return tuple(o for o in offs if o >= 0)


def prepare_sym_values(values, offsets: Sequence[int]):
    """[36, K, Npad] operator -> its off >= 0 slots [36, Ku, Npad]
    (contiguous copy), the port of ``prepare_tiled_values_df_sym`` without
    the tile-major layout."""
    k = len(upper_offsets(offsets))
    return values[:, len(offsets) - k :, :].contiguous()


def stencil_spmv_sym_plain(upper, x, offsets: Sequence[int]):
    """y = A x from the upper half: direct terms by roll (a target outside
    [0, Npad) wraps onto a block that is identically zero), then the
    transposed terms by slicing, y[:, o:] += U[b, :, s, :Npad-o] x[b, :Npad-o]."""
    up = upper_offsets(offsets)
    ku, npad = upper.shape[1], upper.shape[2]
    u4 = upper.reshape(6, 6, ku, npad)
    y = torch.zeros_like(x)
    for s, o in enumerate(up):
        xs = torch.roll(x, -o, dims=1)
        for b in range(6):
            y = y + u4[:, b, s] * xs[b]
    for s, o in enumerate(up):
        if o == 0:
            continue
        for b in range(6):
            y[:, o:] += u4[b, :, s, : npad - o] * x[b, : npad - o]
    return y


def _check(upper, x, offsets):
    if upper.dtype != torch.float64 or x.dtype != torch.float64:
        raise TypeError(f"stencil_spmv_sym takes float64 upper and x, got {upper.dtype} and {x.dtype}")
    if upper.device != x.device:
        raise ValueError(f"upper on {upper.device}, x on {x.device}")
    up = upper_offsets(offsets)
    ku = len(up)
    if not 1 <= ku <= MAX_UPPER or up[0] != 0:
        raise ValueError(f"upper offsets {up}: the kernel takes 1..{MAX_UPPER}, from 0")
    if upper.dim() != 3 or upper.shape[0] != 36 or upper.shape[1] != ku:
        raise ValueError(f"upper must be [36, {ku}, Npad], got {tuple(upper.shape)}")
    npad = upper.shape[2]
    if tuple(x.shape) != (6, npad):
        raise ValueError(f"x must be [6, {npad}], got {tuple(x.shape)}")
    if not (upper.is_contiguous() and x.is_contiguous()):
        raise ValueError("stencil_spmv_sym needs contiguous upper and x")
    return up


def stencil_spmv_sym(upper, x, offsets: Sequence[int]):
    """y = A x with ``upper`` [36, Ku, Npad] (``prepare_sym_values``) and
    x [6, Npad], both float64; ``offsets`` are the full operator's.
    CPU tensors take ``stencil_spmv_sym_plain``; CUDA tensors launch the
    kernel on the current stream, or raise."""
    up = _check(upper, x, offsets)
    if x.device.type == "cpu":
        return stencil_spmv_sym_plain(upper, x, offsets)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_spmv_sym runs on cpu or cuda, not {x.device}")
    fn = _build.load("stencil_spmv_sym").stencil_spmv_sym_f64
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    offs = (ctypes.c_int * len(up))(*up)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(upper.data_ptr(), x.data_ptr(), y.data_ptr(), offs, len(up), upper.shape[2], stream)
    if rc != 0:
        raise RuntimeError(f"stencil_spmv_sym launch failed with CUDA error {rc}")
    stencil_spmv_sym.launches += 1
    return y


# kernel launches since the last reset (plain CPU calls do not count)
stencil_spmv_sym.launches = 0
