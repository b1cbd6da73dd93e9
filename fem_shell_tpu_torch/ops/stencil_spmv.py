"""Stencil block-SpMV y = A x on the SoA operator: the CUDA kernel
``csrc/stencil_spmv.cu`` and its plain PyTorch version.

Port of the TPU kernels ``fem_shell_tpu/ops/pallas_spmv.py``
(``_kernel``/``_kernel_tiled``, f32: the V-cycle smoother and residual)
and ``fem_shell_tpu/ops/pallas_spmv_df.py`` (``_kernel``/``_kernel_flat``
with ``tf=False``: the outer-CG matvec over the two-float32 pair, here
native f64). The JAX package's tile-major value layout is a TPU artefact
and is not carried over: values stay ``[36, K, Npad]``, vectors
``[6, Npad]``.

``stencil_spmv_f32v`` is a port-only instance of the same kernel: f32
values, f64 x and y, each product and sum in f64. It is the f64 CG matvec
over an f32 operator (the f32 ``LargeShellSystem.solve_df`` and
``MultigridShellSystem.solve_df``), the counterpart of the JAX package's
XLA ``df_stencil_matvec_f32v`` (fem_shell_tpu/ops/df.py:212), which is no
Pallas kernel. It reads the values as f32, where a cast-up copy would
move twice their bytes. Its plain version is ``stencil_spmv_plain`` on
the mixed pair (PyTorch widens each f32 value exactly before the f64
product).

``stencil_spmv`` and ``stencil_spmv_f32v`` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; they never fall back from
one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from fem_shell_tpu_torch.ops import _build

MAX_STENCIL = 32
_SYMBOLS = {torch.float32: "stencil_spmv_f32", torch.float64: "stencil_spmv_f64"}


def stencil_spmv_plain(values, x, offsets: Sequence[int]):
    """y = A x as ``soa_matvec``'s roll-and-multiply loop, in x's dtype (f32
    values times f64 x widen the values). A target outside [0, Npad) wraps
    onto a block that is identically zero."""
    k, npad = values.shape[1], values.shape[2]
    v4 = values.reshape(6, 6, k, npad)
    y = torch.zeros_like(x)
    for s, o in enumerate(offsets):
        xs = torch.roll(x, -int(o), dims=1)
        for b in range(6):
            y = y + v4[:, b, s] * xs[b]
    return y


def _check(values, x, offsets, mixed: bool = False):
    """Raise on what the kernel does not take: values and x of one dtype,
    or with ``mixed`` f32 values and f64 x."""
    if not mixed:
        if values.dtype not in _SYMBOLS or x.dtype != values.dtype:
            raise TypeError(
                f"stencil_spmv takes values and x both float32 or both float64, "
                f"got {values.dtype} and {x.dtype}"
            )
    elif values.dtype != torch.float32 or x.dtype != torch.float64:
        raise TypeError(f"stencil_spmv_f32v takes float32 values and float64 x, "
                        f"got {values.dtype} and {x.dtype}")
    if values.device != x.device:
        raise ValueError(f"values on {values.device}, x on {x.device}")
    k = len(offsets)
    if not 1 <= k <= MAX_STENCIL:
        raise ValueError(f"{k} offsets: the kernel takes 1..{MAX_STENCIL}")
    if values.dim() != 3 or values.shape[0] != 36 or values.shape[1] != k:
        raise ValueError(f"values must be [36, {k}, Npad], got {tuple(values.shape)}")
    npad = values.shape[2]
    if tuple(x.shape) != (6, npad):
        raise ValueError(f"x must be [6, {npad}], got {tuple(x.shape)}")
    if not (values.is_contiguous() and x.is_contiguous()):
        raise ValueError("stencil_spmv needs contiguous values and x")


def _launch(symbol: str, values, x, offsets):
    """Launch one instance of the kernel on the current stream; y [6, Npad]
    in x's dtype."""
    if values.device.type != "cuda":
        raise ValueError(f"{symbol} runs on cpu or cuda, not {values.device}")
    k, npad = values.shape[1], values.shape[2]
    fn = getattr(_build.load("stencil_spmv"), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    offs = (ctypes.c_int * k)(*(int(o) for o in offsets))
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(values.data_ptr(), x.data_ptr(), y.data_ptr(), offs, k, npad, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc}")
    return y


def stencil_spmv(values, x, offsets: Sequence[int]):
    """y = A x with values [36, K, Npad] and x [6, Npad], both float32 or
    both float64, and K integer stencil offsets. CPU tensors take
    ``stencil_spmv_plain``; CUDA tensors launch the kernel on the current
    stream, or raise."""
    _check(values, x, offsets)
    if values.device.type == "cpu":
        return stencil_spmv_plain(values, x, offsets)
    y = _launch(_SYMBOLS[values.dtype], values, x, offsets)
    stencil_spmv.launches[values.dtype] += 1
    return y


def stencil_spmv_f32v(values, x, offsets: Sequence[int]):
    """y = A x in f64 with float32 values [36, K, Npad] and float64 x [6,
    Npad]. CPU tensors take ``stencil_spmv_plain``; CUDA tensors launch the
    mixed instance on the current stream, or raise."""
    _check(values, x, offsets, mixed=True)
    if values.device.type == "cpu":
        return stencil_spmv_plain(values, x, offsets)
    y = _launch("stencil_spmv_f32v", values, x, offsets)
    stencil_spmv_f32v.launches += 1
    return y


# kernel launches per dtype since the last reset (plain CPU calls do not count)
stencil_spmv.launches = {torch.float32: 0, torch.float64: 0}
stencil_spmv_f32v.launches = 0
