"""Element stiffness of a batch of flat shell elements, batch-last: the
CUDA kernel ``csrc/elem_stiffness.cu`` and its plain PyTorch version.

Port of the TPU kernel ``fem_shell_tpu/ops/pallas_elem.py``
(``elem_stiffness_pallas``: the traced single-element stiffness
re-executed in two-float32 arithmetic inside one Pallas kernel per tile
of elements). On a GPU the element math runs in native f64, written out
once in the kernel; its contract is the Pallas kernel's,
``xyz [m, 3, E] -> ke [6m, 6m, E]`` with the element axis last, m = 3
(Tri-3) or 4 (Quad-4).

The plain version is ``ops/elements.py`` (``tri_shell_stiffness`` /
``quad_shell_stiffness``) with the batch axis moved. ``elem_stiffness``
takes it for CPU tensors and launches the kernel for CUDA tensors; it
never falls back from one to the other.

``elem_stiffness_vjp`` is the vector-Jacobian product d<g, ke>/d xyz of
the differentiable solve's coordinate gradient. The TPU kernel has no
backward (``pallas_elem.py`` defines none), and the JAX ``ShellSystem``
takes its ke from the XLA element math, which ``jax.grad``
differentiates. Its counterpart here is autograd through that same plain
math, on xyz's own device: the counterpart of an XLA computation, not a
fallback of the kernel. The forward ke on the card still comes from
``csrc/elem_stiffness.cu`` alone, and a failed launch still raises.
"""
from __future__ import annotations

import ctypes

import torch

from fem_shell_tpu_torch.ops import _build
from fem_shell_tpu_torch.ops.elements import quad_shell_stiffness, tri_shell_stiffness


def elem_stiffness_plain(xyz, dm, dp, thickness):
    """ke [6m, 6m, E] from xyz [m, 3, E] through the batched element
    functions of ``ops/elements.py``."""
    fn = tri_shell_stiffness if xyz.shape[0] == 3 else quad_shell_stiffness
    ke = fn(xyz.permute(2, 0, 1), dm, dp, thickness)  # [E, 6m, 6m]
    return ke.permute(1, 2, 0).contiguous()


def _check(xyz, dm, dp):
    for name, t in (("xyz", xyz), ("dm", dm), ("dp", dp)):
        if t.dtype != torch.float64:
            raise TypeError(f"elem_stiffness takes float64 tensors, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"elem_stiffness needs a contiguous {name}")
    if not xyz.device == dm.device == dp.device:
        raise ValueError(f"xyz on {xyz.device}, dm on {dm.device}, dp on {dp.device}")
    if xyz.dim() != 3 or xyz.shape[0] not in (3, 4) or xyz.shape[1] != 3 or xyz.shape[2] < 1:
        raise ValueError(f"xyz must be [m, 3, E] with m 3 or 4 and E >= 1, got {tuple(xyz.shape)}")
    if tuple(dm.shape) != (3, 3) or tuple(dp.shape) != (3, 3):
        raise ValueError(f"dm and dp must be [3, 3], got {tuple(dm.shape)} and {tuple(dp.shape)}")


def elem_stiffness(xyz, dm, dp, thickness: float):
    """Global-axes element stiffnesses ke [6m, 6m, E] f64 of the elements
    with node coordinates xyz [m, 3, E] f64 (m = 3: Tri-3, 4: Quad-4) and
    material matrices dm, dp [3, 3] f64. CPU tensors take
    ``elem_stiffness_plain``; CUDA tensors launch the kernel on the
    current stream, or raise."""
    _check(xyz, dm, dp)
    if xyz.device.type == "cpu":
        return elem_stiffness_plain(xyz, dm, dp, thickness)
    if xyz.device.type != "cuda":
        raise ValueError(f"elem_stiffness runs on cpu or cuda, not {xyz.device}")
    m, _, ne = xyz.shape
    fn = _build.load("elem_stiffness").elem_stiffness_f64
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_double, ctypes.c_int, ctypes.c_int64,
                                               ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ke = torch.empty((6 * m, 6 * m, ne), dtype=torch.float64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xyz.data_ptr(), dm.data_ptr(), dp.data_ptr(), float(thickness), m, ne,
                ke.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"elem_stiffness launch failed with CUDA error {rc}")
    elem_stiffness.launches[m] += 1
    return ke


def elem_stiffness_vjp(xyz, dm, dp, thickness: float, g):
    """d<g, ke>/d xyz [m, 3, E] f64 of ke = elem_stiffness(xyz, ...) for
    cotangents g [6m, 6m, E] f64: autograd of ``elem_stiffness_plain`` on
    xyz's device (the module docstring says why no kernel computes it).
    ``torch.maximum`` in the drilling term splits a tie evenly between its
    arguments, as ``jnp.maximum`` does."""
    _check(xyz, dm, dp)
    m = xyz.shape[0]
    if tuple(g.shape) != (6 * m, 6 * m, xyz.shape[2]) or g.dtype != torch.float64:
        raise ValueError(f"g must be float64 [{6 * m}, {6 * m}, {xyz.shape[2]}], "
                         f"got {g.dtype} {tuple(g.shape)}")
    if g.device != xyz.device:
        raise ValueError(f"xyz on {xyz.device}, g on {g.device}")
    with torch.enable_grad():
        x = xyz.detach().requires_grad_(True)
        ke = elem_stiffness_plain(x, dm.detach(), dp.detach(), thickness)
        (grad,) = torch.autograd.grad(ke, x, g)
    return grad


# kernel launches since the last reset, by element family m (plain CPU
# calls do not count)
elem_stiffness.launches = {3: 0, 4: 0}
