"""fem_shell_tpu_torch — the PyTorch/CUDA port of fem_shell_tpu.

A second package beside the JAX reference: the same flat-shell finite
elements, SoA stencil operator and multigrid solver, run with PyTorch on
an NVIDIA GPU (Hopper, sm_90a), with the stencil block-SpMV as a
hand-written CUDA kernel (csrc/stencil_spmv.cu). It imports nothing of
JAX or of fem_shell_tpu. Entry points run on CUDA unless the caller
passes ``device="cpu"``.

Importing the package neither builds nor loads the kernel: the first
CUDA matvec does (ops/_build.py).
"""
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.meshgen import MeshGenParams, generate
from fem_shell_tpu_torch.mg import MultigridShellSystem

__all__ = ["Material", "ShellMesh", "MultigridShellSystem", "generate", "MeshGenParams"]
