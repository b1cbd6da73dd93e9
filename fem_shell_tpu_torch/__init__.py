"""fem_shell_tpu_torch — the PyTorch/CUDA port of fem_shell_tpu.

A second package beside the JAX reference: the same flat-shell finite
elements, block-ELL stand-alone solver (ShellSystem), SoA operator
(stencil and gather mode, LargeShellSystem), geometric multigrid and
smoothed-aggregation AMG (amg.AMGShellSystem, unstructured meshes), the
coupled FSI structure solver (coupling/) and stress recovery
(ops/recovery.py), run with PyTorch on an NVIDIA GPU (Hopper,
sm_90a), with every kernel of the JAX package's Pallas code as a
hand-written CUDA kernel (csrc/). It imports nothing of
JAX or of fem_shell_tpu. Entry points run on CUDA unless the caller
passes ``device="cpu"``.

Importing the package neither builds nor loads a kernel: the first CUDA
launch does (ops/_build.py).
"""
from fem_shell_tpu_torch.materials import Material
from fem_shell_tpu_torch.mesh import ShellMesh
from fem_shell_tpu_torch.meshgen import MeshGenParams, generate
from fem_shell_tpu_torch.mg import MultigridShellSystem
from fem_shell_tpu_torch.system import ShellSystem

__all__ = ["Material", "ShellMesh", "ShellSystem", "MultigridShellSystem", "generate", "MeshGenParams"]
