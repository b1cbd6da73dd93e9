"""The benchmark of fem_shell_tpu_torch (the PyTorch/CUDA port) on one
GPU; see README.md."""
