"""Operators of the port: element kernels, the SoA stencil operator and
the stencil block-SpMV kernel with its build."""
