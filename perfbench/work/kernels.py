"""Peaks of the card and the work of the kernels the cells measure.

Each work function counts what the product needs from its shapes: every
input byte read once and every output byte written once, whatever the
kernel reads again. A roofline share is the least time the card could take,
the larger of bytes over the bandwidth and operations over the peak rate,
over the time the kernel took. The formulas are the ones the port's kernel
table was measured with (chip_smoke.py: ``kernel_phase``, ``elem_work``,
``amg_products``).
"""
from __future__ import annotations

# Published peaks (NVIDIA's data sheets, dense, without sparsity): memory
# bandwidth in bytes/s and vector (non-tensor-core) rates in FLOP/s by
# element size. The first key found in the device's name wins, so the
# longer names come first.
CARDS = (
    ("H100 PCIe", 2.0e12, {4: 51.2e12, 8: 25.6e12}),
    ("H100 NVL", 3.9e12, {4: 60e12, 8: 30e12}),
    ("H100", 3.35e12, {4: 67e12, 8: 34e12}),
    ("H200", 4.8e12, {4: 67e12, 8: 34e12}),
)

# f64 operations per element of the element-stiffness math (Tri-3: 3,
# Quad-4: 4 nodes), counted from the one-thread-per-element form of the
# kernel: an add, multiply, divide, square root or comparison one each, an
# fma two. Tri-3: frame 67 + membrane 257 + plate 3 x (609 + 135 + 450) +
# 79 + 9 node-pair blocks x 365 = 7270. Quad-4: frame 126 + membrane
# 4 x 480 + plate 88 + 4 x 1183 + 16 x 365 = 12706.
ELEM_OPS = {3: 7270, 4: 12706}


def card(name: str):
    """(bandwidth bytes/s, {itemsize: FLOP/s}) of the card named ``name``."""
    for key, bw, peaks in CARDS:
        if key in name:
            return bw, peaks
    raise KeyError(f"no published peaks for {name!r}")


def bound_s(nbytes: float, flops: float, itemsize: int, name: str) -> float:
    """The least seconds the card could take for this work."""
    bw, peaks = card(name)
    return max(nbytes / bw, flops / peaks[itemsize])


def stencil_spmv_work(offsets, npad: int, itemsize: int, x_itemsize: int = 0):
    """(bytes, operations) of one stencil block-SpMV y = A x on the SoA
    operator [36, K, Npad] with node offsets ``offsets``: the values whose
    target lies inside [0, Npad) read once (36 per slot), x read and y
    written once (6 + 6 per node, ``x_itemsize`` each where the vectors'
    type differs from the values'); 72 operations per slot."""
    slots = sum(npad - abs(int(o)) for o in offsets)
    return 36 * slots * itemsize + 12 * npad * (x_itemsize or itemsize), 72 * slots


def elem_work(m: int, ne: int):
    """(bytes, operations) of the element stiffness of ``ne`` elements of
    ``m`` nodes: the coordinates read and ke [6m, 6m] written once, f64."""
    return 8 * (3 * m + 36 * m * m) * ne, ELEM_OPS[m] * ne


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ell_matvec_work(blocks, adj, x):
    """(bytes, operations) of one block-ELL product y = A x: the blocks
    [n, K, 6, 6] and the adjacency [n, K] read once, x read once and y
    written once (x's shape); 72 operations per block."""
    return tensor_bytes(blocks, adj, x, x), 72 * adj.numel()
