"""The yardstick's work functions against counts made by hand at 8^2 and
16^2, and the trace readers that use them on made-up launches."""
import math
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness
from perfbench.work import kernels

H100 = "NVIDIA H100 80GB HBM3"


def tri_offsets(n):
    """Node offsets of the Tri-3 grid's stencil (lower-left to upper-right
    diagonal), n cells a side."""
    p = n + 1
    return (-p, -p + 1, -1, 0, 1, p - 1, p)


@pytest.mark.parametrize("n, f64_bytes", [(8, 160704), (16, 590784)])
def test_stencil_spmv_work(n, f64_bytes):
    npad = (n + 1) ** 2
    # 8^2: 81 nodes, 7 slots: 7 * 81 - (9 + 8 + 1 + 0 + 1 + 8 + 9) = 531 in range
    #      (36 * 531 + 12 * 81) * 8 = 160704
    # 16^2: 289 nodes: 7 * 289 - (17 + 16 + 1 + 1 + 16 + 17) = 1955
    #      (36 * 1955 + 12 * 289) * 8 = 590784
    slots = 7 * npad - 2 * (n + 1) - 2 * n - 2
    assert kernels.stencil_spmv_work(tri_offsets(n), npad, 8) == ((36 * slots + 12 * npad) * 8, 72 * slots)
    assert kernels.stencil_spmv_work(tri_offsets(n), npad, 8)[0] == f64_bytes
    assert kernels.stencil_spmv_work(tri_offsets(n), npad, 4)[0] == f64_bytes // 2
    # f32 values, f64 vectors: 36 * slots * 4 + 12 * npad * 8
    assert kernels.stencil_spmv_work(tri_offsets(n), npad, 4, 8)[0] == 144 * slots + 96 * npad


@pytest.mark.parametrize("m, n, elems", [(3, 8, 128), (4, 8, 64), (3, 16, 512), (4, 16, 256)])
def test_elem_work(m, n, elems):
    per = {3: 8 * (9 + 324), 4: 8 * (12 + 576)}[m]  # coordinates in, ke [6m, 6m] out
    assert kernels.elem_work(m, elems) == (per * elems, {3: 7270, 4: 12706}[m] * elems)


@pytest.mark.parametrize("n", [81, 289])
def test_ell_matvec_work(n):
    blocks = torch.zeros((n, 9, 6, 6), dtype=torch.float64)
    adj = torch.zeros((n, 9), dtype=torch.int64)
    x = torch.zeros((n, 6), dtype=torch.float64)
    assert kernels.ell_matvec_work(blocks, adj, x) == (n * 9 * 36 * 8 + n * 9 * 8 + 2 * n * 6 * 8, 72 * 9 * n)


def test_bound_picks_the_larger_and_the_card():
    bw, peaks = kernels.card("NVIDIA H100 80GB HBM3")
    assert (bw, peaks[8]) == (3.35e12, 34e12)
    assert kernels.bound_s(3.35e12, 1.0, 8, "NVIDIA H100 80GB HBM3") == 1.0
    assert kernels.bound_s(1.0, 34e12, 8, "NVIDIA H100 80GB HBM3") == 1.0
    assert kernels.card("NVIDIA H100 PCIe")[0] == 2.0e12
    with pytest.raises(KeyError):
        kernels.card("cpu")


def levels_of(*cells):
    return [SimpleNamespace(offsets=tri_offsets(n), npad=(n + 1) ** 2) for n in cells]


def stencil_ctx(events, levels):
    """A traced run's context whose trace holds ``events``: (name, grid,
    block, seconds) of each kernel launch."""
    trace = {"kernels": {}, "launches": lambda pattern: [e for e in events if pattern in e[0]]}
    return SimpleNamespace(trace=trace, system=SimpleNamespace(levels=levels), card_name=H100)


@pytest.mark.parametrize("metric", ["stencil_spmv_f32_roofline", "stencil_spmv_f64_roofline"])
def test_stencil_roofline_counts_each_launch_at_its_level(metric):
    read = harness.reader(metric)
    levels = levels_of(64, 32, 16)
    f32, f64 = "void stencil_spmv_kernel<float, float>(...)", "void stencil_spmv_kernel<double, double>(...)"
    events, least, secs = [], 0.0, 0.0
    for lvl, name, item, sec in ((0, f32, 4, 3e-5), (1, f32, 4, 1e-5), (2, f32, 4, 8e-6), (0, f64, 8, 5e-5)):
        npad = levels[lvl].npad
        events.append((name, [math.ceil(npad / 256), 1, 1], [256, 1, 1], sec))
        if (item == 4) == ("f32" in metric):
            least += kernels.bound_s(*kernels.stencil_spmv_work(levels[lvl].offsets, npad, item), item, H100)
            secs += sec
    events.append(("void other_kernel(...)", [1, 1, 1], [32, 1, 1], 1.0))
    assert read(stencil_ctx(events, levels)) == pytest.approx(100 * least / secs, rel=1e-6)


@pytest.mark.parametrize("case", ["no launch", "no grid", "no level", "no trace"])
def test_stencil_roofline_reads_nothing_it_cannot_count(case):
    read = harness.reader("stencil_spmv_f32_roofline")
    levels = levels_of(64, 32)
    name = "void stencil_spmv_kernel<float, float>(...)"
    grid = {"no grid": None, "no level": [7, 1, 1]}.get(case, [math.ceil(65 ** 2 / 256), 1, 1])
    events = [] if case == "no launch" else [(name, grid, [256, 1, 1], 1e-5)]
    ctx = stencil_ctx(events, levels)
    if case == "no trace":
        ctx.trace = None
    assert read(ctx) is None


def test_elem_roofline_counts_every_level_of_every_traced_solve():
    read = harness.reader("elem_stiffness_roofline")
    mesh = [SimpleNamespace(mesh=SimpleNamespace(tri=range(2 * n * n), quad=())) for n in (64, 32)]
    ctx = SimpleNamespace(trace={"kernels": {"void tri_stiffness_kernel(...)": [2e-3, 6]}},
                          plate=SimpleNamespace(conn=torch.zeros((8192, 3))), system=SimpleNamespace(_systems=mesh),
                          traced_solves=3, card_name=H100)
    nbytes, ops = kernels.elem_work(3, 3 * (2 * 64 * 64 + 2 * 32 * 32))
    assert read(ctx) == pytest.approx(100 * kernels.bound_s(nbytes, ops, 8, H100) / 2e-3)


def test_stencil_roofline_takes_the_least_work_of_levels_sharing_a_grid():
    """Coarse levels padded to one npad share a grid: the launch counts at
    the least of their work."""
    read = harness.reader("stencil_spmv_f64_roofline")
    levels = [SimpleNamespace(offsets=tri_offsets(n), npad=4096) for n in (32, 16)]
    name = "void stencil_spmv_kernel<double, double>(...)"
    least = min(kernels.bound_s(*kernels.stencil_spmv_work(lvl.offsets, 4096, 8), 8, H100) for lvl in levels)
    assert least == kernels.bound_s(*kernels.stencil_spmv_work(tri_offsets(32), 4096, 8), 8, H100)
    ctx = stencil_ctx([(name, [16, 1, 1], [256, 1, 1], 2e-5)], levels)
    assert read(ctx) == pytest.approx(100 * least / 2e-5, rel=1e-9)
