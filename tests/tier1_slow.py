"""The JAX package's tests kept out of the tier-1 run (``-m 'not slow'``),
marked ``slow`` at collection by node ID, so that their files stay as
they were. They still run with ``-m slow`` or with no ``-m`` filter.

A test is listed when it takes over 75 s in the tier-1 command
(``-n 6 --dist load``, JAX's compilation cache empty, an 8-core host), or
when its memory grows without end, and leaves the list only when it
takes under 60 s there; the comment gives what it took, or how fast its
memory grew. An entry without a parameter suffix marks every case of
its test. ``tests/test_tier1_slow.py`` fails when an entry names no test.
"""
import pytest

SLOW_NODE_IDS = (
    "tests/test_grid_asm_shard.py::test_grid_sharded_df_mg_preconditioner",  # 296.8 s
    "tests/test_grid_asm_shard.py::test_grid_sharded_df_solver_golden_and_invariance",  # 256.5 s
    "tests/test_grid_asm_shard.py::test_grid_sharded_refined_solve_mg_prec",  # 144.2 s
    "tests/test_grid_asm_shard.py::test_multi_device_placement",  # 143.6 s
    "tests/test_grid_asm_shard.py::test_grid_sharded_refined_solve",  # 74.0 s
    "tests/test_pallas_spmv.py::test_pallas_df_interpret_matches_xla_df",  # +1.5 GB per 30 s
    "tests/test_pallas_spmv.py::test_pallas_df_flat_interpret_matches_xla_df",  # +1.7 GB per 30 s
    "tests/test_pallas_spmv.py::test_pallas_df_sym_interpret_matches_xla_df",  # 121.2 s
    "tests/test_class_matvec.py::test_mg_routes_fine_level_through_class_operator",  # 135.5 s
    "tests/test_exact_stencil.py::test_refined_solve_cpu[q]",  # 118.6 s
    "tests/test_exact_stencil.py::test_refined_solve_cpu[t]",  # 86.9 s
    "tests/test_mg_df.py::test_df_cycle_solve_matches_f32_cycle_path",  # 98.3 s
    "tests/test_assemble_grid.py::test_grid_df_tiled_layout_matches_flat[t-3]",  # 92.2 s
)


def listed(nodeid: str, node_ids) -> bool:
    """Whether ``nodeid``, or its test without the parameter suffix, is in ``node_ids``."""
    return nodeid in node_ids or nodeid.split("[", 1)[0] in node_ids


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    """Mark the listed tests ``slow`` before ``-m`` deselects by marker."""
    for item in items:
        if listed(item.nodeid, SLOW_NODE_IDS):
            item.add_marker(pytest.mark.slow)
