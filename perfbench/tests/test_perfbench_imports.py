"""What the benchmark may import: no JAX and no JAX package anywhere under
perfbench/, compared by whole top-level name (the port's name begins with
the JAX package's); and nothing of the program in the reference."""
import ast

import pytest

from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "fem_shell_tpu"}
SOURCES = sorted((ROOT / "perfbench").rglob("*.py"))


def top_level_imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_names_compared():
    assert "fem_shell_tpu_torch" not in FORBIDDEN
    assert any("fem_shell_tpu_torch" in top_level_imports(p) for p in SOURCES)


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            mods = [node.module]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top in {"__future__", "math", "torch"} or mod.startswith("perfbench.reference"), mod
