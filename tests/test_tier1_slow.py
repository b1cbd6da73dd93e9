"""The tests that ``tier1_slow.py`` marks ``slow`` from the root
``conftest.py``: every entry names a collected test, so a renamed or
re-parametrised test cannot fall back into the tier-1 run; a listed
test, or every case of a test listed without its parameters, is marked
and left out by ``-m 'not slow'``; and no test of the port is listed."""
import os
import pathlib
import subprocess
import sys

from tier1_slow import SLOW_NODE_IDS, listed

pytest_plugins = ("pytester",)

REPO = pathlib.Path(__file__).parent.parent


def test_every_listed_test_is_collected_as_slow():
    files = sorted({node_id.split("::", 1)[0] for node_id in SLOW_NODE_IDS})
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m", "slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", *files],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    collected = [line for line in out.stdout.splitlines() if "::" in line]
    unmatched = [n for n in SLOW_NODE_IDS if not any(listed(c, (n,)) for c in collected)]
    assert not unmatched, f"listed but not collected as slow: {unmatched}"


def test_no_port_test_is_listed():
    assert not [n for n in SLOW_NODE_IDS if "/test_torch_" in n]


def test_marks_listed_tests_and_every_case_of_a_bare_name(pytester):
    pytester.makeconftest(f"""
import sys
sys.path.insert(0, {str(REPO / "tests")!r})
import tier1_slow
tier1_slow.SLOW_NODE_IDS = ("test_a.py::test_plain", "test_a.py::test_cases[2]", "test_a.py::test_all")
from tier1_slow import pytest_collection_modifyitems
""")
    pytester.makeini("[pytest]\nmarkers =\n    slow: long-running\n")
    pytester.makepyfile(test_a="""
import pytest


def test_plain():
    pass


@pytest.mark.parametrize("n", [1, 2])
def test_cases(n):
    pass


@pytest.mark.parametrize("n", [1, 2])
def test_all(n):
    pass


def test_other():
    pass
""")
    slow = pytester.runpytest_subprocess("--collect-only", "-q", "-m", "slow",
                                         "-p", "no:cacheprovider", "-p", "no:randomly")
    assert [line for line in slow.outlines if "::" in line] == [
        "test_a.py::test_plain", "test_a.py::test_cases[2]", "test_a.py::test_all[1]", "test_a.py::test_all[2]"]
    rest = pytester.runpytest_subprocess("-m", "not slow", "-p", "no:cacheprovider", "-p", "no:randomly")
    rest.assert_outcomes(passed=2, deselected=4)
