"""The per-test time limit of the tier-1 run (``time_limit.py``), held
in an inner session whose limit is 1 s and backstop 2 s later: a test
that loops in Python, in the port's files or outside them, and a test
that blocks in C fail with their names and thread stacks, a test that
never lets the limit's signal in is ended by the backstop (its xdist
worker is replaced), the tests after them still run, a tear-down that
runs past the limit is not cut, and a test marked ``slow`` runs past the
limit."""
import pathlib

pytest_plugins = ("pytester",)

TESTS = pathlib.Path(__file__).parent

REFERENCE_TESTS = """
import time


def test_not_a_port_test():
    while True:
        pass


def test_after_it():
    time.sleep(0.1)
"""

INNER_TESTS = """
import queue
import signal
import time

import pytest


def test_loops_in_python():
    while True:
        pass


def test_blocks_in_c():
    queue.Queue().get()


def test_shuts_the_signal_out():
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGALRM})
    time.sleep(60)


def test_after_them():
    time.sleep(0.1)


@pytest.fixture
def slow_teardown():
    yield
    time.sleep(1.5)


def test_teardown_past_the_limit(slow_teardown):
    pass


@pytest.mark.slow
def test_marked_slow():
    time.sleep(1.5)
"""


def test_limit_fails_slow_tests_and_the_run_goes_on(pytester):
    pytester.makeconftest(f"""
import sys
sys.path.insert(0, {str(TESTS)!r})
import time_limit
time_limit.TEST_TIME_LIMIT_S = 1
time_limit.BACKSTOP_S = 2
from time_limit import pytest_configure, pytest_runtest_call, pytest_runtest_protocol, pytest_runtest_setup
""")
    pytester.makepyfile(test_torch_inner=INNER_TESTS,
                        test_reference=REFERENCE_TESTS)
    result = pytester.runpytest_subprocess("-p", "xdist", "-n", "1", "-p", "no:cacheprovider",
                                           "-p", "no:randomly", timeout=120)
    result.assert_outcomes(passed=4, failed=4)
    out = result.stdout.str()
    for nodeid in ("test_torch_inner.py::test_loops_in_python", "test_torch_inner.py::test_blocks_in_c",
                   "test_reference.py::test_not_a_port_test"):
        assert f"{nodeid} passed its time limit of 1 s" in out
    assert "--- thread MainThread" in out
    assert "in test_not_a_port_test" in out  # the stack at the limit shows the loop's frame
    assert "crashed while running 'test_torch_inner.py::test_shuts_the_signal_out'" in out
    assert "Timeout (0:00:03)!" in result.stderr.str()  # the backstop's dump of the stacks
