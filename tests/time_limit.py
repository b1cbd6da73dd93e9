"""A time limit for each test of the tier-1 run, without a plugin: the
repository's root ``conftest.py`` imports the hooks below. A test marked
``slow`` gets none (long by design, and outside the tier-1 run;
``tier1_slow.py`` marks the JAX package's slowest tests).

A test's set-up and call together get ``TEST_TIME_LIMIT_S``. At the limit
``SIGALRM`` fails the test with its name and the stacks of all its
process's threads; the alarm is armed only while the test's own set-up
or call runs, so the failure is raised in the test's code, never in
pytest's reporting or in a tear-down: its fixtures (a ``DeviceMesh``
among them) tear down to the end, and the run goes on. A test blocked in
C code that never returns to the interpreter (an XLA compile, a
rendezvous, a gloo wait, a ``join``) never sees that signal:
``BACKSTOP_S`` later, counted from the start of its set-up,
``faulthandler`` dumps every thread's stack and ends the process. Under
xdist the run then reports the test as crashed and starts a new worker;
the rank processes the test spawned see their controller gone and exit
(``parallel/comm.py``, ``rank_main``).
"""
import contextlib
import faulthandler
import os
import signal
import sys
import threading
import time
import traceback

import pytest

# over three times the slowest test left in the tier-1 run (the xdist workers
# busy on every core, JAX's compilation cache empty)
TEST_TIME_LIMIT_S = 300
# how long a test may go on past its limit before its process is ended
BACKSTOP_S = 60

# the real standard error, for the backstop's dump (set in pytest_configure)
_stderr_fd = 2
# when the running test passes its limit (None: it has none)
_deadline = None


def pytest_configure(config):
    """Keep a descriptor of the real standard error: during a test pytest
    captures descriptor 2."""
    global _stderr_fd
    capman = config.pluginmanager.getplugin("capturemanager")
    with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
        _stderr_fd = os.dup(2)


def _thread_stacks(frame) -> str:
    """The stack of every thread, the interrupted ``frame`` for this one."""
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    out = []
    for ident, top in sys._current_frames().items():
        stack = traceback.format_stack(frame if ident == me else top)
        out.append(f"--- thread {names.get(ident, ident)}\n{''.join(stack)}")
    return "\n".join(out)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    global _deadline
    if item.get_closest_marker("slow"):
        return (yield)
    _deadline = time.monotonic() + TEST_TIME_LIMIT_S
    faulthandler.dump_traceback_later(TEST_TIME_LIMIT_S + BACKSTOP_S, exit=True, file=_stderr_fd)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        _deadline = None


@contextlib.contextmanager
def _alarm(item):
    """``SIGALRM`` at the test's deadline, while the block runs. Signals
    reach the main thread only; elsewhere the backstop alone holds."""
    if _deadline is None or threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} passed its time limit of {TEST_TIME_LIMIT_S} s\n\n{_thread_stacks(frame)}",
                    pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, max(_deadline - time.monotonic(), 1e-3))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _alarm(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _alarm(item):
        return (yield)
