"""Set-up of every test process; ``tests/conftest.py`` is the JAX
package's suite's own.

- torch runs one intra-op thread: the xdist workers already share the
  host's cores, and torch's default of one thread per core in each of them
  oversubscribes the cores (the port's small solves slow down by over an
  order of magnitude). XLA's threads stay as they are.
- each test not marked ``slow`` has a time limit (``tests/time_limit.py``).
- the JAX package's slowest tests are marked ``slow`` by node ID
  (``tests/tier1_slow.py``), so the tier-1 run (``-m 'not slow'``) leaves
  them out and their files stay as they were.
"""
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).parent / "tests"))
from time_limit import (  # noqa: E402,F401
    pytest_configure,
    pytest_runtest_call,
    pytest_runtest_protocol,
    pytest_runtest_setup,
)
from tier1_slow import pytest_collection_modifyitems  # noqa: E402,F401
