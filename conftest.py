"""Set-up of the PyTorch port's tests (``tests/test_torch_*.py``), in every
test process; ``tests/conftest.py`` is the JAX package's suite's own.

- torch runs one intra-op thread: the xdist workers already share the
  host's cores, and torch's default of one thread per core in each of them
  oversubscribes the cores (the port's small solves slow down by over an
  order of magnitude). XLA's threads stay as they are.
- each of the port's tests has a time limit (``tests/time_limit.py``).
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
