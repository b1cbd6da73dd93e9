"""CPU tests of the benchmark, and its card-marked tests (see ../README.md)."""
