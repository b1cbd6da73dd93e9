"""The coupled solver (the ``FEM-shell-precice`` and ``FluidSolver`` analogs):
a preCICE-style participant API, serial-implicit scheme, IQN-ILS, nearest-
neighbour mapping and m2n transports on the host, and the structure solve
on the device. Port of ``fem_shell_tpu/coupling``."""
