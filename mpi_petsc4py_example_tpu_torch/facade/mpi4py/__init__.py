"""mpi4py facade package of the port (no MPI required; see MPI.py)."""

from . import MPI  # noqa: F401
