"""Exception types the port raises.

The port's subset of ``mpi_petsc4py_example_tpu/utils/errors.py``: a device-side
failure surfaces as :class:`DeviceExecutionError`. Here that is a hand-written
CUDA kernel whose launch the runtime refused (``cudaGetLastError`` was not 0
right after the launch).
"""

from __future__ import annotations


class DeviceExecutionError(RuntimeError):
    """A device-side failure, naming what failed and the runtime's message."""

    def __init__(self, what: str, message: str):
        super().__init__(f"{what}: {message}")
        self.what = what
        self.message = message
