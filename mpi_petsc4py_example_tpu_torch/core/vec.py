"""Distributed vector: one padded tensor on the communicator's device.

The port's counterpart of ``mpi_petsc4py_example_tpu/core/vec.py`` (``Vec``).
Storage is a flat tensor of length ``comm.padded_size(n)``, whose view
``(comm.size, comm.local_size(n))`` is the shard axis; the user-visible
ownership ranges live in a :class:`RowLayout`. The BLAS-1 methods update
``data`` in place where JAX rebinds a new array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import DeviceComm, torch_dtype
from ..parallel.partition import RowLayout


class Vec:
    """Row-sharded distributed vector of logical length ``n``."""

    def __init__(self, comm: DeviceComm, n: int,
                 data: torch.Tensor | None = None, dtype=torch.float64,
                 layout: RowLayout | None = None):
        self.comm = comm
        self.n = int(n)
        self.layout = layout or RowLayout(self.n, comm.size)
        if data is None:
            data = torch.zeros(comm.padded_size(self.n),
                               dtype=torch_dtype(dtype), device=comm.device)
        elif data.shape != (comm.padded_size(self.n),):
            raise ValueError(f"Vec data must have shape "
                             f"({comm.padded_size(self.n)},), got "
                             f"{tuple(data.shape)}")
        self.data = data

    @classmethod
    def from_global(cls, comm: DeviceComm, arr, dtype=None,
                    layout: RowLayout | None = None) -> "Vec":
        arr = np.asarray(arr)
        return cls(comm, arr.shape[0], data=comm.put_rows(arr, dtype),
                   layout=layout)

    def duplicate(self) -> "Vec":
        """A zero Vec of the same layout (PETSc VecDuplicate)."""
        return Vec(self.comm, self.n, data=torch.zeros_like(self.data),
                   layout=self.layout)

    def copy(self) -> "Vec":
        return Vec(self.comm, self.n, data=self.data.clone(),
                   layout=self.layout)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def set_global(self, arr):
        self.data = self.comm.put_rows(np.asarray(arr), self.data.dtype)

    def to_numpy(self) -> np.ndarray:
        """Gather to host, dropping padding."""
        return self.comm.host_fetch(self.data)[: self.n]

    def zero(self):
        self.data.zero_()
        return self

    def norm(self) -> float:
        """2-norm (padding entries are zero, so the padded array is exact)."""
        return float(torch.linalg.vector_norm(self.data))

    def dot(self, other: "Vec") -> float:
        """PETSc VecDot(self, other) for real vectors."""
        return float(torch.dot(self.data, other.data))

    def axpy(self, alpha: float, other: "Vec"):
        """self += alpha * other."""
        self.data.add_(other.data, alpha=alpha)
        return self

    def aypx(self, alpha: float, other: "Vec"):
        """self = alpha * self + other."""
        self.data.mul_(alpha).add_(other.data)
        return self

    def waxpy(self, alpha: float, x: "Vec", y: "Vec"):
        """self = alpha * x + y (PETSc VecWAXPY)."""
        torch.add(y.data, x.data, alpha=alpha, out=self.data)
        return self

    def __len__(self):
        return self.n
