"""Preconditioners: PC ``none`` and ``jacobi``.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/pc.py`` (``PC``,
``:67``) for the two types the CG slice runs. On a uniform-diagonal stencil
operator the CG fast path never calls :meth:`PC.local_apply`: the Jacobi apply
collapses to a scalar there (see ``krylov.cg_stencil_kernel``).
"""

from __future__ import annotations

import numpy as np

PC_TYPES = ("none", "jacobi")


class PC:
    """Preconditioner object, petsc4py-``PC``-shaped."""

    def __init__(self, comm=None):
        self.comm = comm
        self._type = "none"
        self._mat = None

    def set_type(self, pc_type: str):
        pc_type = str(pc_type).lower()
        if pc_type not in PC_TYPES:
            raise ValueError(f"unknown PC type {pc_type!r}; available: "
                             f"{PC_TYPES}")
        self._type = pc_type
        return self

    setType = set_type

    def get_type(self) -> str:
        return self._type

    getType = get_type

    def set_operators(self, mat):
        self._mat = mat
        return self

    def local_apply(self, comm, n: int):
        """``z = M r`` on shard-stacked ``(size, lsize)`` tensors."""
        if self._type == "none":
            return lambda r: r
        if self._mat is None:
            raise RuntimeError("PC jacobi: no operator set")
        diag = self._mat.diagonal()
        inv = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)
        inv_d = comm.put_rows(inv, self._mat.dtype).view(comm.size, -1)
        return lambda r: r * inv_d

    def __repr__(self):
        return f"PC(type={self._type!r})"
