"""Poisson model problems as scipy CSR matrices: the oracle for the tests.

The port's copy of the CSR constructors of ``mpi_petsc4py_example_tpu/models/
poisson.py``. Row ordering is x-fastest (``index = x + nx*(y + ny*z)``), the
ordering :class:`..models.stencil.StencilPoisson3D` shares, so the CSR matrix
is the stencil operator written out.
"""

from __future__ import annotations

import numpy as np


def poisson1d_csr(n: int):
    import scipy.sparse as sp
    return sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1], format="csr")


def poisson2d_csr(nx: int, ny: int | None = None):
    import scipy.sparse as sp
    ny = ny or nx
    Tx, Ty = poisson1d_csr(nx), poisson1d_csr(ny)
    Ix, Iy = sp.eye(nx), sp.eye(ny)
    return (sp.kron(Iy, Tx) + sp.kron(Ty, Ix)).tocsr()


def poisson3d_csr(nx: int, ny: int | None = None, nz: int | None = None):
    """The 7-point 3D Dirichlet Poisson matrix (diagonal 6) in CSR."""
    import scipy.sparse as sp
    ny = ny or nx
    nz = nz or nx
    A2 = poisson2d_csr(nx, ny)
    Tz = poisson1d_csr(nz)
    return (sp.kron(sp.eye(nz), A2) + sp.kron(Tz, sp.eye(nx * ny))).tocsr()
