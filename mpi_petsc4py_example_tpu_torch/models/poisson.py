"""Poisson model problems: scipy CSR matrices, the oracle for the tests, and
the operators built directly in ELL.

The port's copy of ``mpi_petsc4py_example_tpu/models/poisson.py``. Row
ordering is x-fastest (``index = x + nx*(y + ny*z)``), the ordering
:class:`..models.stencil.StencilPoisson3D` shares, so the CSR matrix is the
stencil operator written out. :func:`poisson3d_ell`/:func:`poisson2d_ell`
build the distributed :class:`..core.mat.Mat` from vectorized numpy
neighbour arrays, with no scipy matrix in between (JAX ``:66-110``); such a
Mat keeps no host CSR and takes the ELL product route.
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


def _neighbor_ell(coords, dims, strides, dtype):
    """Vectorized ELL arrays ``(cols, vals)`` of the axis-aligned stencil
    with Dirichlet boundaries: slot 0 the diagonal ``2 * ndim``, then the
    -1/+1 neighbours of each axis (padding slots are ``(0, 0.0)``)."""
    n = coords[0].size
    ndim = len(dims)
    K = 2 * ndim + 1
    cols = np.zeros((n, K), dtype=np.int32)
    vals = np.zeros((n, K), dtype=dtype)
    idx = np.arange(n, dtype=np.int64)
    cols[:, 0] = idx
    vals[:, 0] = 2.0 * ndim
    slot = 1
    for d in range(ndim):
        for step in (-1, +1):
            valid = (coords[d] + step >= 0) & (coords[d] + step < dims[d])
            cols[:, slot] = np.where(valid, idx + step * strides[d], 0)
            vals[:, slot] = np.where(valid, -1.0, 0.0)
            slot += 1
    return cols, vals


def _ell_mat(comm, n, cols, vals, dtype):
    from ..core.mat import Mat
    from ..parallel.mesh import as_comm, numpy_dtype, torch_dtype
    comm = as_comm(comm)
    dt = torch_dtype(dtype)
    m = Mat(comm, (n, n), comm.put_rows(cols),
            comm.put_rows(vals.astype(numpy_dtype(dt)), dt))
    m.assemble()
    return m


def poisson3d_ell(comm, nx: int, ny: int | None = None,
                  nz: int | None = None, dtype=np.float64):
    """The 3D 7-point Poisson operator built directly in ELL (JAX
    ``poisson.py:66``)."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    cols, vals = _neighbor_ell((idx % nx, (idx // nx) % ny, idx // (nx * ny)),
                               (nx, ny, nz), (1, nx, nx * ny), np.float64)
    return _ell_mat(comm, n, cols, vals, dtype)


def poisson2d_ell(comm, nx: int, ny: int | None = None, dtype=np.float64):
    """The 2D 5-point Poisson operator built directly in ELL (JAX
    ``poisson.py:93``)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    cols, vals = _neighbor_ell((idx % nx, idx // nx), (nx, ny), (1, nx),
                               np.float64)
    return _ell_mat(comm, n, cols, vals, dtype)
