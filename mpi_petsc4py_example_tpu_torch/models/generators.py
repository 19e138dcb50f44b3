"""Problem generators of the reference drivers' model families.

The port's copy of ``mpi_petsc4py_example_tpu/models/generators.py``:

* :func:`random_system`: the manufactured-solution system of the reference
  ``test.py`` (seeded ``scipy.sparse.random``, exact ``X``, ``B = A X``);
* :func:`tridiag_family`: the symmetric tridiagonal family of ``test2.py``
  (band values ``i + j + 1``);
* :func:`convdiff2d`: unsymmetric 2D convection-diffusion (the benchmark's
  BiCGStab configuration).
"""

from __future__ import annotations

import numpy as np


def random_system(n: int = 100, seed: int = 42, density: float = 0.1):
    """Seeded random CSR system with a manufactured solution: A, X, B = A X."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed=seed)
    A = sp.random(n, n, density=density, format="csr", dtype=np.float64,
                  random_state=rng)
    X = rng.random(n)
    B = A.dot(X)
    return A, X, B


def tridiag_family(n: int = 100):
    """Symmetric tridiagonal matrix with ``A[i, j] = i + j + 1`` on the band."""
    import scipy.sparse as sp
    i = np.arange(n)
    main = 2.0 * i + 1.0
    off = i[:-1] + i[1:] + 1.0
    return sp.diags([off, main, off], [-1, 0, 1], format="csr")


def convdiff2d(nx: int, ny: int | None = None, beta: float = 0.3):
    """2D convection-diffusion: the 5-point Laplacian plus first-order
    convection of strength ``beta`` (nonzero makes it unsymmetric)."""
    import scipy.sparse as sp
    ny = ny or nx
    n = nx * ny
    x = np.arange(n) % nx
    east = np.where(x[:-1] + 1 < nx, -1.0 + beta, 0.0)
    west = np.where(x[1:] - 1 >= 0, -1.0 - beta, 0.0)
    north = -np.ones(n - nx)
    south = -np.ones(n - nx)
    return sp.diags([west, 4.0 * np.ones(n), east, south, north],
                    [-1, 0, 1, -nx, nx], format="csr")
