"""MatNullSpace: the null space of a singular operator.

The port's copy of ``mpi_petsc4py_example_tpu/core/nullspace.py``. A null
space attached to a matrix (``Mat.set_nullspace``) lets the Krylov loops
solve a compatible singular system, the pure-Neumann Poisson operator whose
null space is the constant vector being the canonical case: the solve
program removes the null-space component from the right-hand side, the
initial guess and every operator and preconditioner output
(``solvers/krylov.py``), with one reduction of the ``(k, n)`` basis against
the vector.

The basis is orthonormalized on the host (QR) once per size and placed on
the communicator's device as a ``(k, n_pad)`` tensor, zero in the padding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import torch_dtype


class NullSpace:
    """petsc4py-``NullSpace``-shaped: ``create(constant=..., vectors=...)``."""

    def __init__(self, constant: bool = False, vectors=()):
        self._constant = bool(constant)
        self._vectors = [np.asarray(getattr(v, "to_numpy", lambda: v)())
                         for v in vectors]
        self._built = None      # ((comm, n, dtype), basis tensor)

    @classmethod
    def create(cls, constant: bool = False, vectors=(), comm=None):
        """``comm`` is accepted for petsc4py's signature; the communicator
        is the matrix's at solve time."""
        return cls(constant=constant, vectors=vectors)

    @property
    def dim(self) -> int:
        return int(self._constant) + len(self._vectors)

    def has_constant(self) -> bool:
        return self._constant

    hasConstant = has_constant

    def basis_host(self, n: int) -> np.ndarray:
        """The orthonormal ``(k, n)`` host basis of the null space."""
        cols = []
        if self._constant:
            cols.append(np.ones(n))
        for v in self._vectors:
            if v.shape[0] != n:
                raise ValueError(
                    f"null-space vector has length {v.shape[0]}, matrix "
                    f"needs {n}")
            cols.append(np.asarray(v, dtype=np.float64))
        if not cols:
            raise ValueError("empty null space: pass constant=True and/or "
                             "vectors")
        Q, R = np.linalg.qr(np.stack(cols, axis=1))
        if np.any(np.abs(np.diag(R)) < 1e-12 * max(1.0, np.abs(R).max())):
            raise ValueError("null-space vectors are linearly dependent")
        return Q.T

    def device_array(self, comm, n: int, dtype) -> torch.Tensor:
        """The ``(k, n_pad)`` orthonormal basis on ``comm``'s device in
        ``dtype``, zero in the padding (made once per communicator, size and
        dtype)."""
        dt = torch_dtype(dtype)
        key = (comm, n, dt)
        if self._built is not None and self._built[0] == key:
            return self._built[1]
        Q = self.basis_host(n)
        Qp = np.zeros((Q.shape[0], comm.padded_size(n)))
        Qp[:, :n] = Q
        arr = torch.tensor(Qp, dtype=dt, device=comm.device)
        self._built = (key, arr)
        return arr

    def remove(self, v: np.ndarray) -> np.ndarray:
        """Host projection: ``v`` minus its null-space component."""
        Q = self.basis_host(v.shape[0])
        return v - Q.T @ (Q @ v)

    def test(self, mat) -> bool:
        """True if ``A q`` is about zero for every basis vector (petsc4py's
        ``ns.test``)."""
        A = mat.to_scipy()
        Q = self.basis_host(mat.shape[0])
        r = np.linalg.norm(A @ Q.T, axis=0)
        scale = abs(A).sum() / max(mat.shape[0], 1)
        return bool(np.all(r <= 1e-10 * max(scale, 1.0)))

    def __repr__(self):
        return (f"NullSpace(constant={self._constant}, "
                f"extra_vectors={len(self._vectors)})")
