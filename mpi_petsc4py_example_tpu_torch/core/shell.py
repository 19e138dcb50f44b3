"""Matrix-free shell operators: the PETSc ``MatShell``.

The port's counterpart of ``mpi_petsc4py_example_tpu/core/shell.py``
(``ShellMat``, ``:34-141``). A shell operator is a torch callable on the
whole unpadded global vector. The solve program lifts it to the
shard-stacked form with :func:`..parallel.mesh.full_vector_local_apply`
(gather the shards, apply, hand each shard its rows), so it composes with
every KSP type and preconditioner an assembled :class:`.mat.Mat` does.
Operators with a sharding-aware structure (a stencil's neighbour halos)
implement the operator protocol instead, as
:class:`..models.stencil.StencilPoisson3D` does.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..parallel.mesh import (DeviceComm, full_vector_local_apply,
                             torch_dtype)
from ..parallel.partition import RowLayout
from .vec import Vec

_uid = itertools.count(1)


class ShellMat:
    """Matrix-free operator defined by a user ``mult``.

    ``mult`` (and ``mult_transpose``, which the transpose KSP types lsqr,
    bicg and cgne need) maps the whole length-``n`` vector, a tensor on the
    communicator's device, to ``A x`` of the same length and dtype.
    ``diagonal`` (for PC jacobi) is a length-``n`` array or a callable
    returning one. ``shape`` is ``n`` or a square ``(n, n)``.
    """

    def __init__(self, comm: DeviceComm, shape, mult, mult_transpose=None,
                 diagonal=None, dtype=torch.float64):
        self.comm = comm
        if np.isscalar(shape):
            shape = (int(shape), int(shape))
        self.shape = (int(shape[0]), int(shape[1]))
        if self.shape[0] != self.shape[1]:
            raise ValueError(
                f"ShellMat must be square (row/column partitions coincide); "
                f"got {self.shape}")
        self._mult = mult
        self._mult_t = mult_transpose
        self._diagonal = diagonal
        self._dtype = torch_dtype(dtype)
        self.layout = RowLayout(self.shape[0], comm.size)
        self._key = ("shellmat", next(_uid))

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    # ---- Mat-shaped conveniences -------------------------------------------
    def get_vecs(self) -> tuple[Vec, Vec]:
        mk = lambda: Vec(self.comm, self.shape[0], dtype=self._dtype,
                         layout=self.layout)
        return mk(), mk()

    getVecs = get_vecs

    def diagonal(self) -> np.ndarray:
        if self._diagonal is None:
            raise ValueError(
                "this ShellMat provides no diagonal — pass diagonal= at "
                "construction to use PC 'jacobi'")
        d = self._diagonal() if callable(self._diagonal) else self._diagonal
        return np.asarray(d)

    def _apply(self, fn, x: Vec, y: Vec | None) -> Vec:
        ypad = full_vector_local_apply(fn, self.comm, self.shape[0])(
            x.data.view(self.comm.size, -1)).reshape(-1)
        if y is None:
            return Vec(self.comm, self.shape[0], data=ypad,
                       layout=self.layout)
        y.data = ypad
        return y

    def mult(self, x: Vec, y: Vec | None = None) -> Vec:
        """``y = A x`` (the solvers use :meth:`local_spmv` instead)."""
        return self._apply(self._mult, x, y)

    def mult_transpose(self, x: Vec, y: Vec | None = None) -> Vec:
        """``y = A^T x`` (MatMultTranspose for shell operators)."""
        if self._mult_t is None:
            raise ValueError(
                "this ShellMat provides no mult_transpose — pass it at "
                "construction")
        return self._apply(self._mult_t, x, y)

    multTranspose = mult_transpose

    # ---- the operator protocol the solvers consume ---------------------------
    def program_key(self):
        return self._key

    def local_spmv(self, comm: DeviceComm):
        return full_vector_local_apply(self._mult, comm, self.shape[0])

    def local_spmv_t(self, comm: DeviceComm):
        if self._mult_t is None:
            raise ValueError(
                "this ShellMat provides no mult_transpose — required by "
                "transpose-needing KSP types (lsqr/bicg/cgne)")
        return full_vector_local_apply(self._mult_t, comm, self.shape[0])

    def __repr__(self):
        return (f"ShellMat(shape={self.shape}, devices={self.comm.size}, "
                f"dtype={self._dtype})")
