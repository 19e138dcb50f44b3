"""Preconditioners: PC ``none``, ``jacobi`` and ``mg``.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/pc.py`` (``PC``,
``:67``) for the three types the stencil slices run. On a uniform-diagonal
stencil operator the CG fast path never calls :meth:`PC.local_apply` for
jacobi: the Jacobi apply collapses to a scalar there (see
``krylov.cg_stencil_kernel``); PC ``mg`` enters it grid-shaped through
:meth:`PC.local_apply_grid3d`.
"""

from __future__ import annotations

import numpy as np

from .mg import make_vcycle, make_vcycle3d

PC_TYPES = ("none", "jacobi", "mg")


class PC:
    """Preconditioner object, petsc4py-``PC``-shaped."""

    def __init__(self, comm=None):
        self.comm = comm
        self._type = "none"
        self._mat = None
        # -pc_mg_smooth_type: 'chebyshev' (the Chebyshev-root omega schedule)
        # or 'jacobi' (fixed omega = 2/3); checked when the cycle is built
        self.mg_smoother = "chebyshev"

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

    def program_key(self) -> tuple:
        """The PC configuration as plain values, as the JAX ``PC.program_key``
        gives it: ``(type,)``, or ``("mg", smoother)``."""
        if self._type == "mg":
            return ("mg", self.mg_smoother)
        return (self._type,)

    def set_operators(self, mat):
        self._mat = mat
        return self

    def _mg_operator(self):
        """The operator the V-cycle is built for; raises ``ValueError`` when
        it is not a structured stencil operator (JAX ``pc.py:341-345``)."""
        op = self._mat
        if op is None:
            raise RuntimeError("PC mg: no operator set")
        if not all(hasattr(op, a) for a in ("nx", "ny", "nz")):
            raise ValueError(
                "PC 'mg' is the geometric multigrid V-cycle for "
                "structured stencil operators (models.StencilPoisson3D)")
        return op

    def local_apply(self, comm, n: int):
        """``z = M r`` on shard-stacked ``(size, lsize)`` tensors."""
        if self._type == "none":
            return lambda r: r
        if self._type == "mg":
            op = self._mg_operator()
            return make_vcycle(op.nz, op.ny, op.nx, comm=comm,
                               smoother=self.mg_smoother,
                               plain=getattr(op, "force_plain", False))
        inv_d = self._inv_diag(comm)
        return lambda r: r * inv_d

    def _inv_diag(self, comm):
        """The shard-stacked inverse diagonal ``(size, lsize)`` of the PC's
        operator (0 where the diagonal is 0)."""
        if self._mat is None:
            raise RuntimeError("PC jacobi: no operator set")
        diag = self._mat.diagonal()
        inv = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)
        return comm.put_rows(inv, self._mat.dtype).view(comm.size, -1)

    def local_apply_many(self, comm, n: int):
        """Batched ``Z = M R`` on ``(size, k, lsize)`` blocks (JAX
        ``pc.py:601``): the identity for none, the inverse diagonal broadcast
        over the column axis for jacobi, and None for mg, which has no
        batched apply (``KSP.solve_many`` then solves column by column)."""
        if self._type == "none":
            return lambda R: R
        if self._type == "mg":
            return None
        inv_d = self._inv_diag(comm)[:, None, :]
        return lambda R: R * inv_d

    def local_apply_grid3d(self, comm):
        """Grid-shaped apply ``z = M3(r)`` on ``(size, lz, ny, nx)`` tensors
        for the stencil-CG fast path, or None (JAX ``pc.py:641-657``). Only
        ``mg`` has one: the V-cycle; the diagonal kinds collapse to scalars
        there instead. The operator's ``force_plain`` switch sends the
        cycle's passes to their plain versions too."""
        if self._type != "mg":
            return None
        op = self._mg_operator()
        return make_vcycle3d(op.nz, op.ny, op.nx, comm=comm,
                             smoother=self.mg_smoother,
                             plain=getattr(op, "force_plain", False))

    def __repr__(self):
        return f"PC(type={self._type!r})"
