"""KSP: the Krylov solver object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/ksp.py``
(``KSP``, ``:47``), reduced to what the CG slices run: ``create``,
``set_type``, ``get_pc``, ``set_operators``, ``set_tolerances``,
``set_norm_type``, ``set_from_options`` and ``solve`` -> :class:`SolveResult`
(petsc4py's ``KSP().create(comm)``, ``setType``, ``getPC``, ``setOperators``,
``setFromOptions``, ``solve(b, x)``). A solve starts from a zero guess.
"""

from __future__ import annotations

import math
import time

import torch

from ..utils.convergence import ConvergedReason, SolveResult
from ..utils.options import global_options
from .krylov import KSP_TYPES, build_ksp_program
from .pc import PC

DEFAULT_RTOL = 1e-5   # PETSc's KSP default
DEFAULT_ATOL = 1e-50
DEFAULT_DIVTOL = 1e5  # PETSc's KSP dtol default (DIVERGED_DTOL trigger)
DEFAULT_MAX_IT = 10000

# 'default' and 'unpreconditioned' are the norm CG monitors (||r||);
# 'none' disables the convergence test: max_it iterations, CONVERGED_ITS
_NORM_TYPES = ("default", "none", "unpreconditioned")
_NORM_BY_INT = {-1: "default", 0: "none", 2: "unpreconditioned"}


class KSP:
    """Krylov solver context."""

    def __init__(self, comm=None):
        self.comm = None
        self._type = "cg"             # the one type this slice ports
        self._pc: PC | None = None
        self._mat = None
        self.rtol = DEFAULT_RTOL
        self.atol = DEFAULT_ATOL
        self.divtol = DEFAULT_DIVTOL
        self.max_it = DEFAULT_MAX_IT
        self._norm_type = "default"
        self.result = SolveResult()
        if comm is not None:
            self.create(comm)

    def create(self, comm=None):
        self.comm = comm
        self._pc = PC(comm)
        return self

    def set_type(self, ksp_type: str):
        ksp_type = str(ksp_type).lower()
        if ksp_type not in KSP_TYPES:
            raise ValueError(f"unknown KSP type {ksp_type!r}; available: "
                             f"{list(KSP_TYPES)}")
        self._type = ksp_type
        return self

    setType = set_type

    def get_type(self) -> str:
        return self._type

    getType = get_type

    def get_pc(self) -> PC:
        if self._pc is None:
            self._pc = PC(self.comm)
        return self._pc

    getPC = get_pc

    def set_operators(self, A, P_mat=None):
        self._mat = A
        if self.comm is None:
            self.create(A.comm)
        self.get_pc().set_operators(P_mat if P_mat is not None else A)
        return self

    setOperators = set_operators

    def set_tolerances(self, rtol=None, atol=None, divtol=None, max_it=None):
        if rtol is not None:
            self.rtol = float(rtol)
        if atol is not None:
            self.atol = float(atol)
        if divtol is not None:
            self.divtol = float(divtol)
        if max_it is not None:
            self.max_it = int(max_it)
        return self

    setTolerances = set_tolerances

    def set_norm_type(self, norm_type):
        if isinstance(norm_type, int):
            norm_type = _NORM_BY_INT.get(norm_type, norm_type)
        t = str(norm_type).lower().replace("ksp_norm_", "")
        if t not in _NORM_TYPES:
            raise ValueError(f"norm type {norm_type!r} is not available for "
                             f"KSP 'cg' here; use one of {_NORM_TYPES}")
        self._norm_type = t
        return self

    setNormType = set_norm_type

    def get_norm_type(self) -> str:
        return "unpreconditioned" if self._norm_type == "default" \
            else self._norm_type

    getNormType = get_norm_type

    def set_from_options(self):
        """Apply the options database: ``-ksp_type``, ``-ksp_rtol``,
        ``-ksp_atol``, ``-ksp_max_it``, ``-ksp_norm_type``, ``-pc_type``,
        ``-pc_mg_smooth_type``."""
        opt = global_options()
        t = opt.get_string("ksp_type")
        if t:
            self.set_type(t)
        self.rtol = opt.get_real("ksp_rtol", self.rtol)
        self.atol = opt.get_real("ksp_atol", self.atol)
        self.max_it = opt.get_int("ksp_max_it", self.max_it)
        nt = opt.get_string("ksp_norm_type")
        if nt:
            self.set_norm_type(nt)
        pct = opt.get_string("pc_type")
        if pct:
            self.get_pc().set_type(pct)
        mst = opt.get_string("pc_mg_smooth_type")
        if mst:                       # 'chebyshev' | 'jacobi' (solvers/mg)
            self.get_pc().mg_smoother = mst
        return self

    setFromOptions = set_from_options

    def solve(self, b, x) -> SolveResult:
        """Solve ``A x = b``; the solution is written into ``x``."""
        mat = self._mat
        if mat is None:
            raise RuntimeError("KSP.solve: no operators set")
        norm_none = self._norm_type == "none"
        rtol, atol, divtol = self.rtol, self.atol, self.divtol
        if norm_none:
            rtol, atol, divtol = 0.0, 0.0, 0.0
        prog = build_ksp_program(mat.comm, self._type, self.get_pc(), mat)
        t0 = time.perf_counter()
        xd, iters, rnorm, reason, syncs = prog(
            b.data, torch.zeros_like(b.data), rtol, atol, divtol, self.max_it)
        x.data = xd
        wall = time.perf_counter() - t0
        # a NaN/Inf residual exits as DIVERGED_MAX_IT (NaN fails every
        # comparison); report it as the blow-up it is. KSP_NORM_NONE has no
        # norm to classify, and keeps breakdown visible.
        if not norm_none and not math.isfinite(rnorm):
            reason = ConvergedReason.DIVERGED_NANORINF
        if norm_none and reason != ConvergedReason.DIVERGED_BREAKDOWN:
            reason = ConvergedReason.CONVERGED_ITS
        self.result = SolveResult(iters, rnorm, reason, wall, syncs)
        return self.result

    def __repr__(self):
        return (f"KSP(type={self._type!r}, pc={self.get_pc().get_type()!r}, "
                f"rtol={self.rtol:g}, max_it={self.max_it})")
