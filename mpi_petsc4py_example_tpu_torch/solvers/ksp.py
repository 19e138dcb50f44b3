"""KSP: the Krylov solver object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/ksp.py``
(``KSP``, ``:47``), reduced to what the CG slices run: ``create``,
``set_type``, ``get_pc``, ``set_operators``, ``set_tolerances``,
``set_norm_type``, ``set_from_options``, ``solve`` -> :class:`SolveResult`
and ``solve_many`` -> :class:`BatchedSolveResult` (petsc4py's
``KSP().create(comm)``, ``setType``, ``getPC``, ``setOperators``,
``setFromOptions``, ``solve(b, x)``, ``matSolve(B, X)``). A solve starts from
a zero guess.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core.vec import Vec
from ..parallel.mesh import numpy_dtype
from ..utils.convergence import BatchedSolveResult, ConvergedReason, SolveResult
from ..utils.options import global_options
from .krylov import (KSP_TYPES, batched_pc_supported, build_ksp_program,
                     build_ksp_program_many)
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
        # -ksp_batch_limit: at most this many columns per batched solve
        # (0: no limit)
        self.batch_limit = 0
        self.result = SolveResult()
        self.result_many = BatchedSolveResult()
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
        ``-ksp_atol``, ``-ksp_max_it``, ``-ksp_norm_type``,
        ``-ksp_batch_limit``, ``-pc_type``, ``-pc_mg_smooth_type``."""
        opt = global_options()
        t = opt.get_string("ksp_type")
        if t:
            self.set_type(t)
        self.rtol = opt.get_real("ksp_rtol", self.rtol)
        self.atol = opt.get_real("ksp_atol", self.atol)
        self.max_it = opt.get_int("ksp_max_it", self.max_it)
        self.batch_limit = opt.get_int("ksp_batch_limit", self.batch_limit)
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

    def _run_tolerances(self):
        """``(norm_none, rtol, atol, divtol)`` as the loop takes them: the
        norm type none turns off the convergence test."""
        if self._norm_type == "none":
            return True, 0.0, 0.0, 0.0
        return False, self.rtol, self.atol, self.divtol

    def solve(self, b, x) -> SolveResult:
        """Solve ``A x = b``; the solution is written into ``x``."""
        mat = self._mat
        if mat is None:
            raise RuntimeError("KSP.solve: no operators set")
        norm_none, rtol, atol, divtol = self._run_tolerances()
        prog = build_ksp_program(mat.comm, self._type, self.get_pc(), mat)
        t0 = time.perf_counter()
        xd, iters, rnorm, reason, syncs = prog(
            b.data, torch.zeros_like(b.data), rtol, atol, divtol, self.max_it)
        x.data = xd
        wall = time.perf_counter() - t0
        self.result = SolveResult(iters, rnorm,
                                  _final_reason(reason, rnorm, norm_none),
                                  wall, syncs)
        return self.result

    def solve_many(self, B, X=None) -> BatchedSolveResult:
        """Solve ``A X = B`` for a block of ``k`` right-hand sides (PETSc's
        ``KSPMatSolve``; JAX ``ksp.py:1471``), each from a zero guess.

        ``B`` is an ``(n, k)`` host array or a list of ``k`` Vecs; ``X`` is
        None, an ``(n, k)`` host array or a list of ``k`` Vecs, and receives
        the solution. Returns per-column iterations, residual norms and
        reasons; a column that converges early freezes while the others run
        on.

        CG with PC none/jacobi and norm type default/none runs the ``k``
        recurrences in lockstep: one kernel pass per shard and one reduction
        per phase serve every column. Other configurations (PC mg) solve the
        columns one by one. ``batch_limit`` (``-ksp_batch_limit``) splits a
        wider block into batched solves of at most that many columns.
        """
        mat = self._mat
        if mat is None:
            raise RuntimeError("KSP.solve_many: no operators set")
        n = mat.shape[0]
        b_vecs = _is_vec_list(B)
        if isinstance(B, (list, tuple)) and not b_vecs:
            B = np.stack([b.to_numpy() if isinstance(b, Vec)
                          else np.asarray(b) for b in B], axis=1) \
                if B else np.zeros((n, 0))
        shape = (_vec_rows(B), len(B)) if b_vecs else np.shape(B)
        if len(shape) != 2 or shape[0] != n:
            raise ValueError(f"KSP.solve_many: B must be ({n}, nrhs), got "
                             f"{shape}")
        k = shape[1]
        if k == 0:
            raise ValueError("KSP.solve_many: empty RHS block (nrhs=0)")
        x_vecs = isinstance(X, (list, tuple))
        if X is None:
            X = np.zeros((n, k), dtype=numpy_dtype(mat.dtype))
        elif not x_vecs:
            X = np.asarray(X)
        x_shape = (_vec_rows(X), len(X)) if x_vecs else X.shape
        if x_shape != tuple(shape):
            raise ValueError(f"KSP.solve_many: X shape {x_shape} != B shape "
                             f"{tuple(shape)}")
        limit = int(self.batch_limit)
        if 0 < limit < k:
            return self._solve_many_chunked(B, X, k, limit, b_vecs, x_vecs)
        pc = self.get_pc()
        if not (self._type == "cg" and batched_pc_supported(pc)
                and self._norm_type in ("default", "none")):
            return self._solve_many_sequential(B, X, k, b_vecs, x_vecs)
        comm = mat.comm
        norm_none, rtol, atol, divtol = self._run_tolerances()
        prog = build_ksp_program_many(comm, self._type, pc, mat)
        # one placement of the block: stacked on the card from Vecs, or
        # transposed on the host and copied once
        Bd = (torch.stack([b.data.view(comm.size, -1) for b in B],
                          dim=1).to(mat.dtype)
              if b_vecs else comm.put_cols(B, mat.dtype))
        t0 = time.perf_counter()
        Xd, iters, rnorms, reasons, syncs = prog(
            Bd, torch.zeros_like(Bd), rtol, atol, divtol, self.max_it)
        if x_vecs:
            for j, xv in enumerate(X):
                xv.data = Xd[:, j].reshape(-1).to(xv.dtype)
        else:
            X[...] = comm.fetch_cols(Xd, n)
        wall = time.perf_counter() - t0
        reasons = [_final_reason(r, rn, norm_none)
                   for r, rn in zip(reasons, rnorms)]
        self.result_many = BatchedSolveResult(
            iters, rnorms, reasons, wall, X, [[] for _ in range(k)], syncs)
        return self.result_many

    def _solve_many_chunked(self, B, X, k, limit, b_vecs, x_vecs):
        """``-ksp_batch_limit``: ceil(k / limit) batched solves."""
        res = BatchedSolveResult(X=X)
        t0 = time.perf_counter()
        for s in range(0, k, limit):
            sl = slice(s, min(s + limit, k))
            sub = self.solve_many(B[sl] if b_vecs else B[:, sl],
                                  X[sl] if x_vecs else X[:, sl])
            res.iterations += sub.iterations
            res.residual_norms += sub.residual_norms
            res.reasons += sub.reasons
            res.histories += sub.histories
            res.host_syncs += sub.host_syncs
        res.wall_time = time.perf_counter() - t0
        self.result_many = res
        return res

    def _solve_many_sequential(self, B, X, k, b_vecs, x_vecs):
        """The columns one by one through :meth:`solve`, for configurations
        without a batched kernel (PC mg); the same per-column results."""
        mat = self._mat
        res = BatchedSolveResult(X=X)
        t0 = time.perf_counter()
        for j in range(k):
            bv = B[j] if b_vecs else Vec.from_global(
                mat.comm, B[:, j], dtype=mat.dtype, layout=mat.layout)
            xv = X[j] if x_vecs else Vec(mat.comm, mat.shape[0],
                                         dtype=mat.dtype, layout=mat.layout)
            sub = self.solve(bv, xv)
            if not x_vecs:
                X[:, j] = xv.to_numpy()
            res.iterations.append(sub.iterations)
            res.residual_norms.append(sub.residual_norm)
            res.reasons.append(sub.reason)
            res.histories.append([])
            res.host_syncs += sub.host_syncs
        res.wall_time = time.perf_counter() - t0
        self.result_many = res
        return res
    def __repr__(self):
        return (f"KSP(type={self._type!r}, pc={self.get_pc().get_type()!r}, "
                f"rtol={self.rtol:g}, max_it={self.max_it})")


def _final_reason(reason, rnorm, norm_none):
    """The reported reason: a NaN/Inf residual exits as DIVERGED_MAX_IT (NaN
    fails every comparison), reported as the blow-up it is; KSP_NORM_NONE
    has no norm to classify, and keeps breakdown visible."""
    if not norm_none and not math.isfinite(rnorm):
        return ConvergedReason.DIVERGED_NANORINF
    if norm_none and reason != ConvergedReason.DIVERGED_BREAKDOWN:
        return ConvergedReason.CONVERGED_ITS
    return reason


def _is_vec_list(block) -> bool:
    return (isinstance(block, (list, tuple)) and bool(block)
            and all(isinstance(v, Vec) for v in block))


def _vec_rows(vecs) -> int:
    """The common length of a list of Vecs; raises ``ValueError`` when they
    differ."""
    rows = {v.n for v in vecs}
    if len(rows) != 1:
        raise ValueError(f"KSP.solve_many: the Vecs of a block must have one "
                         f"length, got {sorted(rows)}")
    return rows.pop()
