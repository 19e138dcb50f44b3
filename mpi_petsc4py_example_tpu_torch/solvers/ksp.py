"""KSP: the Krylov solver object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/ksp.py``
(``KSP``, ``:47``): ``create``, ``set_type`` (cg, gmres, bcgs, preonly),
``get_pc``, ``set_operators``, ``set_tolerances``, ``set_norm_type``,
``set_true_residual_check``, ``set_from_options``, ``set_up``, ``solve`` ->
:class:`SolveResult` and ``solve_many`` -> :class:`BatchedSolveResult`
(petsc4py's ``KSP().create(comm)``, ``setType``, ``getPC``,
``setOperators``, ``setFromOptions``, ``setUp``, ``solve(b, x)``,
``matSolve(B, X)``). A solve starts from a zero guess; only the re-entries
of the true-residual gate start from the current iterate.

A bfloat16 operator runs the mixed-precision plan (``solvers/cg_plans.py``):
its tolerance scalars travel in ``utils.dtypes.tolerance_dtype``, fp32 (JAX
``ksp.py:734-738``), and its host blocks as float32.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core.vec import Vec
from ..parallel.mesh import numpy_dtype
from ..utils.convergence import BatchedSolveResult, ConvergedReason, SolveResult
from ..utils.dtypes import tolerance_dtype
from ..utils.options import global_options
from .krylov import (KSP_TYPES, batched_pc_supported, build_ksp_program,
                     build_ksp_program_many)
from .pc import PC

DEFAULT_RTOL = 1e-5   # PETSc's KSP default
DEFAULT_ATOL = 1e-50
DEFAULT_DIVTOL = 1e5  # PETSc's KSP dtol default (DIVERGED_DTOL trigger)
DEFAULT_MAX_IT = 10000

# petsc4py's integer KSP.NormType values; 'natural' is not ported
_NORM_TYPES = ("default", "none", "preconditioned", "unpreconditioned")
_NORM_BY_INT = {-1: "default", 0: "none", 1: "preconditioned",
                2: "unpreconditioned"}
# the norm each loop monitors (fixed in its recurrence)
_KERNEL_NORMS = {"gmres": "preconditioned", "preonly": "none"}
# restarted solvers advance a whole cycle at a time: no fixed-iteration
# contract (norm type 'none') for them
_CYCLE_GRANULAR = ("gmres",)
# re-entries of the true-residual gate before it reports a failure
_MAX_REENTRIES = 3


class KSP:
    """Krylov solver context."""

    def __init__(self, comm=None):
        self.comm = None
        self._type = "gmres"          # PETSc's default
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
        self.restart = 30             # -ksp_gmres_restart
        # -ksp_true_residual_check: after the loop, ||b - A x|| against
        # max(rtol ||b||, atol); a miss re-enters from the current iterate
        self._true_residual_check = False
        # -ksp_true_residual_margin: with the gate on, the loop stops at
        # margin * rtol (the gate itself keeps rtol)
        self.true_residual_margin = 1.0
        self._last_true_res = None
        self._last_reentries = 0
        self._reason_flag = False     # -ksp_converged_reason
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
            raise ValueError(f"norm type {norm_type!r} is not available in "
                             f"the port; use one of {_NORM_TYPES}")
        self._norm_type = t
        return self

    setNormType = set_norm_type

    def get_norm_type(self) -> str:
        if self._norm_type != "default":
            return self._norm_type
        return _KERNEL_NORMS.get(self._type, "unpreconditioned")

    getNormType = get_norm_type

    def _check_norm_type(self):
        """The JAX ``KSP._check_norm_type``: 'none' is refused for the
        cycle-granular types, and a type other than the loop's own monitored
        norm raises."""
        t = self._norm_type
        if t == "default":
            return
        if t == "none":
            if self._type in _CYCLE_GRANULAR:
                raise ValueError(
                    f"norm type 'none' is unavailable for KSP {self._type!r} "
                    "(iterations advance a whole restart cycle at a time, so "
                    "a fixed max_it contract cannot hold)")
            return
        have = _KERNEL_NORMS.get(self._type, "unpreconditioned")
        if t != have:
            raise ValueError(
                f"KSP {self._type!r} monitors the {have} residual norm; "
                f"norm type {t!r} is not available for it")

    def set_true_residual_check(self, flag: bool):
        """Opt-in final true-residual gate (``-ksp_true_residual_check``):
        the solve program's epilogue computes ``||b - A x||`` and ``||b||``;
        if the true residual misses ``max(rtol ||b||, atol)`` the solve
        re-enters from the current iterate, at most 3 times."""
        self._true_residual_check = bool(flag)
        return self

    setTrueResidualCheck = set_true_residual_check

    def set_from_options(self):
        """Apply the options database: ``-ksp_type``, ``-ksp_rtol``,
        ``-ksp_atol``, ``-ksp_divtol``, ``-ksp_max_it``,
        ``-ksp_gmres_restart``, ``-ksp_norm_type``, ``-ksp_batch_limit``,
        ``-ksp_true_residual_check``, ``-ksp_true_residual_margin``,
        ``-ksp_converged_reason``, ``-pc_type``,
        ``-pc_factor_mat_solver_type``, ``-pc_bjacobi_blocks``,
        ``-pc_sor_omega``, ``-pc_asm_overlap``, ``-pc_factor_fill``,
        ``-pc_setup_device``, ``-pc_mg_smooth_type``."""
        opt = global_options()
        t = opt.get_string("ksp_type")
        if t:
            self.set_type(t)
        self.rtol = opt.get_real("ksp_rtol", self.rtol)
        self.atol = opt.get_real("ksp_atol", self.atol)
        self.divtol = opt.get_real("ksp_divtol", self.divtol)
        self.max_it = opt.get_int("ksp_max_it", self.max_it)
        self.restart = opt.get_int("ksp_gmres_restart", self.restart)
        self.batch_limit = opt.get_int("ksp_batch_limit", self.batch_limit)
        nt = opt.get_string("ksp_norm_type")
        if nt:
            self.set_norm_type(nt)
        self._true_residual_check = opt.get_bool(
            "ksp_true_residual_check", self._true_residual_check)
        self.true_residual_margin = opt.get_real(
            "ksp_true_residual_margin", self.true_residual_margin)
        self._reason_flag = opt.get_bool("ksp_converged_reason",
                                         self._reason_flag)
        pc = self.get_pc()
        pct = opt.get_string("pc_type")
        if pct:
            pc.set_type(pct)
        fst = opt.get_string("pc_factor_mat_solver_type")
        if fst:
            pc.set_factor_solver_type(fst)
        pc.bjacobi_blocks = opt.get_int("pc_bjacobi_blocks",
                                        pc.bjacobi_blocks)
        pc.sor_omega = opt.get_real("pc_sor_omega", pc.sor_omega)
        pc.asm_overlap = opt.get_int("pc_asm_overlap", pc.asm_overlap)
        pc.factor_fill = opt.get_real("pc_factor_fill", pc.factor_fill)
        sd = opt.get_string("pc_setup_device")
        if sd:
            pc.setup_device = sd
        mst = opt.get_string("pc_mg_smooth_type")
        if mst:                       # 'chebyshev' | 'jacobi' (solvers/mg)
            pc.mg_smoother = mst
        return self

    setFromOptions = set_from_options

    def set_up(self):
        """Set up the PC on its operator (the factor PCs factor here)."""
        if self._mat is None:
            raise RuntimeError("KSP.set_up: no operators set")
        pc = self.get_pc()
        pc.set_up(pc._mat if pc._mat is not None else self._mat)
        return self

    setUp = set_up

    def get_iteration_number(self) -> int:
        return self.result.iterations

    getIterationNumber = get_iteration_number

    def get_residual_norm(self) -> float:
        return self.result.residual_norm

    getResidualNorm = get_residual_norm

    def get_converged_reason(self) -> int:
        return self.result.reason

    getConvergedReason = get_converged_reason

    def _run_tolerances(self):
        """``(norm_none, rtol, atol, divtol)`` as the loop takes them: the
        norm type none turns off the convergence test."""
        if self._norm_type == "none" and self._type != "preonly":
            return True, 0.0, 0.0, 0.0
        return False, self.rtol, self.atol, self.divtol

    def _margin(self) -> float:
        margin = float(self.true_residual_margin)
        if not 0.0 < margin <= 1.0:
            raise ValueError(
                f"-ksp_true_residual_margin must be in (0, 1], got "
                f"{margin!r}: 0 makes every gated target unreachable, >1 "
                "would stop looser than rtol and defeat the gate")
        return margin

    def solve(self, b, x, *, _rtol=None, _atol=None, _guess_nonzero=False,
              _no_reenter=False) -> SolveResult:
        """Solve ``A x = b``; the solution is written into ``x``. The
        underscore arguments are the true-residual gate's re-entry: other
        tolerances, and the current ``x`` as the initial guess. With
        ``-ksp_converged_reason`` the outcome is printed, as PETSc does."""
        res = self._solve(b, x, _rtol, _atol, _guess_nonzero, _no_reenter)
        if self._reason_flag and not _no_reenter:
            verb = "converged" if res.converged else "did not converge"
            print(f"Linear solve {verb} due to {res.reason_name} "
                  f"iterations {res.iterations}")
        return res

    def _solve(self, b, x, _rtol, _atol, _guess_nonzero, _no_reenter):
        mat = self._mat
        if mat is None:
            raise RuntimeError("KSP.solve: no operators set")
        self._check_norm_type()
        self.set_up()
        pc = self.get_pc()
        if pc.kind == "hostlu":
            return self._solve_hostlu(b, x)
        norm_none, rtol, atol, divtol = self._run_tolerances()
        if _rtol is not None:
            rtol, atol = _rtol, _atol
        gate = (self._true_residual_check and self._type != "preonly"
                and not norm_none)
        margin = self._margin() if gate else 1.0
        prog = build_ksp_program(mat.comm, self._type, pc, mat,
                                 restart=self.restart, true_res=gate)
        x0 = (x.data.clone() if _guess_nonzero
              else torch.zeros_like(b.data))
        t0 = time.perf_counter()
        out = prog(b.data, x0, *_tolerances(mat.dtype, rtol * margin,
                                            atol * margin, divtol),
                   self.max_it)
        xd, iters, rnorm, reason, syncs = out[:5]
        x.data = xd
        wall = time.perf_counter() - t0
        self.result = SolveResult(iters, rnorm,
                                  _final_reason(reason, rnorm, norm_none),
                                  wall, syncs)
        if not _no_reenter:
            self._last_reentries = 0
        if not gate:
            return self.result
        true_rn, bnorm = out[5:]
        self._last_true_res = (true_rn, bnorm)
        target = max(rtol * bnorm, atol)
        # the margin must never turn a truly converged solve into a failure
        if (not self.result.converged and math.isfinite(true_rn)
                and true_rn <= target):
            self.result = SolveResult(iters, true_rn,
                                      ConvergedReason.CONVERGED_RTOL, wall,
                                      syncs)
        if not _no_reenter and self.result.converged:
            self._reenter(b, x, target, true_rn, rnorm)
        return self.result

    def _reenter(self, b, x, target, trn, last_mon_rn):
        """The gate (JAX ``ksp.py:971-1031``): while the true residual misses
        ``target``, solve again from the current iterate, at most
        ``_MAX_REENTRIES`` times; the result sums the iterations."""
        res = self.result
        total = [res.iterations, res.wall_time, res.host_syncs]
        attempts = 0
        while trn > target:
            if attempts == _MAX_REENTRIES:
                # "converged" means the true residual met the target
                self.result = SolveResult(total[0], trn,
                                          ConvergedReason.DIVERGED_MAX_IT,
                                          total[1], total[2])
                break
            attempts += 1
            # a preconditioned-norm loop exits on its own norm: map the
            # unpreconditioned target through the ratio seen at this iterate
            sub_atol = target
            if (self.get_norm_type() == "preconditioned"
                    and math.isfinite(last_mon_rn) and last_mon_rn > 0
                    and trn > 0):
                sub_atol = target * last_mon_rn / trn
            sub = self.solve(b, x, _rtol=0.0, _atol=sub_atol,
                             _guess_nonzero=True, _no_reenter=True)
            total = [total[0] + sub.iterations, total[1] + sub.wall_time,
                     total[2] + sub.host_syncs]
            last_mon_rn = sub.residual_norm
            trn = self._last_true_res[0]
            reason = (ConvergedReason.CONVERGED_RTOL if trn <= target
                      else sub.reason)
            self.result = SolveResult(total[0], trn, reason, total[1],
                                      total[2])
            self._last_reentries = attempts

    def _solve_hostlu(self, b, x) -> SolveResult:
        """Direct solve through the PC's host sparse-LU factor (JAX
        ``ksp.py:1033``): one read of ``b``, one SuperLU solve, one write of
        ``x``. Only KSP preonly applies it."""
        if self._type != "preonly":
            raise ValueError(
                "PC 'lu'/'cholesky' is in host sparse-LU mode (irreducible "
                "sparsity past the dense cap); the factor applies on the "
                "host, which an iterative KSP cannot call per iteration: "
                "use KSP 'preonly', or an iterative KSP with pc "
                "'bjacobi'/'jacobi'")
        factor, A64 = self.get_pc()._hostlu
        self._last_reentries = 0
        t0 = time.perf_counter()
        bh = np.asarray(b.to_numpy(), dtype=np.float64)
        xh = factor.solve(bh)
        x.set_global(xh.astype(numpy_dtype(self._mat.dtype)))
        rnorm = float(np.linalg.norm(bh - A64 @ xh))
        self.result = SolveResult(1, rnorm, ConvergedReason.CONVERGED_ITS,
                                  time.perf_counter() - t0, 1)
        return self.result

    def solve_many(self, B, X=None) -> BatchedSolveResult:
        """Solve ``A X = B`` for a block of ``k`` right-hand sides (PETSc's
        ``KSPMatSolve``; JAX ``ksp.py:1471``), each from a zero guess.

        ``B`` is an ``(n, k)`` host array or a list of ``k`` Vecs; ``X`` is
        None, an ``(n, k)`` host array or a list of ``k`` Vecs, and receives
        the solution. Returns per-column iterations, residual norms and
        reasons; a column that converges early freezes while the others run
        on.

        CG with PC none/jacobi/bjacobi/lu (dense) and norm type
        default/none runs the ``k`` recurrences in lockstep: one operator
        pass and one reduction per phase serve every column. Other
        configurations (PC mg or host LU, GMRES/BiCGStab/preonly, the
        true-residual gate) solve the columns one by one. ``batch_limit``
        (``-ksp_batch_limit``) splits a wider block into batched solves of
        at most that many columns.
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
        self._check_norm_type()
        self.set_up()
        pc = self.get_pc()
        if not (self._type == "cg" and batched_pc_supported(pc)
                and self._norm_type in ("default", "none")
                and not self._true_residual_check):
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
            Bd, torch.zeros_like(Bd), *_tolerances(mat.dtype, rtol, atol,
                                                   divtol), self.max_it)
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


def _tolerances(dtype, *values) -> list:
    """The tolerance scalars as the loop takes them: each rounded to the
    operator's ``tolerance_dtype`` (the value its arithmetic uses anyway)."""
    tdt = tolerance_dtype(dtype)
    return [torch.tensor(v, dtype=tdt).item() for v in values]


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
