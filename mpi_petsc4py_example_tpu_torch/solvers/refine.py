"""Mixed-precision iterative refinement: ``RefinedKSP``.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/refine.py``
(``:46-651``). The Krylov iteration runs in a low storage precision on the
card (``-ksp_inner_precision {bf16,f32,f64}``, default f32) inside an fp64
outer loop, the classic Wilkinson scheme: each outer step computes the exact
fp64 residual ``r = b - A x`` with scipy on the host, solves the correction
system ``A d = r`` with the inner KSP at the inner precision, and accumulates
``x += d`` in fp64. The inner reductions accumulate in fp32 under bf16
storage (the mixed-precision plans of ``solvers/cg_plans.py``), so the final
accuracy contract, ``rtol`` against the fp64 residual, does not depend on the
inner precision; a bf16 inner solve takes more, cheaper, outer steps. The
per-step inner target is floored at a few storage epsilons.

On a communicator of several processes every process holds the fp64 system
and runs the host residual on it (replicated, SPMD); the correction comes
back through one collective read (``Vec.to_numpy``) per outer step, and the
inner KSP runs on the process's shards.

Refinement contracts only while ``cond(A) * eps_storage`` stays small enough
for the corrections to keep reducing the residual; the stagnation guard
(``0.9 * rnorm``) ends the loop with ``DIVERGED_BREAKDOWN`` when they stop
doing so.

Not ported: the fused one-dispatch refinement program (``-ksp_megasolve``,
JAX ``solvers/megasolve.py``) raises ``NotImplementedError``; its telemetry
spans wait for the port's telemetry (ROADMAP Queue A item 6).
"""

from __future__ import annotations

import time

import numpy as np

from ..core.mat import Mat
from ..parallel.mesh import DeviceComm
from ..utils.convergence import ConvergedReason, SolveResult
from ..utils.dtypes import inner_precision_dtype, is_low_precision, real_eps
from ..utils.options import global_options
from .ksp import KSP

#: tightest per-correction inner target the storage precision can resolve:
#: a handful of eps (bf16 ~3e-2, f32 ~5e-7)
_INNER_RTOL_FLOOR_EPS = 4.0
#: the inner solve's iteration cap per correction
_INNER_MAX_IT = 20000


class RefinedKSP:
    """KSP-shaped mixed-precision solver: a low-precision inner Krylov solve
    (``-ksp_inner_precision``: bf16/f32/f64, default f32) inside an fp64
    refinement loop.

    ``set_operators`` takes the fp64 scipy matrix, from which the inner
    operator is assembled at the inner precision, or, for matrix-free
    stencils, an inner operator built by the caller (``inner_op``, e.g. a
    ``StencilPoisson3D`` at the inner dtype); the scipy matrix then serves
    only the exact fp64 residual.
    """

    def __init__(self, comm=None):
        self.comm = comm
        self.inner = KSP(comm)
        self.inner_rtol = 1e-6
        self.rtol = 1e-12
        self.atol = 0.0
        self.max_refine = 20
        self.inner_precision = "f32"
        self.megasolve = False        # -ksp_megasolve (not ported: raises)
        self._A_host = None
        self._mat_lp: Mat | None = None
        self._inner_op = None
        self.refine_steps = 0
        self.result = SolveResult()

    def create(self, comm=None):
        self.comm = comm
        self.inner.create(comm)
        return self

    # ---- precision axis ----------------------------------------------------
    def set_inner_precision(self, precision: str):
        """Choose the inner storage precision (``bf16``/``f32``/``f64``).
        Call it before :meth:`set_operators` (the inner operator is built at
        this dtype), or call ``set_operators`` again after."""
        inner_precision_dtype(precision)     # validate the spelling
        self.inner_precision = str(precision).lower()
        return self

    setInnerPrecision = set_inner_precision

    @property
    def inner_dtype(self):
        """The inner storage dtype (a ``torch.dtype``) of the current
        precision setting."""
        return inner_precision_dtype(self.inner_precision)

    def set_from_options(self):
        """Apply the options database under the inner KSP's options prefix
        (JAX ``refine.py:112``): ``-ksp_inner_precision``,
        ``-ksp_refine_max`` (outer-step cap), ``-ksp_refine_inner_rtol``
        (per-correction inner target) and ``-ksp_megasolve``, then the inner
        KSP's own flags (``-ksp_type``, ``-pc_type``, ...)."""
        opt = global_options()
        p = self.inner.get_options_prefix()
        ip = opt.get_string(p + "ksp_inner_precision")
        if ip:
            self.set_inner_precision(ip)
        self.max_refine = opt.get_int(p + "ksp_refine_max", self.max_refine)
        self.inner_rtol = opt.get_real(p + "ksp_refine_inner_rtol",
                                       self.inner_rtol)
        self.megasolve = opt.get_bool(p + "ksp_megasolve", self.megasolve)
        self.inner.set_from_options()
        # the refinement loop is the megasolve slot: the inner KSP must not
        # also take it (JAX refine.py:119-122)
        self.inner.megasolve = False
        return self

    setFromOptions = set_from_options

    def set_operators(self, A_scipy, inner_op=None, outer_op=None):
        """``A_scipy``: the fp64 scipy sparse matrix (kept for the exact
        residuals). ``inner_op``: an operator already built at the inner
        precision (matrix-free stencils); by default an assembled Mat at
        :attr:`inner_dtype`. ``outer_op`` (the fused program's fp64 device
        operator) is accepted for the JAX signature and unused: the port's
        refinement computes its residuals on the host."""
        del outer_op
        A = A_scipy.tocsr()
        self._A_host = A
        if self.comm is None:
            self.create(DeviceComm())       # the card, as an entry point
        if inner_op is not None:
            self._inner_op = inner_op
            self._mat_lp = None
        else:
            self._mat_lp = Mat.from_scipy(self.comm, A,
                                          dtype=self.inner_dtype)
            self._inner_op = self._mat_lp
        self.inner.set_operators(self._inner_op)
        return self

    def set_type(self, t):
        self.inner.set_type(t)
        return self

    def get_pc(self):
        return self.inner.get_pc()

    def set_tolerances(self, rtol=None, atol=None, max_refine=None,
                       inner_rtol=None):
        if rtol is not None:
            self.rtol = float(rtol)
        if atol is not None:
            self.atol = float(atol)
        if max_refine is not None:
            self.max_refine = int(max_refine)
        if inner_rtol is not None:
            self.inner_rtol = float(inner_rtol)
        return self

    # ---- the Wilkinson loop ------------------------------------------------
    def _arm_inner_guards(self):
        """Arm the inner KSP's drift bounds as the JAX package does
        (``refine.py:177-201``): a pipecg inner on sub-f32 storage, with no
        replacement set, gets ``-ksp_pipeline_auto_replacement 25`` (its u/w
        recurrences drift with the storage epsilon), and an sstep inner at
        any precision ``-ksp_sstep_auto_replacement 25`` (the monomial
        basis' conditioning can stall the correction solves). Both arm the
        guarded loops, ROADMAP.md Queue A item 6, so those inner solves
        raise ``NotImplementedError`` naming it; a pipecg inner at f32/f64
        runs unguarded, as in the JAX package."""
        if (self.inner.get_type() == "pipecg"
                and is_low_precision(self.inner_dtype)
                and self.inner.residual_replacement == 0
                and self.inner.pipeline_auto_replacement == 0):
            self.inner.pipeline_auto_replacement = 25
        if (self.inner.get_type() == "sstep"
                and self.inner.residual_replacement == 0
                and self.inner.sstep_auto_replacement == 0):
            self.inner.sstep_auto_replacement = 25

    def _effective_inner_rtol(self) -> float:
        """The per-correction target the inner solve runs at:
        ``inner_rtol`` floored at a few STORAGE epsilons (a bf16 inner CG
        asked for 1e-6 would spin to max_it against resolution it does not
        have; the fp64 outer loop supplies the remaining digits)."""
        floor = _INNER_RTOL_FLOOR_EPS * real_eps(self.inner_dtype)
        return max(self.inner_rtol, floor)

    def _check_mode(self):
        if self._A_host is None:
            raise RuntimeError("RefinedKSP.solve: no operators set")
        if self.megasolve:
            raise NotImplementedError(
                "-ksp_megasolve: the fused one-dispatch refinement program "
                "(the JAX package's solvers/megasolve.py) is not ported; "
                "ROADMAP.md Queue A item 5 brings it (a captured CUDA graph "
                "of the refinement loop). Unset -ksp_megasolve to run the "
                "host refinement loop")

    def _start(self):
        """Inner tolerances for a solve: the floored target and the
        per-correction iteration cap."""
        self.inner.set_tolerances(rtol=self._effective_inner_rtol(),
                                  max_it=_INNER_MAX_IT)
        self._arm_inner_guards()

    def solve(self, b: np.ndarray) -> tuple[np.ndarray, SolveResult]:
        """Solve ``A x = b`` (fp64 in and out); returns ``(x, result)`` with
        the inner iterations summed over the outer steps
        (:attr:`refine_steps`) and the final fp64 residual norm."""
        self._check_mode()
        A = self._A_host
        b = np.asarray(b, dtype=np.float64)
        bnorm = np.linalg.norm(b)
        tol = max(self.rtol * bnorm, self.atol)
        x = np.zeros_like(b)
        self._start()
        dx, rv = self._inner_op.get_vecs()

        t0 = time.perf_counter()
        total_inner = 0
        # ONE exact fp64 residual per outer step: it decides convergence and
        # stagnation and feeds the next correction
        r = b - A @ x
        rnorm = np.linalg.norm(r)
        reason = ConvergedReason.DIVERGED_MAX_IT
        it = 0
        if rnorm <= tol:
            reason = self._converged(rnorm)
        else:
            for it in range(1, self.max_refine + 1):
                rv.set_global(r)            # rounded to the inner dtype
                res = self.inner.solve(rv, dx)
                total_inner += res.iterations
                x = x + dx.to_numpy().astype(np.float64)
                r = b - A @ x
                r_new = np.linalg.norm(r)
                # checked AFTER the correction: a solve that lands on the
                # tolerance at the max_refine-th step converges
                if r_new <= tol:
                    rnorm = r_new
                    reason = self._converged(r_new)
                    break
                # stagnation guard: the inner precision cannot represent
                # corrections below ~eps of the iterate
                if r_new >= 0.9 * rnorm:
                    rnorm = r_new
                    reason = ConvergedReason.DIVERGED_BREAKDOWN
                    break
                rnorm = r_new
        self.refine_steps = it
        self.result = SolveResult(total_inner, float(rnorm), int(reason),
                                  time.perf_counter() - t0)
        return x, self.result

    def _converged(self, rnorm):
        return (ConvergedReason.CONVERGED_ATOL if rnorm <= self.atol
                else ConvergedReason.CONVERGED_RTOL)

    def solve_many(self, B: np.ndarray) -> tuple[np.ndarray, SolveResult]:
        """Block refinement: solve ``A X = B`` for an fp64 ``(n, nrhs)``
        block. Each outer step computes the block's exact fp64 residual and
        runs ONE batched low-precision ``KSP.solve_many`` correction; columns
        that already meet the tolerance contribute a zero residual and
        freeze at once. Returns ``(X, result)`` with the per-step maxima of
        the inner iterations summed and the worst column's final
        residual."""
        self._check_mode()
        A = self._A_host
        B = np.asarray(B, dtype=np.float64)
        if B.ndim != 2:
            raise ValueError(f"solve_many needs an (n, nrhs) block, got "
                             f"{B.shape}")
        bnorm = np.linalg.norm(B, axis=0)
        tol = np.maximum(self.rtol * bnorm, self.atol)
        X = np.zeros_like(B)
        self._start()

        t0 = time.perf_counter()
        total_inner = 0
        R = B - A @ X
        rnorm = np.linalg.norm(R, axis=0)
        reason = ConvergedReason.DIVERGED_MAX_IT
        it = 0
        if np.all(rnorm <= tol):
            reason = ConvergedReason.CONVERGED_RTOL
        else:
            for it in range(1, self.max_refine + 1):
                res = self.inner.solve_many(R)   # rounded to the inner dtype
                total_inner += int(max(res.iterations, default=0))
                X = X + np.asarray(res.X, dtype=np.float64)
                R = B - A @ X
                r_new = np.linalg.norm(R, axis=0)
                if np.all(r_new <= tol):
                    rnorm = r_new
                    reason = ConvergedReason.CONVERGED_RTOL
                    break
                if np.all(r_new >= 0.9 * np.maximum(rnorm, 1e-300)):
                    rnorm = r_new
                    reason = ConvergedReason.DIVERGED_BREAKDOWN
                    break
                rnorm = r_new
        self.refine_steps = it
        self.result = SolveResult(total_inner, float(rnorm.max(initial=0.0)),
                                  int(reason), time.perf_counter() - t0)
        return X, self.result

    # ---- legacy spelling ---------------------------------------------------
    @property
    def _mat32(self):
        """The inner Mat (historical name from the fp32-only scheme)."""
        return self._mat_lp
