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

``-ksp_megasolve`` runs the whole refinement recurrence as the fused program
of ``solvers/megasolve.py`` (replayed as captured CUDA graphs on the card):
the fp64 true residual on the device through the outer operator, the
explicit ``outer_op``, the inner Mat itself at fp64 inner precision, or an
fp64 Mat assembled from the host CSR when first needed. The routing is the
JAX package's (``_megasolve_available``): a custom inner operator without an
``outer_op``, a null space, monitors or a history on the inner KSP, a norm
type other than the default, and the types and PCs without a fused program
run the host loop. The fault points of the JAX fused refinement
(``ksp.solve``, ``ksp.program``/``device.lost``, ``ksp.result``,
``refine.py:275-421``) sit in the fused path; the guarded inner solves of
the host loop carry their own. An inner KSP with the silent-corruption guard
(``-ksp_abft``, a replacement interval, or the drift bounds
``_arm_inner_guards`` arms for an sstep inner and a bf16 pipecg inner) runs
the fused program's guarded mode (JAX ``refine.py:276-337``): a detection
raises ``SilentCorruptionError``, and a demotion of the s-step inner reruns
the refinement through the host loop, whose inner solves demote per
correction.

Telemetry (JAX ``refine.py:499-589``): ``solve`` and ``solve_many`` are one
``refine.outer`` span each; the host loop's outer steps are ``refine.step``
children (the inner ``ksp.solve`` spans nest in them), the fused path's
``ksp.setup``/``ksp.dispatch``/``ksp.fetch``.
"""

from __future__ import annotations

import time

import numpy as np

import torch

from ..core.mat import Mat
from ..core.vec import Vec
from ..parallel.mesh import DeviceComm
from ..resilience import faults as _faults
from ..utils.convergence import ConvergedReason, SolveResult
from ..utils.errors import SilentCorruptionError, wrap_device_errors
from ..utils.dtypes import inner_precision_dtype, is_low_precision, real_eps
from ..utils.options import global_options
from ..utils.profiling import record_event, record_sdc, record_sync
from ..telemetry import spans as _telemetry
from .cg_plans import SDC_DEMOTE, SDC_DETECTOR_NAMES, SDC_NONE
from .ksp import KSP, _megasolve_stats

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
        self.megasolve = False        # -ksp_megasolve: the fused program
        self._A_host = None
        self._mat_lp: Mat | None = None
        self._inner_op = None
        self._outer_op = None
        self._mat_outer: Mat | None = None
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
        :attr:`inner_dtype`. ``outer_op``: the fp64 device operator the
        fused program (``-ksp_megasolve``) takes its true residuals with
        (the host loop computes them with scipy)."""
        A = A_scipy.tocsr()
        self._A_host = A
        self._outer_op = outer_op
        self._mat_outer = None
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
        guarded loops (``solvers/cg_plans.py``); a pipecg inner at f32/f64
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

    # ---- megasolve: the fused refinement program --------------------------------
    def _outer_operator(self):
        """The fp64 device operator of the fused program's true residual
        (JAX ``refine.py:216``): the explicit ``outer_op``, the inner Mat at
        fp64 inner precision, or an fp64 Mat assembled from the host CSR
        when first needed; None for a custom inner operator without an
        ``outer_op``."""
        if self._outer_op is not None:
            return self._outer_op
        if self._mat_lp is None:
            return None
        if self.inner_dtype == torch.float64:
            return self._mat_lp
        if self._mat_outer is None:
            self._mat_outer = Mat.from_scipy(self.comm, self._A_host,
                                             dtype=torch.float64)
        return self._mat_outer

    def _megasolve_available(self, many: bool = False) -> bool:
        """Route through the fused program (JAX ``refine.py:234``)? The
        routing rule of ``KSP._megasolve_eligible``, plus an outer
        operator."""
        if not self.megasolve or self._inner_op is None:
            return False
        ksp = self.inner
        if ksp._nullspace_basis(self._inner_op) is not None:
            return False
        if ksp._monitors or ksp._monitor_flag or ksp._history is not None:
            return False
        if ksp._norm_type != "default" or ksp.unroll != 1:
            return False
        from .megasolve import megasolve_supported
        if not megasolve_supported(ksp.get_type(), ksp.get_pc(),
                                   self._inner_op,
                                   nrhs=2 if many else None):
            return False
        return self._outer_operator() is not None

    def _run_fused(self, B, many):
        """The fused refinement on the fp64 vector or ``(n, k)`` block
        ``B``: one program with the refinement semantics (the storage-eps
        floored inner target, the inner iteration cap, ``max_refine``
        steps, DIVERGED_BREAKDOWN on stagnation). Returns the result, the
        outer operator, the wall and the guard's checks and replacements;
        a guarded program's detection raises ``SilentCorruptionError``,
        and its demotion returns None for the host loop to rerun."""
        from .megasolve import (build_megasolve_program,
                                build_megasolve_program_many)
        ksp, op = self.inner, self._inner_op
        outer = self._outer_operator()
        comm = op.comm
        _faults.check("ksp.solve")
        ksp._check_guard()
        with _telemetry.span("ksp.setup"):
            ksp.set_up()
        self._arm_inner_guards()
        guard = ksp._megasolve_guard(many=many)
        pc = ksp.get_pc()
        out_op = None if outer is op else outer
        with _telemetry.span("ksp.setup"):
            if many:
                prog = build_megasolve_program_many(
                    comm, ksp.get_type(), pc, op, out_op, nrhs=B.shape[1],
                    sstep_s=ksp.sstep_s, **guard)
            else:
                prog = build_megasolve_program(comm, ksp.get_type(), pc, op,
                                               out_op, sstep_s=ksp.sstep_s,
                                               **guard)
        if many:
            b = comm.put_cols(B, torch.float64)
        else:
            b = Vec.from_global(comm, B, dtype=torch.float64,
                                layout=outer.layout).data.view(
                                    comm.local_shards, -1)
        # the fault points around the fused program (JAX refine.py:304-311)
        fault = _faults.triggered("ksp.program")
        if fault is None:
            fault = _faults.mesh_fault("device.lost", comm.device_ids)
        if fault is not None:
            raise fault.error()
        t0 = time.perf_counter()
        with _telemetry.span("ksp.dispatch"):
            _telemetry.record_program_dispatch(
                "megasolve_many" if many else "megasolve")
            res = prog(b, None, self.rtol, self.atol,
                       self._effective_inner_rtol(), ksp.divtol,
                       _INNER_MAX_IT, self.max_refine,
                       ConvergedReason.DIVERGED_BREAKDOWN)
        with _telemetry.span("ksp.fetch"):
            wall = time.perf_counter() - t0
        record_sync("KSP solve_many result fetch" if many
                    else "KSP result fetch/solve", res.host_reads)
        checks = rrc = 0
        if guard:
            dets = res.det if many else [res.det]
            rrc = int(sum(res.rrc)) if many else res.rrc
            iters = sum(res.iters) if many else res.iters
            steps = res.steps * (len(dets) if many else 1)
            checks = ksp._fused_checks(guard, steps, iters)
            bad = [j for j, d in enumerate(dets)
                   if d not in (SDC_NONE, SDC_DEMOTE)]
            record_sdc(checks, len(bad), rrc)
            if bad:
                raise SilentCorruptionError(
                    "KSPSolve", SDC_DETECTOR_NAMES.get(dets[bad[0]],
                                                       f"det{dets[bad[0]]}"),
                    iters, detail=f"detected inside the fused refinement "
                                  f"loop at outer step {res.steps} ({rrc} "
                                  "replacement(s) passed)")
            if SDC_DEMOTE in dets:
                return None
        return res, outer, wall, checks, rrc

    def _solve_fused(self, b):
        """One fused program from the refinement loop to the verified answer
        (JAX ``refine.py:257``); the results as :meth:`solve` reports
        them. A demotion of the s-step inner reruns the host loop (JAX
        ``refine.py:322-328``)."""
        run = self._run_fused(b, many=False)
        if run is None:
            return self._solve_host(b)
        res, outer, wall, checks, rrc = run
        x = Vec(outer.comm, outer.shape[0], data=res.x.reshape(-1),
                layout=outer.layout).to_numpy()
        reason = res.reason
        if _faults.triggered("ksp.result") is not None:
            res.rnorm = float("nan")
        if not np.isfinite(res.rnorm):
            reason = ConvergedReason.DIVERGED_NANORINF
        self.refine_steps = res.steps
        self.result = SolveResult(res.iters, float(res.rnorm), int(reason),
                                  wall, res.host_reads, abft_checks=checks,
                                  residual_replacements=rrc)
        _megasolve_stats(self.result, res)
        ksp = self.inner
        record_event(f"RefinedKSP({ksp.get_type()}+{ksp.get_pc().get_type()}"
                     f"+mega,{self.inner_precision})", self._inner_op.shape[0],
                     res.iters, wall, int(reason))
        return x, self.result

    def _solve_many_fused(self, B):
        """The fused block refinement (JAX ``refine.py:370``): per-column
        freezing at both levels; the result reports the most inner
        iterations of a column, the worst column's residual and one
        reason for the block."""
        run = self._run_fused(B, many=True)
        if run is None:
            return self._solve_many_host(B)
        res, outer, wall, checks, rrc = run
        X = outer.comm.fetch_cols(res.x, outer.shape[0])
        rn = np.asarray(res.rnorm, dtype=float)
        reasons = np.asarray(res.reason)
        conv = np.isfinite(rn) & (reasons > 0)
        if conv.all():
            reason = ConvergedReason.CONVERGED_RTOL
        elif not np.all(np.isfinite(rn)):
            reason = ConvergedReason.DIVERGED_NANORINF
        elif np.all(reasons[~conv] == ConvergedReason.DIVERGED_BREAKDOWN):
            reason = ConvergedReason.DIVERGED_BREAKDOWN
        else:
            reason = ConvergedReason.DIVERGED_MAX_IT
        self.refine_steps = res.steps
        self.result = SolveResult(int(max(res.iters, default=0)),
                                  float(rn.max(initial=0.0)), int(reason),
                                  wall, res.host_reads, abft_checks=checks,
                                  residual_replacements=rrc)
        _megasolve_stats(self.result, res)
        ksp = self.inner
        record_event(f"RefinedKSP({ksp.get_type()}+{ksp.get_pc().get_type()}"
                     f"+mega,{self.inner_precision},k={B.shape[1]})",
                     self._inner_op.shape[0], self.result.iterations, wall,
                     int(reason))
        return X, self.result

    def _start(self):
        """Inner tolerances for a solve: the floored target and the
        per-correction iteration cap."""
        self.inner.set_tolerances(rtol=self._effective_inner_rtol(),
                                  max_it=_INNER_MAX_IT)
        self._arm_inner_guards()

    @wrap_device_errors("RefinedKSPSolve")
    def solve(self, b: np.ndarray) -> tuple[np.ndarray, SolveResult]:
        """Solve ``A x = b`` (fp64 in and out); returns ``(x, result)`` with
        the inner iterations summed over the outer steps
        (:attr:`refine_steps`) and the final fp64 residual norm. The call
        is one ``refine.outer`` span."""
        self._check_mode()
        b = np.asarray(b, dtype=np.float64)
        with _telemetry.span("refine.outer",
                             inner_precision=self.inner_precision,
                             ksp_type=self.inner.get_type(),
                             n=int(self._A_host.shape[0]),
                             rtol=self.rtol) as osp:
            if self._megasolve_available():
                x, res = self._solve_fused(b)
            else:
                x, res = self._solve_host(b)
            osp.set_attrs(refine_steps=self.refine_steps,
                          inner_iterations=res.iterations,
                          reason=res.reason)
            return x, res

    def _solve_host(self, b):
        """The Wilkinson loop on the host (JAX ``refine.py:515``), one
        ``refine.step`` span an outer step."""
        A = self._A_host
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
                with _telemetry.span("refine.step", step=it) as ssp:
                    rv.set_global(r)        # rounded to the inner dtype
                    res = self.inner.solve(rv, dx)
                    total_inner += res.iterations
                    x = x + dx.to_numpy().astype(np.float64)
                    r = b - A @ x
                    r_new = np.linalg.norm(r)
                    ssp.set_attrs(inner_iterations=res.iterations,
                                  rnorm=float(r_new))
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

    @wrap_device_errors("RefinedKSPSolveMany")
    def solve_many(self, B: np.ndarray) -> tuple[np.ndarray, SolveResult]:
        """Block refinement: solve ``A X = B`` for an fp64 ``(n, nrhs)``
        block. Each outer step computes the block's exact fp64 residual and
        runs ONE batched low-precision ``KSP.solve_many`` correction; columns
        that already meet the tolerance contribute a zero residual and
        freeze at once. Returns ``(X, result)`` with the per-step maxima of
        the inner iterations summed and the worst column's final
        residual. The call is one ``refine.outer`` span."""
        self._check_mode()
        B = np.asarray(B, dtype=np.float64)
        if B.ndim != 2:
            raise ValueError(f"solve_many needs an (n, nrhs) block, got "
                             f"{B.shape}")
        with _telemetry.span("refine.outer",
                             inner_precision=self.inner_precision,
                             ksp_type=self.inner.get_type(),
                             n=int(self._A_host.shape[0]),
                             rtol=self.rtol) as osp:
            if self._megasolve_available(many=True):
                X, res = self._solve_many_fused(B)
            else:
                X, res = self._solve_many_host(B)
            osp.set_attrs(refine_steps=self.refine_steps,
                          inner_iterations=res.iterations,
                          reason=res.reason, nrhs=int(X.shape[1]))
            return X, res

    def _solve_many_host(self, B):
        """The block Wilkinson loop on the host (JAX ``refine.py:594``)."""
        A = self._A_host
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

