"""KSP: the Krylov solver object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/ksp.py``
(``KSP``, ``:47``): ``create``, ``set_type`` (every type of the JAX
``KSP_KERNELS``), ``get_pc``/``set_pc``, ``set_operators``/
``get_operators``, ``set_tolerances``/``get_tolerances``,
``set_norm_type`` (natural for cg/fcg/cr), ``set_initial_guess_nonzero``,
``set_monitor``, ``set_convergence_history``, ``set_true_residual_check``,
``set_from_options``, ``set_up``, ``view``, ``solve`` ->
:class:`SolveResult` and ``solve_many`` -> :class:`BatchedSolveResult`
(petsc4py's ``KSP().create(comm)``, ``setType``, ``getPC``,
``setOperators``, ``setFromOptions``, ``setUp``, ``solve(b, x)``,
``matSolve(B, X)``). A solve starts from zero unless the initial guess is
marked nonzero; the re-entries of the true-residual gate start from the
current iterate.

Monitors (``set_monitor``, ``-ksp_monitor``, the convergence history) are
called on the host with each residual norm the loop reads anyway, in
order, as ``(ksp, iteration, rnorm)``: per iteration, per restart cycle
for gmres/fgmres/lgmres, or per ``ell`` steps for bcgsl, the iteration-0
norm included. They add no host read;
one that raises ends the solve with its exception.

The silent-corruption guard (``-ksp_abft``, ``-ksp_abft_tol``,
``-ksp_residual_replacement``, and for pipecg/sstep
``-ksp_pipeline_auto_replacement``/``-ksp_sstep_auto_replacement`` with
``-ksp_sstep_max_replacements``; JAX ``ksp.py:519-566``, ``:662-952``) runs
the guarded loops of cg, pipecg and sstep (``solvers/cg_plans.py``), one RHS
or batched; other types raise ``ValueError`` as JAX ``_check_guard`` does. A
detection raises :class:`..utils.errors.SilentCorruptionError` with ``x``
rolled back to the last verified iterate; an s-step solve that spends its
basis-restart budget continues as classic CG from its trusted iterate
(``SDC_DEMOTE``, a ``sstep_demote`` recovery event). Under
``-ksp_megasolve`` the guard runs inside the fused program
(``solvers/megasolve.py``): a detection raises the same error with ``x``
set to the fused loop's verified carry, and a demotion continues as classic
CG from the outer carry, as JAX ``ksp.py:1280-1308`` does.

Telemetry (``telemetry/``, JAX ``ksp.py:578-607``): each ``solve`` is one
``ksp.solve`` span (gate re-entries nest as child ``ksp.solve`` spans) with
``ksp.setup``, ``ksp.dispatch``, ``ksp.fetch`` and ``ksp.verify`` children,
each ``solve_many`` a ``ksp.solve_many`` span; one
``record_program_dispatch`` per solve program run, at the JAX package's
sites; ``record_sync`` with the host reads the solve made (the sum over a
solve equals its result's ``host_syncs``); ``record_sdc`` with the guard's
checks, detections and replacements; ``record_event`` for ``-log_view``.

The fault points of ``resilience/faults.py`` sit where the JAX package has
them: ``ksp.solve`` at the entry of every solve, ``ksp.program`` and
``device.lost`` around the solve program (``iter=K`` leaves K iterations of
real progress in ``x`` before the failure), ``ksp.result`` on the residual
the solve reports; device failures surface as
:class:`..utils.errors.DeviceExecutionError` with their failure class.

``-ksp_megasolve`` routes an eligible cg/pipecg/sstep solve (and
``solve_many`` block) through the fused program of ``solvers/megasolve.py``,
replayed as captured CUDA graphs on the card, with the true-residual gate
in-program (``GATE_REFINE_MAX`` steps); ``-ksp_megasolve_stencil_fastpath``
gives its inner CG the stencil fused-dot loop. The routing rule is the JAX
package's (``_megasolve_eligible``): other types, a null space, monitors or
a history, a norm type other than the default, ``-ksp_unroll`` above 1 and
host LU run the unfused path. ``-ksp_reduction_auto`` re-routes a
cg/pipecg/sstep solve to the reduction plan that ``solvers/autoselect.py``
picks from this communicator's measured latencies, once per operator and
mesh, at ``set_up``.

A null space on the operator (``Mat.set_nullspace``) is projected out in
the solve program (``solvers/krylov.py``). A bfloat16 operator runs the
mixed-precision plan (``solvers/cg_plans.py``): its tolerance scalars travel
in ``utils.dtypes.tolerance_dtype``, fp32 (JAX ``ksp.py:734-738``), and its
host blocks as float32.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from ..core.vec import Vec
from ..parallel.mesh import numpy_dtype
from ..resilience import faults as _faults
from ..resilience.abft import DEFAULT_ABFT_TOL
from ..utils.convergence import (BatchedSolveResult, ConvergedReason,
                                 RecoveryEvent, SolveResult)
from ..utils.dtypes import host_dtype, tolerance_dtype
from ..utils.errors import SilentCorruptionError, wrap_device_errors
from ..utils.options import global_options
from ..utils.profiling import record_event, record_sdc, record_sync
from ..telemetry import spans as _telemetry
from ..telemetry.metrics import registry
from .cg_plans import SDC_DEMOTE, SDC_DETECTOR_NAMES, SDC_NONE
from .krylov import (BATCHED_TYPES, GUARDED_TYPES, NATURAL_TYPES,
                     batched_pc_supported, build_guarded_program,
                     build_ksp_program, build_ksp_program_many,
                     check_ksp_type, guarded_stencil_eligible,
                     stencil_cg_eligible)
from .pc import PC

DEFAULT_RTOL = 1e-5   # PETSc's KSP default
DEFAULT_ATOL = 1e-50
DEFAULT_DIVTOL = 1e5  # PETSc's KSP dtol default (DIVERGED_DTOL trigger)
DEFAULT_MAX_IT = 10000

# petsc4py's integer KSP.NormType values
_NORM_TYPES = ("default", "none", "preconditioned", "unpreconditioned",
               "natural")
_NORM_BY_INT = {-1: "default", 0: "none", 1: "preconditioned",
                2: "unpreconditioned", 3: "natural"}
# the norm each loop monitors (fixed in its recurrence; JAX ksp.py:274)
_KERNEL_NORMS = {"gmres": "preconditioned", "lgmres": "preconditioned",
                 "cr": "preconditioned", "symmlq": "unpreconditioned",
                 "preonly": "none"}
# restarted solvers advance a whole cycle at a time, bcgsl ell steps: no
# fixed-iteration contract (norm type 'none') for them (JAX ksp.py:312)
_CYCLE_GRANULAR = ("gmres", "fgmres", "lgmres", "bcgsl")
# the replacement interval pipecg and sstep arm when
# -ksp_residual_replacement is unset (JAX ksp.py:520-531)
_AUTO_REPLACEMENT = {"pipecg": "pipeline_auto_replacement",
                     "sstep": "sstep_auto_replacement"}
# re-entries of the true-residual gate before it reports a failure
_MAX_REENTRIES = 3
# petsc4py's default cap on the convergence history
_HISTORY_LENGTH = 10000
# the boolean flags of the ported modes: the fused program and the reduction
# plan selection
_MODE_FLAGS = ("megasolve", "megasolve_stencil_fastpath", "reduction_auto")


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
        self._view_flag = False       # -ksp_view
        self._monitor_flag = False    # -ksp_monitor
        self._monitors = []           # set_monitor callbacks
        self._initial_guess_nonzero = False
        # set_convergence_history: the list (None: off), its cap, and
        # whether each solve clears it
        self._history = None
        self._history_length = _HISTORY_LENGTH
        self._history_reset = False
        self._prefix = ""             # set_options_prefix
        # the silent-corruption guard: -ksp_abft (checksums) and
        # -ksp_residual_replacement N (a true-residual replacement every N
        # iterations)
        self.abft = False
        self.residual_replacement = 0
        # -ksp_megasolve, -ksp_megasolve_stencil_fastpath: the fused program
        # (solvers/megasolve.py); -ksp_reduction_auto: the reduction plan
        # chosen from measured latencies (solvers/autoselect.py)
        self.megasolve = False
        self.megasolve_stencil_fastpath = False
        self.reduction_auto = False
        self._reduction_report = None
        self._autoselect_key = None
        self.lgmres_augment = 2       # -ksp_lgmres_augment
        self.bcgsl_ell = 2            # -ksp_bcgsl_ell
        self.sstep_s = 4              # -ksp_sstep_s: the s-step block size
        # the replacement interval of pipecg/sstep when
        # -ksp_residual_replacement is unset: it arms the guard
        self.pipeline_auto_replacement = 0
        self.sstep_auto_replacement = 0
        # -ksp_abft_tol: the ABFT threshold multiplier;
        # -ksp_sstep_max_replacements: the s-step basis restarts before the
        # demotion to classic CG; -ksp_reduction_probe_refresh re-measures
        # the reduction probe of -ksp_reduction_auto. -ksp_unroll only
        # reschedules XLA's loop (JAX ksp.py:62-70) and has no effect here
        # but the megasolve routing, which it turns off as in JAX.
        self.abft_tol = DEFAULT_ABFT_TOL
        self.unroll = 1
        self.sstep_max_replacements = 3
        self.reduction_probe_refresh = False
        self.result = SolveResult()
        self.result_many = BatchedSolveResult()
        self._abft_placed = None
        if comm is not None:
            self.create(comm)

    def destroy(self):
        """Release the operators and the PC (petsc4py ``KSP.destroy``; JAX
        ``ksp.py:189``)."""
        self._mat = None
        self._pc = None
        self._abft_placed = None
        return self

    def create(self, comm=None):
        self.comm = comm
        self._pc = PC(comm)
        return self

    def set_type(self, ksp_type: str):
        """The Krylov type: any of the JAX package's ``KSP_KERNELS``; a type
        neither package has raises ``ValueError``."""
        self._type = check_ksp_type(str(ksp_type).lower())
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

    def set_pc(self, pc: PC):
        self._pc = pc
        return self

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

    def get_tolerances(self):
        """``(rtol, atol, divtol, max_it)`` (petsc4py's getTolerances)."""
        return (self.rtol, self.atol, self.divtol, self.max_it)

    getTolerances = get_tolerances

    def get_operators(self):
        """``(A, P)``: the operator and the preconditioning matrix; raises
        before ``set_operators``, as petsc4py does."""
        if self._mat is None:
            raise RuntimeError("KSP.get_operators: no operators set")
        return (self._mat, self.get_pc()._mat)

    getOperators = get_operators

    def set_initial_guess_nonzero(self, flag: bool):
        """Start the next solves from the ``x`` passed in (``X`` for
        ``solve_many``) instead of zero."""
        self._initial_guess_nonzero = bool(flag)
        return self

    setInitialGuessNonzero = set_initial_guess_nonzero

    def set_monitor(self, cb):
        """Add ``cb(ksp, iteration, rnorm)``, called with every residual
        norm the solve reads (``-ksp_monitor``'s slot)."""
        self._monitors.append(cb)
        return self

    setMonitor = set_monitor

    def set_convergence_history(self, length: int | None = None,
                                reset: bool = False):
        """KSPSetResidualHistory: record the residual norms of the next
        solves, the iteration-0 norm included (``iterations + 1`` entries
        a solve; one per restart cycle for gmres/fgmres). ``length`` caps
        the record (petsc4py's 10000 by default); ``reset`` clears it at
        each solve, otherwise it accumulates. Calling again starts a new
        record."""
        self._history = []
        self._history_length = (_HISTORY_LENGTH if length is None
                                else int(length))
        self._history_reset = bool(reset)
        return self

    setConvergenceHistory = set_convergence_history

    def get_convergence_history(self) -> np.ndarray:
        """The recorded residual norms, oldest first."""
        return np.asarray(self._history or [], dtype=float)

    getConvergenceHistory = get_convergence_history

    def _monitor_list(self) -> list:
        """The callbacks a solve delivers to, in the JAX package's order:
        the user monitors, ``-ksp_monitor``'s printout when there are none,
        the history record."""
        mons = list(self._monitors)
        if self._monitor_flag and not self._monitors and self._prints():
            mons.append(lambda ksp, k, rn: print(
                f"  {int(k):4d} KSP Residual norm {float(rn):.12e}"))
        if self._history is not None:
            def record(_ksp, _it, rn):
                if len(self._history) < self._history_length:
                    self._history.append(float(rn))
            mons.append(record)
        return mons

    def _prints(self) -> bool:
        """Whether this process prints: rank 0 of a process comm, always
        on the virtual mesh."""
        return getattr(self.comm, "rank", 0) == 0

    def view(self, file=None):
        """Print the solver configuration (``-ksp_view``)."""
        file = file or sys.stdout
        pc = self.get_pc()
        print(f"KSP Object: type={self._type}\n"
              f"  tolerances: rtol={self.rtol:g}, atol={self.atol:g}, "
              f"divtol={self.divtol:g}, max_it={self.max_it}\n"
              f"  norm type: {self.get_norm_type()}\n"
              f"  gmres restart: {self.restart}\n"
              f"  PC Object: type={pc.get_type()}, "
              f"factor solver: {pc._factor_solver_type}\n"
              f"  mesh devices: {self.comm.size if self.comm else '?'}",
              file=file)

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
        if t == "natural":
            if self._type not in NATURAL_TYPES:
                raise ValueError(
                    f"norm type 'natural' is available for KSP "
                    f"{list(NATURAL_TYPES)}, whose recurrence carries "
                    f"sqrt <r, M r>; {self._type!r} does not — use "
                    "'default'")
            return
        if t == "none":
            if self._type in _CYCLE_GRANULAR:
                raise ValueError(
                    f"norm type 'none' is unavailable for KSP {self._type!r} "
                    "(iterations advance a whole restart cycle, or ell steps "
                    "for bcgsl, at a time, so a fixed max_it contract cannot "
                    "hold)")
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

    def set_options_prefix(self, prefix: str):
        """Read this KSP's (and its PC's) flags as ``-<prefix>ksp_...``
        (JAX ``ksp.py:345``)."""
        self._prefix = prefix or ""
        return self

    setOptionsPrefix = set_options_prefix

    def get_options_prefix(self) -> str:
        return self._prefix

    getOptionsPrefix = get_options_prefix

    def set_from_options(self):
        """Apply the options database under the options prefix (JAX
        ``ksp.py:392-472``): ``-ksp_type``, ``-ksp_rtol``, ``-ksp_atol``,
        ``-ksp_divtol``, ``-ksp_max_it``, ``-ksp_gmres_restart``,
        ``-ksp_norm_type``, ``-ksp_batch_limit``,
        ``-ksp_true_residual_check``, ``-ksp_true_residual_margin``,
        ``-ksp_converged_reason``, ``-ksp_monitor``, ``-ksp_view``,
        ``-ksp_lgmres_augment``, ``-ksp_bcgsl_ell``, ``-ksp_sstep_s``,
        ``-pc_type``, ``-pc_factor_mat_solver_type``, ``-pc_bjacobi_blocks``,
        ``-pc_sor_omega``, ``-pc_asm_overlap``, ``-pc_factor_fill``,
        ``-pc_setup_device``, ``-pc_mg_smooth_type``,
        ``-pc_composite_type``, ``-pc_composite_pcs`` (comma-separated).

        ``-ksp_megasolve``, ``-ksp_megasolve_stencil_fastpath``,
        ``-ksp_reduction_auto`` and ``-ksp_reduction_probe_refresh`` choose
        the fused program and the reduction plan selection (module
        docstring). ``-ksp_abft``, ``-ksp_abft_tol``,
        ``-ksp_residual_replacement``, ``-ksp_pipeline_auto_replacement``,
        ``-ksp_sstep_auto_replacement`` and ``-ksp_sstep_max_replacements``
        configure the silent-corruption guard. ``-pc_gamg_threshold``,
        ``-pc_gamg_coarse_eq_limit`` and ``-pc_mg_levels`` tune PC gamg's
        hierarchy; ``-ksp_unroll`` is stored (above 1 it keeps a solve off
        the fused program, as in JAX)."""
        opt = global_options()
        p = self._prefix
        t = opt.get_string(p + "ksp_type")
        if t:
            self.set_type(t)
        self.rtol = opt.get_real(p + "ksp_rtol", self.rtol)
        self.atol = opt.get_real(p + "ksp_atol", self.atol)
        self.divtol = opt.get_real(p + "ksp_divtol", self.divtol)
        self.max_it = opt.get_int(p + "ksp_max_it", self.max_it)
        self.restart = opt.get_int(p + "ksp_gmres_restart", self.restart)
        self.batch_limit = opt.get_int(p + "ksp_batch_limit",
                                       self.batch_limit)
        nt = opt.get_string(p + "ksp_norm_type")
        if nt:
            self.set_norm_type(nt)
        self._true_residual_check = opt.get_bool(
            p + "ksp_true_residual_check", self._true_residual_check)
        self.true_residual_margin = opt.get_real(
            p + "ksp_true_residual_margin", self.true_residual_margin)
        self.abft = opt.get_bool(p + "ksp_abft", self.abft)
        self.residual_replacement = opt.get_int(
            p + "ksp_residual_replacement", self.residual_replacement)
        for attr in _MODE_FLAGS:
            setattr(self, attr, opt.get_bool(p + "ksp_" + attr,
                                             getattr(self, attr)))
        self.abft_tol = opt.get_real(p + "ksp_abft_tol", self.abft_tol)
        for attr in ("lgmres_augment", "bcgsl_ell", "unroll",
                     "pipeline_auto_replacement", "sstep_s",
                     "sstep_max_replacements", "sstep_auto_replacement"):
            setattr(self, attr, opt.get_int(p + "ksp_" + attr,
                                            getattr(self, attr)))
        self.reduction_probe_refresh = opt.get_bool(
            p + "ksp_reduction_probe_refresh", self.reduction_probe_refresh)
        self._reason_flag = opt.get_bool(p + "ksp_converged_reason",
                                         self._reason_flag)
        self._monitor_flag = opt.get_bool(p + "ksp_monitor",
                                          self._monitor_flag)
        self._view_flag = opt.get_bool(p + "ksp_view", self._view_flag)
        pc = self.get_pc()
        pct = opt.get_string(p + "pc_type")
        if pct:
            pc.set_type(pct)
        fst = opt.get_string(p + "pc_factor_mat_solver_type")
        if fst:
            pc.set_factor_solver_type(fst)
        pc.bjacobi_blocks = opt.get_int(p + "pc_bjacobi_blocks",
                                        pc.bjacobi_blocks)
        pc.sor_omega = opt.get_real(p + "pc_sor_omega", pc.sor_omega)
        pc.asm_overlap = opt.get_int(p + "pc_asm_overlap", pc.asm_overlap)
        pc.factor_fill = opt.get_real(p + "pc_factor_fill", pc.factor_fill)
        pc.gamg_threshold = opt.get_real(p + "pc_gamg_threshold",
                                         pc.gamg_threshold)
        pc.gamg_coarse_size = opt.get_int(p + "pc_gamg_coarse_eq_limit",
                                          pc.gamg_coarse_size)
        pc.gamg_max_levels = opt.get_int(p + "pc_mg_levels",
                                         pc.gamg_max_levels)
        sd = opt.get_string(p + "pc_setup_device")
        if sd:
            pc.setup_device = sd
        mst = opt.get_string(p + "pc_mg_smooth_type")
        if mst:                       # 'chebyshev' | 'jacobi' (solvers/mg)
            pc.mg_smoother = mst
        ct = opt.get_string(p + "pc_composite_type")
        if ct:
            pc.set_composite_type(ct)
        cp = opt.get_string(p + "pc_composite_pcs")
        if cp:
            pc.set_composite_pcs(*[t.strip() for t in cp.split(",")
                                   if t.strip()])
        return self

    setFromOptions = set_from_options

    def _effective_replacement(self) -> int:
        """The replacement interval a solve arms (JAX ``ksp.py:520``):
        ``-ksp_residual_replacement`` when set, else pipecg's
        ``-ksp_pipeline_auto_replacement`` or sstep's
        ``-ksp_sstep_auto_replacement``."""
        if self.residual_replacement > 0:
            return int(self.residual_replacement)
        if self._type in _AUTO_REPLACEMENT:
            return int(getattr(self, _AUTO_REPLACEMENT[self._type]))
        return 0

    def _guard_requested(self) -> bool:
        """Whether a solve would arm the silent-corruption guard (JAX
        ``ksp.py:533``)."""
        return bool(self.abft or self._effective_replacement() > 0)

    def _check_guard(self):
        """The guard's support rule (JAX ``ksp.py:535`` and ``krylov.py:
        2191-2207``): cg, pipecg and sstep only, no null space, the
        unpreconditioned norm."""
        if not self._guard_requested():
            return
        if self._type not in GUARDED_TYPES:
            raise ValueError(
                f"-ksp_abft / -ksp_residual_replacement (the "
                f"silent-corruption guard) support KSP "
                f"{sorted(GUARDED_TYPES)}; KSP {self._type!r} has no "
                "guarded kernel: disable the guard or use cg")
        if self._mat is not None and self._nullspace_basis(
                self._mat) is not None:
            raise ValueError(
                "the silent-corruption guard does not compose with a "
                "null-space projection (the projected operator's column "
                "checksum differs from the assembled one); disable "
                "-ksp_abft/-ksp_residual_replacement for singular solves")
        if self._norm_type == "natural":
            raise ValueError(
                "the silent-corruption guard monitors the unpreconditioned "
                "residual norm; it does not compose with -ksp_norm_type "
                "natural")

    def set_up(self):
        """Set up the PC on its operator (the factor PCs factor here), then,
        with ``-ksp_reduction_auto``, choose the reduction plan. Raises
        first when a mode the port lacks was asked for."""
        if self._mat is None:
            raise RuntimeError("KSP.set_up: no operators set")
        pc = self.get_pc()
        pc.set_up(pc._mat if pc._mat is not None else self._mat)
        if self.reduction_auto:
            # after the PC set-up: the apply probe runs the real operator
            # and PC apply
            self._autoselect_reduction()
        return self

    def _autoselect_reduction(self):
        """``-ksp_reduction_auto`` (JAX ``ksp.py:487-517``): pick classic,
        pipelined or s-step CG (with its ``s``) from the measured latency of
        one reduction on this communicator and of one operator + PC apply
        (``solvers/autoselect.py``). Runs once per (operator, mesh); only a
        cg/pipecg/sstep starting type is re-routed. The report stays on the
        KSP as ``_reduction_report``."""
        if self._type not in ("cg", "pipecg", "sstep"):
            return
        mat = self._mat
        key = (id(mat), getattr(mat, "_state", 0), id(mat.comm))
        if self._autoselect_key == key:
            return
        from . import autoselect
        with _telemetry.span("ksp.autoselect", starting_type=self._type) as sp:
            report = autoselect.select_reduction_plan(
                mat.comm, mat, self.get_pc(),
                refresh=self.reduction_probe_refresh)
            self._type = report.ksp_type
            if report.ksp_type == "sstep":
                self.sstep_s = int(report.s)
            self._reduction_report = report
            self._autoselect_key = key
            sp.set_attrs(choice=report.ksp_type, s=int(report.s or 0),
                         psum_us=float(report.psum_us),
                         apply_us=float(report.apply_us),
                         probe_cached=bool(report.probe_cached))

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

    @property
    def converged(self) -> bool:
        """Whether the last solve converged (JAX ``ksp.py:1970``)."""
        return self.result.converged

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

    # reductions an iteration of the CG family makes, by (type, guarded)
    # (per s-block for sstep): the JAX package's span attribute; the port's
    # loops make the same count but on an unguarded stencil fast path, whose
    # fused kernel folds <p, A p> into its own reduction (2, not 3)
    _REDUCE_SITES = {("cg", False): 3, ("cg", True): 2,
                     ("pipecg", False): 1, ("pipecg", True): 1,
                     ("sstep", False): 1, ("sstep", True): 1}

    def _reduce_sites(self):
        """The ``reduce_sites`` span attribute, or None where the port's
        plan makes another count than JAX's."""
        guard = self._guard_requested()
        sites = self._REDUCE_SITES.get((self._type, guard))
        mat, pc = self._mat, self._pc
        if sites is None or guard or mat is None or pc is None:
            return sites
        if self._megasolve_eligible():
            from .megasolve import megasolve_stencil_supported
            fast = (self.megasolve_stencil_fastpath
                    and megasolve_stencil_supported(self._type, pc, mat))
        else:
            fast = stencil_cg_eligible(self._type, pc, mat,
                                       nullspace=self._nullspace_basis(mat),
                                       natural=self._norm_type == "natural")
        return None if fast else sites

    @wrap_device_errors("KSPSolve")
    def solve(self, b, x, *, _rtol=None, _atol=None, _guess_nonzero=None,
              _no_reenter=False, _mon_offset=0) -> SolveResult:
        """Solve ``A x = b``; the solution is written into ``x``. The
        underscore arguments are the true-residual gate's re-entry: other
        tolerances, the current ``x`` as the initial guess, and the
        iterations already spent, by which the monitors' iteration numbers
        are offset. With ``-ksp_converged_reason`` the outcome is printed,
        and with ``-ksp_view`` the configuration, as PETSc does. The call
        is one ``ksp.solve`` span."""
        mat = self._mat
        sp = _telemetry.span(
            "ksp.solve", ksp_type=self._type,
            pc=self._pc.get_type() if self._pc is not None else "",
            operator=type(mat).__name__ if mat is not None else "",
            n=int(mat.shape[0]) if mat is not None else 0,
            precision=_dtype_name(mat),
            devices=int(getattr(self.comm, "size", 0) or 0),
            reentry=bool(_no_reenter))
        if sp is not _telemetry.NOOP:
            sites = self._reduce_sites()
            if sites is not None:
                sp.set_attr("reduce_sites", sites)
        with sp:
            res = self._solve(b, x, _rtol, _atol, _guess_nonzero,
                              _no_reenter, _mon_offset)
            sp.set_attrs(iterations=res.iterations, reason=res.reason,
                         converged=res.converged, rnorm=res.residual_norm)
        if not _no_reenter and self._prints():
            if self._view_flag:
                self.view()
            if self._reason_flag:
                verb = "converged" if res.converged else "did not converge"
                print(f"Linear solve {verb} due to {res.reason_name} "
                      f"iterations {res.iterations}")
        return res

    def _nullspace_basis(self, mat):
        """The operator's null-space basis on its device, or None (no null
        space, or an empty one: JAX ``ksp.py:684``)."""
        ns = getattr(mat, "nullspace", None)
        if ns is None or ns.dim == 0:
            return None
        return ns.device_array(mat.comm, mat.shape[0], mat.dtype)

    def _solve(self, b, x, _rtol, _atol, _guess_nonzero, _no_reenter,
               _mon_offset):
        mat = self._mat
        if mat is None:
            raise RuntimeError("KSP.solve: no operators set")
        _agreed_check(mat.comm, "ksp.solve")   # a pre-solve failure
        self._check_norm_type()
        self._check_guard()
        with _telemetry.span("ksp.setup"):
            self.set_up()
        pc = self.get_pc()
        if pc.kind == "hostlu":
            return self._solve_hostlu(b, x)
        if self._history is not None and self._history_reset:
            self._history.clear()
        norm_none, rtol, atol, divtol = self._run_tolerances()
        if _rtol is not None:
            rtol, atol = _rtol, _atol
        guess_nonzero = (self._initial_guess_nonzero if _guess_nonzero is None
                         else _guess_nonzero)
        # -ksp_megasolve: the fused program, the true-residual gate
        # in-program (solvers/megasolve.py); other configurations run the
        # unfused path below (JAX ksp.py:650-656)
        if self._megasolve_eligible():
            return self._solve_megasolve(b, x, rtol, atol, guess_nonzero)
        gate = (self._true_residual_check and self._type != "preonly"
                and not norm_none)
        guard = self._guard_requested()
        margin = self._margin() if gate else 1.0
        monitors = self._monitor_list()
        monitor = None
        if monitors:
            def monitor(it, rn):
                for m in monitors:
                    m(self, it + _mon_offset, rn)
        pc_on = False
        if guard:
            cs, csM, pc_on = self._guard_checksums(mat, pc)
        with _telemetry.span("ksp.setup"):
            if guard:
                prog = build_guarded_program(
                    mat.comm, self._type, pc, mat, abft_tol=self.abft_tol,
                    rr_n=self._effective_replacement(), cs=cs, csM=csM,
                    max_repl=self.sstep_max_replacements, true_res=gate,
                    monitor=monitor, sstep_s=self.sstep_s)
            else:
                prog = build_ksp_program(
                    mat.comm, self._type, pc, mat, restart=self.restart,
                    true_res=gate, nullspace=self._nullspace_basis(mat),
                    monitor=monitor, natural=self._norm_type == "natural",
                    aug=self.lgmres_augment, ell=self.bcgsl_ell,
                    sstep_s=self.sstep_s)
        x0 = (x.data.clone() if guess_nonzero
              else torch.zeros_like(b.data))
        self._program_fault(prog, b.data, x0, divtol, mat,
                            lambda xd: setattr(x, "data", xd))
        t0 = time.perf_counter()
        with _telemetry.span("ksp.dispatch"):
            _telemetry.record_program_dispatch("ksp")
            out = prog(b.data, x0, *_tolerances(mat.dtype, rtol * margin,
                                                atol * margin, divtol),
                       self.max_it)
        with _telemetry.span("ksp.fetch"):
            xd, iters, rnorm, reason, syncs = out[:5]
            x.data = xd
        record_sync("KSP result fetch/solve", syncs)
        rest = out[5:]
        checks = rrc = 0
        if guard:
            det, rrc, xv = rest[:3]
            rest = rest[3:]
            # one init check, then one a step per checked channel (the
            # stencil fast path has no PC channel: its Jacobi is a scalar)
            checks = (1 + iters * (1 + int(pc_on))) if self.abft else 0
            if det == SDC_DEMOTE:
                record_sdc(checks, 0, rrc)
                return self._demote_sstep(b, x, rtol=rtol, atol=atol,
                                          iters=iters, rrc=rrc,
                                          checks=checks, t0=t0, syncs=syncs)
            if det != SDC_NONE:
                record_sdc(checks, 1, rrc)
                x.data = xv
                raise SilentCorruptionError(
                    "KSPSolve", SDC_DETECTOR_NAMES.get(det, f"det{det}"),
                    iters, detail=f"{rrc} residual replacement(s) passed "
                                  "before detection")
            record_sdc(checks, 0, rrc)
        rnorm, iters = _result_fault(rnorm, iters)
        wall = time.perf_counter() - t0
        self.result = SolveResult(iters, rnorm,
                                  _final_reason(reason, rnorm, norm_none),
                                  wall, syncs, abft_checks=checks,
                                  residual_replacements=rrc)
        record_event(f"KSPSolve({self._type}+{pc.get_type()})", mat.shape[0],
                     self.result.iterations, wall, self.result.reason)
        if not _no_reenter:
            self._last_reentries = 0
        if not gate:
            return self.result
        true_rn, bnorm = rest
        self._last_true_res = (true_rn, bnorm)
        target = max(rtol * bnorm, atol)
        # the margin must never turn a truly converged solve into a failure
        if (not self.result.converged and math.isfinite(true_rn)
                and true_rn <= target):
            self.result = SolveResult(iters, true_rn,
                                      ConvergedReason.CONVERGED_RTOL, wall,
                                      syncs, abft_checks=checks,
                                      residual_replacements=rrc)
        if not _no_reenter and self.result.converged:
            with _telemetry.span("ksp.verify", true_rnorm=float(true_rn),
                                 bnorm=float(bnorm)) as vsp:
                self._reenter(b, x, target, true_rn, rnorm, _mon_offset)
                vsp.set_attrs(reentries=self._last_reentries,
                              passed=self._last_true_res[0] <= target)
        return self.result

    def _reenter(self, b, x, target, trn, last_mon_rn, mon_offset):
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
            # a loop on the preconditioned or natural norm exits on its own
            # norm: map the unpreconditioned target through the ratio seen
            # at this iterate
            sub_atol = target
            if (self.get_norm_type() in ("preconditioned", "natural")
                    and math.isfinite(last_mon_rn) and last_mon_rn > 0
                    and trn > 0):
                sub_atol = target * last_mon_rn / trn
            sub = self.solve(b, x, _rtol=0.0, _atol=sub_atol,
                             _guess_nonzero=True, _no_reenter=True,
                             _mon_offset=mon_offset + total[0])
            total = [total[0] + sub.iterations, total[1] + sub.wall_time,
                     total[2] + sub.host_syncs]
            last_mon_rn = sub.residual_norm
            trn = self._last_true_res[0]
            reason = (ConvergedReason.CONVERGED_RTOL if trn <= target
                      else sub.reason)
            self.result = SolveResult(total[0], trn, reason, total[1],
                                      total[2])
            self._last_reentries = attempts

    # ---- the silent-corruption guard ----------------------------------------
    def _guard_checksums(self, mat, pc, many=False, fused=False):
        """``(cs, csM, pc_on)`` for a guarded program (JAX
        ``ksp.py:544-566``): the operator's and the PC's column checksums
        placed on this process's rows, or None; ``"boundary"`` for the
        stencil fast path, which reads its analytic checksum on the
        boundary shells and has no PC channel (never for the ``fused``
        program, whose guard takes the general route). Cached on the KSP,
        keyed by the operator, the PC and their mutation counters."""
        if not self.abft:
            return None, None, False
        if not fused and guarded_stencil_eligible(self._type, pc, mat, many):
            return "boundary", None, False
        from ..resilience import abft as abft_mod
        pmat = pc._mat
        key = (id(mat), getattr(mat, "_state", 0), pc.get_type(), id(pmat),
               getattr(pmat, "_state", 0), str(mat.dtype), id(mat.comm))
        if self._abft_placed is not None and self._abft_placed[0] == key:
            return self._abft_placed[1]
        comm = mat.comm
        L = comm.local_shards
        cs = comm.put_rows(np.asarray(abft_mod.column_checksum(mat)),
                           mat.dtype).view(L, -1)
        csM_h = abft_mod.pc_checksum(pc, mat)
        csM = (None if csM_h is None else
               comm.put_rows(np.asarray(csM_h), mat.dtype).view(L, -1))
        placed = (cs, csM, csM is not None)
        self._abft_placed = (key, placed)
        return placed

    def _program_fault(self, prog, b, x0, divtol, mat, keep):
        """The ``ksp.program`` fault point and the ``device.lost`` check
        around the solve program (JAX ``ksp.py:772-786``): a simulated
        device failure during the solve. With ``iter=K`` the program first
        runs K iterations (``maxit`` truncated, tolerances 0) and ``keep``
        receives that real partial iterate, as after a mid-solve crash."""
        fault = _faults.triggered("ksp.program")
        if fault is None:
            fault = _faults.mesh_fault("device.lost", mat.comm.device_ids)
        fault = mat.comm.agree_fault(fault)
        if fault is None:
            return
        if fault.iter_k:
            _telemetry.record_program_dispatch("ksp")
            part = prog(b, x0.clone(), *_tolerances(mat.dtype, 0.0, 0.0,
                                                    divtol),
                        min(int(fault.iter_k), self.max_it))
            keep(part[0])
        raise fault.error()

    def _demote_clone(self) -> "KSP":
        """A classic-CG twin sharing the operator and the set-up PC: the
        continuation of a demoted s-step solve (JAX ``ksp.py:1085``). It
        keeps ABFT when armed, not the s-step replacement interval, which
        would restart CG's direction chain every few iterations."""
        k2 = KSP()
        k2.comm = self.comm
        k2._mat = self._mat
        k2._pc = self._pc
        k2._type = "cg"
        k2.rtol, k2.atol = self.rtol, self.atol
        k2.divtol, k2.max_it = self.divtol, self.max_it
        k2.abft = self.abft
        k2.abft_tol = self.abft_tol
        k2.residual_replacement = 0
        k2._monitors = list(self._monitors)
        k2._monitor_flag = self._monitor_flag
        k2._initial_guess_nonzero = True
        return k2

    def _demote_sstep(self, b, x, *, rtol, atol, iters, rrc, checks,
                      t0, syncs=0) -> SolveResult:
        """The ``SDC_DEMOTE`` exit of a guarded s-step solve (JAX
        ``ksp.py:1108``): the drift gate restarted the basis
        ``-ksp_sstep_max_replacements`` times and it still stalls, so the
        solve continues as classic CG from its trusted iterate; the result
        merges both (``syncs``: the s-step part's host reads) and records a
        ``sstep_demote`` event."""
        registry.counter("sstep.demotions").inc()
        sub_ksp = self._demote_clone()
        sub_ksp.max_it = max(self.max_it - iters, 1)
        sub = sub_ksp.solve(b, x, _rtol=rtol, _atol=atol,
                            _guess_nonzero=True, _mon_offset=iters)
        res = SolveResult(iters + sub.iterations, sub.residual_norm,
                          sub.reason, time.perf_counter() - t0,
                          syncs + sub.host_syncs,
                          abft_checks=checks + sub.abft_checks,
                          residual_replacements=rrc
                          + sub.residual_replacements)
        res.recovery_events = [RecoveryEvent(
            "sstep_demote", 1,
            detail=(f"s={self.sstep_s}: {self.sstep_max_replacements} "
                    "basis restart(s) exhausted; demoted to classic cg"),
            iterations=iters, detector="drift")] + list(sub.recovery_events)
        self.result = res
        return res

    def _demote_sstep_many(self, B, X, *, iters, rrc, checks, t0,
                           demoted, syncs=0) -> BatchedSolveResult:
        """Batched twin of :meth:`_demote_sstep` (JAX ``ksp.py:1129``): the
        whole block continues as classic CG from its current iterates (a
        converged column freezes at once), on the remaining iteration
        budget."""
        registry.counter("sstep.demotions").inc(len(demoted))
        sub_ksp = self._demote_clone()
        sub_ksp.max_it = max(self.max_it - (max(iters) if iters else 0), 1)
        sub = sub_ksp.solve_many(B, X)
        res = BatchedSolveResult(
            [int(a) + int(c) for a, c in zip(iters, sub.iterations)],
            sub.residual_norms, sub.reasons, time.perf_counter() - t0,
            sub.X, sub.histories, syncs + sub.host_syncs,
            abft_checks=checks + sub.abft_checks,
            residual_replacements=rrc + sub.residual_replacements)
        res.recovery_events = [RecoveryEvent(
            "sstep_demote", 1,
            detail=(f"s={self.sstep_s}: columns {sorted(demoted)} "
                    "exhausted the basis-restart budget; block demoted to "
                    "classic cg"),
            iterations=max(iters) if iters else 0, detector="drift")] \
            + list(sub.recovery_events)
        self.result_many = res
        return res

    # ---- megasolve: the fused whole-solve path --------------------------------
    def _megasolve_eligible(self, many: bool = False) -> bool:
        """Route this solve through the fused program (JAX ``ksp.py:1165``)?
        Any configuration without a fused equivalent (non-CG types, a null
        space, monitors or a history, a norm type other than the default,
        ``unroll`` above 1, host LU) runs the unfused path: JAX's routing
        rule, not a fallback on failure."""
        if not self.megasolve or self._mat is None:
            return False
        if self._nullspace_basis(self._mat) is not None:
            return False
        if self._norm_type != "default" or self.unroll != 1:
            return False
        if self._monitors or self._monitor_flag or self._history is not None:
            return False
        from .megasolve import megasolve_supported
        return megasolve_supported(self._type, self.get_pc(), self._mat,
                                   nrhs=2 if many else None)

    def _megasolve_guard(self, many=False) -> dict:
        """The guard's arguments of the fused program (JAX ``ksp.py:1205-
        1217``): ``abft``/``abft_pc``/``rr``, the placed checksums of the
        general route, the ``-ksp_abft_tol`` multiplier, the replacement
        interval and the s-step restart budget; empty without a guard."""
        if not self._guard_requested():
            return {}
        cs, csM, pc_on = self._guard_checksums(self._mat, self.get_pc(),
                                               many=many, fused=True)
        rr_n = self._effective_replacement()
        return dict(abft=bool(self.abft), abft_pc=pc_on, rr=rr_n > 0,
                    cs=cs, csM=csM, abft_tol=float(self.abft_tol),
                    rr_n=rr_n, max_repl=int(self.sstep_max_replacements))

    def _megasolve_program(self, many_k=None, guard=None):
        from .megasolve import (build_megasolve_program,
                                build_megasolve_program_many,
                                megasolve_stencil_supported)
        mat, pc = self._mat, self.get_pc()
        guard = guard or {}
        sf = (self.megasolve_stencil_fastpath
              and megasolve_stencil_supported(self._type, pc, mat,
                                              nrhs=many_k,
                                              guard=bool(guard)))
        with _telemetry.span("ksp.setup"):
            if many_k is None:
                return build_megasolve_program(
                    mat.comm, self._type, pc, mat, sstep_s=self.sstep_s,
                    stencil_fastpath=sf, **guard)
            return build_megasolve_program_many(
                mat.comm, self._type, pc, mat, nrhs=many_k,
                sstep_s=self.sstep_s, stencil_fastpath=sf, **guard)

    def _megasolve_run(self, prog, b, x0, rtol, atol, kind, keep):
        """One fused solve with the uniform-gate semantics: the unfused
        gate's step cap and its DIVERGED_MAX_IT for a drift stall (an inner
        breakdown still reports DIVERGED_BREAKDOWN). The fault points around
        the program come first (JAX ``ksp.py:1224-1249``): with ``iter=K``
        one outer step of K inner iterations runs, and ``keep`` receives
        its iterate."""
        from .megasolve import GATE_REFINE_MAX
        fault = _faults.triggered("ksp.program")
        if fault is None:
            fault = _faults.mesh_fault("device.lost",
                                       self._mat.comm.device_ids)
        fault = self._mat.comm.agree_fault(fault)
        if fault is not None:
            if fault.iter_k:
                _telemetry.record_program_dispatch(kind)
                part = prog(b, x0, 0.0, 0.0, 0.0, self.divtol,
                            min(int(fault.iter_k), self.max_it), 1,
                            ConvergedReason.DIVERGED_MAX_IT)
                keep(part.x)
            raise fault.error()
        t0 = time.perf_counter()
        # the program holds the scalars in the operator's tolerance dtype
        with _telemetry.span("ksp.dispatch"):
            _telemetry.record_program_dispatch(kind)
            res = prog(b, x0, rtol, atol, rtol, self.divtol, self.max_it,
                       GATE_REFINE_MAX, ConvergedReason.DIVERGED_MAX_IT)
        self._last_reentries = 0      # in-program re-entries are no host
        #                               gate re-entries
        return res, t0

    def _fused_checks(self, guard, steps, iters):
        """ABFT checks of a fused guarded solve (JAX ``ksp.py:1282``): one
        init check an outer step (a column), one an inner iteration a
        checked channel."""
        if not guard.get("abft"):
            return 0
        return steps + iters * (1 + int(guard["abft_pc"]))

    def _solve_megasolve(self, b, x, rtol, atol, guess_nonzero):
        """The ``-ksp_megasolve`` path (JAX ``ksp.py:1188``): the fused
        program re-enters the CG recurrence from the TRUE residual until
        ``max(rtol ||b||, atol)`` passes, so the reported norm is the
        verified ``||b - A x||``. The result also carries the outer steps
        (``megasolve_steps``), the graph replays, the masked inner steps
        and whether CUDA graphs ran. Under the guard a detection raises
        ``SilentCorruptionError`` with ``x`` the fused loop's verified
        carry, and a demotion continues as classic CG from the outer
        carry."""
        mat = self._mat
        L = mat.comm.local_shards
        guard = self._megasolve_guard()
        prog = self._megasolve_program(guard=guard)
        x0 = x.data.view(L, -1).to(mat.dtype) if guess_nonzero else None
        keep = lambda xd: setattr(x, "data", xd.reshape(-1))
        res, t0 = self._megasolve_run(prog, b.data.view(L, -1), x0, rtol,
                                      atol, "megasolve", keep)
        with _telemetry.span("ksp.fetch"):
            keep(res.x)
        record_sync("KSP result fetch/solve", res.host_reads)
        checks = rrc = 0
        if guard:
            rrc = res.rrc
            checks = self._fused_checks(guard, res.steps, res.iters)
            if res.det == SDC_DEMOTE:
                record_sdc(checks, 0, rrc)
                return self._demote_sstep(
                    b, x, rtol=rtol, atol=atol, iters=res.iters, rrc=rrc,
                    checks=checks, t0=t0, syncs=res.host_reads)
            if res.det != SDC_NONE:
                record_sdc(checks, 1, rrc)
                keep(res.xv)
                raise SilentCorruptionError(
                    "KSPSolve", SDC_DETECTOR_NAMES.get(res.det,
                                                       f"det{res.det}"),
                    res.iters,
                    detail=f"detected inside the fused megasolve loop "
                           f"({rrc} residual replacement(s) passed before "
                           "detection)")
            record_sdc(checks, 0, rrc)
        rnorm, iters = _result_fault(res.rnorm, res.iters)
        reason = res.reason
        if not math.isfinite(rnorm):
            reason = ConvergedReason.DIVERGED_NANORINF
        wall = time.perf_counter() - t0
        self.result = SolveResult(iters, rnorm, int(reason), wall,
                                  res.host_reads, abft_checks=checks,
                                  residual_replacements=rrc)
        _megasolve_stats(self.result, res)
        record_event(f"KSPSolve({self._type}+{self.get_pc().get_type()}"
                     "+mega)", mat.shape[0], iters, wall, int(reason))
        return self.result

    def _solve_many_megasolve(self, Bd, X, n, x_vecs, B):
        """The batched fused path (JAX ``ksp.py:1336``): the whole block's
        gate recurrence in one fused program, per-column results as the
        unfused batched path reports them; under the guard a detection
        writes the block's verified carry into ``X`` and raises, a demotion
        continues the block as classic CG."""
        mat = self._mat
        comm = mat.comm
        k = int(Bd.shape[1])
        guard = self._megasolve_guard(many=True)
        prog = self._megasolve_program(many_k=k, guard=guard)
        X0 = None
        if self._initial_guess_nonzero:
            X0 = (torch.stack([v.data.view(comm.local_shards, -1) for v in X],
                              dim=1).to(mat.dtype)
                  if x_vecs else comm.put_cols(X, mat.dtype))

        def write(Xd):
            if x_vecs:
                for j, xv in enumerate(X):
                    xv.data = Xd[:, j].reshape(-1).to(xv.dtype)
            else:
                X[...] = comm.fetch_cols(Xd, n)

        res, t0 = self._megasolve_run(prog, Bd, X0, self.rtol, self.atol,
                                      "megasolve_many", write)
        with _telemetry.span("ksp.fetch"):
            write(res.x)
        record_sync("KSP solve_many result fetch", res.host_reads)
        checks = rrc = 0
        if guard:
            rrc = int(sum(res.rrc))
            checks = self._fused_checks(guard, k * res.steps,
                                        sum(res.iters))
            bad = [j for j, d in enumerate(res.det)
                   if d not in (SDC_NONE, SDC_DEMOTE)]
            record_sdc(checks, len(bad), rrc)
            if bad:
                write(res.xv)
                raise SilentCorruptionError(
                    "KSPSolveMany", SDC_DETECTOR_NAMES.get(
                        res.det[bad[0]], str(res.det[bad[0]])),
                    int(max(res.iters[j] for j in bad)),
                    detail=f"columns {bad} flagged inside the fused "
                           "megasolve loop")
            demoted = [j for j, d in enumerate(res.det) if d == SDC_DEMOTE]
            if demoted:
                return self._demote_sstep_many(
                    B, X, iters=list(res.iters), rrc=rrc, checks=checks,
                    t0=t0, demoted=demoted, syncs=res.host_reads)
        reasons = [ConvergedReason.DIVERGED_NANORINF
                   if not math.isfinite(rn) else int(r)
                   for rn, r in zip(res.rnorm, res.reason)]
        wall = time.perf_counter() - t0
        self.result_many = BatchedSolveResult(
            list(res.iters), list(res.rnorm), reasons, wall, X,
            [[] for _ in reasons], res.host_reads, abft_checks=checks,
            residual_replacements=rrc)
        _megasolve_stats(self.result_many, res)
        conv = self.result_many.converged
        record_event(f"KSPSolveMany({self._type}+{self.get_pc().get_type()}"
                     f"+mega,k={k})", n, max(res.iters, default=0), wall,
                     max(reasons) if conv else min(reasons))
        return self.result_many

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
        bh = np.asarray(b.to_numpy(), dtype=host_dtype(self._mat.dtype))
        xh = factor.solve(bh)
        x.set_global(xh.astype(numpy_dtype(self._mat.dtype)))
        rnorm = float(np.linalg.norm(bh - A64 @ xh))
        self.result = SolveResult(1, rnorm, ConvergedReason.CONVERGED_ITS,
                                  time.perf_counter() - t0, 1)
        record_sync("KSP hostlu gather/scatter", 1)
        record_event("KSPSolve(preonly+hostlu)", self._mat.shape[0], 1,
                     self.result.wall_time, self.result.reason)
        return self.result

    @wrap_device_errors("KSPSolveMany")
    def solve_many(self, B, X=None) -> BatchedSolveResult:
        """Solve ``A X = B`` for a block of ``k`` right-hand sides (PETSc's
        ``KSPMatSolve``; JAX ``ksp.py:1471``), each from a zero guess, or
        from ``X`` with ``set_initial_guess_nonzero(True)``.

        ``B`` is an ``(n, k)`` host array or a list of ``k`` Vecs; ``X`` is
        None, an ``(n, k)`` host array or a list of ``k`` Vecs, and receives
        the solution. Returns per-column iterations, residual norms, reasons
        and, when monitoring, histories; a column that converges early
        freezes while the others run on.

        CG, pipecg and sstep with PC none/jacobi/bjacobi/lu (dense), no
        null space and norm type default/none run the ``k`` recurrences in
        lockstep: one operator pass and one reduction per phase (pipecg:
        per iteration; sstep: per block) serve every column. With
        ``-ksp_true_residual_check`` the program's epilogue returns every
        column's ``||b_j - A x_j||`` and ``||b_j||``; the columns whose true
        residual misses ``max(rtol ||b_j||, atol)`` send the whole block
        back in from the current ``X``, where the columns that already meet
        their tolerance freeze at once (JAX ``:1588-1630``). Other
        configurations (PC mg, shell or composite, host LU, the other KSP
        types, a null space) solve the columns one by one. ``batch_limit``
        (``-ksp_batch_limit``) splits a wider block into batched solves of
        at most that many columns. The call is one ``ksp.solve_many``
        span.
        """
        mat = self._mat
        sp = _telemetry.span(
            "ksp.solve_many", ksp_type=self._type,
            pc=self._pc.get_type() if self._pc is not None else "",
            operator=type(mat).__name__ if mat is not None else "",
            n=int(mat.shape[0]) if mat is not None else 0,
            precision=_dtype_name(mat),
            devices=int(getattr(self.comm, "size", 0) or 0))
        with sp:
            res = self._solve_many(B, X)
            its = res.iterations
            sp.set_attrs(nrhs=len(its), iterations=max(its) if its else 0,
                         converged=res.converged)
            return res

    def _solve_many(self, B, X):
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
        _agreed_check(mat.comm, "ksp.solve")   # the one pre-solve point
        self._check_norm_type()
        self._check_guard()
        with _telemetry.span("ksp.setup"):
            self.set_up()
        pc = self.get_pc()
        if not (self._type in BATCHED_TYPES and batched_pc_supported(pc)
                and self._norm_type in ("default", "none")
                and self._nullspace_basis(mat) is None
                and hasattr(mat, "local_spmv_many")):
            return self._solve_many_sequential(B, X, k, b_vecs, x_vecs)
        comm = mat.comm
        if self._megasolve_eligible(many=True):
            Bd = (torch.stack([v.data.view(comm.local_shards, -1) for v in B],
                              dim=1).to(mat.dtype)
                  if b_vecs else comm.put_cols(B, mat.dtype))
            return self._solve_many_megasolve(Bd, X, n, x_vecs, B)
        norm_none, rtol, atol, divtol = self._run_tolerances()
        gate = self._true_residual_check and not norm_none
        guard = self._guard_requested()
        margin = self._margin() if gate else 1.0
        monitored = bool(self._monitor_list())
        histories = [[] for _ in range(k)]

        def record(j, it, rn):
            histories[j].append(float(rn))

        pc_on = False
        if guard:
            cs, csM, pc_on = self._guard_checksums(mat, pc, many=True)
            build = lambda true_res, monitor=None: build_guarded_program(
                comm, self._type, pc, mat, abft_tol=self.abft_tol,
                rr_n=self._effective_replacement(), cs=cs, csM=csM,
                max_repl=self.sstep_max_replacements, true_res=true_res,
                monitor=monitor, sstep_s=self.sstep_s, many=True)
        else:
            build = lambda true_res, monitor=None: build_ksp_program_many(
                comm, self._type, pc, mat, true_res=true_res,
                monitor=monitor, sstep_s=self.sstep_s)
        with _telemetry.span("ksp.setup"):
            prog = build(gate, record if monitored else None)
        # one placement of each block: stacked on the card from Vecs, or
        # transposed on the host and copied once
        place = lambda blk, is_vecs: (
            torch.stack([v.data.view(comm.local_shards, -1) for v in blk],
                        dim=1).to(mat.dtype)
            if is_vecs else comm.put_cols(blk, mat.dtype))
        Bd = place(B, b_vecs)
        tols = _tolerances(mat.dtype, rtol * margin, atol * margin, divtol)

        def write(Xd):
            if x_vecs:
                for j, xv in enumerate(X):
                    xv.data = Xd[:, j].reshape(-1).to(xv.dtype)
            else:
                X[...] = comm.fetch_cols(Xd, n)

        t0 = time.perf_counter()
        Xd = (place(X, x_vecs) if self._initial_guess_nonzero
              else torch.zeros_like(Bd))
        self._program_fault(prog, Bd, Xd, divtol, mat, write)
        with _telemetry.span("ksp.dispatch"):
            _telemetry.record_program_dispatch("ksp_many")
            out = prog(Bd, Xd, *tols, self.max_it)
        with _telemetry.span("ksp.fetch"):
            Xd, iters, rnorms, reasons, syncs = out[:5]
        record_sync("KSP solve_many result fetch", syncs)
        rest = out[5:]
        checks = rrc = 0
        if guard:
            det, rrc_l, Xv = rest[:3]
            rest = rest[3:]
            rrc = int(sum(rrc_l))
            checks = ((k + sum(iters) * (1 + int(pc_on))) if self.abft
                      else 0)
            bad = [j for j in range(k) if det[j] not in (SDC_NONE,
                                                         SDC_DEMOTE)]
            record_sdc(checks, len(bad), rrc)
            self._raise_many_sdc(det, iters, Xv, write)
            demoted = [j for j in range(k) if det[j] == SDC_DEMOTE]
            if demoted:
                write(Xd)
                return self._demote_sstep_many(
                    B, X, iters=iters, rrc=rrc, checks=checks, t0=t0,
                    demoted=demoted, syncs=syncs)

        def demote(its, dem, Xcur):
            write(Xcur)
            return self._demote_sstep_many(B, X, iters=its, rrc=rrc,
                                           checks=checks, t0=t0, demoted=dem)

        reasons = [_final_reason(r, rn, norm_none)
                   for r, rn in zip(reasons, rnorms)]
        self._last_reentries = 0
        if gate:
            gated = self._gate_many(
                comm, build, Bd, Xd, iters, rnorms, reasons, syncs,
                rest[0], rest[1], rtol, atol, tols, guard, write, demote)
            if isinstance(gated, BatchedSolveResult):
                return gated
            Xd, iters, rnorms, reasons, syncs = gated
        write(Xd)
        wall = time.perf_counter() - t0
        if monitored:
            self._replay_many(histories)
        self.result_many = BatchedSolveResult(
            iters, rnorms, reasons, wall, X, histories, syncs,
            abft_checks=checks, residual_replacements=rrc)
        conv = self.result_many.converged
        record_event(f"KSPSolveMany({self._type}+{pc.get_type()},k={k})", n,
                     max(iters, default=0), wall,
                     max(reasons) if conv else min(reasons))
        return self.result_many

    def _raise_many_sdc(self, det, iters, Xv, write):
        """A batched guarded solve's detection (JAX ``ksp.py:1709-1724``):
        the whole block rolled back to its columns' verified iterates, then
        ``SilentCorruptionError`` naming the first flagged column's
        detector."""
        bad = [j for j, d in enumerate(det) if d not in (SDC_NONE,
                                                         SDC_DEMOTE)]
        if not bad:
            return
        write(Xv)
        raise SilentCorruptionError(
            "KSPSolveMany", SDC_DETECTOR_NAMES.get(det[bad[0]],
                                                   str(det[bad[0]])),
            int(max(iters[j] for j in bad)), detail=f"columns {bad} flagged")

    def _gate_many(self, comm, build, Bd, Xd, iters, rnorms, reasons,
                   syncs, trn, bn, rtol, atol, tols, guard, write, demote):
        """The per-column true-residual gate of a batched solve (JAX
        ``ksp.py:1776-1875``): a column that claims convergence must meet
        ``max(rtol ||b_j||, atol)`` in its true residual; while one misses,
        the whole block re-enters from the current ``X`` (at most
        ``_MAX_REENTRIES`` times) and the passes' iterations add up per
        column. A column whose loop stopped short of the margin-tightened
        tolerance but whose true residual meets the target has converged.
        Guarded, a re-entry that detects corruption rolls the block back and
        raises, and one that spends the s-step budget demotes the block
        (the returned :class:`BatchedSolveResult`)."""
        k = len(iters)
        iters, rnorms, reasons = list(iters), list(rnorms), list(reasons)
        target = [max(rtol * v, atol) for v in bn]
        prog2 = None
        while True:
            for j in range(k):
                if (reasons[j] <= 0
                        and reasons[j] != ConvergedReason.DIVERGED_BREAKDOWN
                        and math.isfinite(trn[j]) and trn[j] <= target[j]):
                    reasons[j] = ConvergedReason.CONVERGED_RTOL
                    rnorms[j] = float(trn[j])
            bad = [j for j in range(k) if reasons[j] > 0
                   and not (math.isfinite(trn[j]) and trn[j] <= target[j])]
            if not bad:
                break
            if self._last_reentries == _MAX_REENTRIES:
                for j in bad:
                    reasons[j] = ConvergedReason.DIVERGED_MAX_IT
                    rnorms[j] = float(trn[j])
                break
            self._last_reentries += 1
            if prog2 is None:
                prog2 = build(True)
            _telemetry.record_program_dispatch("ksp_many")
            out = prog2(Bd, Xd, *tols, self.max_it)
            Xd, it2, rn2, rs2, s2 = out[:5]
            trn, bn = out[-2:]
            syncs += s2
            record_sync("KSP solve_many result fetch", s2)
            if guard:
                det2, Xv2 = out[5], out[7]
                bad2 = [j for j in range(k) if det2[j] not in (SDC_NONE,
                                                               SDC_DEMOTE)]
                if bad2:
                    record_sdc(0, len(bad2), int(sum(out[6])))
                self._raise_many_sdc(det2, it2, Xv2, write)
                dem2 = [j for j in range(k) if det2[j] == SDC_DEMOTE]
                if dem2:
                    return demote([a + b for a, b in zip(iters, it2)], dem2,
                                  Xd)
            target = [max(rtol * v, atol) for v in bn]
            for j in range(k):
                iters[j] += it2[j]
                rnorms[j] = float(rn2[j])
                reasons[j] = (ConvergedReason.DIVERGED_NANORINF
                              if not math.isfinite(rnorms[j]) else rs2[j])
        return Xd, iters, rnorms, reasons, syncs

    def _replay_many(self, histories):
        """Deliver a batched solve's per-column residual norms to the
        monitors and the history, column after column (the JAX replay,
        ``ksp.py:1744-1768``)."""
        if self._history is not None and self._history_reset:
            self._history.clear()
        monitors = self._monitor_list()
        for hist in histories:
            for it, rn in enumerate(hist):
                for m in monitors:
                    m(self, it, rn)

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
        without a batched program; the same per-column results, and each
        column's own slice of the history when one is recorded."""
        mat = self._mat
        res = BatchedSolveResult(X=X)
        t0 = time.perf_counter()
        for j in range(k):
            bv = B[j] if b_vecs else Vec.from_global(
                mat.comm, B[:, j], dtype=mat.dtype, layout=mat.layout)
            xv = X[j] if x_vecs else Vec.from_global(
                mat.comm, X[:, j], dtype=mat.dtype, layout=mat.layout)
            prev = len(self._history) if self._history is not None else 0
            sub = self.solve(bv, xv)
            if not x_vecs:
                X[:, j] = xv.to_numpy()
            res.iterations.append(sub.iterations)
            res.residual_norms.append(sub.residual_norm)
            res.reasons.append(sub.reason)
            res.histories.append(
                [] if self._history is None else
                [float(v) for v in self._history[
                    0 if self._history_reset else prev:]])
            res.host_syncs += sub.host_syncs
        res.wall_time = time.perf_counter() - t0
        self.result_many = res
        return res

    def __repr__(self):
        return (f"KSP(type={self._type!r}, pc={self.get_pc().get_type()!r}, "
                f"rtol={self.rtol:g}, max_it={self.max_it})")


def _agreed_check(comm, point: str):
    """A raising fault point taken by every rank of ``comm`` when it fires
    on any (``DeviceComm.agree_fault``; ``faults.check`` on one process)."""
    fault = comm.agree_fault(_faults.triggered(point))
    if fault is not None and fault.kind in _faults.RAISING_KINDS:
        raise fault.error()


def _result_fault(rnorm, iters):
    """The ``ksp.result`` fault point (JAX ``ksp.py:930``): poison the
    reported residual with NaN/Inf (at ``iter=K``, reported at iteration
    K), the stand-in for a recurrence blowing up."""
    fault = _faults.triggered("ksp.result")
    if fault is None:
        return rnorm, iters
    rnorm = math.nan if fault.kind == "nan" else math.inf
    if fault.iter_k is not None:
        iters = fault.iter_k
    return rnorm, iters


def _tolerances(dtype, *values) -> list:
    """The tolerance scalars as the loop takes them: each rounded to the
    operator's ``tolerance_dtype`` (the value its arithmetic uses anyway)."""
    tdt = tolerance_dtype(dtype)
    return [torch.tensor(v, dtype=tdt).item() for v in values]


def _megasolve_stats(result, res):
    """A fused solve's extra fields on its result: the outer steps, the
    graph replays (uncaptured runs of the pieces where no graph ran), the
    masked inner steps, and whether CUDA graphs ran."""
    result.megasolve_steps = res.steps
    result.replays = res.replays
    result.masked_steps = res.masked_steps
    result.graph = res.graph


def _final_reason(reason, rnorm, norm_none):
    """The reported reason: a NaN/Inf residual exits as DIVERGED_MAX_IT (NaN
    fails every comparison), reported as the blow-up it is; KSP_NORM_NONE
    has no norm to classify, and keeps breakdown visible."""
    if not norm_none and not math.isfinite(rnorm):
        return ConvergedReason.DIVERGED_NANORINF
    if norm_none and reason != ConvergedReason.DIVERGED_BREAKDOWN:
        return ConvergedReason.CONVERGED_ITS
    return reason


def _dtype_name(mat) -> str:
    """The operator's dtype as the JAX package names it ("float64",
    "bfloat16", ...), for span attributes; "" without an operator."""
    return "" if mat is None else str(mat.dtype).removeprefix("torch.")


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
