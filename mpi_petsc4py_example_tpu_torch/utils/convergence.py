"""Solver result reporting: the KSPConvergedReason codes, ``SolveResult``,
``BatchedSolveResult`` and the resilience trail's ``RecoveryEvent``.

The port's copy of ``mpi_petsc4py_example_tpu/utils/convergence.py``, with
the same PETSc-compatible integer codes and resilience fields (``attempts``,
``recovery_events``, and the silent-error counters ``abft_checks``,
``sdc_detections``, ``residual_replacements``), so results of the two
packages compare field by field.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class ConvergedReason:
    """Integer reason codes, PETSc-compatible values."""
    CONVERGED_RTOL = 2
    CONVERGED_ATOL = 3
    CONVERGED_ITS = 4
    ITERATING = 0
    DIVERGED_NULL = -2
    DIVERGED_MAX_IT = -3
    DIVERGED_DTOL = -4
    DIVERGED_BREAKDOWN = -5
    DIVERGED_NANORINF = -9

    _NAMES = {
        2: "CONVERGED_RTOL", 3: "CONVERGED_ATOL", 4: "CONVERGED_ITS",
        0: "ITERATING", -2: "DIVERGED_NULL", -3: "DIVERGED_MAX_IT",
        -4: "DIVERGED_DTOL", -5: "DIVERGED_BREAKDOWN",
        -9: "DIVERGED_NANORINF",
    }

    @classmethod
    def name(cls, code: int) -> str:
        return cls._NAMES.get(int(code), f"UNKNOWN({code})")


@dataclass
class RecoveryEvent:
    """One entry in a resilient solve's recovery trail (``resilience/``).

    The retry wrapper and the fallback chain record what they did:
    checkpoint written, backoff slept, solve resumed, method escalated,
    precision reduced, mesh shrunk or regrown (JAX ``convergence.py:39``).
    """
    kind: str            # 'fault' | 'checkpoint' | 'backoff' | 'resume'
                         # | 'fallback' | 'precision' | 'rollback'
                         # | 'verify' | 'mesh_shrink' | 'mesh_regrow'
                         # | 'sstep_demote'
    attempt: int         # 1-based attempt number the event belongs to
    detail: str = ""     # specifics: checkpoint path, 'cg->bcgs', dtypes
    error_class: str = ""  # DeviceExecutionError.failure_class or reason
    delay: float = 0.0   # seconds slept ('backoff' events)
    iterations: int = 0  # iterations completed when the event fired
    detector: str = ""   # what detected a silent corruption, else empty
    old_devices: int = 0  # mesh_shrink / mesh_regrow: shards before
    new_devices: int = 0  # ... and after the rebuild

    def __repr__(self):
        extra = f", delay={self.delay:g}s" if self.kind == "backoff" else ""
        if self.detector:
            extra += f", detector={self.detector}"
        if self.kind in ("mesh_shrink", "mesh_regrow"):
            extra += f", {self.old_devices}->{self.new_devices} devices"
        return (f"RecoveryEvent({self.kind}, attempt={self.attempt}, "
                f"{self.detail or self.error_class}{extra})")


@dataclass
class SolveResult:
    """What a KSP solve reports: iterations, residual norm, reason, wall time.

    ``host_syncs`` counts the device-to-host reads the eager Krylov loop made
    (one at set-up, one per iteration for the loop condition).
    ``attempts``/``recovery_events`` are the resilience trail (one attempt
    and no event for a plain solve); ``abft_checks``, ``sdc_detections`` and
    ``residual_replacements`` count the silent-error guard's checksum checks,
    its detections and its true-residual replacements. ``history`` holds the
    recorded residual norms of a column of a monitored batched solve
    (:meth:`BatchedSolveResult.per_rhs`), empty otherwise (JAX
    ``convergence.py:87``; it is the last field here, so that the positional
    ``host_syncs`` keeps its place).
    """
    iterations: int = 0
    residual_norm: float = 0.0
    reason: int = ConvergedReason.ITERATING
    wall_time: float = 0.0
    host_syncs: int = 0
    attempts: int = 1
    recovery_events: list = field(default_factory=list)
    abft_checks: int = 0
    sdc_detections: int = 0
    residual_replacements: int = 0
    history: list = field(default_factory=list)

    @property
    def converged(self) -> bool:
        return self.reason > 0

    @property
    def reason_name(self) -> str:
        return ConvergedReason.name(self.reason)

    def __repr__(self):
        return (f"SolveResult(iters={self.iterations}, "
                f"rnorm={self.residual_norm:.3e}, {self.reason_name}, "
                f"{self.wall_time*1e3:.1f} ms{_recovery(self)})")


@dataclass
class BatchedSolveResult:
    """What ``KSP.solve_many`` reports: one entry per RHS column.

    ``iterations``/``residual_norms``/``reasons`` are per-column lists (a
    column that converges early keeps its own, smaller iteration count while
    the others run on); ``histories`` holds each column's recorded residual
    norms when monitoring was on (empty lists otherwise). ``X`` is the solution block the solve wrote: the
    ``(n, nrhs)`` host array, or the list of ``Vec``s passed as ``X``.
    ``wall_time`` covers the whole batched solve; ``host_syncs`` counts its
    device-to-host reads (one at set-up, one per lockstep iteration).
    """
    iterations: list = field(default_factory=list)
    residual_norms: list = field(default_factory=list)
    reasons: list = field(default_factory=list)
    wall_time: float = 0.0
    X: object = None
    histories: list = field(default_factory=list)
    host_syncs: int = 0
    attempts: int = 1
    recovery_events: list = field(default_factory=list)
    abft_checks: int = 0          # summed over the columns
    sdc_detections: int = 0
    residual_replacements: int = 0

    @property
    def nrhs(self) -> int:
        return len(self.reasons)

    @property
    def converged(self) -> bool:
        """True when EVERY column converged (KSPMatSolve semantics)."""
        return bool(self.reasons) and all(r > 0 for r in self.reasons)

    @property
    def reason_names(self):
        return [ConvergedReason.name(r) for r in self.reasons]

    def per_rhs(self):
        """Per-column :class:`SolveResult` views (shared wall time), each
        with its column's history (JAX ``convergence.py:156-162``)."""
        return [SolveResult(int(it), float(rn), int(rs), self.wall_time,
                            history=list(h) if h is not None else [])
                for it, rn, rs, h in zip(
                    self.iterations, self.residual_norms, self.reasons,
                    self.histories or [None] * len(self.reasons))]

    def __repr__(self):
        if not self.reasons:
            return "BatchedSolveResult(empty)"
        return (f"BatchedSolveResult(nrhs={self.nrhs}, "
                f"iters={min(self.iterations)}-{max(self.iterations)}, "
                f"max rnorm={max(self.residual_norms):.3e}, "
                f"{'all converged' if self.converged else 'NOT converged'}, "
                f"{self.wall_time*1e3:.1f} ms{_recovery(self)})")


def _recovery(res) -> str:
    """The resilience part of a result's repr: empty for a plain solve."""
    if res.attempts > 1 or res.recovery_events:
        return (f", attempts={res.attempts}, "
                f"{len(res.recovery_events)} recovery events")
    return ""
