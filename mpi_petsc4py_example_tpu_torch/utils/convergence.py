"""Solver result reporting: the KSPConvergedReason codes and ``SolveResult``.

The port's copy of ``mpi_petsc4py_example_tpu/utils/convergence.py`` (the
single-solve part), with the same PETSc-compatible integer codes, so results
of the two packages compare field by field.
"""

from __future__ import annotations

from dataclasses import dataclass


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
class SolveResult:
    """What a KSP solve reports: iterations, residual norm, reason, wall time.

    ``host_syncs`` counts the device-to-host reads the eager Krylov loop made
    (one at set-up, one per iteration for the loop condition).
    """
    iterations: int = 0
    residual_norm: float = 0.0
    reason: int = ConvergedReason.ITERATING
    wall_time: float = 0.0
    host_syncs: int = 0

    @property
    def converged(self) -> bool:
        return self.reason > 0

    @property
    def reason_name(self) -> str:
        return ConvergedReason.name(self.reason)

    def __repr__(self):
        return (f"SolveResult(iters={self.iterations}, "
                f"rnorm={self.residual_norm:.3e}, {self.reason_name}, "
                f"{self.wall_time*1e3:.1f} ms)")
