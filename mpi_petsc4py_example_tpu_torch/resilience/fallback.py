"""Graceful-degradation chains for Krylov solves.

The port's counterpart of ``mpi_petsc4py_example_tpu/resilience/
fallback.py``. A breakdown (``DIVERGED_BREAKDOWN``) or a blown-up residual
(``DIVERGED_NANORINF``) says the METHOD failed, not the problem:
:class:`KSPFallbackChain` escalates through more robust methods (by default
``cg -> bcgs -> gmres -> preonly + lu``, the last the direct path, on the
card or through the host sparse LU of ``KSP._solve_hostlu``), restoring the
initial guess before each stage so a poisoned iterate never seeds the next.
A device ``oom`` failure instead retries the same method at reduced
precision on the card (float64 -> float32, complex128 -> complex64). Every
escalation is a :class:`..utils.convergence.RecoveryEvent` on the result:
these are the reference's documented recovery stages, not a hidden
fallback.

No stage moves a solve from the card to the CPU. Any other device failure
(a kernel that did not build or launch, an injected ``unavailable``) is the
device's and not the method's, so the chain re-raises it for
``resilient_solve`` or the caller; and where the direct stage would resolve
to the host sparse LU (``hostlu``) for an operator on the card, the chain
raises :class:`HostStageError` instead of taking it. On the CPU the chain
takes the JAX package's stages unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.convergence import ConvergedReason, RecoveryEvent, SolveResult
from ..utils.errors import DeviceExecutionError

# escalation order: (ksp_type, pc_type or None); None keeps the owner's PC
DEFAULT_ESCALATION = (("bcgs", None), ("gmres", None), ("preonly", "lu"))

# the reasons that mean "the method broke, a stronger one may not"
DEFAULT_ESCALATE_ON = (ConvergedReason.DIVERGED_BREAKDOWN,
                       ConvergedReason.DIVERGED_NANORINF)

_REDUCED = {torch.float64: torch.float32, torch.complex128: torch.complex64}


class HostStageError(RuntimeError):
    """The chain's next stage would solve an operator that lives on the
    card through the host sparse LU. ``recovery_events`` holds the
    escalations made before it."""

    def __init__(self, message: str, recovery_events):
        super().__init__(message)
        self.recovery_events = list(recovery_events)


def _on_card(mat) -> bool:
    return mat.comm.device.type != "cpu"


def _host_direct(ksp) -> bool:
    """Whether the KSP's PC lu/cholesky would factor and apply on the host
    (``hostlu``) while its matrix lives on the card."""
    from ..solvers.pc import lu_mode
    pmat = ksp.get_operators()[1]
    return (ksp.get_pc().get_type() in ("lu", "cholesky")
            and hasattr(pmat, "to_scipy") and _on_card(pmat)
            and lu_mode(pmat) == "hostlu")


def reduced_dtype(dtype):
    """The reduced-precision retry dtype (a ``torch.dtype``), or None when
    already minimal."""
    from ..parallel.mesh import torch_dtype
    return _REDUCED.get(torch_dtype(dtype))


class KSPFallbackChain:
    """Escalate a KSP solve through more robust methods on breakdown/NaN
    (JAX ``fallback.py:47``).

    ``methods`` overrides the stages (``ksp_type`` strings or ``(ksp_type,
    pc_type)`` pairs, tried after the KSP's own configuration);
    ``direct=False`` drops the terminal direct stage;
    ``reduced_precision=False`` disables the oom retry at lower precision;
    ``escalate_on`` overrides the escalating reasons. The last working
    configuration stays on the KSP (``keep_working_config``); a
    reduced-precision recovery runs on a scratch solver cached on the chain,
    so the owner's operators stay full precision."""

    def __init__(self, ksp, methods=None, *, direct: bool = True,
                 reduced_precision: bool = True,
                 escalate_on: tuple = DEFAULT_ESCALATE_ON,
                 keep_working_config: bool = True):
        self.ksp = ksp
        self.reduced_precision = reduced_precision
        self.escalate_on = tuple(escalate_on)
        self.keep_working_config = keep_working_config
        self._lo_cache = None
        self.last_config = None
        if methods is None:
            stages = [st for st in DEFAULT_ESCALATION
                      if direct or st[0] != "preonly"]
        else:
            stages = [(m, None) if isinstance(m, str) else tuple(m)
                      for m in methods]
            if direct and all(t != "preonly" for t, _ in stages):
                stages.append(("preonly", "lu"))
        self.stages = tuple(stages)

    def _solve_reduced(self, b, x, events, attempt):
        """The current configuration at reduced precision (the ``oom``
        degradation), on a scratch solver on the same communicator; None
        when no lower precision exists or the operator is matrix-free."""
        from ..core.mat import Mat
        from ..core.vec import Vec
        from ..parallel.mesh import numpy_dtype
        from ..solvers.ksp import KSP
        ksp = self.ksp
        mat = ksp.get_operators()[0]
        rdt = reduced_dtype(mat.dtype)
        if rdt is None or not hasattr(mat, "to_scipy"):
            return None
        comm = mat.comm
        events.append(RecoveryEvent(
            kind="precision", attempt=attempt,
            detail=f"{numpy_dtype(mat.dtype)}->{numpy_dtype(rdt)}",
            error_class="oom"))
        token = (mat, ksp.get_type(), ksp.get_pc().get_type())
        if self._lo_cache is not None and self._lo_cache[0] == token:
            sub = self._lo_cache[1]
        else:
            mat_lo = Mat.from_scipy(comm, mat.to_scipy(), dtype=rdt)
            sub = KSP().create(comm)
            sub.set_operators(mat_lo)
            sub.set_type(ksp.get_type())
            sub.get_pc().set_type(ksp.get_pc().get_type())
            self._lo_cache = (token, sub)
        # float32 cannot reach float64 tolerances: rtol floored at sqrt(eps)
        rtol = max(ksp.rtol, math.sqrt(torch.finfo(rdt).eps))
        sub.set_tolerances(rtol=rtol, atol=ksp.atol, divtol=ksp.divtol,
                           max_it=ksp.max_it)
        b_lo = Vec.from_global(comm, b.to_numpy(), dtype=rdt,
                               layout=mat.layout)
        x_lo = Vec.from_global(comm, x.to_numpy(), dtype=rdt,
                               layout=mat.layout)
        result = sub.solve(b_lo, x_lo)
        x.set_global(np.asarray(x_lo.to_numpy()))
        return result

    def solve(self, b, x) -> SolveResult:
        """Solve ``A x = b``, escalating until a method converges or the
        chain is spent; the last stage's result carries the whole
        ``recovery_events`` trail either way."""
        ksp = self.ksp
        config0 = (ksp.get_type(), ksp.get_pc().get_type())
        # the initial guess, restored before every stage
        x0_data = x.data.clone()
        events: list[RecoveryEvent] = []
        plan = ((config0[0], None),) + tuple(
            st for st in self.stages if st[0] != config0[0])
        attempt = 0
        result = None
        tried_precision = False
        precision_success = False
        last_config = config0 + (None,)
        try:
            for ksp_type, pc_type in plan:
                attempt += 1
                if attempt > 1:
                    x.data = x0_data.clone()
                ksp.set_type(ksp_type)
                if pc_type is not None:
                    ksp.get_pc().set_type(pc_type)
                last_config = (ksp_type, pc_type or config0[1], None)
                if attempt > 1 and _host_direct(ksp):
                    raise HostStageError(
                        f"KSPFallbackChain: stage {attempt} ({ksp_type} + "
                        f"{ksp.get_pc().get_type()}) would solve on the host "
                        "sparse LU, and the operator lives on the card; "
                        "build the chain with direct=False, or solve on "
                        "the host explicitly", events)
                try:
                    result = ksp.solve(b, x)
                except DeviceExecutionError as exc:
                    if exc.failure_class != "oom":
                        # the device's failure, not the method's: another
                        # method is no cure (resilient_solve retries it)
                        raise
                    if self.reduced_precision and not tried_precision:
                        tried_precision = True
                        result = self._solve_reduced(b, x, events, attempt)
                        if result is not None and result.converged:
                            precision_success = True
                            last_config = (ksp_type, last_config[1],
                                           "reduced-precision")
                            break
                        if result is not None:
                            continue
                    if attempt >= len(plan):
                        raise
                    events.append(RecoveryEvent(
                        kind="fallback", attempt=attempt,
                        detail=f"{ksp_type}: {exc.failure_class} "
                               "device failure",
                        error_class=exc.failure_class))
                    continue
                if result.reason not in self.escalate_on:
                    break
                if attempt < len(plan):
                    events.append(RecoveryEvent(
                        kind="fallback", attempt=attempt,
                        detail=f"{ksp_type}->{plan[attempt][0]}",
                        error_class=ConvergedReason.name(result.reason),
                        iterations=result.iterations))
        finally:
            # the owner's configuration comes back on every exit that did
            # not end on a working one (a raising last stage included)
            if not self.keep_working_config or precision_success or (
                    result is None or not result.converged):
                ksp.set_type(config0[0])
                ksp.get_pc().set_type(config0[1])
        if result is None:
            raise DeviceExecutionError(
                "KSPFallbackChain", RuntimeError("all stages failed"))
        result.attempts = attempt
        result.recovery_events = events
        # (type, pc, note) of the configuration that produced the result
        self.last_config = last_config
        return result
