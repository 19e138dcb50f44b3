"""Retry with backoff and checkpoint-resume around the KSP solve boundary.

The port's counterpart of ``mpi_petsc4py_example_tpu/resilience/retry.py``:
a retriable device failure (``DeviceExecutionError`` of class
``unavailable``, or ``detected_sdc`` from the guarded loops) is recovered:

1. the iterate the failure left (a ``ksp.program`` fault's partial
   iterate, the guard's verified iterate) is checkpointed
   (``utils.checkpoint.save_solve_state``: atomic, loadable on any shard
   count) when the operator is an assembled Mat;
2. an ``unavailable`` failure waits out the policy's deterministic
   exponential backoff, then rebuilds the operator from the checkpoint
   (fresh device buffers); a ``detected_sdc`` one re-enters at once;
3. the solve resumes from the restored iterate
   (``set_initial_guess_nonzero(True)``).

Past the same-mesh retries, a persistently lost shard escalates to the
elastic tier (``resilience/elastic.py``): the session is resharded onto the
largest power of two of the surviving shards and resumes there
(``mesh_shrink``), and after :func:`..faults.heal` grows back
(``mesh_regrow``). Every action is a :class:`..utils.convergence.
RecoveryEvent` on the result. After a silent corruption the answer is
verified by an independent host fp64 apply of the operator before it is
returned. With no failure, :func:`resilient_solve` is exactly one
``ksp.solve``.

Telemetry (JAX ``retry.py:55-67``, ``:262-288``, ``:337-480``): each wrapper
call is one ``resilient.solve`` span whose children are the ladder's stages
(``resilient.rollback``, ``resilient.backoff``, ``resilient.rebuild``,
``resilient.shrink``/``resilient.regrow``, ``resilient.verify``) beside the
solves' own spans; every recovery event is mirrored into the flight ring,
every executed shrink or regrow is recorded for ``-log_view``, and an error
that escapes unrecovered dumps the ring (``telemetry.auto_dump``).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np

from ..utils.checkpoint import (load_solve_state, load_solve_state_many,
                                save_solve_state, save_solve_state_many)
from ..utils.convergence import (BatchedSolveResult, RecoveryEvent,
                                 SolveResult)
from ..utils.errors import DeviceExecutionError, SilentCorruptionError
from ..utils.profiling import record_mesh_regrow, record_mesh_shrink
from ..telemetry import flight as _flight
from ..telemetry import spans as _telemetry


def _push(events: list, e: RecoveryEvent) -> RecoveryEvent:
    """Append one recovery event to the trail and, while telemetry is
    armed, to the flight recorder's ring (JAX ``retry.py:55-67``)."""
    events.append(e)
    if _telemetry.enabled():
        _flight.recorder.record_event(
            "recovery", stage=e.kind, attempt=e.attempt, detail=e.detail,
            error_class=e.error_class, detector=e.detector,
            iterations=e.iterations, old_devices=e.old_devices,
            new_devices=e.new_devices, delay=e.delay)
    return e


@dataclass
class RetryPolicy:
    """When and how to retry a failed solve (JAX ``retry.py:71``).

    Delays are exponential (``base_delay * backoff_factor**retry``), capped at
    ``max_delay`` and deterministic unless ``jitter`` (a fraction of the
    delay drawn from ``jitter_seed``) is set. ``retriable_classes`` keys off
    ``DeviceExecutionError.failure_class``: ``unavailable`` retries after a
    backoff, ``detected_sdc`` re-enters at once from the verified iterate;
    ``oom`` needs a cheaper configuration (``resilience/fallback.py``), and
    ``callback``/``unsupported`` cannot succeed on retry. ``sleep`` is
    injectable (tests record the delays)."""
    max_attempts: int = 3
    base_delay: float = 0.5
    backoff_factor: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.0
    jitter_seed: int = 0
    retriable_classes: tuple = ("unavailable", "detected_sdc")
    sleep: object = time.sleep

    @classmethod
    def serving(cls) -> "RetryPolicy":
        """The solve server's default policy (JAX ``retry.py:98-104``):
        clients wait on futures, so the backoff is two orders shorter than
        the batch default (50 ms base, 1 s cap) and deterministic;
        ``detected_sdc`` re-enters at once either way.
        ``-solve_server_retry_delay`` overrides the base delay."""
        return cls(max_attempts=3, base_delay=0.05, max_delay=1.0)

    def delay(self, retry_index: int) -> float:
        """Backoff before retry ``retry_index`` (0-based)."""
        d = min(self.base_delay * self.backoff_factor ** retry_index,
                self.max_delay)
        if self.jitter:
            import random
            # one integer seed per (jitter_seed, retry): the JAX package
            # seeds with the tuple, which Python 3.12's random refuses
            rng = random.Random(self.jitter_seed * 1_000_003 + retry_index)
            d *= 1.0 + self.jitter * rng.random()
        return d

    def should_retry(self, exc: Exception) -> bool:
        return (isinstance(exc, DeviceExecutionError)
                and exc.failure_class in self.retriable_classes)


def host_apply(mat, X: np.ndarray) -> np.ndarray:
    """``A X`` for a host vector or ``(n, k)`` block, in fp64 on the host:
    the verification channel, independent of the device's applies (the
    Mat's host CSR; the stencil's 7 points; a ShellMat's own ``mult``)."""
    X = np.asarray(X)
    if hasattr(mat, "to_scipy"):
        A = mat.to_scipy().tocsr()
        dt = np.complex128 if np.iscomplexobj(A.data) else np.float64
        return A.astype(dt) @ X.astype(np.result_type(X.dtype, dt))
    if hasattr(mat, "column_checksum_host") and hasattr(mat, "grid3d"):
        nx, ny, nz = mat.nx, mat.ny, mat.nz
        U = X.astype(np.float64).reshape((nz, ny, nx) + X.shape[1:])
        Y = 6.0 * U
        for ax in range(3):
            Y[(slice(None),) * ax + (slice(1, None),)] -= \
                U[(slice(None),) * ax + (slice(None, -1),)]
            Y[(slice(None),) * ax + (slice(None, -1),)] -= \
                U[(slice(None),) * ax + (slice(1, None),)]
        return Y.reshape(X.shape)
    from ..core.vec import Vec
    cols = X.reshape(X.shape[0], -1)
    out = [np.asarray(mat.mult(Vec.from_global(
        mat.comm, cols[:, j], dtype=mat.dtype, layout=mat.layout)).to_numpy(),
        dtype=np.float64) for j in range(cols.shape[1])]
    return np.stack(out, axis=1).reshape(X.shape)


def _verify_true_residual(ksp, b, x):
    """The recovered iterate's true residual against the KSP's target:
    ``(ok, relative residual)``, from :func:`host_apply` (JAX
    ``retry.py:123``). A zero target (norm type none) passes."""
    mat = ksp.get_operators()[0]
    bh = np.asarray(b.to_numpy(), dtype=np.float64)
    rn = float(np.linalg.norm(bh - host_apply(mat, x.to_numpy())))
    bn = float(np.linalg.norm(bh))
    target = max(ksp.rtol * bn, ksp.atol)
    # 1.05: the device-vs-host norm rounding slack (JAX's convention)
    ok = target <= 0 or rn <= target * 1.05
    return ok, rn / bn if bn > 0 else rn


def _verify_true_residual_many(ksp, B, X):
    """Per-column twin of :func:`_verify_true_residual`: ``(all_ok, worst
    relative residual)``."""
    mat = ksp.get_operators()[0]
    B = np.asarray(B, dtype=np.float64)
    R = B - host_apply(mat, np.asarray(X))
    rn = np.linalg.norm(R, axis=0)
    bn = np.linalg.norm(B, axis=0)
    targets = np.maximum(ksp.rtol * bn, ksp.atol)
    ok = bool(np.all((targets <= 0) | (rn <= targets * 1.05)))
    return ok, float(np.max(rn / np.where(bn > 0, bn, 1.0)))


def _reraise_if_rebuild_failed(rebuild_exc, original):
    """The same-mesh checkpoint reload failed: a device-shaped failure (a
    placement onto a mesh that lost a shard) surfaces the original solve
    error, chained; anything else (a corrupt checkpoint's ValueError)
    propagates as itself."""
    name = type(rebuild_exc).__name__
    if ("XlaRuntimeError" in name
            or isinstance(rebuild_exc, DeviceExecutionError)):
        raise original from rebuild_exc
    raise rebuild_exc


def _failure_iteration(exc) -> int:
    """Iterations of real progress a failure left in the iterate (0 when
    unknown)."""
    it = getattr(exc, "iteration", None)
    if it is None:
        it = getattr(getattr(exc, "original", None), "iteration", None)
    return int(it or 0)


class _ElasticEscalation:
    """Per-solve elastic state of the two wrappers (JAX ``retry.py:196``):
    the :class:`..faults.HealthMonitor` and the shrink/regrow step."""

    def __init__(self, policy=None):
        from .elastic import ElasticPolicy, MeshRebuilder
        from .faults import HealthMonitor
        self.policy = (policy if policy is not None
                       else ElasticPolicy.from_options())
        self.monitor = HealthMonitor(
            threshold=self.policy.max_same_mesh_retries)
        self.rebuilder = MeshRebuilder(self.policy)
        # the mesh the solve started on: the regrow ceiling (None until a
        # shrink happened)
        self.orig_comm = None

    def record(self, exc):
        """Count one failure toward the persistent-loss classification
        (``unavailable`` only)."""
        if getattr(exc, "failure_class", "") == "unavailable":
            self.monitor.record(exc)

    def plan(self, ksp, exc, budget_exhausted: bool):
        """The communicator to rebuild onto, or None: a regrow after a heal
        when this solve shrank; a shrink once the loss is classified
        persistent (a mesh member in the lost registry, or the monitor's
        evidence at its threshold) or as the last rung when the same-mesh
        budget is spent."""
        from . import faults as _faults
        if (not self.policy.enabled
                or getattr(exc, "failure_class", "") != "unavailable"):
            return None
        if (self.policy.regrow and self.orig_comm is not None
                and self.monitor.heal_observed()):
            grown = self.rebuilder.grown_comm(ksp.comm, self.orig_comm)
            if grown is not None:
                return grown
        ids = set(getattr(ksp.comm, "device_ids", ()))
        registry_hit = any(d in ids for d in _faults.lost_devices())
        if not (registry_hit or self.monitor.persistent()
                or budget_exhausted):
            return None
        return self.rebuilder.shrunk_comm(ksp.comm,
                                          self.monitor.lost_devices())

    def reshard(self, ksp, comm_new, events, attempt, *, persisted, path,
                b=None, x=None, B=None, X=None, many=False) -> bool:
        """Rebuild onto ``comm_new``, down (``mesh_shrink``) or up
        (``mesh_regrow``); False when the operator cannot live there."""
        from .elastic import shrink_solve_session
        old_n = ksp.comm.size
        growing = comm_new.size > old_n
        old_comm = ksp.comm
        t0 = time.perf_counter()
        try:
            it0 = shrink_solve_session(
                ksp, comm_new, checkpoint_path=path if persisted else None,
                b=b, x=x, B=B, X=X, many=many)
        except ValueError:
            return False
        wall = time.perf_counter() - t0
        if growing:
            record_mesh_regrow(old_n, comm_new.size, wall)
        else:
            if self.orig_comm is None:
                self.orig_comm = old_comm
            record_mesh_shrink(old_n, comm_new.size, wall)
        _push(events, RecoveryEvent(
            kind="mesh_regrow" if growing else "mesh_shrink",
            attempt=attempt,
            detail=(f"rebuilt {old_n} -> {comm_new.size} devices in "
                    f"{wall:.3f}s; resuming from iteration {it0}"),
            error_class="unavailable", iterations=it0,
            old_devices=old_n, new_devices=comm_new.size))
        self.monitor.healthy()
        return True


def default_checkpoint_path(ksp=None) -> str:
    """The default solve-state checkpoint path, unique per process and per
    solver object."""
    tag = f"_{id(ksp):x}" if ksp is not None else ""
    return os.path.join(tempfile.gettempdir(),
                        f"tpu_solve_ckpt_{os.getpid()}{tag}.npz")


def _recover(ksp, exc, policy, esc, events, attempt, mesh_attempt, path,
             save, restore, reshard):
    """One failure's recovery step, shared by the two wrappers; returns the
    new same-mesh attempt count, or raises when the failure is not
    recoverable."""
    esc.record(exc)
    retriable = policy.should_retry(exc)
    exhausted = mesh_attempt >= policy.max_attempts
    comm_new = esc.plan(ksp, exc, exhausted) if retriable else None
    if comm_new is None and (exhausted or not retriable):
        raise exc
    detector = getattr(exc, "detector", "")
    _push(events, RecoveryEvent(
        kind="fault", attempt=attempt, detail=str(exc),
        error_class=exc.failure_class, detector=detector))
    mat = ksp.get_operators()[0]
    persisted = hasattr(mat, "to_scipy")
    if persisted:
        # after a detection the solve already rolled the iterate back to the
        # verified one: that is what the checkpoint keeps
        save(path, mat, _failure_iteration(exc))
        _push(events, RecoveryEvent(kind="checkpoint", attempt=attempt,
                                    detail=path))
    if comm_new is not None:
        old_n, new_n = int(ksp.comm.size), int(comm_new.size)
        with _telemetry.span(
                "resilient.regrow" if new_n > old_n else "resilient.shrink",
                old_devices=old_n, new_devices=new_n) as shsp:
            ok = reshard(comm_new, persisted)
            if ok:
                # the event carries the iteration the resumed solve
                # continues from
                shsp.set_attr("resumed_iteration", events[-1].iterations)
        if not ok:
            raise exc
        return 0                        # a fresh budget on the new mesh
    if exc.failure_class == "detected_sdc":
        with _telemetry.span("resilient.rollback", detector=detector):
            _push(events, RecoveryEvent(
                kind="rollback", attempt=attempt,
                detail="re-entering from verified iterate",
                detector=detector))
    else:
        delay = policy.delay(mesh_attempt - 1)
        _push(events, RecoveryEvent(kind="backoff", attempt=attempt,
                                    delay=delay,
                                    error_class=exc.failure_class))
        with _telemetry.span("resilient.backoff", delay=delay,
                             error_class=exc.failure_class):
            policy.sleep(delay)
        if persisted:
            # fresh device buffers from the checkpoint: nothing from before
            # the failure is trusted
            with _telemetry.span("resilient.rebuild", checkpoint=path):
                try:
                    restore(path, mat.comm)
                except Exception as rexc:  # noqa: BLE001 (classified below)
                    _reraise_if_rebuild_failed(rexc, exc)
    return mesh_attempt


def _wrapped(many, impl):
    """The ``resilient.solve`` span of a wrapper (JAX ``retry.py:337``):
    the recovery-ladder stages are its children; an error that escapes
    unrecovered dumps the flight ring (``auto_dump``, after the span
    closed, so the failed solve's tree is in the dump) and re-raises."""
    sp = _telemetry.span("resilient.solve", many=many)
    try:
        with sp:
            result = impl()
            size = ({"nrhs": len(result.iterations)} if many
                    else {"iterations": result.iterations})
            sp.set_attrs(attempts=result.attempts,
                         recoveries=len(result.recovery_events),
                         **size, converged=result.converged)
            return result
    except Exception:  # noqa: BLE001 (dumped and re-raised at once)
        _flight.auto_dump("unrecovered resilient_solve"
                          + ("_many" if many else "") + " failure")
        raise


def resilient_solve(ksp, b, x, policy: RetryPolicy | None = None, *,
                    checkpoint_path: str | None = None,
                    elastic=None) -> SolveResult:
    """``ksp.solve(b, x)`` that survives retriable device failures (JAX
    ``retry.py:312``): checkpoint, backoff, rebuild and resume, up to
    ``policy.max_attempts`` attempts a mesh, and the elastic shrink (or,
    after a heal, regrow) of a persistently failing mesh. A non-retriable
    failure, or an exhausted policy with no smaller mesh, re-raises the
    original error. After a silent corruption the answer's true residual
    is verified on the host (a ``verify`` event; a miss raises
    :class:`..utils.errors.SilentCorruptionError`). Returns the converged
    attempt's result with ``attempts`` and ``recovery_events``; the call is
    one ``resilient.solve`` span."""
    return _wrapped(False, lambda: _resilient_solve(
        ksp, b, x, policy, checkpoint_path, elastic))


def _resilient_solve(ksp, b, x, policy, checkpoint_path, elastic):
    policy = policy or RetryPolicy()
    path = checkpoint_path or default_checkpoint_path(ksp)
    esc = _ElasticEscalation(elastic)
    events: list[RecoveryEvent] = []
    guess0 = ksp._initial_guess_nonzero
    attempt, mesh_attempt = 1, 1

    def save(p, mat, it):
        save_solve_state(p, mat, x, b, iteration=it)

    def restore(p, comm):
        mat2, x2, _b2, _it = load_solve_state(p, comm)
        ksp.set_operators(mat2)
        x.data = x2.data

    try:
        while True:
            try:
                result = ksp.solve(b, x)
                break
            except DeviceExecutionError as exc:
                mesh_attempt = _recover(
                    ksp, exc, policy, esc, events, attempt, mesh_attempt,
                    path, save, restore,
                    lambda c, persisted: esc.reshard(
                        ksp, c, events, attempt, persisted=persisted,
                        path=path, b=b, x=x))
                ksp.set_initial_guess_nonzero(True)
                attempt += 1
                mesh_attempt += 1
                _push(events, RecoveryEvent(
                    kind="resume", attempt=attempt,
                    detail="initial_guess_nonzero from restored iterate"))
    finally:
        ksp.set_initial_guess_nonzero(guess0)
    result.attempts = attempt
    result.recovery_events = events
    sdc = [e for e in events if e.kind == "fault" and e.detector]
    if sdc:
        with _telemetry.span("resilient.verify") as vsp:
            ok, rres = _verify_true_residual(ksp, b, x)
            vsp.set_attrs(ok=ok, rel_residual=float(rres))
        if not ok:
            raise SilentCorruptionError(
                "resilient_solve", "verify", result.iterations,
                detail=f"recovered solve's true relative residual "
                       f"{rres:.3e} misses the tolerance target")
        _push(events, RecoveryEvent(
            kind="verify", attempt=attempt,
            detail=f"true relative residual {rres:.3e} meets target",
            detector="verify"))
        result.sdc_detections = len(sdc)
    return result


def resilient_solve_many(ksp, B, X=None, policy: RetryPolicy | None = None,
                         *, checkpoint_path: str | None = None,
                         elastic=None) -> BatchedSolveResult:
    """``ksp.solve_many(B, X)`` that survives retriable device failures, the
    batched twin of :func:`resilient_solve` (JAX ``retry.py:488``): the
    checkpoint holds the whole ``(n, nrhs)`` blocks, a resumed block
    restarts every column from where it stood (converged columns freeze at
    once), and the verification is per column. On a comm of several
    processes every attempt ends with the ranks agreeing on its outcome
    (``DeviceComm.agree_error``): one rank's failure is every rank's, so a
    retry is taken by all ranks or by none."""
    return _wrapped(True, lambda: _resilient_solve_many(
        ksp, B, X, policy, checkpoint_path, elastic))


def _resilient_solve_many(ksp, B, X, policy, checkpoint_path, elastic):
    policy = policy or RetryPolicy()
    path = checkpoint_path or default_checkpoint_path(ksp)
    esc = _ElasticEscalation(elastic)
    events: list[RecoveryEvent] = []
    guess0 = ksp._initial_guess_nonzero
    mat = ksp.get_operators()[0]
    if isinstance(B, (list, tuple)):
        B = np.stack([v.to_numpy() if hasattr(v, "to_numpy")
                      else np.asarray(v) for v in B], axis=1)
    B = np.asarray(B)
    from ..parallel.mesh import numpy_dtype
    if X is None:
        X = np.zeros(B.shape, dtype=numpy_dtype(mat.dtype))
    else:
        # the resume contract needs a writable host array the fault
        # boundary writes the partial iterate into
        X = np.asarray(X)
        if not X.flags.writeable:
            X = X.copy()
    attempt, mesh_attempt = 1, 1

    def save(p, m, it):
        save_solve_state_many(p, m, X, B, iteration=it)

    def restore(p, comm):
        mat2, X2, _B2, _it = load_solve_state_many(p, comm)
        ksp.set_operators(mat2)
        X[...] = X2.astype(X.dtype, copy=False)

    try:
        while True:
            exc = None
            try:
                result = ksp.solve_many(B, X)
            except Exception as e:  # noqa: BLE001 (agreed below)
                exc = e
            # on a comm of several processes every rank takes the first
            # failing rank's outcome: a retry by all ranks or by none
            exc = ksp.get_operators()[0].comm.agree_error(exc)
            if exc is None:
                break
            if not isinstance(exc, DeviceExecutionError):
                raise exc
            mesh_attempt = _recover(
                ksp, exc, policy, esc, events, attempt, mesh_attempt,
                path, save, restore,
                lambda c, persisted: esc.reshard(
                    ksp, c, events, attempt, persisted=persisted,
                    path=path, B=B, X=X, many=True))
            ksp.set_initial_guess_nonzero(True)
            attempt += 1
            mesh_attempt += 1
            _push(events, RecoveryEvent(
                kind="resume", attempt=attempt,
                detail="initial_guess_nonzero from restored iterate "
                       "block"))
    finally:
        ksp.set_initial_guess_nonzero(guess0)
    result.attempts = attempt
    result.recovery_events = events
    sdc = [e for e in events if e.kind == "fault" and e.detector]
    if sdc:
        with _telemetry.span("resilient.verify") as vsp:
            ok, rres = _verify_true_residual_many(ksp, B, result.X)
            # rank 0's verdict: it holds the whole answer block when the
            # answers come back to it alone (DeviceComm.answers_to_root)
            ok, rres = ksp.get_operators()[0].comm.bcast_obj((ok, rres))
            vsp.set_attrs(ok=ok, rel_residual=float(rres))
        if not ok:
            raise SilentCorruptionError(
                "resilient_solve_many", "verify",
                max(result.iterations, default=0),
                detail=f"recovered batch's worst true relative residual "
                       f"{rres:.3e} misses the tolerance target")
        _push(events, RecoveryEvent(
            kind="verify", attempt=attempt,
            detail=f"worst per-column true relative residual {rres:.3e} "
                   "meets target", detector="verify"))
        result.sdc_detections = len(sdc)
    return result
