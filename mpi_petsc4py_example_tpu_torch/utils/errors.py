"""Exception types the port raises, and the classification of device failures.

The port's counterpart of ``mpi_petsc4py_example_tpu/utils/errors.py``: a
device-side failure surfaces as :class:`DeviceExecutionError` with a
structured ``failure_class`` and ``retriable`` flag, so the resilience layer
(``resilience/retry.py``, ``resilience/fallback.py``) decides per class
whether to checkpoint and retry (``unavailable``), degrade (``oom``: retry at
reduced precision) or surface the error. On the card the failures are CUDA's
own: a hand-written kernel whose launch the runtime refused
(``cudaGetLastError`` not 0 right after the launch, ``ops/stencil.py``),
``torch.cuda.OutOfMemoryError`` and ``RuntimeError: CUDA error: out of
memory`` (class ``oom``). The injected faults of ``resilience/faults.py``
carry the JAX package's messages, so one spec gives one class in both
packages. :class:`SilentCorruptionError` is the ``detected_sdc`` class the
guarded Krylov loops raise. :class:`ServerOverloadedError` and
:class:`DeadlineExceededError` are the solve server's typed admission
outcomes (``serving/server.py``): plain ``RuntimeError`` subclasses outside
the device classes, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FailureClass:
    """One recognized device-failure signature and its recovery contract.

    Markers match case-sensitively, except all-lowercase markers, which
    match against the lowercased message."""
    name: str
    markers: tuple          # substrings of the runtime error that match it
    hint: str               # actionable guidance, included in the message
    retriable: bool         # a plain retry (same config) can succeed

    def matches(self, message: str, lowered: str) -> bool:
        return any(m in (lowered if m == m.lower() else message)
                   for m in self.markers)


# Ordered: the first matching class is the primary classification
# (DeviceExecutionError.failure_class); every matching class adds its hint.
# The names, order and retriable flags are the JAX package's; the markers add
# CUDA's own spellings of the same failures.
FAILURE_CLASSES = (
    FailureClass(
        "unavailable", ("worker process crashed", "UNAVAILABLE",
                        "device-side assert", "unspecified launch failure"),
        "the device worker crashed or restarted; checkpoint state "
        "(utils.checkpoint.save_solve_state) and retry", retriable=True),
    FailureClass(
        "oom", ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory"),
        "device memory exhausted: shard over more devices, use fp32/bf16, "
        "or the matrix-free stencil path", retriable=False),
    FailureClass(
        "callback", ("host send/recv callbacks", "debug.callback"),
        "this runtime does not support in-program host callbacks; remove "
        "the callback", retriable=False),
    FailureClass(
        "unsupported", ("LuDecomposition", "not implemented",
                        "no kernel image is available"),
        "an op is unsupported on this backend/dtype", retriable=False),
    FailureClass(
        "detected_sdc", ("SILENT_DATA_CORRUPTION",),
        "an ABFT checksum or invariant monitor detected silent data "
        "corruption mid-solve; the iterate cannot be trusted: roll back to "
        "the last checkpoint or re-enter from the verified iterate the "
        "solve boundary restored (resilience.resilient_solve does both and "
        "re-verifies the final true residual)", retriable=True),
)


def classify_failure(message: str) -> list[FailureClass]:
    """Every :data:`FAILURE_CLASSES` entry whose signature matches."""
    lowered = message.lower()
    return [fc for fc in FAILURE_CLASSES if fc.matches(message, lowered)]


class DeviceExecutionError(RuntimeError):
    """A device-side failure, naming what failed, with recovery guidance.

    ``original`` is the runtime's exception, or its message as a string.
    ``failure_class`` is the primary classification ('unavailable', 'oom',
    'callback', 'unsupported', 'detected_sdc' or 'unknown') and ``retriable``
    whether a plain same-configuration retry can succeed, the knobs
    :class:`..resilience.RetryPolicy` keys off."""

    def __init__(self, what: str, original):
        if not isinstance(original, BaseException):
            original = RuntimeError(str(original))
        self.original = original
        self.what = what
        self.message = msg = str(original)
        matches = classify_failure(msg)
        self.failure_class = matches[0].name if matches else "unknown"
        self.retriable = matches[0].retriable if matches else False
        hint = "; ".join(fc.hint for fc in matches)
        super().__init__(f"{what} failed on device: {msg}"
                         + (f" ({hint})" if hint else ""))

    def __reduce__(self):
        # the constructor's arguments, then the attributes: each error type
        # of this module survives pickling (the RPC transport's replies,
        # serving/transport.py), which the JAX package's do not
        return (type(self), (self.what, self.original), self.__dict__)


class SilentCorruptionError(DeviceExecutionError):
    """Silent data corruption detected during a solve (``detected_sdc``).

    Raised by the solve boundary when an in-loop detector fires: an ABFT
    checksum mismatch on the operator or preconditioner apply, the
    recurrence-vs-true-residual drift gate, or a NaN/monotonicity sentinel
    (the guarded loops of ``solvers/cg_plans.py``). Before raising, the solve
    writes the last verified iterate back into the caller's solution, so
    ``resilience.resilient_solve`` can re-enter from it.

    ``detector`` names what fired ('abft' | 'abft_pc' | 'drift' | 'nan' |
    'monotonic' | 'verify'); ``iteration`` is where it fired."""

    def __init__(self, what: str, detector: str, iteration: int = 0,
                 detail: str = ""):
        extra = f" ({detail})" if detail else ""
        original = RuntimeError(
            f"SILENT_DATA_CORRUPTION: {detector} detector fired at "
            f"iteration {iteration}{extra}")
        super().__init__(what, original)
        self.detector = detector
        self.iteration = int(iteration)
        self.detail = detail

    def __reduce__(self):
        return (type(self), (self.what, self.detector, self.iteration,
                             self.detail), self.__dict__)


class ServerOverloadedError(RuntimeError):
    """A solve-server submission rejected by admission control (JAX
    ``errors.py:125``).

    ``SolveServer.submit`` raises it when the pending queue is at
    ``-solve_server_max_queue``: a typed, immediate rejection lets callers
    shed or redirect load instead of queueing without bound. The same type
    resolves a pending request that the QoS admission tier shed
    (``shed=True``) to admit a more urgent arrival (``serving/qos.py``).
    Carries ``pending`` (queue depth at rejection), ``limit`` and
    ``shed``."""

    def __init__(self, pending: int, limit: int, shed: bool = False):
        self.pending = int(pending)
        self.limit = int(limit)
        self.shed = bool(shed)
        if shed:
            msg = (f"solve server overloaded: this request was shed from "
                   f"the queue ({pending} pending, admission limit "
                   f"{limit}) to admit a more urgent arrival — resubmit, "
                   "or raise its QoS class")
        else:
            msg = (f"solve server overloaded: {pending} request(s) "
                   f"pending, admission limit {limit} "
                   "(-solve_server_max_queue) — shed load, raise the "
                   "limit, or add capacity")
        super().__init__(msg)

    def __reduce__(self):
        return (type(self), (self.pending, self.limit, self.shed),
                self.__dict__)


class DeadlineExceededError(RuntimeError):
    """A solve request's server-side deadline expired before dispatch (JAX
    ``errors.py:159``): the request resolves with this error instead of
    occupying a batch column. ``waited`` is the seconds it sat queued,
    ``deadline`` the budget it had."""

    def __init__(self, waited: float, deadline: float):
        self.waited = float(waited)
        self.deadline = float(deadline)
        super().__init__(
            f"DEADLINE_EXCEEDED: request waited {waited:.3f}s in the "
            f"solve-server queue, past its {deadline:.3f}s deadline — "
            "never dispatched")

    def __reduce__(self):
        return (type(self), (self.waited, self.deadline), self.__dict__)


def _is_device_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is a device runtime failure to classify: an injected
    fault (named like the JAX runtime's error), CUDA's out-of-memory error,
    or a ``RuntimeError`` carrying a CUDA error message."""
    name = type(exc).__name__
    if "XlaRuntimeError" in name or "JaxRuntimeError" in name:
        return True
    if name in ("OutOfMemoryError", "AcceleratorError"):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


def wrap_device_errors(what: str):
    """Decorator: convert device runtime failures into
    :class:`DeviceExecutionError` (an already classified one passes)."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except DeviceExecutionError:
                raise
            except Exception as e:  # noqa: BLE001 (classify and re-raise)
                if _is_device_failure(e):
                    raise DeviceExecutionError(what, e) from e
                raise
        return inner
    return deco
