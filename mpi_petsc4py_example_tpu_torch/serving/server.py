"""SolveServer: a long-lived solve session with request coalescing.

The port's counterpart of ``mpi_petsc4py_example_tpu/serving/server.py``. A
:class:`SolveServer` registers each operator once (operands, PC set-up and
the fused programs' CUDA graphs stay resident on the card) and coalesces a
concurrent stream of requests into ``(n, k)`` blocks solved by
``KSP.solve_many`` (one operator pass and one reduction a lockstep
iteration serve every column):

* :meth:`SolveServer.submit` returns a ``concurrent.futures.Future`` of a
  :class:`ServedSolveResult`; :meth:`SolveServer.solve` submits and waits;
* the coalescer (``serving/coalescer.py``) groups requests of one operator
  and one set of tolerances; ``-solve_server_window`` holds the oldest
  request so that concurrent arrivals ride its block, ``-solve_server_max_k``
  caps the width and ``-solve_server_pad_pow2`` rounds widths up to powers
  of two;
* QoS (``serving/qos.py``): priority and deadline classes, a
  deadline-weighted scheduling pass a window that dispatches one batch, and
  priority shedding under ``-solve_server_max_queue``; expired requests
  resolve with :class:`~..utils.errors.DeadlineExceededError`;
* every block goes through :func:`~..resilience.retry.resilient_solve_many`
  (``-solve_server_resilient``): a crash checkpoints and resumes, a detected
  corruption rolls back, and a persistent shard loss shrinks the mesh,
  which the server then adopts for every session, and :meth:`regrow` (or
  the dispatcher, after :func:`~..resilience.faults.heal`) grows it back;
* ``persistent=True`` stages batches into the resident multi-request
  program of ``serving/persistent.py``;
* ``multisplit=True`` is the asynchronous schedule class: each request is
  one stale-tolerant outer solve of the session's ``MultisplitSolver``
  (``solvers/multisplit.py``), QoS-``interactive`` batches under the
  tighter ``-multisplit_urgent_stale`` bound.

**No hidden fallback.** A block dispatched on the card runs on the card: a
failure the retry policy cannot recover resolves the block's futures with
the error, and nothing re-runs it on the CPU.

**Threads and CUDA graphs.** :meth:`submit` is host-only (it copies ``b``
into numpy), so client threads never touch CUDA. Every CUDA call the server
makes, registration (with its ``warm_widths`` blocks) included, runs under
the session lock (``_session_lock``), on the dispatcher thread or on the
registering caller's. A fused session (``megasolve``/``persistent``)
captures a block width's graphs at its first launch, so either at
registration (``warm_widths``, in the caller's thread) or in the dispatcher
thread; the lock keeps every other CUDA call of the server out of the
capture. The capture keeps ``torch.cuda.graph``'s default
``capture_error_mode="global"``: while a server captures, the process must
run no CUDA work on other threads, which then fails loudly instead of
joining the graph.

**One process.** The dispatcher drives every shard from one thread; a
``ProcessComm`` of several processes raises ``NotImplementedError``
(serving across processes, with the dispatcher on one rank and the blocks on
all ranks, is ROADMAP.md Queue A item 7.3).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from ..core.mat import Mat
from ..parallel.mesh import as_comm, numpy_dtype
from ..resilience import faults as _faults
from ..resilience.retry import RetryPolicy, resilient_solve_many
from ..solvers.ksp import KSP
from ..telemetry import flight as _flight
from ..telemetry import metrics as _metrics
from ..telemetry import spans as _telemetry
from ..utils.convergence import SolveResult
from ..utils.errors import DeadlineExceededError, ServerOverloadedError
from ..utils.options import global_options
from ..utils.profiling import (record_admission, record_qos,
                               record_serving)
from . import qos as _qos
from .coalescer import SolveRequest, padded_width


class ServerClosedError(RuntimeError):
    """Submission to a server that has been shut down."""


@dataclass
class ServedSolveResult(SolveResult):
    """A per-request :class:`SolveResult` out of the coalesced block it rode
    in (JAX ``server.py:108``): ``x`` the request's solution (a host copy of
    its column), ``batch_width`` the real requests of the block (padding
    excluded), ``queue_wait`` the seconds between submission and dispatch;
    the inherited ``history`` is its residual history (empty unless the
    session monitors). ``wall_time`` and the resilience trail are the block's."""
    x: object = None
    op: str = ""
    batch_width: int = 1
    queue_wait: float = 0.0


def _block(sess, reqs, width):
    """The ``(n, width)`` block of the requests' right-hand sides (zero
    padding columns)."""
    B = np.zeros((sess.n, width), dtype=sess.dtype)
    for j, r in enumerate(reqs):
        B[:, j] = r.b
    return B


class _OperatorSession:
    """One registered operator: the resident operands and a KSP whose PC
    set-up and programs persist across requests. The registered tolerance
    defaults live here: a dispatch sets the KSP's tolerances to each
    batch's, so the KSP's own drift with traffic."""

    __slots__ = ("name", "operator", "ksp", "dtype", "precision", "n",
                 "rtol", "atol", "max_it", "multisplit", "persistent")

    def __init__(self, name, operator, ksp, multisplit=None,
                 persistent=None):
        self.name = name
        self.operator = operator
        self.ksp = ksp
        self.dtype = numpy_dtype(operator.dtype)
        self.precision = str(operator.dtype).removeprefix("torch.")
        self.n = int(operator.shape[0])
        self.rtol = float(ksp.rtol)
        self.atol = float(ksp.atol)
        self.max_it = int(ksp.max_it)
        self.multisplit = multisplit   # MultisplitSolver, or None
        self.persistent = persistent   # PersistentRunner, or None

    @property
    def schedule(self) -> str:
        """The reduction-plan schedule ("cg", "pipecg", "sstep:<s>", or the
        asynchronous class "multisplit"), part of every request's
        compatibility key: blocks never mix schedules."""
        if self.multisplit is not None:
            return "multisplit"
        tp = self.ksp.get_type()
        return f"{tp}:{int(self.ksp.sstep_s)}" if tp == "sstep" else tp


class SolveServer:
    """Long-lived solve session with request coalescing (module docstring;
    JAX ``server.py:170``).

    ``window`` (``-solve_server_window``, seconds the oldest request is
    held), ``max_k`` (``-solve_server_max_k``), ``pad_pow2``
    (``-solve_server_pad_pow2``), ``resilient``
    (``-solve_server_resilient``), ``retry_policy`` (default
    :meth:`RetryPolicy.serving`; ``-solve_server_retry_delay`` replaces its
    base delay), ``max_queue`` (``-solve_server_max_queue``, 0: unbounded)
    and ``deadline`` (``-solve_server_deadline``, seconds, 0: none); the
    options database wins over the arguments. ``autostart=False`` lets a
    caller enqueue a known population, then :meth:`start`. ``comm=None``
    takes the default communicator, which is the card's. ``session_lock``
    (an ``RLock``) replaces the server's own session lock: servers of one
    process that share a card share it (the fleet's replicas)."""

    def __init__(self, comm=None, *, window: float = 0.002,
                 max_k: int = 32, pad_pow2: bool = True,
                 resilient: bool = True,
                 retry_policy: RetryPolicy | None = None,
                 max_queue: int = 0, deadline: float = 0.0,
                 autostart: bool = True, session_lock=None):
        self.comm = as_comm(comm)
        if self.comm.multiprocess:
            raise NotImplementedError(
                f"SolveServer on a ProcessComm of {self.comm.nprocs} "
                "processes: serving across processes (the dispatcher on one "
                "rank, the blocks on all ranks) is ROADMAP.md Queue A item "
                "7.3; serve from one process")
        # the mesh the server was provisioned on: the regrow ceiling
        self._full_comm = self.comm
        self._heal_epoch_seen = _faults.heal_epoch()
        self.window = float(window)
        self.max_k = int(max_k)
        self.pad_pow2 = bool(pad_pow2)
        self.resilient = bool(resilient)
        self.retry_policy = retry_policy or RetryPolicy.serving()
        self.max_queue = int(max_queue)
        self.deadline = float(deadline)
        self.qos_classes = _qos.builtin_classes()
        self._sessions: dict[str, _OperatorSession] = {}
        self._pending: list[SolveRequest] = []
        # the batches left from the last scheduling pass, valid while
        # submit/shed leave _pending alone: a backlog costs one schedule
        self._sched_cache: list | None = None
        self._inflight = 0
        self._stop = False
        self._closed = False
        self._cv = threading.Condition()
        # serializes session mutation (regrow/adoption rebuilds,
        # registration) and every CUDA call of the server against the
        # in-flight dispatch; the dispatcher holds it across _dispatch (an
        # RLock: its own shrink adoption re-enters). Lock order: this lock,
        # then _cv. Servers that drive one card from one process (the
        # fleet's replicas, serving/fleet.py) pass one shared RLock, so no
        # graph capture of one meets another's CUDA work.
        self._session_lock = (threading.RLock() if session_lock is None
                              else session_lock)
        self._thread: threading.Thread | None = None
        self._dispatch_hook = None       # test seam: called per batch
        self._stats = {"requests": 0, "batches": 0, "padded_cols": 0,
                       "width_hist": {}, "qos_hist": {},
                       "rejected": 0, "expired": 0, "shed": 0,
                       "mesh_shrinks": [], "mesh_regrows": []}
        # the per-server twin of the registry's queue-wait histogram (the
        # same Histogram.summary percentiles)
        self._wait_hist = _metrics.Histogram(
            "serving.queue_wait_seconds", _metrics.QUEUE_WAIT_BUCKETS_S)
        self.set_from_options()
        if autostart:
            self.start()

    # ---- configuration ------------------------------------------------------
    def set_from_options(self):
        """Apply the ``-solve_server_*`` flags."""
        opt = global_options()
        self.window = opt.get_real("solve_server_window", self.window)
        self.max_k = opt.get_int("solve_server_max_k", self.max_k)
        self.pad_pow2 = opt.get_bool("solve_server_pad_pow2",
                                     self.pad_pow2)
        self.resilient = opt.get_bool("solve_server_resilient",
                                      self.resilient)
        self.max_queue = opt.get_int("solve_server_max_queue",
                                     self.max_queue)
        self.deadline = opt.get_real("solve_server_deadline",
                                     self.deadline)
        delay = opt.get_real("solve_server_retry_delay", None)
        if delay is not None:
            # replace, never mutate: the caller may share the policy
            self.retry_policy = dataclasses.replace(
                self.retry_policy, base_delay=float(delay))
        return self

    setFromOptions = set_from_options

    # ---- operator registry --------------------------------------------------
    def register_operator(self, name: str, A, *, ksp_type: str = "cg",
                          pc_type: str = "jacobi", dtype=None,
                          rtol: float = 1e-5, atol: float = 0.0,
                          max_it: int = 10000, abft: bool = False,
                          residual_replacement: int = 0,
                          megasolve: bool = False,
                          multisplit: bool = False,
                          persistent: bool = False,
                          warm_widths=()):
        """Register operator ``name`` and make its solve state resident (JAX
        ``server.py:293``).

        ``A`` is a port operator (``Mat``, ``StencilPoisson3D``,
        ``ShellMat``) or anything ``scipy.sparse.csr_matrix`` takes.
        ``rtol``/``atol``/``max_it`` are the session's defaults, which a
        request may override. ``abft``/``residual_replacement`` arm the
        silent-corruption guard, ``megasolve`` the fused program (one
        program run a block, its graphs captured at a width's first launch).
        ``persistent`` (or ``-solve_server_persistent``) stages batches into
        the resident multi-request program (``serving/persistent.py``); a
        guarded or ineligible session warns and keeps the per-batch
        dispatch. ``warm_widths`` runs zero blocks of those widths now, so
        the first real request of a width finds its graphs captured. The
        session KSP then reads the options database (``-ksp_*``), which wins.
        ``multisplit`` routes the session to the asynchronous tier (JAX
        ``server.py:344-353``): requests dispatch column by column through
        its ``MultisplitSolver``, whose inner block solves take the
        session's ``ksp_type``/``pc_type`` (a ``-multisplit_inner_type``
        flag wins); it needs an assembled operator, and excludes
        ``persistent``. The whole registration (placement, set-up, warm
        blocks: CUDA work) runs under the session lock."""
        with self._session_lock:
            if name in self._sessions:
                raise ValueError(f"operator {name!r} already registered")
            op = A
            if not hasattr(op, "program_key"):
                import scipy.sparse as sp
                kw = {} if dtype is None else {"dtype": dtype}
                op = Mat.from_scipy(self.comm, sp.csr_matrix(A), **kw)
            ksp = KSP().create(self.comm)
            ksp.set_operators(op)
            ksp.set_type(ksp_type)
            ksp.get_pc().set_type(pc_type)
            ksp.set_tolerances(rtol=rtol, atol=atol, max_it=max_it)
            ksp.abft = bool(abft)
            ksp.residual_replacement = int(residual_replacement)
            ksp.megasolve = bool(megasolve)
            ksp.set_from_options()
            # a stray global -ksp_type/-pc_type can turn the coalesced block
            # into per-column sequential solves: right, but without the
            # batching; say so
            from ..solvers.krylov import BATCHED_TYPES, batched_pc_supported
            if not multisplit and (
                    ksp.get_type() not in BATCHED_TYPES
                    or not batched_pc_supported(ksp.get_pc())):
                warnings.warn(
                    f"SolveServer operator {name!r}: configuration "
                    f"{ksp.get_type()}+{ksp.get_pc().get_type()} has no "
                    "batched kernel — coalesced blocks will dispatch as "
                    "per-column sequential solves (check for stray global "
                    "-ksp_type/-pc_type options)", stacklevel=2)
            ksp.set_up()                      # the PC set up now, once
            ms = None
            if multisplit:
                ms = self._multisplit_solver(name, op, ksp, rtol, atol,
                                             dtype)
            persistent = global_options().get_bool("solve_server_persistent",
                                                   persistent)
            if persistent and ms is not None:
                raise ValueError(
                    f"operator {name!r}: persistent and multisplit are "
                    "mutually exclusive schedule classes — the async tier "
                    "has no coalesced block program to keep resident")
            if persistent:
                from ..solvers.megasolve import megasolve_supported
                guard = bool(ksp.abft) or int(ksp.residual_replacement) > 0
                if guard or not megasolve_supported(ksp.get_type(),
                                                    ksp.get_pc(), op, nrhs=2):
                    warnings.warn(
                        f"SolveServer operator {name!r}: persistent serving "
                        "needs a megasolve-eligible configuration without "
                        "the ABFT guard — falling back to per-batch "
                        "dispatch", stacklevel=2)
                    persistent = False
                else:
                    # the recovery path (serving/persistent.py) dispatches
                    # through the session KSP: keep it on the fused program
                    ksp.megasolve = True
            sess = _OperatorSession(name, op, ksp, multisplit=ms)
            if persistent:
                from .persistent import PersistentRunner
                sess.persistent = PersistentRunner(self, sess)
            self._sessions[name] = sess
            for w in warm_widths:
                w = padded_width(int(w), self.max_k, self.pad_pow2)
                ksp.solve_many(np.zeros((sess.n, w), sess.dtype))
            return sess

    registerOperator = register_operator

    def _multisplit_solver(self, name, op, ksp, rtol, atol, dtype):
        """The session's asynchronous solver (JAX ``server.py:388-404``):
        the session's KSP type and PC seed the inner block solves unless
        ``-multisplit_inner_type`` is set (the options database wins)."""
        from ..solvers.multisplit import MultisplitSolver
        if not hasattr(op, "to_scipy"):
            raise ValueError(
                f"operator {name!r}: the multisplit schedule class needs a "
                "host-reconstructible operator (Mat) — matrix-free "
                "stencils have no row splitting")
        inner = (None if global_options().has("multisplit_inner_type")
                 else ksp.get_type())
        ms = MultisplitSolver(self.comm, inner_type=inner,
                              pc_type=ksp.get_pc().get_type(), rtol=rtol,
                              atol=atol, dtype=dtype)
        return ms.set_operator(op)

    def register_session(self, name: str, operator, *,
                         ksp_type: str = "cg", pc_type: str = "jacobi",
                         **kw):
        """Register an operator already placed for this server's mesh (JAX
        ``server.py:444``): the landing pad of a migrated session, so that
        it never goes back through scipy. Same contract as
        :meth:`register_operator`."""
        return self.register_operator(name, operator, ksp_type=ksp_type,
                                      pc_type=pc_type, **kw)

    def unregister_operator(self, name: str):
        """Remove a resident session; refuses while requests for it are
        queued (drain first)."""
        with self._session_lock, self._cv:
            if any(r.op == name for r in self._pending):
                raise RuntimeError(
                    f"unregister_operator({name!r}): requests still "
                    "pending — drain() first")
            sess = self._sessions.pop(name, None)
        if sess is None:
            raise ValueError(f"unknown operator {name!r}; registered: "
                             f"{self.operators()}")
        return sess

    def operators(self):
        return sorted(self._sessions)

    # ---- client APIs --------------------------------------------------------
    def submit(self, op: str, b, *, rtol: float | None = None,
               atol: float | None = None, max_it: int | None = None,
               deadline: float | None = None, qos: str | None = None,
               priority: int | None = None) -> Future:
        """Enqueue one solve; returns a Future of :class:`ServedSolveResult`
        (JAX ``server.py:477``). Tolerance overrides narrow the request's
        compatibility group. ``deadline`` (seconds, 0: none) overrides the
        class's or the server's dispatch deadline; ``qos`` names a class
        (``interactive``/``bulk``), ``priority`` a tier (lower is more
        urgent). With the queue at ``max_queue`` the arrival sheds the least
        urgent strictly-lower-priority pending request (its future resolves
        with :class:`ServerOverloadedError`, ``shed=True``), or else is
        rejected with :class:`ServerOverloadedError`. Host-only: ``b`` is
        copied into numpy here."""
        sess = self._sessions.get(op)
        if sess is None:
            raise ValueError(f"unknown operator {op!r}; registered: "
                             f"{self.operators()}")
        b = np.asarray(b)
        if b.shape != (sess.n,):
            raise ValueError(f"submit({op!r}): b must be ({sess.n},), "
                             f"got {b.shape}")
        cls = _qos.resolve(qos, self.qos_classes)
        prio = (int(priority) if priority is not None
                else cls.priority if cls is not None
                else _qos.DEFAULT_PRIORITY)
        if deadline is not None:
            budget = float(deadline)
        elif cls is not None and cls.deadline > 0:
            budget = cls.deadline
        else:
            budget = self.deadline
        fut: Future = Future()
        req = SolveRequest(
            # a copy: the caller may reuse its buffer while the request
            # waits in the batching window
            op=op, b=np.array(b, dtype=sess.dtype, copy=True),
            rtol=sess.rtol if rtol is None else float(rtol),
            atol=sess.atol if atol is None else float(atol),
            max_it=sess.max_it if max_it is None else int(max_it),
            precision=sess.precision, schedule=sess.schedule,
            qos=cls.name if cls is not None else "",
            priority=prio, future=fut)
        if budget > 0:
            req.t_deadline = req.t_submit + budget
        with self._cv:
            if self._closed:
                raise ServerClosedError("SolveServer is shut down")
            if self._sessions.get(op) is not sess:
                raise ValueError(f"operator {op!r} was unregistered "
                                 "while submitting")
            if self.max_queue > 0 and len(self._pending) >= self.max_queue:
                victim = _qos.shed_victim(self._pending, prio)
                if victim is None:
                    self._stats["rejected"] += 1
                    record_admission(rejected=1)
                    raise ServerOverloadedError(len(self._pending),
                                                self.max_queue)
                # removal by identity: dataclass equality would compare the
                # right-hand sides
                self._pending = [r for r in self._pending
                                 if r is not victim]
                self._stats["shed"] += 1
                record_admission(shed=1)
                if victim.future.set_running_or_notify_cancel():
                    victim.future.set_exception(ServerOverloadedError(
                        len(self._pending) + 1, self.max_queue,
                        shed=True))
                self._end_request_span(victim, "shed")
            record_qos(req.qos)
            # admitted requests only get a span (detached: finished on the
            # dispatcher thread, linked to its batch's span)
            req.span = _telemetry.start_span("serving.request", op=op)
            self._pending.append(req)
            self._sched_cache = None
            _metrics.registry.gauge("serving.queue_depth").set(
                len(self._pending))
            self._cv.notify_all()
        return fut

    def solve(self, op: str, b, *, timeout: float | None = None,
              **tol_overrides) -> ServedSolveResult:
        """Synchronous client API: submit and wait."""
        return self.submit(op, b, **tol_overrides).result(timeout)

    # ---- lifecycle ----------------------------------------------------------
    def start(self):
        """Start the dispatcher thread (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="SolveServer-dispatch",
                daemon=True)
            self._thread.start()
        return self

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted request has resolved; False on
        timeout. The server stays open."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while (self._pending or self._inflight
                   or self._persistent_unresolved()):
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cv.wait(rem if rem is not None else 0.5)
        return True

    def drain_operator(self, name: str,
                       timeout: float | None = None) -> bool:
        """Block until no request for ``name`` is pending; False on
        timeout. Does not wait for other sessions' traffic."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while any(r.op == name for r in self._pending):
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cv.wait(rem if rem is not None else 0.5)
        return True

    def shutdown(self, wait: bool = True):
        """Stop the server. ``wait=True`` resolves every pending future
        first, then joins the dispatcher; ``wait=False`` fails the pending
        futures with :class:`ServerClosedError`."""
        with self._cv:
            if self._closed and self._thread is None:
                return
            self._closed = True
            if not wait:
                for r in self._pending:
                    if r.future.set_running_or_notify_cancel():
                        r.future.set_exception(
                            ServerClosedError("server shut down before "
                                              "dispatch"))
                    if r.span is not None:
                        r.span.set_attr("outcome", "closed").end()
                self._pending.clear()
                self._sched_cache = None
            pending = bool(self._pending)
        if self._thread is None and pending:
            # a server never started flushes on its own thread too, so
            # shutdown keeps the every-future-resolves contract
            self.start()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(wait=exc == (None, None, None))
        return False

    # ---- dispatcher ---------------------------------------------------------
    def _loop(self):
        while True:
            with self._cv:
                while (not self._pending and not self._stop
                       and not self._persistent_unresolved()):
                    self._cv.wait()
                stopping = not self._pending and self._stop
                idle = not self._pending
                t_open = (self._pending[0].t_submit if self._pending
                          else 0.0)
            if idle:
                # the queue went quiet (or the server stops) with persistent
                # launches outstanding: resolve them now
                with self._session_lock:
                    self._flush_persistent()
                if stopping:
                    return
                continue
            # a heal may have restored capacity: adopt the larger mesh
            # before this window's traffic
            self._maybe_regrow()
            # the batching window: hold the oldest request at most `window`
            # seconds; a request the one-batch-a-pass rule left queued is
            # older than the window and goes at once
            while True:
                with self._cv:
                    if self._stop:
                        break
                    rem = self.window - (time.monotonic() - t_open)
                    if rem <= 0:
                        break
                    self._cv.wait(timeout=rem)
            # one scheduling pass, one batch dispatched; the rest of the
            # order is reused while nothing touches the queue
            with self._cv:
                if self._sched_cache:
                    batch = self._sched_cache.pop(0)
                else:
                    with _telemetry.span(
                            "serving.coalesce",
                            taken=len(self._pending)) as csp:
                        batches = _qos.schedule(self._pending, self.max_k)
                        csp.set_attrs(batches=len(batches))
                    if not batches:
                        continue
                    batch = batches[0]
                    self._sched_cache = batches[1:]
                chosen = {id(r) for r in batch}
                self._pending = [r for r in self._pending
                                 if id(r) not in chosen]
                self._inflight += len(batch)
                _metrics.registry.gauge("serving.queue_depth").set(
                    len(self._pending))
            try:
                with self._session_lock:
                    self._dispatch(batch)
            finally:
                with self._cv:
                    self._inflight -= len(batch)
                    self._cv.notify_all()

    def _dispatch(self, reqs):
        """Solve one coalesced batch and resolve its requests' futures."""
        if self._dispatch_hook is not None:
            self._dispatch_hook(reqs)
        # expired requests resolve with DEADLINE_EXCEEDED instead of taking
        # a column
        now = time.monotonic()
        expired = [r for r in reqs if r.expired(now)]
        if expired:
            with self._cv:
                self._stats["expired"] += len(expired)
            record_admission(expired=len(expired))
            for r in expired:
                if r.future.set_running_or_notify_cancel():
                    r.future.set_exception(DeadlineExceededError(
                        now - r.t_submit, r.t_deadline - r.t_submit))
                self._end_request_span(r, "deadline_exceeded")
            reqs = [r for r in reqs if not r.expired(now)]
        # a request cancelled by its client never reaches the device
        live = []
        for r in reqs:
            if r.future.set_running_or_notify_cancel():
                live.append(r)
            else:
                self._end_request_span(r, "cancelled")
        reqs = live
        if not reqs:
            return
        sess = self._sessions.get(reqs[0].op)
        if sess is None:
            exc = ValueError(f"operator {reqs[0].op!r} is no longer "
                             "registered")
            for r in reqs:
                r.future.set_exception(exc)
                self._end_request_span(r, "error")
            return
        k = len(reqs)
        t0 = time.monotonic()
        waits = [t0 - r.t_submit for r in reqs]
        with self._cv:
            qh = self._stats["qos_hist"]
            for r in reqs:
                key = r.qos or "default"
                qh[key] = qh.get(key, 0) + 1
        if sess.persistent is not None:
            # stage into the resident program's next launch and go back to
            # coalescing; resolution happens at turnover or the idle flush
            sess.persistent.enqueue(reqs, waits)
            self._record(k, waits, 0)
            return
        kpad = padded_width(k, self.max_k, self.pad_pow2)
        bsp = _telemetry.span("serving.dispatch", op=reqs[0].op,
                              width=k, padded=kpad - k,
                              precision=reqs[0].precision)
        with bsp:
            B = _block(sess, reqs, kpad)
            ksp = sess.ksp
            ksp.set_tolerances(rtol=reqs[0].rtol, atol=reqs[0].atol,
                               max_it=reqs[0].max_it)
            try:
                if sess.multisplit is not None:
                    res = self._multisplit_solve_many(sess, reqs, B)
                elif self.resilient:
                    res = resilient_solve_many(ksp, B,
                                               policy=self.retry_policy)
                else:
                    res = ksp.solve_many(B)
            except Exception as exc:  # noqa: BLE001 (resolves the futures)
                # whatever the dispatch raised reaches the waiting futures;
                # the dispatcher must survive for every later request
                bsp.set_attr("error", type(exc).__name__)
                bsp.end()
                _flight.auto_dump("serving dispatch failed: "
                                  f"{type(exc).__name__}")
                for r in reqs:
                    r.future.set_exception(exc)
                    self._end_request_span(r, "error", batch=bsp)
                self._record(k, waits, kpad - k)
                return
            shrinks = [e for e in res.recovery_events
                       if e.kind == "mesh_shrink"]
            if shrinks:
                # the resilient dispatch resharded this session onto a
                # degraded mesh: adopt it server-wide
                self._adopt_shrunk_mesh(sess, shrinks,
                                        time.monotonic() - t0)
            self._resolve_block(reqs, res, waits, k, bsp)
            bsp.set_attrs(attempts=res.attempts,
                          iterations=max(res.iterations, default=0))
        self._record(k, waits, kpad - k)

    def _multisplit_solve_many(self, sess, reqs, B):
        """One batch through the asynchronous tier (JAX ``server.py:907``):
        a stale-tolerant outer solve per request instead of a coalesced
        block. When any request is QoS-``interactive`` the staleness bound
        tightens to ``-multisplit_urgent_stale`` (default: half the
        session's bound, at least 1), trading straggler tolerance for
        fresher exchanges on the traffic that waits."""
        from ..utils.convergence import BatchedSolveResult
        ms = sess.multisplit
        bound = None
        if any(r.qos == "interactive" for r in reqs):
            bound = global_options().get_int(
                "multisplit_urgent_stale", max(1, ms.max_stale // 2))
        t0 = time.monotonic()
        X = np.zeros((sess.n, len(reqs)), dtype=sess.dtype)
        iters, rnorms, reasons, hists = [], [], [], []
        for j, r in enumerate(reqs):
            res = ms.solve(B[:, j], rtol=r.rtol, atol=r.atol,
                           max_stale=bound)
            X[:, j] = res.x
            iters.append(int(res.iterations))
            rnorms.append(float(res.residual_norm))
            reasons.append(int(res.reason))
            hists.append([rn for _v, rn in res.history])
        return BatchedSolveResult(iterations=iters, residual_norms=rnorms,
                                  reasons=reasons,
                                  wall_time=time.monotonic() - t0, X=X,
                                  histories=hists)

    def _resolve_block(self, reqs, res, waits, width, bsp):
        """Resolve each request's future from its column of a block result
        (a ``BatchedSolveResult``); shared with the persistent fallback."""
        hist = res.histories or []
        XT = np.ascontiguousarray(res.X.T)   # one row a request
        for j, (r, col) in enumerate(zip(reqs, res.per_rhs())):
            out = ServedSolveResult(
                iterations=col.iterations,
                residual_norm=col.residual_norm,
                reason=col.reason, wall_time=res.wall_time,
                attempts=res.attempts,
                recovery_events=list(res.recovery_events),
                abft_checks=res.abft_checks,
                sdc_detections=res.sdc_detections,
                residual_replacements=res.residual_replacements,
                x=XT[j], op=r.op, batch_width=width,
                queue_wait=waits[j],
                history=list(hist[j]) if j < len(hist) else [])
            r.future.set_result(out)
            self._end_request_span(r, "ok", batch=bsp,
                                   iterations=col.iterations,
                                   queue_wait=waits[j])

    def _persistent_unresolved(self) -> int:
        """Requests staged into or riding persistent launches (the drain
        and idle-flush count; a stale read costs one condvar lap)."""
        return sum(s.persistent.unresolved
                   for s in list(self._sessions.values())
                   if s.persistent is not None)

    def _flush_persistent(self):
        """Resolve every outstanding persistent launch and drain the staged
        backlogs; the caller holds the session lock."""
        for s in list(self._sessions.values()):
            if s.persistent is not None:
                s.persistent.flush()

    @staticmethod
    def _end_request_span(req, outcome: str, batch=None, **attrs):
        """Finish a request's detached ``serving.request`` span, linked to
        the batch span it was resolved out of."""
        sp = req.span
        if sp is None:
            return
        if batch is not None and batch.span_id:
            sp.set_attr("batch_span", batch.span_id)
        sp.set_attrs(outcome=outcome, **attrs)
        sp.end()

    def _rebuild_sessions_on(self, comm_new, skip=None) -> dict:
        """Re-place every resident session on ``comm_new`` (operator, PC,
        the block widths traffic has used re-warmed), the step shared by the
        shrink adoption and the regrow; ``skip`` is a session the elastic
        retry already rebuilt. A session that cannot live there is recorded,
        not raised: its next dispatch surfaces the error on its futures."""
        from ..resilience import elastic as _elastic
        # persistent launches hold buffers of the old mesh: resolve them
        # first; their staged slots launch on the new geometry
        for s in list(self._sessions.values()):
            if s.persistent is not None:
                s.persistent.quiesce()
        with self._cv:
            widths = sorted(padded_width(w, self.max_k, self.pad_pow2)
                            for w in self._stats["width_hist"])
        failures = {}
        for s in self._sessions.values():
            if s is skip:
                continue
            try:
                mat2 = _elastic.rebuild_operator(s.operator, comm_new)
                _elastic.rebuild_ksp(s.ksp, mat2)
                s.operator = mat2
                _elastic.warm(s.ksp, widths)
            except Exception as exc:  # noqa: BLE001 (recorded per session)
                failures[s.name] = repr(exc)
        return failures

    def _adopt_shrunk_mesh(self, shrunk_sess, shrink_events, dispatch_wall):
        """Adopt the degraded mesh a resilient dispatch landed on: every
        other resident session is rebuilt there (JAX ``server.py:990``)."""
        comm_new = shrunk_sess.ksp.comm
        if comm_new is self.comm or comm_new.size >= self.comm.size:
            return
        old_n = self.comm.size
        t0 = time.monotonic()
        shrunk_sess.operator = shrunk_sess.ksp.get_operators()[0]
        failures = self._rebuild_sessions_on(comm_new, skip=shrunk_sess)
        self.comm = comm_new
        # _heal_epoch_seen stays: a heal that landed during the degraded
        # dispatch must still trigger the regrow on the next pass
        entry = {"old_devices": old_n, "new_devices": comm_new.size,
                 "dispatch_wall_s": float(dispatch_wall),
                 "adopt_wall_s": time.monotonic() - t0,
                 "resumed_iteration": max(
                     (e.iterations for e in shrink_events), default=0),
                 "rebuild_failures": failures}
        with self._cv:
            self._stats["mesh_shrinks"].append(entry)

    def _maybe_regrow(self) -> bool:
        """The dispatcher's check: degraded, and a heal since the last
        look? Then :meth:`regrow`."""
        if self.comm.size >= self._full_comm.size:
            return False
        ep = _faults.heal_epoch()
        if ep == self._heal_epoch_seen:
            return False
        self._heal_epoch_seen = ep
        return self.regrow()

    def regrow(self) -> bool:
        """Rebuild every resident session on the largest viable larger mesh
        over the healed shards (``-elastic_regrow``), never past the
        provisioned one; False when not degraded, disarmed, or no larger
        rung exists. Safe from any thread: it waits out an in-flight
        dispatch on the session lock."""
        from ..resilience import elastic as _elastic
        from ..utils.profiling import record_mesh_regrow
        policy = _elastic.ElasticPolicy.from_options()
        if not (policy.enabled and policy.regrow):
            return False
        with self._session_lock:
            grown = _elastic.MeshRebuilder(policy).grown_comm(
                self.comm, self._full_comm)
            if grown is None:
                return False
            old_n = self.comm.size
            t0 = time.monotonic()
            with _telemetry.span("serving.regrow", old_devices=old_n,
                                 new_devices=int(grown.size)) as gsp:
                failures = self._rebuild_sessions_on(grown)
                self.comm = grown
                wall = time.monotonic() - t0
                record_mesh_regrow(old_n, grown.size, wall)
                gsp.set_attrs(
                    rebuilt=len(self._sessions) - len(failures),
                    failures=len(failures))
        entry = {"old_devices": old_n, "new_devices": grown.size,
                 "adopt_wall_s": wall, "rebuild_failures": failures}
        with self._cv:
            self._stats["mesh_regrows"].append(entry)
        return True

    def _record(self, width, waits, padded):
        record_serving(width, waits, padded)   # the process-wide twin
        for w in waits:
            self._wait_hist.observe(float(w))
        with self._cv:
            st = self._stats
            st["requests"] += width
            st["batches"] += 1
            st["padded_cols"] += padded
            st["width_hist"][width] = st["width_hist"].get(width, 0) + 1

    # ---- observability ------------------------------------------------------
    def stats(self) -> dict:
        """Per-server coalescing statistics (``profiling.serving_stats()``
        is the process-wide twin ``-log_view`` prints)."""
        with self._cv:
            st = self._stats
            out = {"requests": st["requests"], "batches": st["batches"],
                   "padded_cols": st["padded_cols"],
                   "width_hist": dict(st["width_hist"]),
                   "qos_hist": dict(st["qos_hist"]),
                   "rejected": st["rejected"], "expired": st["expired"],
                   "shed": st["shed"],
                   "pending": len(self._pending),
                   "devices": int(self.comm.size),
                   "mesh_shrinks": [dict(e)
                                    for e in st["mesh_shrinks"]],
                   "mesh_regrows": [dict(e)
                                    for e in st["mesh_regrows"]]}
            per = {s.name: dict(s.persistent.stats)
                   for s in self._sessions.values()
                   if s.persistent is not None}
            if per:
                out["persistent"] = per
        out["mean_width"] = (out["requests"] / out["batches"]
                             if out["batches"] else 0.0)
        s = self._wait_hist.summary((50, 99))
        if s["count"]:
            out["queue_wait_mean_s"] = s["mean"]
            out["queue_wait_p50_s"] = s["p50"]
            out["queue_wait_p99_s"] = s["p99"]
            out["queue_wait_max_s"] = s["max"]
        return out

    def metrics_endpoint(self) -> str:
        """The process-wide registry in the Prometheus text format, to
        mount behind ``GET /metrics`` on whatever front-end serves this
        server."""
        return _metrics.registry.prometheus_text()

    metricsEndpoint = metrics_endpoint

    def __repr__(self):
        return (f"SolveServer(ops={self.operators()}, "
                f"window={self.window:g}s, max_k={self.max_k}, "
                f"resilient={self.resilient})")
