"""Remote replicas: the fleet router spanning hosts over the RPC layer.

The port's counterpart of ``mpi_petsc4py_example_tpu/serving/remote.py``.
Three pieces make the fleet of ``serving/fleet.py`` a multi-host one without
changing the router's placement and migration logic:

* :class:`ReplicaHost` -- the host side: one :class:`~.server.SolveServer`
  behind an :class:`~.transport.RpcHost` handler table. Besides the verbs
  (register, solve, drain, stats, ...) it keeps each resident session's
  elastic checkpoint, rewritten after every resolved solve with the
  session's cumulative iteration count, and reports ``{op: iteration}`` on
  every lease ping, so that the client pulls only the checkpoints that
  advanced.
* :class:`RemoteReplica` -- the client stub speaking the replica interface
  ``SolveRouter`` uses (``register_operator``, ``submit``, ``drain``,
  ``stats``, ``shutdown``, ``.comm``); a router built with a stub factory
  shards sessions across hosts unchanged. A submit whose RPC fails asks the
  ``failover`` hook and replays the same idempotency key on the session's
  new home.
* :class:`FleetManager` -- hosts, stubs, router and the lease-based failure
  detector: :meth:`~FleetManager.lease_step` pings every host; a host that
  misses ``-fleet_transport_suspect_after`` renewals is suspected (its stub
  quarters its call deadlines), one that misses
  ``-fleet_transport_confirm_after`` is confirmed lost, and its sessions are
  re-registered on a survivor from their last pulled checkpoint, resumed
  past iteration 0 (span ``fleet.failover``, ``resumed_iteration``).
  Placement changes carry monotonic epochs; after a partition heals,
  :meth:`~FleetManager.reconcile` keeps exactly one registration of every
  session.

**On the card.** Checkpoint bytes are built from and loaded onto port
operators, so the register, refresh and migration steps are CUDA work: each
runs under the session lock of the server it touches (``_h_register`` holds
its server's lock through the resumed warm solve, as the dispatcher would),
and the hosts and stubs a :class:`FleetManager` builds in one process share
one lock (``card_lock``), so that no graph capture meets another thread's
CUDA work. What crosses the wire is host data only: numpy arrays, the npz
bytes of a checkpoint, plain values (``serving/transport.py`` refuses a
``torch.Tensor``).

**One process.** A ``ProcessComm`` of several processes raises
``NotImplementedError`` (ROADMAP.md Queue A item 7.3).
"""

from __future__ import annotations

import collections
import itertools
import os
import tempfile
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..parallel.mesh import numpy_dtype
from ..telemetry import metrics as _metrics
from ..telemetry import spans as _telemetry
from ..utils.options import global_options
from .fleet import SolveRouter, _refuse_multiprocess
from .server import ServedSolveResult, SolveServer
from .transport import (LoopbackTransport, RpcClient, RpcHost,
                        SocketHostServer, SocketTransport, TransportError)

__all__ = ["ReplicaHost", "RemoteReplica", "RemoteSession",
           "FleetManager", "FailoverEvent"]


def _ckpt_to_bytes(mat, X, B, iteration: int = 0) -> bytes:
    """The elastic checkpoint as wire bytes (the npz file's contents)."""
    from ..utils.checkpoint import save_solve_state_many
    fd, path = tempfile.mkstemp(suffix=".npz", prefix="tpu_fleet_ckpt_")
    os.close(fd)
    try:
        save_solve_state_many(path, mat, X, B, iteration=int(iteration))
        with open(path, "rb") as f:
            return f.read()
    finally:
        try:
            os.remove(path)
        except OSError:
            pass


def _ckpt_from_bytes(blob: bytes, comm):
    """``(mat, X, B, iteration)`` reloaded onto ``comm``'s mesh."""
    from ..utils.checkpoint import load_solve_state_many
    fd, path = tempfile.mkstemp(suffix=".npz", prefix="tpu_fleet_ckpt_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        return load_solve_state_many(path, comm)
    finally:
        try:
            os.remove(path)
        except OSError:
            pass


class ReplicaHost:
    """The host side of one remote replica (module docstring).

    ``server`` may be given; otherwise one is built from ``comm`` and
    ``server_kw``. The handlers sit behind the transport's idempotency
    cache, so a verb delivered twice runs once."""

    def __init__(self, server: SolveServer | None = None, *, comm=None,
                 host_index: int = 0, **server_kw):
        self.server = (server if server is not None
                       else SolveServer(comm, **server_kw))
        self.host_index = int(host_index)
        self._lock = threading.RLock()
        # op -> {"bytes", "iteration", "epoch", "kwargs"}: the freshest
        # checkpoint of every resident session, what a failover on another
        # host resumes from
        self._ckpt: dict[str, dict] = {}
        # the seconds of the latest checkpoint rewrites, one a resolved solve
        self.refresh_seconds = collections.deque(maxlen=4096)
        self.rpc = RpcHost({
            "hello": self._h_hello,
            "ping": self._h_ping,
            "register": self._h_register,
            "unregister": self._h_unregister,
            "solve": self._h_solve,
            "drain": self._h_drain,
            "drain_operator": self._h_drain_operator,
            "stats": self._h_stats,
            "operators": self._h_operators,
            "resident": self._h_resident,
            "checkpoint": self._h_checkpoint,
            "regrow": self._h_regrow,
            "shutdown": self._h_shutdown,
        }, host_index=host_index)

    # ---- handlers (payload dict -> picklable reply) -------------------------

    def _h_hello(self, p):
        return {"host": self.host_index,
                "mesh": self.server.comm.fingerprint()}

    def _h_ping(self, p):
        with self._lock:
            its = {op: e["iteration"] for op, e in self._ckpt.items()}
        return {"host": self.host_index, "iterations": its}

    def _h_register(self, p):
        """Land a session from checkpoint bytes. ``resume=True`` with a
        checkpoint past iteration 0 warm-restarts its iterate block (the
        failover's "never from iteration 0"); the reply's
        ``resumed_iteration`` is the count the solve continued from. The
        whole handler (placement, registration, the warm solve, the new
        checkpoint) is CUDA work under the server's session lock."""
        op = p["op"]
        kwargs = dict(p.get("kwargs") or {})
        epoch = int(p.get("epoch", 0))
        with self.server._session_lock:
            mat, X, B, it = _ckpt_from_bytes(p["ckpt"], self.server.comm)
            sess = self.server.register_session(op, mat, **kwargs)
            resumed = 0
            iteration = int(it)
            if p.get("resume") and it > 0:
                resumed = int(it)
                sess.ksp.set_initial_guess_nonzero(True)
                try:
                    res = sess.ksp.solve_many(np.asarray(B), np.asarray(X))
                finally:
                    sess.ksp.set_initial_guess_nonzero(False)
                iteration = int(it) + int(max(res.iterations or [0]))
                X = np.asarray(res.X)
            blob = _ckpt_to_bytes(sess.operator, np.asarray(X),
                                  np.asarray(B), iteration)
        with self._lock:
            self._ckpt[op] = {"bytes": blob, "iteration": iteration,
                              "epoch": epoch, "kwargs": kwargs}
        return {"host": self.host_index, "epoch": epoch,
                "resumed_iteration": resumed, "iteration": iteration,
                "mesh": self.server.comm.fingerprint()}

    def _h_unregister(self, p):
        op = p["op"]
        self.server.drain_operator(op)
        self.server.unregister_operator(op)
        with self._lock:
            self._ckpt.pop(op, None)
        return True

    def _h_solve(self, p):
        op = p["op"]
        b = np.asarray(p["b"])
        kw = dict(p.get("kw") or {})
        budget = float(p.get("timeout") or 120.0)
        res = self.server.submit(op, b, **kw).result(timeout=budget)
        self._refresh_ckpt(op, b, res)
        return {"op": op, "x": np.asarray(res.x),
                "iterations": int(res.iterations),
                "residual_norm": float(res.residual_norm),
                "reason": int(res.reason),
                "wall_time": float(res.wall_time),
                "batch_width": int(res.batch_width),
                "queue_wait": float(res.queue_wait)}

    def _refresh_ckpt(self, op: str, b, res):
        """Advance ``op``'s checkpoint past the solve that just resolved:
        the iterate block becomes the solution and the session's iteration
        count accumulates, so a later failover resumes past iteration 0.
        The operator's read runs under the server's session lock."""
        t0 = time.perf_counter()
        with self.server._session_lock, self._lock:
            entry = self._ckpt.get(op)
            if entry is None:
                return
            sess = self.server._sessions.get(op)
            if sess is None:
                return
            n = int(sess.n)
            X = np.asarray(res.x, dtype=sess.dtype).reshape(n, -1)
            B = np.asarray(b, dtype=sess.dtype).reshape(n, -1)
            entry["iteration"] = (int(entry["iteration"])
                                  + int(res.iterations))
            entry["bytes"] = _ckpt_to_bytes(sess.operator, X, B,
                                            entry["iteration"])
            self.refresh_seconds.append(time.perf_counter() - t0)

    def _h_drain(self, p):
        return bool(self.server.drain(p.get("timeout")))

    def _h_drain_operator(self, p):
        self.server.drain_operator(p["op"])
        return True

    def _h_stats(self, p):
        return self.server.stats()

    def _h_operators(self, p):
        return self.server.operators()

    def _h_resident(self, p):
        with self._lock:
            return {op: int(e["epoch"]) for op, e in self._ckpt.items()}

    def _h_checkpoint(self, p):
        with self._lock:
            e = self._ckpt[p["op"]]
            return {"bytes": e["bytes"], "iteration": int(e["iteration"]),
                    "epoch": int(e["epoch"]),
                    "kwargs": dict(e["kwargs"])}

    def _h_regrow(self, p):
        return bool(self.server.regrow())

    def _h_shutdown(self, p):
        self.server.shutdown(wait=bool(p.get("wait", True)))
        return True


class RemoteSession:
    """What :meth:`RemoteReplica.register_operator` returns: the client-side
    placed operator (the router keeps ``.operator`` for migration
    checkpoints) and the host's registration reply."""

    __slots__ = ("name", "operator", "info")

    def __init__(self, name, operator, info=None):
        self.name = name
        self.operator = operator
        self.info = dict(info or {})


class RemoteReplica:
    """Client stub speaking the replica interface over one ``RpcClient``.

    ``comm`` is the client-side communicator a checkpoint is placed on when
    the router reloads one for a migration (the host may run another
    geometry, which the elastic format absorbs). ``failover`` is an optional
    ``callable(op, replica_name) -> RemoteReplica | None`` asked when a
    solve RPC fails: the same idempotency key replays on the returned stub.
    ``epoch_source`` supplies the placement epochs (the FleetManager's
    counter; a standalone stub keeps its own). ``session_lock`` (an
    ``RLock``) guards the stub's own CUDA work, the client-side placement
    and checkpoint reads: a :class:`FleetManager` passes the lock its
    in-process hosts share."""

    def __init__(self, client: RpcClient, *, name: str = "remote",
                 comm=None, failover=None, epoch_source=None,
                 solve_timeout: float = 120.0, max_workers: int = 4,
                 session_lock=None):
        self.client = client
        self.name = str(name)
        self._comm = comm
        self.failover = failover
        self.degraded = False       # set by the failure detector
        self.solve_timeout = float(solve_timeout)
        self._counter = itertools.count(1)
        self._epoch = epoch_source or (lambda c=itertools.count(1):
                                       next(c))
        self._session_lock = (threading.RLock() if session_lock is None
                              else session_lock)
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(max_workers)),
            thread_name_prefix=f"rpc-{name}")
        self._ops: dict[str, dict] = {}

    @property
    def comm(self):
        return self._comm

    def _deadline(self) -> float:
        """A call's budget: a suspected host gets a quarter of the normal
        deadline, so that in-flight work fails over fast."""
        d = self.client.deadline
        return d * 0.25 if self.degraded else d

    def hello(self) -> dict:
        return self.client.call("hello", {}, deadline=self._deadline())

    # ---- replica interface (what SolveRouter calls) -------------------------

    def register_operator(self, name: str, A, **kw):
        mat = A
        if not hasattr(mat, "program_key"):
            import scipy.sparse as sp
            from ..core.mat import Mat
            dkw = {} if kw.get("dtype") is None else {"dtype": kw["dtype"]}
            with self._session_lock:
                mat = Mat.from_scipy(self._comm, sp.csr_matrix(A), **dkw)
        return self.register_session(name, mat, **kw)

    def register_session(self, name: str, operator, **kw):
        n = int(operator.shape[0])
        z = np.zeros((n, 1), dtype=numpy_dtype(operator.dtype))
        epoch = int(self._epoch())
        with self._session_lock:
            blob = _ckpt_to_bytes(operator, z, z, 0)
        info = self.client.call(
            "register",
            {"op": name, "ckpt": blob,
             "kwargs": dict(kw), "epoch": epoch, "resume": False},
            deadline=self.client.deadline,
            idem_key=f"{self.name}.register.{name}.{epoch}")
        self._ops[name] = dict(kw)
        return RemoteSession(name, operator, info)

    def unregister_operator(self, name: str):
        self.client.call("unregister", {"op": name},
                         deadline=self._deadline())
        self._ops.pop(name, None)

    def submit(self, op: str, b, **kw) -> Future:
        """One solve as a Future, carried off-thread by a small pool; the
        idempotency key is fixed per logical submit, so retries and failover
        replays reuse it and the solve runs once whichever host answers."""
        fut: Future = Future()
        idem = f"{self.name}.solve.{op}.{next(self._counter)}"
        payload = {"op": op, "b": np.asarray(b), "kw": dict(kw),
                   "timeout": self.solve_timeout}
        self._pool.submit(self._solve_task, op, payload, idem, fut)
        return fut

    def _solve_task(self, op, payload, idem, fut: Future):
        if not fut.set_running_or_notify_cancel():
            return
        try:
            try:
                reply = self.client.call("solve", payload,
                                         deadline=self._deadline(),
                                         idem_key=idem)
            except TransportError:
                target = (self.failover(op, self.name)
                          if self.failover is not None else None)
                if target is None:
                    raise
                # the same key on the session's new home: the survivor
                # solves from the re-homed checkpoint, and its own cache
                # dedupes the retries from here on
                reply = target.client.call(
                    "solve", payload, deadline=target.client.deadline,
                    idem_key=idem)
            fut.set_result(_result_from_reply(reply))
        except Exception as exc:  # noqa: BLE001 (resolves the future)
            fut.set_exception(exc)

    def solve(self, op: str, b, *, timeout: float | None = None, **kw):
        return self.submit(op, b, **kw).result(
            timeout if timeout is not None else self.solve_timeout)

    def operators(self):
        return self.client.call("operators", {},
                                deadline=self._deadline())

    def drain(self, timeout: float | None = None) -> bool:
        budget = (timeout if timeout is not None
                  else self.solve_timeout) + self.client.deadline
        return bool(self.client.call("drain", {"timeout": timeout},
                                     deadline=budget))

    def drain_operator(self, name: str):
        return self.client.call(
            "drain_operator", {"op": name},
            deadline=self.solve_timeout + self.client.deadline)

    def stats(self) -> dict:
        """The host server's stats, or an ``unreachable`` skeleton when the
        host is gone (the router sums these keys)."""
        try:
            return self.client.call("stats", {},
                                    deadline=self._deadline())
        except TransportError:
            return {"requests": 0, "batches": 0, "padded_cols": 0,
                    "width_hist": {}, "qos_hist": {}, "rejected": 0,
                    "expired": 0, "shed": 0, "pending": 0, "devices": 0,
                    "mesh_shrinks": [], "mesh_regrows": [],
                    "mean_width": 0.0, "unreachable": True}

    def regrow(self) -> bool:
        try:
            return bool(self.client.call("regrow", {},
                                         deadline=self._deadline()))
        except TransportError:
            return False

    def shutdown(self, wait: bool = True):
        try:
            self.client.call("shutdown", {"wait": bool(wait)},
                             deadline=self._deadline())
        except TransportError:
            pass        # a dead host is shut down
        self._pool.shutdown(wait=False)

    def __repr__(self):
        return (f"RemoteReplica({self.name!r}, "
                f"host={self.client.host_index}, "
                f"degraded={self.degraded})")


def _result_from_reply(reply: dict) -> ServedSolveResult:
    return ServedSolveResult(
        iterations=int(reply["iterations"]),
        residual_norm=float(reply["residual_norm"]),
        reason=int(reply["reason"]),
        wall_time=float(reply["wall_time"]),
        x=np.asarray(reply["x"]),
        op=str(reply["op"]),
        batch_width=int(reply["batch_width"]),
        queue_wait=float(reply["queue_wait"]))


@dataclass(frozen=True)
class FailoverEvent:
    """One confirmed host loss re-homed: which sessions moved where, and the
    checkpointed iteration the resumed solve continued from
    (``resumed_iteration > 0``: never from scratch)."""
    host: str
    dst: str
    sessions: tuple
    resumed_iteration: int
    wall_s: float


class FleetManager:
    """Hosts, transports, stubs, router and the failure detector.

    ``transport`` (or ``-fleet_transport``) is ``loopback`` (in-process,
    deterministic) or ``socket`` (TCP on ``127.0.0.1``: every frame is
    pickled and crosses a socket); anything else raises. The lease knobs
    come from the options database: ``-fleet_transport_lease_s`` between the
    monitor thread's rounds (:meth:`lease_step` itself is manual), and
    ``-fleet_transport_suspect_after`` / ``-fleet_transport_confirm_after``,
    the consecutive misses that make a host suspected or confirmed lost;
    each must be positive. ``client_sleep`` goes to every ``RpcClient``
    (drills pass a no-op); ``monitor=True`` starts a daemon thread running
    the lease loop. The in-process hosts and the stubs share one session
    lock, :attr:`card_lock`."""

    def __init__(self, hosts: int = 2, comm=None, *,
                 transport: str | None = None, monitor: bool = False,
                 client_sleep=time.sleep, vnodes: int | None = None,
                 rpc_deadline: float | None = None,
                 rpc_retry_max: int | None = None, **server_kw):
        _refuse_multiprocess(comm, "FleetManager")
        opt = global_options()
        self.transport_kind = opt.get_string(
            "fleet_transport", transport or "loopback")
        self.lease_s = opt.get_real("fleet_transport_lease_s", 0.5)
        self.suspect_after = opt.get_int("fleet_transport_suspect_after",
                                         2)
        self.confirm_after = opt.get_int("fleet_transport_confirm_after",
                                         4)
        if self.transport_kind not in ("loopback", "socket"):
            raise ValueError(
                f"-fleet_transport {self.transport_kind!r}: the port has "
                "the 'loopback' and 'socket' transports")
        if (self.lease_s <= 0 or self.suspect_after < 1
                or self.confirm_after < 1):
            raise ValueError(
                f"FleetManager: lease {self.lease_s} s, suspect after "
                f"{self.suspect_after}, confirm after {self.confirm_after}: "
                "each must be positive")
        self._epochs = itertools.count(1)
        self._lock = threading.RLock()
        self.card_lock = threading.RLock()
        self.hosts: dict[str, ReplicaHost] = {}
        self.stubs: dict[str, RemoteReplica] = {}
        self.transports: dict[str, object] = {}
        self._socket_servers: list[SocketHostServer] = []
        stubs = []
        for i in range(max(1, int(hosts))):
            name = f"r{i}"
            host = ReplicaHost(comm=comm, host_index=i,
                               session_lock=self.card_lock, **server_kw)
            if self.transport_kind == "socket":
                srv = SocketHostServer(host.rpc)
                self._socket_servers.append(srv)
                tr = SocketTransport(srv.address, i)
            else:
                tr = LoopbackTransport(host.rpc)
            client = RpcClient(tr, deadline=rpc_deadline,
                               retry_max=rpc_retry_max, seed=i,
                               sleep=client_sleep)
            stub = RemoteReplica(client, name=name,
                                 comm=host.server.comm,
                                 failover=self.failover_target,
                                 epoch_source=self._next_epoch,
                                 session_lock=self.card_lock)
            self.hosts[name] = host
            self.stubs[name] = stub
            self.transports[name] = tr
            stubs.append(stub)
        pool = list(stubs)
        # the router names replicas r0, r1, ... in factory-call order, so
        # popping in order keeps stub and router names aligned
        self.router = SolveRouter(len(stubs), comm,
                                  vnodes=vnodes,
                                  server_factory=lambda: pool.pop(0))
        self._lease = {name: {"misses": 0, "status": "live"}
                       for name in self.stubs}
        # op -> {"bytes","iteration","kwargs","epoch","host"}: the client
        # side's checkpoints, what a failover re-homes from; seeded at
        # registration, refreshed by lease_step when a ping shows a
        # session's iteration advanced
        self._ckpt: dict[str, dict] = {}
        self.failovers: list[FailoverEvent] = []
        self._closed = False
        self._monitor = None
        if monitor:
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="fleet-lease",
                daemon=True)
            self._monitor.start()

    def _next_epoch(self) -> int:
        with self._lock:
            return next(self._epochs)

    # ---- session front-end --------------------------------------------------

    def register_operator(self, name: str, A, **kw):
        """Router registration and an immediate checkpoint pull, so that a
        host lost before the first lease round is still re-homeable."""
        sess = self.router.register_operator(name, A, **kw)
        owner = self.router.owner(name)
        self._pull_ckpt(name, owner)
        return sess

    def submit(self, op: str, b, **kw) -> Future:
        return self.router.submit(op, b, **kw)

    def solve(self, op: str, b, *, timeout: float | None = None, **kw):
        return self.router.solve(op, b, timeout=timeout, **kw)

    def _pull_ckpt(self, op: str, owner: str):
        stub = self.stubs[owner]
        try:
            ck = stub.client.call("checkpoint", {"op": op},
                                  deadline=stub.client.deadline)
        except TransportError:
            return
        with self._lock:
            self._ckpt[op] = {"bytes": ck["bytes"],
                              "iteration": int(ck["iteration"]),
                              "kwargs": dict(ck["kwargs"]),
                              "epoch": int(ck["epoch"]), "host": owner}

    # ---- lease/heartbeat failure detector -----------------------------------

    def lease_step(self) -> dict:
        """One renewal round over every host not yet dead: a reachable host
        resets its misses and reports its sessions' iterations (advanced
        ones get their checkpoints pulled); an unreachable one climbs the
        suspected -> confirmed ladder."""
        with self._lock:
            live = 0
            for name, stub in self.stubs.items():
                st = self._lease[name]
                if st["status"] == "dead":
                    continue
                try:
                    reply = stub.client.call(
                        "ping", {}, deadline=max(self.lease_s, 0.05))
                except TransportError:
                    st["misses"] += 1
                    _metrics.registry.counter("fleet.lease_misses").inc(
                        label=name)
                    if st["misses"] >= self.confirm_after:
                        self._confirm_loss(name)
                    elif st["misses"] >= self.suspect_after:
                        st["status"] = "suspected"
                        stub.degraded = True
                    continue
                st["misses"] = 0
                st["status"] = "live"
                stub.degraded = False
                live += 1
                for op, it in reply["iterations"].items():
                    cached = self._ckpt.get(op)
                    if (cached is None or cached["host"] != name
                            or int(it) > int(cached["iteration"])):
                        self._pull_ckpt(op, name)
            _metrics.registry.gauge("fleet.live_hosts").set(live)
            return {name: dict(st)
                    for name, st in self._lease.items()}

    def _monitor_loop(self):
        while not self._closed:
            try:
                self.lease_step()
            except Exception:  # noqa: BLE001 (a bad round: misses counted)
                pass
            time.sleep(self.lease_s)

    def _survivor(self, dead: str) -> str | None:
        """The re-home destination: a live host, else a suspected one."""
        with self._lock:
            for want in ("live", "suspected"):
                for name, st in self._lease.items():
                    if name != dead and st["status"] == want:
                        return name
        return None

    def _confirm_loss(self, name: str):
        """A confirmed host loss: kill its transport, re-register every
        session it owned on a survivor from the cached checkpoint (resumed
        at its checkpointed iteration) and flip the router's placement.
        Idempotent."""
        with self._lock:
            st = self._lease[name]
            if st["status"] == "dead":
                return
            st["status"] = "dead"
            self.stubs[name].degraded = True
            tr = self.transports[name]
            if hasattr(tr, "kill"):
                tr.kill()
            t0 = time.perf_counter()
            owned = [op for op in self.router.operators()
                     if self.router.owner(op) == name]
            dst = self._survivor(name)
            moved = []
            resumed_max = 0
            with _telemetry.span("fleet.failover", host=name) as sp:
                if dst is not None:
                    for op in owned:
                        ck = self._ckpt.get(op)
                        if ck is None:
                            continue    # never checkpointed: lost with
                            # its host (absent from `sessions`)
                        stub = self.stubs[dst]
                        epoch = self._next_epoch()
                        reply = stub.client.call(
                            "register",
                            {"op": op, "ckpt": ck["bytes"],
                             "kwargs": ck["kwargs"], "epoch": epoch,
                             "resume": True},
                            deadline=stub.client.deadline,
                            idem_key=f"failover.{op}.{epoch}")
                        self.router.rehome(op, dst)
                        self._ckpt[op].update(
                            host=dst, epoch=epoch,
                            iteration=int(reply["iteration"]))
                        moved.append(op)
                        resumed_max = max(
                            resumed_max,
                            int(reply["resumed_iteration"]))
                sp.set_attrs(sessions=len(moved),
                             resumed_iteration=resumed_max)
            _metrics.registry.counter("fleet.failovers").inc(label=name)
            self.failovers.append(FailoverEvent(
                host=name, dst=dst or "", sessions=tuple(moved),
                resumed_iteration=resumed_max,
                wall_s=time.perf_counter() - t0))

    def failover_target(self, op: str, src_name: str):
        """The stubs' failover hook: an in-flight solve RPC to ``src_name``
        failed. Take it as confirmation (the retry budget was a probe
        burst), re-home if nobody has yet, and return the stub now serving
        ``op``, or None when no survivor exists."""
        with self._lock:
            owner = self.router.owner(op)
            if (owner != src_name
                    and self._lease[owner]["status"] != "dead"):
                return self.stubs[owner]    # already re-homed
            self._confirm_loss(src_name)
            owner = self.router.owner(op)
            if (owner == src_name
                    or self._lease[owner]["status"] == "dead"):
                return None
            return self.stubs[owner]

    # ---- partition healing --------------------------------------------------

    def reconcile(self) -> dict:
        """Post-partition reconcile: gather ``resident()`` from every
        reachable host; keep one registration a session (the router's owner
        when it holds one, else the highest epoch), unregister the orphans,
        and point the router at the winner. Returns what moved."""
        with self._lock, _telemetry.span("fleet.reconcile") as sp:
            resident = {}
            for name, stub in self.stubs.items():
                if self._lease[name]["status"] == "dead":
                    continue
                try:
                    resident[name] = stub.client.call(
                        "resident", {}, deadline=stub.client.deadline)
                except TransportError:
                    continue        # still partitioned: next round
            orphans = []
            rehomed = []
            for op in self.router.operators():
                holders = {name: int(eps[op])
                           for name, eps in resident.items()
                           if op in eps}
                if not holders:
                    continue
                auth = self.router.owner(op)
                winner = (auth if auth in holders
                          else max(holders, key=holders.get))
                for name in sorted(holders):
                    if name == winner:
                        continue
                    self.stubs[name].client.call(
                        "unregister", {"op": op},
                        deadline=self.stubs[name].client.deadline)
                    orphans.append((op, name))
                if winner != auth:
                    self.router.rehome(op, winner)
                    self._pull_ckpt(op, winner)
                    rehomed.append((op, winner))
            sp.set_attrs(orphans=len(orphans), rehomed=len(rehomed))
            return {"orphans_removed": orphans, "rehomed": rehomed,
                    "resident": resident}

    # ---- drill/observability helpers ----------------------------------------

    def kill_host(self, name: str):
        """Abrupt host loss: the transport dies now; discovery still goes
        through the lease ladder or an in-flight call's failover."""
        tr = self.transports[name]
        if hasattr(tr, "kill"):
            tr.kill()

    def lease_table(self) -> dict:
        with self._lock:
            return {name: dict(st) for name, st in self._lease.items()}

    def stats(self) -> dict:
        out = self.router.stats()
        out["lease"] = self.lease_table()
        out["failovers"] = [
            {"host": e.host, "dst": e.dst, "sessions": list(e.sessions),
             "resumed_iteration": e.resumed_iteration,
             "wall_s": e.wall_s}
            for e in self.failovers]
        return out

    def shutdown(self, wait: bool = True):
        self._closed = True
        self.router.shutdown(wait=wait)
        for srv in self._socket_servers:
            srv.close()
        # a host whose transport died never heard the router's shutdown:
        # its in-process server stops here
        for host in self.hosts.values():
            host.server.shutdown(wait=False)
        if self._monitor is not None:
            self._monitor.join(timeout=max(1.0, 2 * self.lease_s))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(wait=exc == (None, None, None))
        return False
